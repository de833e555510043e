"""Tail-sampled distributed trace store: keep exactly the traces that matter.
A copy of `openwhisk_tpu/utils/tracestore.py`.

The tracing spine (utils/tracing.py) reports every finished span into a
flat reporter buffer — fine for unit tests, useless for answering "show me
everything that happened to THIS slow activation" once traffic is real:
head-sampling (Dapper's design, see PAPERS.md) must decide at ingress,
before anyone knows whether the request will be interesting. This module
samples at the TAIL instead: spans tee from the tracer's reporter into a
bounded per-trace pending table, and the keep/drop verdict is made at
completion — when the e2e latency, outcome, spill/fence/force flags and
placement-divergence verdict are all known. Kept traces are joined with
the activation's waterfall stage vector (utils/waterfall.py), the flight
recorder's batch digest and the placement-quality digest, serialized once,
and promoted into a kept SeqRingBuffer; everything else ages out without
ever being serialized.

Verdict reasons (the `trace_kept_total{reason}` label, priority order —
the FIRST matching reason is the counter's label):

  error      the activation's outcome was an application/system error
  timeout    the controller force-timed the activation out
  fenced     the activation rode a fenced (HA handoff) dispatch
  spilled    the waterfall row crossed a spill_forward hop
  forced     forced placement row, or an explicit force-trace flag
  divergent  the shadow counterfactual kernel disagreed with placement
  exemplar   an OpenMetrics exemplar was pinned to this trace id (every
             rendered exemplar must resolve via /admin/trace/{id})
  slow       e2e above the live tail threshold (waterfall p99 bucket,
             SLO target fallback)
  floor      the uniform keep floor (deterministic 1-in-N, so the clean
             bulk keep rate equals the configured floor exactly)

Cross-process assembly (`assemble_trace`) merges per-process kept halves
into ONE causal span tree. Clocks are aligned at the bus handoff pairs —
a spilled half's publish_enqueue pins to the origin's spill_forward, an
invoker-side half's invoker_pickup pins to the origin's publish_enqueue —
which deliberately collapses bus transit into the handoff edge (the
conservative alignment; see docs/tpu-balancer.md for the caveats). The
tree telescopes: stage spans are synthesized from the waterfall deltas,
which by construction sum to exactly the measured e2e.

Off-switch: `CONFIG_whisk_tracing_tail_enabled=false` is a TRUE no-op —
the reporter tee is never attached, completions take one attribute check,
no span, dict entry or counter is ever touched (tracemalloc-asserted in
tests/test_tracestore.py).
"""
from __future__ import annotations

import secrets
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from .config import load_config
from .eventlog import identity
from .ring_buffer import SeqRingBuffer
from .tracing import GLOBAL_TRACER, Reporter, Span, Tracer
from .waterfall import (STAGES, STAGE_INVOKER_PICKUP, STAGE_PUBLISH_ENQUEUE,
                        STAGE_SPILL_FORWARD)

#: keep-reason priority: the first match labels `trace_kept_total`
REASONS = ("error", "timeout", "fenced", "spilled", "forced", "divergent",
           "exemplar", "slow", "floor")


@dataclass(frozen=True)
class TraceTailConfig:
    """`CONFIG_whisk_tracing_tail_*` env overrides."""
    enabled: bool = True
    #: kept-trace ring slots (each entry is a fully serialized trace)
    keep_ring: int = 256
    #: in-flight pending traces; past it the oldest ages out (counted)
    pending_limit: int = 4096
    #: uniform keep floor for otherwise-uninteresting traces; 0 disables.
    #: Deterministic 1-in-round(1/floor), not random — the clean-bulk
    #: keep rate is exactly the floor, which the bench rider asserts.
    keep_floor: float = 0.01


def tail_config(data: Optional[dict] = None) -> TraceTailConfig:
    return load_config(TraceTailConfig, data, env_path="tracing.tail")


class _TeeReporter(Reporter):
    """Wraps the tracer's real reporter: every finished span flows to the
    pending table AND the inner sink. `swap_inner` lets
    maybe_enable_zipkin replace the sink without losing the tee."""

    def __init__(self, store: "TraceStore", inner: Reporter):
        self.store = store
        self.inner = inner

    def swap_inner(self, inner: Reporter) -> None:
        self.inner = inner

    def report(self, span: Span) -> None:
        self.store._ingest(span)
        self.inner.report(span)

    # the tracing health gauges read these off whatever reporter is live
    @property
    def sent_spans(self) -> int:
        return getattr(self.inner, "sent_spans", 0)

    @property
    def dropped_spans(self) -> int:
        return getattr(self.inner, "dropped_spans", 0)


def synthetic_span(trace_id: str, name: str, start: float, end: float,
                   tags: Optional[dict] = None,
                   parent_id: Optional[str] = None) -> Span:
    """A fully-formed span from EXISTING timestamps (the device-dispatch /
    spill-hop / container spans ride stamps already taken on the hot path
    — building the span never reads a clock)."""
    return Span(trace_id=trace_id, span_id=secrets.token_hex(8),
                parent_id=parent_id, name=name, start=start, end=end,
                tags=dict(tags or {}))


class TraceStore:
    """Per-process tail-sampling trace store (one instance per process,
    like GLOBAL_WATERFALL — the balancer hook owns rendering and the
    admin read side)."""

    #: spans kept per pending trace (a runaway span producer must not
    #: grow one trace unboundedly)
    SPAN_CAP = 64
    #: bound on the pre-completion mark table (divergent/exemplar/forced
    #: flags noted before the verdict)
    MARK_CAP = 8192

    def __init__(self, config: Optional[TraceTailConfig] = None):
        self.config = config or tail_config()
        self.enabled = bool(self.config.enabled)
        self._lock = threading.Lock()
        #: trace_id -> [Span, ...] (insertion-ordered: first key is oldest)
        self._pending: Dict[str, List[Span]] = {}
        #: trace_id -> {reason, ...} noted before completion
        self._marks: Dict[str, set] = {}
        self._kept: SeqRingBuffer[dict] = SeqRingBuffer(
            max(8, int(self.config.keep_ring)))
        #: trace_id -> kept seq (consistent via the ring's evicted return)
        self._by_id: Dict[str, int] = {}
        self.kept_total: Dict[str, int] = {}
        self.dropped_total = 0
        self.pending_evicted = 0
        self._seen = 0
        floor = float(self.config.keep_floor)
        self._floor_every = int(round(1.0 / floor)) if floor > 0 else 0
        #: live tail threshold source (the balancer wires the waterfall's
        #: host-side p99 bucket here); the default is the SLO e2e target
        self.threshold_source: Optional[Callable[[], Optional[float]]] = None
        self.default_threshold_ms = 1000.0
        #: keep-time join: activation id -> flight-recorder placement
        #: digest (called ONLY for kept traces, never on the drop path)
        self.placement_lookup: Optional[Callable[[str], Optional[dict]]] = None
        self._attached: Optional[Tracer] = None

    @property
    def active(self) -> bool:
        """Enabled AND teed into a tracer — the gate the extra span sites
        (container pair, device dispatch, spill hop) check so processes
        without the plane never pay for span objects nobody collects."""
        return self.enabled and self._attached is not None

    # -- lifecycle ---------------------------------------------------------
    def attach(self, tracer: Optional[Tracer] = None) -> None:
        """Tee the tracer's reporter through this store. Idempotent —
        every balancer in the process attaches the same global store.
        Never called when disabled: the off state touches nothing."""
        if not self.enabled:
            return
        t = tracer if tracer is not None else GLOBAL_TRACER
        rep = t.reporter
        if isinstance(rep, _TeeReporter) and rep.store is self:
            return
        t.reporter = _TeeReporter(self, rep)
        self._attached = t

    def detach(self) -> None:
        """Restore the wrapped reporter (test isolation)."""
        t = self._attached
        if t is not None and isinstance(t.reporter, _TeeReporter) \
                and t.reporter.store is self:
            t.reporter = t.reporter.inner
        self._attached = None

    def reset(self) -> None:
        """Drop all state (bench riders isolate measured windows)."""
        with self._lock:
            self._pending.clear()
            self._marks.clear()
            self._kept = SeqRingBuffer(max(8, int(self.config.keep_ring)))
            self._by_id.clear()
            self.kept_total = {}
            self.dropped_total = 0
            self.pending_evicted = 0
            self._seen = 0

    # -- write side --------------------------------------------------------
    def _ingest(self, span: Span) -> None:
        """Reporter-tee entry: file the span under its trace id. Bounded:
        a new trace past `pending_limit` ages the oldest pending trace
        out (counted, never serialized). Dict ops are GIL-atomic — spans
        report from the event loop and worker threads alike."""
        tid = span.trace_id
        pend = self._pending
        spans = pend.get(tid)
        if spans is None:
            if len(pend) >= self.config.pending_limit:
                try:
                    old = next(iter(pend))
                    pend.pop(old, None)
                    self.pending_evicted += 1
                except (StopIteration, KeyError):
                    pass
            spans = pend[tid] = []
        if len(spans) < self.SPAN_CAP:
            spans.append(span)

    def emit(self, span: Span) -> None:
        """Report a pre-built (synthetic) span through the attached
        tracer's reporter, so it reaches both the tee and the sink."""
        t = self._attached if self._attached is not None else GLOBAL_TRACER
        t.reporter.report(span)

    def mark(self, trace_id: Optional[str], reason: str) -> None:
        """Note a keep reason BEFORE the verdict (divergent placement,
        pinned exemplar, explicit force flag). Consulted and consumed at
        completion."""
        if not self.enabled or not trace_id:
            return
        marks = self._marks
        s = marks.get(trace_id)
        if s is None:
            if len(marks) >= self.MARK_CAP:
                try:
                    marks.pop(next(iter(marks)), None)
                except (StopIteration, KeyError):
                    pass
            s = marks[trace_id] = set()
        s.add(reason)

    def force(self, trace_id: Optional[str], reason: str = "forced") -> None:
        """The explicit force-trace flag (and the exemplar pin hook)."""
        self.mark(trace_id, reason)

    # -- verdict -----------------------------------------------------------
    def tail_threshold_ms(self) -> float:
        src = self.threshold_source
        if src is not None:
            try:
                t = src()
                if t is not None:
                    return float(t)
            except Exception:  # noqa: BLE001 — a broken source must not
                pass           # take the completion path down
        return self.default_threshold_ms

    def complete(self, aid: str, trace_id: Optional[str],
                 e2e_ms: Optional[float] = None, *,
                 error: bool = False, timeout: bool = False,
                 forced: bool = False, fenced: bool = False,
                 row: Optional[dict] = None) -> Optional[dict]:
        """The completion-time tail-sampling verdict for one activation:
        decide keep/drop now that the outcome is known, and on keep join
        the pending spans with the waterfall row and the flight-recorder
        placement digest. Returns the kept entry, or None on drop."""
        if not self.enabled:
            return None
        tid = trace_id or (row.get("trace_id") if row else None)
        self._seen += 1
        marks = self._marks.pop(tid, None) if tid else None
        reasons: List[str] = []
        if error:
            reasons.append("error")
        if timeout or forced:
            reasons.append("timeout" if timeout else "forced")
        if fenced:
            reasons.append("fenced")
        if row is not None and row["deltas_us"][STAGE_SPILL_FORWARD] >= 0:
            reasons.append("spilled")
        if marks:
            for r in ("spilled", "forced", "divergent", "exemplar"):
                if r in marks and r not in reasons:
                    reasons.append(r)
        if e2e_ms is None and row is not None:
            e2e_ms = row["total_us"] / 1000.0
        if e2e_ms is not None and e2e_ms > self.tail_threshold_ms():
            reasons.append("slow")
        if not reasons and self._floor_every \
                and self._seen % self._floor_every == 0:
            reasons.append("floor")
        if not reasons:
            if tid:
                self._pending.pop(tid, None)
            self.dropped_total += 1
            return None
        # priority order for the counter label
        reasons.sort(key=REASONS.index)
        return self._keep(aid, tid, e2e_ms, reasons, row)

    def _keep(self, aid: str, tid: Optional[str], e2e_ms: Optional[float],
              reasons: List[str], row: Optional[dict]) -> dict:
        spans = self._pending.pop(tid, None) if tid else None
        placement = None
        if self.placement_lookup is not None:
            try:
                placement = self.placement_lookup(aid)
            except Exception:  # noqa: BLE001 — a join miss never drops
                placement = None
        entry = {
            "trace_id": tid,
            "activation_id": aid,
            "ts": row["ts"] if row else time.time(),
            "reason": reasons[0],
            "reasons": reasons,
            "e2e_ms": (round(e2e_ms, 3) if e2e_ms is not None else None),
            "identity": identity(),
            "spans": [s.to_json() for s in (spans or [])],
            "waterfall": dict(row) if row else None,
            "placement": placement,
            "quality": (placement or {}).get("quality"),
        }
        with self._lock:
            seq, evicted = self._kept.append(entry)
            entry["_seq"] = seq
            if evicted is not None:
                etid = evicted.get("trace_id")
                if etid and self._by_id.get(etid) == evicted.get("_seq"):
                    del self._by_id[etid]
            if tid:
                self._by_id[tid] = seq
            r = reasons[0]
            self.kept_total[r] = self.kept_total.get(r, 0) + 1
        return entry

    # -- read side ---------------------------------------------------------
    def get(self, trace_id: str) -> Optional[dict]:
        """The kept entry for one trace id, or None if never kept / the
        ring has wrapped past it."""
        with self._lock:
            seq = self._by_id.get(trace_id)
            if seq is None:
                return None
            entry = self._kept.get(seq)
        if entry is None or entry.get("trace_id") != trace_id:
            return None
        return entry

    def entries(self) -> List[dict]:
        """Every kept entry, oldest first (the loadgen NDJSON export)."""
        with self._lock:
            return list(self._kept.last(self._kept.size))

    def list(self, reason: Optional[str] = None, n: int = 50) -> List[dict]:
        """Kept-trace summaries, newest first, optionally filtered by
        verdict reason."""
        with self._lock:
            rows = self._kept.last(self._kept.size)
        out = []
        for e in reversed(rows):
            if reason and reason not in e["reasons"]:
                continue
            out.append({
                "trace_id": e["trace_id"],
                "activation_id": e["activation_id"],
                "ts": e["ts"],
                "reason": e["reason"],
                "reasons": e["reasons"],
                "e2e_ms": e["e2e_ms"],
                "spans": len(e["spans"]),
            })
            if len(out) >= n:
                break
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "identity": identity(),
                "pending": len(self._pending),
                "pending_evicted": self.pending_evicted,
                "kept": len(self._kept),
                "kept_total": dict(self.kept_total),
                "dropped_total": self.dropped_total,
                "seen": self._seen,
                "keep_floor": self.config.keep_floor,
                "tail_threshold_ms": self.tail_threshold_ms(),
            }

    # -- exposition --------------------------------------------------------
    def prometheus_text(self, openmetrics: bool = False) -> str:
        """`openwhisk_trace_kept_total{reason=...}` /
        `openwhisk_trace_dropped_total` (rendering shared with the other
        planes via controller/monitoring.py)."""
        if not self.enabled:
            return ""
        from ..controller.monitoring import counter_family_text
        with self._lock:
            kept = dict(self.kept_total)
            dropped = self.dropped_total
        out = counter_family_text(
            "openwhisk_trace_kept_total",
            [({"reason": r}, int(kept[r])) for r in sorted(kept)],
            openmetrics=openmetrics)
        # unlabeled counter: rendered bare (an empty `{}` label set is
        # invalid OpenMetrics), with the same TYPE-name rule as
        # counter_family_text (OM types the base, samples keep _total)
        drop = "openwhisk_trace_dropped_total"
        out += [f"# TYPE {drop[:-len('_total')] if openmetrics else drop} "
                "counter", f"{drop} {int(dropped)}"]
        return "\n".join(out)


# -- cross-process assembly -------------------------------------------------

def _stage_times_us(row: dict) -> Dict[int, int]:
    """Absolute stage times in µs since the row's own t0: the deltas
    telescope, so a running sum over PRESENT stages reconstructs each
    stamp's offset exactly."""
    out: Dict[int, int] = {}
    t = 0
    for i, d in enumerate(row.get("deltas_us") or []):
        if d < 0:
            continue
        t += d
        out[i] = t
    return out


def _half_key(half: dict) -> str:
    ident = half.get("identity") or {}
    inst = ident.get("instance")
    role = ident.get("role") or "proc"
    return f"{role}{inst if inst is not None else ''}" or "local"


def _pick_origin(halves: List[dict]) -> int:
    """The origin half: the one whose waterfall row starts the pipeline
    (api_accept present), else the longest row, else the first half."""
    best, best_score = 0, (-1, -1)
    for i, h in enumerate(halves):
        row = h.get("waterfall")
        if not row:
            continue
        times = _stage_times_us(row)
        score = (1 if 0 in times else 0, int(row.get("total_us") or 0))
        if score > best_score:
            best, best_score = i, score
    return best


def assemble_trace(trace_id: str, halves: List[dict],
                   members_missing: Iterable[Any] = ()) -> dict:
    """Merge per-process kept halves into ONE causal span tree.

    Alignment: the origin half's t0 is the tree's zero. A peer half with
    a spilled-in row pins its publish_enqueue to the origin's
    spill_forward stamp; an invoker-side half pins its invoker_pickup to
    the origin's publish_enqueue (both collapse bus transit into the
    handoff edge — the conservative alignment). Halves with neither
    handoff stamp fall back to wall-clock deltas between entry `ts`
    anchors. Spans are deduplicated by span id, so scraping the same
    process twice (or a shared in-process store) never double-counts.
    """
    seen = set()
    uniq: List[dict] = []
    for h in halves:
        if not h:
            continue
        # one half per process identity: scraping a shared in-process
        # store through three API servers yields three identical copies
        k = (_half_key(h), (h.get("identity") or {}).get("pid"),
             h.get("activation_id"), h.get("ts"))
        if k in seen:
            continue
        seen.add(k)
        uniq.append(h)
    halves = uniq
    if not halves:
        return {"trace_id": trace_id, "found": False,
                "members_missing": sorted(members_missing, key=str)}
    oi = _pick_origin(halves)
    origin = halves[oi]
    orow = origin.get("waterfall") or {}
    otimes = _stage_times_us(orow)
    ototal = int(orow.get("total_us") or 0)

    #: per-half offset (µs) of its own t0 on the origin timeline
    offsets: List[int] = []
    for i, h in enumerate(halves):
        if i == oi:
            offsets.append(0)
            continue
        row = h.get("waterfall") or {}
        times = _stage_times_us(row)
        if STAGE_SPILL_FORWARD in otimes and STAGE_PUBLISH_ENQUEUE in times:
            # spilled half: its enqueue IS the origin's spill handoff
            offsets.append(otimes[STAGE_SPILL_FORWARD]
                           - times[STAGE_PUBLISH_ENQUEUE])
        elif STAGE_PUBLISH_ENQUEUE in otimes and STAGE_INVOKER_PICKUP in times:
            offsets.append(otimes[STAGE_PUBLISH_ENQUEUE]
                           - times[STAGE_INVOKER_PICKUP])
        else:
            # wall-clock fallback: anchor completion timestamps
            o_ts, h_ts = origin.get("ts") or 0, h.get("ts") or 0
            h_total = int(row.get("total_us") or 0)
            offsets.append(int((h_ts - o_ts) * 1e6) + ototal - h_total)

    # -- collect nodes ------------------------------------------------------
    span_nodes: Dict[str, dict] = {}
    parent_of: Dict[str, Optional[str]] = {}
    groups: List[dict] = []
    procs: set = set()
    end_us = ototal

    for i, h in enumerate(halves):
        off = offsets[i]
        key = _half_key(h)
        procs.add(key)
        row = h.get("waterfall") or {}
        times = _stage_times_us(row)
        stage_nodes = []
        prev = 0
        placement = h.get("placement") or {}
        for si in sorted(times):
            start = prev + off
            dur = times[si] - prev
            node = {"name": f"stage:{STAGES[si]}", "proc": key,
                    "start_us": start, "duration_us": dur,
                    "tags": {}, "children": []}
            if STAGES[si] == "device_dispatch" and placement:
                # the per-micro-batch device link: the flight-recorder
                # digest joins this member to its batch (and the batch's
                # own span under the digest's trace id)
                node["tags"] = {
                    "batch_seq": placement.get("seq"),
                    "kernel": placement.get("kernel"),
                    "batch_trace_id": placement.get("trace_id"),
                }
            stage_nodes.append(node)
            prev = times[si]
            end_us = max(end_us, prev + off)
        group = {"name": f"proc:{key}", "proc": key,
                 "start_us": off, "duration_us": max(0, prev),
                 "tags": {}, "children": stage_nodes}
        groups.append(group)
        for sp in h.get("spans") or []:
            sid = sp.get("id")
            if not sid or sid in span_nodes:
                continue  # dedup across scraped copies of one store
            tags = sp.get("tags") or {}
            proc = tags.get("proc")
            if proc:
                procs.add(proc)
            # span wall µs -> origin-relative: anchor at the half's own
            # wall t0 (completion ts minus total), then shift by offset
            h_total = int(row.get("total_us") or 0)
            t0_wall_us = (h.get("ts") or 0) * 1e6 - h_total
            start = int(sp.get("timestamp", 0) - t0_wall_us) + off
            node = {"name": sp.get("name"), "proc": proc or key,
                    "start_us": start,
                    "duration_us": int(sp.get("duration") or 0),
                    "tags": tags, "children": []}
            span_nodes[sid] = node
            parent_of[sid] = sp.get("parentId")
            group.setdefault("_span_ids", []).append(sid)
            end_us = max(end_us, start + node["duration_us"])

    # -- link reported spans: parent when present, else the half group -----
    for sid, node in span_nodes.items():
        pid = parent_of.get(sid)
        if pid and pid in span_nodes:
            span_nodes[pid]["children"].append(node)
    for group in groups:
        for sid in group.pop("_span_ids", []):
            pid = parent_of.get(sid)
            if not (pid and pid in span_nodes):
                group["children"].append(span_nodes[sid])
        group["children"].sort(key=lambda n: n["start_us"])

    groups.sort(key=lambda g: g["start_us"])
    root = {"name": f"activation:{trace_id}", "proc": _half_key(origin),
            "start_us": 0, "duration_us": max(0, end_us),
            "tags": {"activation_id": origin.get("activation_id"),
                     "reason": origin.get("reason")},
            "children": groups}
    return {
        "trace_id": trace_id,
        "found": True,
        "e2e_us": root["duration_us"],
        "processes": sorted(procs),
        "reasons": sorted({r for h in halves
                           for r in (h.get("reasons") or [])}),
        "members_missing": sorted(members_missing, key=str),
        "root": root,
    }


#: the process-wide store (same pattern as GLOBAL_WATERFALL /
#: GLOBAL_TRACER): spans report from layers that share no balancer
#: reference; the CommonLoadBalancer hook attaches the tee, wires the
#: verdict and owns rendering + the admin read side
GLOBAL_TRACE_STORE = TraceStore()
