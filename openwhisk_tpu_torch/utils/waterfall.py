"""Activation latency waterfall: per-activation stage timestamps.

The balancer's observability planes (flight recorder, telemetry,
profiler, anomaly) watch its *interior*. The end-to-end path around it —
accept → entitle → throttle → enqueue → assemble → dispatch → readback →
produce → pickup → acquire → run → ack → record — is a black box to them:
they cannot say *where* an activation's latency lives. This plane answers
that: every activation carries a fixed-enum stage vector of monotonic-ns
stamps, folded at completion into per-stage log2 histograms, a
dominant-stage counter (tail attribution: which stage most often dominates
the slowest activations) and a slowest-exemplar ring joined to
flight-recorder trace ids.

Design (same shape as the tracer: one process-global instance, because the
stages span layers that do not share a balancer reference — the API
handler, the entitlement pipeline, the messaging producers, the invoker,
the container pool and the record batcher all stamp into it; the balancer's
CommonLoadBalancer hook owns rendering and the admin read side):

  ctx   = [t0_ns, trace_id, s_0 .. s_12]   one small list per activation
  stamp = first-wins write of monotonic_ns into the stage slot (first-wins
          makes re-sends / ack-vs-store races idempotent)
  finish (at completion_ack) folds deltas between consecutive *present*
          stamps into int64[13, B] histograms — absent stages simply do
          not contribute, so partial pipelines (echo invokers, CPU twins)
          stay honest and the per-activation deltas always telescope to
          exactly (last stamp - t0).

Hot-path budget: one dict get + one list write per stamp; finish is ~13
integer bucket folds under a lock. Disabled
(`CONFIG_whisk_waterfall_enabled=false`) is a true no-op: open() returns
None, stamps find no context, no dict entry or array is ever touched.

Clock note: t0 may be injected (the open-loop load generator anchors it at
the *scheduled* arrival time, so the first stage delta carries the
coordinated-omission send lag) and must share time.monotonic_ns()'s epoch.

Known race, by design: the invoker sends the completion ack *before* it
stores the activation record, and the controller consumes the ack
asynchronously — so `record_write` may stamp before `completion_ack`
(clamped to a 0 delta) or land after finish() (dropped). Every other stage
pair is causally ordered.
"""
from __future__ import annotations

import functools
import math
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from .config import load_config
from .eventlog import identity
from .ring_buffer import SeqRingBuffer

#: the fixed stage enum — index order IS the causal pipeline order
STAGES = (
    "api_accept",         # request routed + parsed at the REST handler
    "entitle",            # entitlement (rights) check passed
    "throttle",           # rate/concurrency throttle passed
    "spill_forward",      # overflow row forwarded to a peer controller
                          # (active/active spillover; origin-side terminal
                          # stage — the peer's books own the rest)
    "publish_enqueue",    # balancer accepted the activation into its queue
    "batch_assemble",     # micro-batch packed host-side (TPU balancer)
    "device_dispatch",    # device program dispatched
    "device_readback",    # placement read back from the device
    "produce",            # activation message handed to the bus
    "invoker_pickup",     # invoker parsed the message off its topic
    "container_acquire",  # container pool granted a proxy
    "run",                # user code finished (active ack sent)
    "completion_ack",     # controller processed the completion ack
    "record_write",       # activation record persisted (may race the ack)
)
(STAGE_API_ACCEPT, STAGE_ENTITLE, STAGE_THROTTLE, STAGE_SPILL_FORWARD,
 STAGE_PUBLISH_ENQUEUE,
 STAGE_BATCH_ASSEMBLE, STAGE_DEVICE_DISPATCH, STAGE_DEVICE_READBACK,
 STAGE_PRODUCE, STAGE_INVOKER_PICKUP, STAGE_CONTAINER_ACQUIRE, STAGE_RUN,
 STAGE_COMPLETION_ACK, STAGE_RECORD_WRITE) = range(len(STAGES))
N_STAGES = len(STAGES)

#: ctx layout: [t0_ns, trace_id] + one stamp slot per stage
_CTX_T0, _CTX_TRACE = 0, 1
_CTX_BASE = 2

#: how often (in finished activations) the tail-bucket threshold — the p99
#: bucket of the total-latency histogram — is recomputed
_TAIL_REFRESH = 64


@dataclass(frozen=True)
class WaterfallConfig:
    """`CONFIG_whisk_waterfall_*` env overrides."""
    enabled: bool = True
    #: completed-row ring (the recent/slowest exemplar source)
    ring: int = 512
    #: log2 stage-duration buckets: bucket i covers (2^(i-1), 2^i] us —
    #: 30 buckets span 1 us .. ~9 min (sub-ms resolution matters here:
    #: assembly/dispatch phases live around 100 us)
    buckets: int = 30
    #: slowest-activation exemplar rows kept
    exemplars: int = 8
    #: in-flight stamp-vector cap; past it the oldest context is evicted
    #: (counted) so abandoned activations cannot grow the map unboundedly
    max_active: int = 65536


def bucket_of_us(v: int, n_buckets: int) -> int:
    """Integer-exact log2 bucket: the smallest i with 2^i us >= v (v <= 1
    lands in bucket 0); the last bucket is the overflow."""
    if v <= 1:
        return 0
    return min(int(v - 1).bit_length(), n_buckets - 1)


@functools.lru_cache(maxsize=8)
def bucket_bounds_ms(n_buckets: int) -> List[float]:
    """Finite upper bounds in ms (2^i us); the implicit last is +Inf.
    Cached: tail_threshold_ms() reads the bounds once per completion
    verdict — callers must not mutate the returned list."""
    return [(2 ** i) / 1000.0 for i in range(max(1, n_buckets - 1))]


class ActivationWaterfall:
    """The stage-timestamp plane. Stamps run on the event loop (or any
    thread — dict get/set and list writes are GIL-atomic); finish() and the
    read side serialize on one lock around the numpy aggregates."""

    def __init__(self, config: Optional[WaterfallConfig] = None):
        self.config = config or WaterfallConfig()
        self.enabled = self.config.enabled
        self.n_buckets = max(4, int(self.config.buckets))
        self._active: Dict[str, list] = {}
        self._lock = threading.Lock()
        self.evicted_active = 0
        self._reset_aggregates()

    def _reset_aggregates(self) -> None:
        b = self.n_buckets
        #: per-stage duration histograms (stage delta = time since the
        #: previous PRESENT stamp) + sums for `_sum`/mean. Plain Python
        #: int lists, NOT numpy: finish() does ~15 single-element
        #: increments per activation, where a numpy scalar index costs
        #: ~1-2 us each vs ~50 ns for a list slot — at hundreds of
        #: activations/s that difference IS the plane's overhead budget
        self._hist = [[0] * b for _ in range(N_STAGES)]
        self._sum_us = [0] * N_STAGES
        self._stage_count = [0] * N_STAGES
        #: end-to-end (t0 -> last stamp) histogram
        self._total_hist = [0] * b
        self._total_sum_us = 0
        #: dominant-stage counters: which stage carried the largest delta,
        #: over all activations and over the tail (total >= the p99 bucket)
        self._dominant = [0] * N_STAGES
        self._dominant_tail = [0] * N_STAGES
        self._tail_bucket = self.n_buckets - 1
        self._finished = 0
        self._ring: SeqRingBuffer[dict] = SeqRingBuffer(
            max(8, int(self.config.ring)))
        #: (total_us, tiebreak, row) kept sorted ascending, capped at
        #: config.exemplars (the counter keeps equal totals comparable)
        self._slowest: List[tuple] = []
        self._slow_seq = 0

    @classmethod
    def from_config(cls) -> "ActivationWaterfall":
        return cls(load_config(WaterfallConfig, env_path="waterfall"))

    def reset(self) -> None:
        """Drop all state (bench riders isolate measured windows)."""
        with self._lock:
            self._active.clear()
            self.evicted_active = 0
            self._reset_aggregates()

    # -- write side --------------------------------------------------------
    def open(self, t0_ns: Optional[int] = None,
             trace_id: Optional[str] = None) -> Optional[list]:
        """A fresh, not-yet-adopted stage vector anchored at `t0_ns`
        (default: now). The open-loop load generator anchors at the
        SCHEDULED arrival time so the first stage delta is
        coordinated-omission-correct. None when disabled."""
        if not self.enabled:
            return None
        return [t0_ns if t0_ns is not None else time.monotonic_ns(),
                trace_id] + [0] * N_STAGES

    def adopt(self, aid: str, ctx: Optional[list],
              trace_id: Optional[str] = None) -> None:
        """Register the context under its activation id (the id is minted
        after the first stamps: api_accept/entitle/throttle land on the
        un-adopted ctx)."""
        if ctx is None or not self.enabled:
            return
        if trace_id is not None:
            ctx[_CTX_TRACE] = trace_id
        if len(self._active) >= self.config.max_active:
            # insertion-ordered dict: the first key is the oldest context
            try:
                self._active.pop(next(iter(self._active)))
                self.evicted_active += 1
            except (StopIteration, KeyError):
                pass
        self._active[aid] = ctx

    def begin(self, aid: str, t0_ns: Optional[int] = None,
              trace_id: Optional[str] = None) -> Optional[list]:
        """open() + adopt() for callers that already know the id."""
        ctx = self.open(t0_ns=t0_ns, trace_id=trace_id)
        self.adopt(aid, ctx)
        return ctx

    @staticmethod
    def stamp_ctx(ctx: Optional[list], stage: int,
                  now_ns: Optional[int] = None) -> None:
        """Stamp a stage on an un-adopted context (first write wins)."""
        if ctx is not None and ctx[_CTX_BASE + stage] == 0:
            ctx[_CTX_BASE + stage] = (now_ns if now_ns is not None
                                      else time.monotonic_ns())

    def stamp(self, aid: str, stage: int,
              now_ns: Optional[int] = None) -> None:
        """Stamp a stage for an in-flight activation; silently ignores ids
        this process is not tracking (cross-process bus peers, finished or
        disabled activations) — that silence IS the off-switch."""
        ctx = self._active.get(aid)
        if ctx is not None and ctx[_CTX_BASE + stage] == 0:
            ctx[_CTX_BASE + stage] = (now_ns if now_ns is not None
                                      else time.monotonic_ns())

    def stamp_many(self, aids, stage: int,
                   now_ns: Optional[int] = None) -> None:
        """One shared timestamp for a whole micro-batch (the TPU balancer's
        assemble/dispatch/readback edges are batch events)."""
        if not self.enabled:
            return
        now = now_ns if now_ns is not None else time.monotonic_ns()
        slot = _CTX_BASE + stage
        active = self._active
        for aid in aids:
            ctx = active.get(aid)
            if ctx is not None and ctx[slot] == 0:
                ctx[slot] = now

    def discard(self, aid: str) -> None:
        """Forget an activation that will never complete (publish failure,
        throttle rejection) without polluting the histograms."""
        self._active.pop(aid, None)

    def ctx_of(self, aid: str) -> Optional[list]:
        return self._active.get(aid)

    @property
    def active(self) -> int:
        return len(self._active)

    # -- finish: fold one activation into the aggregates -------------------
    def _compute_row(self, aid: str, ctx: list) -> Optional[dict]:
        """The lock-free half of finish(): stage deltas + the row dict."""
        t0 = ctx[_CTX_T0]
        deltas_us = [0] * N_STAGES
        stamped = 0
        clamped = 0
        prev = t0
        for i in range(N_STAGES):
            s = ctx[_CTX_BASE + i]
            if s == 0:
                deltas_us[i] = -1  # absent
                continue
            stamped += 1
            # clamp: record_write may stamp before completion_ack (the
            # ack-vs-store race) — its delta reads 0, never negative.
            # Any OTHER out-of-order pair is counted: the pipeline stages
            # are causally ordered, so a clamp there is an
            # instrumentation bug the soak test asserts against.
            if s < prev and i != STAGE_RECORD_WRITE:
                clamped += 1
            deltas_us[i] = max(0, (s - prev) // 1000)
            prev = max(prev, s)
        if stamped == 0:
            return None
        total_us = max(0, (prev - t0) // 1000)
        return {
            "activation_id": aid,
            "trace_id": ctx[_CTX_TRACE],
            "ts": time.time(),
            "total_us": total_us,
            "deltas_us": deltas_us,
            "clamped": clamped,
        }

    def _fold_locked(self, row: dict) -> None:
        """Fold one computed row into the aggregates (self._lock held)."""
        nb = self.n_buckets
        deltas_us = row["deltas_us"]
        total_us = row["total_us"]
        dom, dom_delta = -1, -1
        for i in range(N_STAGES):
            d = deltas_us[i]
            if d < 0:
                continue
            self._hist[i][bucket_of_us(d, nb)] += 1
            self._sum_us[i] += d
            self._stage_count[i] += 1
            if d > dom_delta:
                dom, dom_delta = i, d
        tb = bucket_of_us(total_us, nb)
        self._total_hist[tb] += 1
        self._total_sum_us += total_us
        if dom >= 0:
            self._dominant[dom] += 1
            if tb >= self._tail_bucket:
                self._dominant_tail[dom] += 1
        self._finished += 1
        if self._finished % _TAIL_REFRESH == 0:
            self._tail_bucket = self._pctl_bucket(self._total_hist, 0.99)
        self._ring.append(row)
        self._note_slow(total_us, row)

    def finish(self, aid: str) -> Optional[dict]:
        """Fold the stage vector into the histograms and file the row.
        Called when the completion ack lands (the last causally-ordered
        stage); a record_write stamped later finds nothing and no-ops."""
        ctx = self._active.pop(aid, None)
        if ctx is None:
            return None
        row = self._compute_row(aid, ctx)
        if row is None:
            return None
        with self._lock:
            self._fold_locked(row)
        return row

    def finish_many(self, aids, rows_out: Optional[list] = None) -> int:
        """The batch-shaped completion path's fold: N finishes under ONE
        lock acquisition (the per-ack lock round trip was real work at
        thousands of completions/s). Semantically identical to calling
        finish() per id; returns how many rows folded. `rows_out` collects
        the computed rows for the caller — the trace store's completion
        verdict reads them without recomputing the vectors."""
        rows = []
        pop = self._active.pop
        for aid in aids:
            ctx = pop(aid, None)
            if ctx is not None:
                row = self._compute_row(aid, ctx)
                if row is not None:
                    rows.append(row)
        if rows_out is not None:
            rows_out.extend(rows)
        if not rows:
            return 0
        with self._lock:
            for row in rows:
                self._fold_locked(row)
        return len(rows)

    def _note_slow(self, total_us: int, row: dict) -> None:
        sl = self._slowest
        cap = self.config.exemplars
        if cap <= 0:  # exemplars disabled by config
            return
        if len(sl) < cap or total_us > sl[0][0]:
            import bisect
            self._slow_seq += 1
            bisect.insort(sl, (total_us, self._slow_seq, row))
            if len(sl) > self.config.exemplars:
                sl.pop(0)

    # -- read side ---------------------------------------------------------
    def tail_threshold_ms(self) -> Optional[float]:
        """The live tail threshold for the trace store's `slow` verdict:
        the upper bound of the host-side p99 bucket, already
        refreshed every `_TAIL_REFRESH` finishes by the fold — reading it
        is one GIL-atomic attribute load, no lock, no scan. None while
        the series is empty or the p99 sits in the overflow bucket (the
        caller falls back to the SLO e2e target)."""
        tb = self._tail_bucket
        bounds = bucket_bounds_ms(self.n_buckets)
        if self._finished == 0 or tb >= len(bounds):
            return None
        return bounds[tb]

    @staticmethod
    def _pctl_bucket(counts: List[int], q: float) -> int:
        total = sum(counts)
        if total == 0:
            return len(counts) - 1
        target = max(1, math.ceil(q * total))
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target:
                return i
        return len(counts) - 1

    def _pctl_ms(self, counts: List[int], q: float) -> Optional[float]:
        """Upper bound (ms) of the bucket holding the q-quantile; None for
        an empty series or a quantile in the overflow bucket."""
        if not sum(counts):
            return None
        b = self._pctl_bucket(counts, q)
        bounds = bucket_bounds_ms(self.n_buckets)
        return bounds[b] if b < len(bounds) else None

    def stage_report(self) -> List[dict]:
        with self._lock:
            hist = [list(h) for h in self._hist]
            sums = list(self._sum_us)
            counts = list(self._stage_count)
        out = []
        for i, name in enumerate(STAGES):
            n = int(counts[i])
            out.append({
                "stage": name,
                "count": n,
                "mean_ms": round(float(sums[i]) / n / 1000.0, 3) if n else None,
                "p50_ms": self._pctl_ms(hist[i], 0.50),
                "p90_ms": self._pctl_ms(hist[i], 0.90),
                "p99_ms": self._pctl_ms(hist[i], 0.99),
            })
        return out

    def budget(self) -> dict:
        """The tail budget: per-stage medians vs the measured e2e median.
        Computed from the EXACT deltas of the last `ring` completed rows
        (not the log2 histograms — bucket upper-bound rounding could
        overstate a 13-term sum by up to 2x): per-activation deltas
        telescope to exactly (last stamp - t0), so on steady traffic the
        stage medians sum to ~the e2e median with no unaccounted gap."""
        with self._lock:
            rows = self._ring.last(self._ring.size)
        if not rows:
            return {"stage_medians_ms": {}, "stage_median_sum_ms": 0.0,
                    "e2e_p50_ms": None, "e2e_p99_ms": None,
                    "e2e_mean_ms": None, "count": 0, "window": 0,
                    "coverage_ratio": None}

        def pctl(xs: list, q: float) -> float:
            return xs[min(len(xs) - 1, int(q * len(xs)))]

        medians = {}
        for i, name in enumerate(STAGES):
            vals = sorted(r["deltas_us"][i] for r in rows
                          if r["deltas_us"][i] >= 0)
            if vals:
                medians[name] = round(pctl(vals, 0.50) / 1000.0, 3)
        budget_sum = sum(medians.values())

        # band decomposition: average the stage deltas of the activations
        # AROUND a quantile of the total. Per activation the deltas
        # telescope to exactly the total (absent stages contribute 0 and
        # their time is absorbed by the next present stage's delta), so
        # band sums match the band's e2e by construction — unlike raw
        # per-stage medians, which need not add up (stage durations are
        # not independent: a long queue wait pairs with a short assemble)
        by_total = sorted(rows, key=lambda r: r["total_us"])
        n = len(by_total)

        def band(sel: list) -> tuple:
            """(per-stage mean deltas, mean e2e) over the band's rows —
            per activation the deltas telescope to the total, so the
            stage sums match the band's own e2e up to clamp/rounding."""
            acc = [0] * N_STAGES
            tot = 0
            for r in sel:
                tot += r["total_us"]
                for i, d in enumerate(r["deltas_us"]):
                    if d > 0:
                        acc[i] += d
            return ({STAGES[i]: round(acc[i] / len(sel) / 1000.0, 3)
                     for i in range(N_STAGES) if acc[i]},
                    tot / len(sel) / 1000.0)

        mid = min(n - 1, n // 2)
        k = max(1, n // 20)
        p50_decomp, p50_band_e2e = band(
            by_total[max(0, mid - k): mid + k + 1])
        p99_decomp, p99_band_e2e = band(
            by_total[min(n - 1, int(0.99 * n)):])
        totals = sorted(r["total_us"] for r in rows)
        e2e_p50 = pctl(totals, 0.50) / 1000.0
        decomp_sum = sum(p50_decomp.values())
        return {
            "stage_medians_ms": medians,
            "stage_median_sum_ms": round(budget_sum, 3),
            #: where the MEDIAN-band activation's time goes
            "p50_decomposition_ms": p50_decomp,
            "p50_decomposition_sum_ms": round(decomp_sum, 3),
            "p50_band_e2e_ms": round(p50_band_e2e, 3),
            #: where the p99 tail's time goes (the stage to attack)
            "p99_decomposition_ms": p99_decomp,
            "p99_decomposition_sum_ms": round(sum(p99_decomp.values()), 3),
            "p99_band_e2e_ms": round(p99_band_e2e, 3),
            "e2e_p50_ms": round(e2e_p50, 3),
            "e2e_p99_ms": round(pctl(totals, 0.99) / 1000.0, 3),
            "e2e_mean_ms": round(sum(totals) / len(totals) / 1000.0, 3),
            "count": len(totals),
            "window": len(rows),
            #: the accounting check ("no unaccounted gap"): the band's
            #: stage sums vs the SAME band's e2e — deviates from 1 only
            #: through clamping (out-of-order stamps) or rounding, never
            #: through sampling skew. External comparisons (stage budget
            #: vs a generator's independently measured e2e) live with the
            #: measurement, e.g. tools/loadgen.py's budget_vs_measured_p50.
            "coverage_ratio": (round(decomp_sum / p50_band_e2e, 3)
                               if p50_band_e2e else None),
        }

    def tail_attribution(self) -> dict:
        with self._lock:
            dom = list(self._dominant)
            tail = list(self._dominant_tail)
            tb = self._tail_bucket
        bounds = bucket_bounds_ms(self.n_buckets)
        return {
            "tail_threshold_ms": bounds[tb] if tb < len(bounds) else None,
            "dominant": {STAGES[i]: int(dom[i])
                         for i in range(N_STAGES) if dom[i]},
            "dominant_tail": {STAGES[i]: int(tail[i])
                              for i in range(N_STAGES) if tail[i]},
        }

    def _row_json(self, row: dict) -> dict:
        out = {
            "activation_id": row["activation_id"],
            "trace_id": row["trace_id"],
            "ts": row["ts"],
            "total_ms": round(row["total_us"] / 1000.0, 3),
            "stages_ms": {STAGES[i]: round(d / 1000.0, 3)
                          for i, d in enumerate(row["deltas_us"]) if d >= 0},
            "clamped": row.get("clamped", 0),
        }
        # federation annotations: a merged fleet report marks
        # rows joined across a spill_forward boundary with both halves'
        # provenance — plain per-process rows never carry these keys
        for k in ("joined", "origin_instance", "peer_instance", "instance"):
            if k in row:
                out[k] = row[k]
        return out

    def slowest(self) -> List[dict]:
        with self._lock:
            rows = [r for _, _, r in reversed(self._slowest)]
        return [self._row_json(r) for r in rows]

    def recent(self, n: int = 20) -> List[dict]:
        with self._lock:
            rows = self._ring.last(n)
        return [self._row_json(r) for r in rows]

    def report(self, recent: int = 0) -> dict:
        """The `GET /admin/latency/waterfall` payload. Host-side numpy
        only — never a device sync, so it runs inline on the event loop."""
        if not self.enabled:
            # no identity on the disabled snapshot: the off-switch keeps
            # the payload byte-identical to pre-federation builds, and the
            # fleet mergers drop disabled members before keying anyway
            return {"enabled": False}
        out = {
            "enabled": True,
            # the federation's merge key: which process this
            # snapshot came from
            "identity": identity(),
            "stages": list(STAGES),
            "finished": self._finished,
            "active": len(self._active),
            "evicted_active": self.evicted_active,
            "buckets_le_ms": bucket_bounds_ms(self.n_buckets),
            "per_stage": self.stage_report(),
            "budget": self.budget(),
            "tail": self.tail_attribution(),
            "slowest": self.slowest(),
        }
        if recent:
            out["recent"] = self.recent(recent)
        return out

    def raw_counts(self, rows: int = 0) -> dict:
        """The exact-merge export behind `?raw=1`: integer
        bucket counts and sums, NOT percentiles — percentiles do not
        compose across processes, bucket counts merge bucket-wise
        bit-exactly. `rows` > 0 additionally ships the most recent ring
        rows (raw deltas_us), which the fleet merger needs to join a
        spilled activation's origin/peer halves by activation id."""
        with self._lock:
            out = {
                "identity": identity(),
                "enabled": self.enabled,
                "buckets": self.n_buckets,
                "stages": list(STAGES),
                "hist": [list(h) for h in self._hist],
                "sum_us": list(self._sum_us),
                "stage_count": list(self._stage_count),
                "total_hist": list(self._total_hist),
                "total_sum_us": int(self._total_sum_us),
                "dominant": list(self._dominant),
                "dominant_tail": list(self._dominant_tail),
                "finished": int(self._finished),
                "rows": ([dict(r) for r in self._ring.last(rows)]
                         if rows else []),
            }
        return out

    # -- exposition --------------------------------------------------------
    def prometheus_text(self, openmetrics: bool = False) -> str:
        """`openwhisk_activation_stage_duration_seconds{stage=...}` as a
        real cumulative-`le` histogram family plus the dominant-stage
        counter (rendering shared with the telemetry plane)."""
        if not self.enabled:
            return ""
        from ..controller.monitoring import (counter_family_text,
                                             histogram_family_text)
        with self._lock:
            hist = [list(h) for h in self._hist]
            sums = list(self._sum_us)
            dom = list(self._dominant)
            tail = list(self._dominant_tail)
        bounds = bucket_bounds_ms(self.n_buckets)
        rows = [(STAGES[i], hist[i], sums[i] / 1000.0)
                for i in range(N_STAGES) if sum(hist[i])]
        out = histogram_family_text(
            "openwhisk_activation_stage_duration_seconds", "stage",
            rows, bounds)
        out += counter_family_text(
            "openwhisk_activation_dominant_stage_total",
            [({"stage": STAGES[i], "scope": scope}, int(arr[i]))
             for scope, arr in (("all", dom), ("tail", tail))
             for i in range(N_STAGES) if arr[i]],
            openmetrics=openmetrics)
        return "\n".join(out)


#: the process-wide plane every layer stamps into (same pattern as
#: GLOBAL_TRACER): the API handler, entitlement, messaging producers,
#: invoker, container pool and record batcher have no balancer reference —
#: the balancer hook (CommonLoadBalancer) owns rendering and admin reads
GLOBAL_WATERFALL = ActivationWaterfall.from_config()
