"""User-events monitoring service and the fleet federation merges.

A copy of `openwhisk_tpu/controller/monitoring.py` (rebuild of
core/monitoring/user-events: OpenWhiskEvents.start :34-66,
EventConsumer.scala, PrometheusRecorder.scala): consume the `events` topic
and translate Activation/Metric event bodies into Prometheus series —
per-action activation counts, status-code counts, duration/waitTime/initTime
sums, cold-start counts, and namespace-level throttle counters. Runs either
embedded in a controller or as its own process
(`python -m openwhisk_tpu_torch.controller.monitoring --bus ...`).

It also holds the Prometheus exposition helpers the planes render through
and the fleet observatory's merge math (`metrics_raw`, the `merged_*`
reports, `join_spill_rows`, `merged_timeline`, `PHASE_MARKS` and
`reconstruct_phases`, which splits a failover's downtime into its phases
from the merged event timeline).
"""
from __future__ import annotations

import asyncio
import math
from typing import Optional

from ..messaging.connector import MessageFeed
from ..messaging.message import EventMessage
from ..utils.logging import MetricEmitter, _prom_label_value
from ..utils.tasks import wait_for_shutdown

EVENTS_TOPIC = "events"


# -- Prometheus exposition of accumulated counts ---------------------------
# The balancer telemetry plane (loadbalancer/telemetry.py) accumulates
# latency bucket counts on device / in numpy; THESE helpers own how they
# render as real Prometheus `histogram` families (cumulative `le` buckets,
# `_sum`/`_count`) and counter families on the controller's /metrics page
# (MetricEmitter renderer hook). Bounds arrive in ms; the wire format is
# seconds, per Prometheus base-unit conventions.

def _labels(d: dict) -> str:
    return ",".join(f'{k}="{_prom_label_value(v)}"'
                    for k, v in sorted(d.items()))


def histogram_family_text(family: str, label_name: str, rows,
                          bounds_ms, exemplars=None) -> list:
    """Render one histogram family. `rows` yields (label_value,
    per-bucket counts [B], latency_sum_ms); counts are PER-bucket — the
    cumulative `le` semantics happen here, and the last (overflow) bucket
    becomes `+Inf`, equal to `_count` as the format requires.

    `exemplars` (OpenMetrics scrapes only — the classic text format has no
    exemplar syntax) maps label_value -> {bucket_index: (exemplar_labels,
    value_ms, unix_ts)}; the matching bucket line gets the
    `# {trace_id="..."} <seconds> <ts>` suffix that links the histogram
    back to a trace."""
    rows = list(rows)
    if not rows:
        return []
    out = [f"# TYPE {family} histogram"]
    les = [f"{b / 1000.0:g}" for b in bounds_ms] + ["+Inf"]
    for value, counts, sum_ms in rows:
        lbl = _labels({label_name: value})
        row_ex = (exemplars or {}).get(value) or {}
        cum = 0
        for i, (le, cnt) in enumerate(zip(les, counts)):
            cum += int(cnt)
            line = f'{family}_bucket{{{lbl},le="{le}"}} {cum}'
            ex = row_ex.get(i)
            if ex is not None:
                ex_labels, ex_ms, ex_ts = ex
                line += (f" # {{{_labels(ex_labels)}}} "
                         f"{float(ex_ms) / 1000.0:g} {float(ex_ts):.3f}")
            out.append(line)
        out.append(f"{family}_sum{{{lbl}}} {float(sum_ms) / 1000.0:g}")
        out.append(f"{family}_count{{{lbl}}} {cum}")
    return out


def counter_family_text(family: str, rows, openmetrics: bool = False) -> list:
    """Render one counter family from (label_dict, value) pairs.

    OpenMetrics names counter families WITHOUT the `_total` suffix and
    requires every sample to carry it (`# TYPE x counter` + `x_total{...}`);
    the classic text format types the full sample name. Getting this wrong
    on a negotiated OM scrape aborts the whole page in Prometheus's OM
    parser — exemplar scraping would lose all metrics instead of adding
    trace links."""
    rows = list(rows)
    if not rows:
        return []
    base = family[:-len("_total")] if family.endswith("_total") else family
    sample = base + "_total" if openmetrics else family
    out = [f"# TYPE {base if openmetrics else family} counter"]
    for labels, value in rows:
        out.append(f"{sample}{{{_labels(labels)}}} {value}")
    return out


def gauge_family_text(family: str, rows) -> list:
    """Render one gauge family from (label_dict, value) pairs (the anomaly
    plane's score/firing families render through this)."""
    rows = list(rows)
    if not rows:
        return []
    out = [f"# TYPE {family} gauge"]
    for labels, value in rows:
        out.append(f"{family}{{{_labels(labels)}}} {value}")
    return out


# -- Fleet federation merge math -------------------------------------------
# Pure functions over the `raw_counts()` exports of the per-process
# observability planes (waterfall, telemetry/SLO, host observatory,
# MetricEmitter). The federation endpoints in controller/fleet.py scrape
# one raw export per live peer and fold them HERE; everything below is
# deterministic integer math, unit-testable without any process pair.
#
# The merge invariant the property tests pin: per-process log2 bucket
# counts summed bucket-wise equal the histogram of the pooled samples —
# bucketing is per-sample and bucket-wise integer addition is exact, so
# merged percentiles are judged with exactly single-process math over
# the merged counts. Percentiles themselves NEVER merge (a p99 of p99s
# is meaningless); only counts and sums cross process boundaries.

def _members_of(raws) -> list:
    """Provenance block: one identity per merged member, scrape order."""
    return [r.get("identity") or {} for r in raws]


def _sum_into(acc: list, add) -> None:
    for i, v in enumerate(add):
        acc[i] += int(v)


def _pctl_from_hist(hist, q: float) -> int:
    """Index of the bucket holding the q-quantile (cumulative walk over
    merged integer counts — same math as the per-process planes)."""
    total = sum(int(v) for v in hist)
    if not total:
        return 0
    target = max(1, math.ceil(q * total))
    cum = 0
    for i, v in enumerate(hist):
        cum += int(v)
        if cum >= target:
            return i
    return len(hist) - 1


def metrics_raw(snapshot: dict, ident: Optional[dict] = None) -> dict:
    """Serialize a MetricEmitter snapshot() for the federation wire:
    tuple series keys `(name, ((k, v), ...))` become `[name, [[k, v],
    ...], value]` rows (JSON has no tuple keys). The merge side
    (merge_serialized_counters / merged_metrics) consumes exactly this
    shape."""
    def rows(d: dict) -> list:
        return [[name, [list(kv) for kv in tags], value]
                for (name, tags), value in sorted(d.items())]

    return {
        "identity": ident or {},
        "counters": rows(snapshot.get("counters") or {}),
        "gauges": rows(snapshot.get("gauges") or {}),
        "histograms": rows(snapshot.get("histograms") or {}),
    }


def merge_serialized_counters(raws, field: str = "counters") -> list:
    """Sum MetricEmitter counter rows `[name, [[k, v], ...], value]` by
    (name, sorted-tag) series key across members. Returns sorted rows in
    the same wire shape."""
    acc: dict = {}
    for r in raws:
        for name, tags, value in r.get(field) or []:
            key = (str(name), tuple((str(k), str(v)) for k, v in tags))
            acc[key] = acc.get(key, 0) + int(value)
    return [[name, [list(kv) for kv in tags], value]
            for (name, tags), value in sorted(acc.items())]


def merged_metrics(raws) -> dict:
    """`GET /admin/fleet/metrics` body: counters sum; histogram lifetime
    count/sum merge exactly; gauges stay per-member (a fleet sum of a
    utilization gauge is a lie). Windowed percentiles are dropped — they
    do not compose."""
    hist: dict = {}
    for r in raws:
        for name, tags, h in r.get("histograms") or []:
            key = (str(name), tuple((str(k), str(v)) for k, v in tags))
            slot = hist.setdefault(key, {"count": 0, "sum": 0.0})
            slot["count"] += int(h.get("count", 0))
            slot["sum"] += float(h.get("sum", 0.0))
    return {
        "members": _members_of(raws),
        "counters": merge_serialized_counters(raws),
        "histograms": [[name, [list(kv) for kv in tags],
                        {"count": h["count"], "sum": round(h["sum"], 6)}]
                       for (name, tags), h in sorted(hist.items())],
        "gauges_by_member": [
            {"identity": r.get("identity") or {},
             "gauges": r.get("gauges") or []} for r in raws],
    }


def join_spill_rows(rows: list) -> list:
    """Join a spilled activation's origin/peer ring-row halves into one
    telescoping row. The origin half carries a terminal `spill_forward`
    delta (>= 0: hand-off to the `ctrlspill` frame was its LAST stamped
    stage); the peer half resumes at the stages after it. Merged row:
    origin deltas up to and including spill_forward, peer deltas beyond
    (whichever half stamped a stage wins when only one did), total = sum
    of present deltas — the telescoping invariant survives the join
    because the halves partition the stage axis at the boundary."""
    from ..utils.waterfall import N_STAGES, STAGE_SPILL_FORWARD

    by_aid: dict = {}
    for row in rows:
        by_aid.setdefault(row.get("activation_id"), []).append(row)
    out = []
    for aid, halves in by_aid.items():
        if aid is None or len(halves) < 2:
            out.extend(halves)
            continue
        origin = next((h for h in halves
                       if (h.get("deltas_us") or [-1])[STAGE_SPILL_FORWARD]
                       >= 0), None)
        peer = next((h for h in halves if h is not origin), None)
        if origin is None or peer is None:
            out.extend(halves)
            continue
        deltas = []
        for i in range(N_STAGES):
            o = origin["deltas_us"][i] if i < len(origin["deltas_us"]) else -1
            p = peer["deltas_us"][i] if i < len(peer["deltas_us"]) else -1
            if i <= STAGE_SPILL_FORWARD:
                deltas.append(o if o >= 0 else p)
            else:
                deltas.append(p if p >= 0 else o)
        joined = {
            "activation_id": aid,
            # the origin minted the trace context; the peer inherited it
            "trace_id": origin.get("trace_id") or peer.get("trace_id"),
            "ts": origin.get("ts", peer.get("ts")),
            "total_us": sum(d for d in deltas if d > 0),
            "deltas_us": deltas,
            "clamped": max(origin.get("clamped", 0), peer.get("clamped", 0)),
            "joined": True,
            "origin_instance": (origin.get("instance") or {}).get("instance")
            if isinstance(origin.get("instance"), dict)
            else origin.get("instance"),
            "peer_instance": (peer.get("instance") or {}).get("instance")
            if isinstance(peer.get("instance"), dict)
            else peer.get("instance"),
        }
        out.append(joined)
    out.sort(key=lambda r: r.get("ts") or 0.0)
    return out


def merged_waterfall_report(raws, recent: int = 0) -> dict:
    """`GET /admin/fleet/waterfall` body: sum the per-stage and total
    histograms bucket-wise, join spill rows, then render through a fresh
    ActivationWaterfall so budget/tail/exposition logic stays single-
    sourced. Members whose bucket count differs from the first member's
    cannot merge exactly and are skipped (labeled, never silently
    pooled)."""
    from ..utils.waterfall import (ActivationWaterfall, N_STAGES,
                                   WaterfallConfig)

    raws = [r for r in raws if r.get("enabled")]
    if not raws:
        return {"enabled": False, "members": []}
    nb = int(raws[0]["buckets"])
    usable = [r for r in raws if int(r["buckets"]) == nb]
    skipped = [r for r in raws if int(r["buckets"]) != nb]

    rows = []
    for r in usable:
        inst = (r.get("identity") or {}).get("instance")
        for row in r.get("rows") or []:
            row = dict(row)
            row.setdefault("instance", inst)
            rows.append(row)
    rows = join_spill_rows(rows)

    wf = ActivationWaterfall(WaterfallConfig(
        enabled=True, buckets=nb, ring=max(8, len(rows) or 8)))
    for r in usable:
        for i in range(N_STAGES):
            _sum_into(wf._hist[i], r["hist"][i])
        _sum_into(wf._sum_us, r["sum_us"])
        _sum_into(wf._stage_count, r["stage_count"])
        _sum_into(wf._total_hist, r["total_hist"])
        wf._total_sum_us += int(r["total_sum_us"])
        _sum_into(wf._dominant, r["dominant"])
        _sum_into(wf._dominant_tail, r["dominant_tail"])
        wf._finished += int(r["finished"])
    if wf._finished:
        wf._tail_bucket = wf._pctl_bucket(wf._total_hist, 0.99)
    for row in rows:
        wf._ring.append(row)
        wf._note_slow(int(row.get("total_us", 0)), row)

    out = wf.report(recent=recent)
    out["identity"] = {"role": "fleet", "members": len(usable)}
    out["members"] = _members_of(usable)
    if skipped:
        out["members_skipped"] = _members_of(skipped)
    out["joined_rows"] = sum(1 for r in rows if r.get("joined"))
    return out


def merged_slo_report(raws) -> dict:
    """`GET /admin/fleet/slo` body: per-namespace and per-invoker bucket/
    outcome counts merge by LABEL (slot indexes are first-come-first-
    served per process — slot-wise merging would pool different tenants),
    then the verdict math re-judges the MERGED counts via the same
    judge_scope the per-process plane uses."""
    import numpy as np

    from ..ops.telemetry import N_OUTCOMES, bucket_bounds_ms
    from .loadbalancer.telemetry import judge_scope

    raws = [r for r in raws if r.get("enabled")]
    if not raws:
        return {"enabled": False, "members": []}
    nb = int(raws[0]["buckets"])
    usable = [r for r in raws if int(r["buckets"]) == nb]
    skipped = [r for r in raws if int(r["buckets"]) != nb]
    bounds = bucket_bounds_ms(nb)
    targets = dict(raws[0].get("targets") or {})
    overrides = dict(raws[0].get("overrides") or {})

    def fold(field: str) -> dict:
        acc: dict = {}
        for r in usable:
            for label, row in (r.get(field) or {}).items():
                slot = acc.setdefault(label, {
                    "buckets": [0] * nb,
                    "outcomes": [0] * len(row["outcomes"]),
                })
                _sum_into(slot["buckets"], row["buckets"])
                _sum_into(slot["outcomes"], row["outcomes"])
        return acc

    namespaces = fold("namespaces")
    invokers = fold("invokers")

    p99_t = float(targets.get("e2e_p99_ms", 1000.0))
    err_t = float(targets.get("error_ratio", 0.01))

    def judged(acc: dict, with_overrides: bool) -> dict:
        out = {}
        for label, slot in sorted(acc.items()):
            ov = (overrides.get(label, {}) or {}) if with_overrides else {}
            out[label] = judge_scope(
                np.asarray(slot["buckets"], dtype=np.int64),
                np.asarray(slot["outcomes"], dtype=np.int64),
                bounds,
                float(ov.get("e2e_p99_ms", p99_t)),
                float(ov.get("error_ratio", err_t)))
        return out

    g_buckets = np.zeros(nb, dtype=np.int64)
    g_outcomes = None
    for slot in namespaces.values():
        g_buckets += np.asarray(slot["buckets"], dtype=np.int64)
        o = np.asarray(slot["outcomes"], dtype=np.int64)
        g_outcomes = o if g_outcomes is None else g_outcomes + o
    if g_outcomes is None:
        g_outcomes = np.zeros(N_OUTCOMES, dtype=np.int64)

    return {
        "enabled": True,
        "members": _members_of(usable),
        **({"members_skipped": _members_of(skipped)} if skipped else {}),
        "targets": targets,
        "buckets_le_ms": bounds,
        "dropped_events": sum(int(r.get("dropped_events", 0))
                              for r in usable),
        "global": judge_scope(g_buckets, g_outcomes, bounds, p99_t, err_t),
        "namespaces": judged(namespaces, with_overrides=True),
        "invokers": judged(invokers, with_overrides=False),
    }


def merged_quality_report(raws) -> dict:
    """`GET /admin/fleet/quality` body: regret histograms and attribution
    counters sum positionally (bit-exact integer merge, same bucket grid
    as the SLO plane), per-invoker regret/divergence series merge by
    LABEL, then the fleet regret p99 re-derives from the MERGED histogram
    — a fleet-level percentile from counts, never an average of
    per-member p99s. Imbalance is a per-member shape statistic (CoV of
    occupancy over that member's partition), so it stays per-member."""
    from ..ops.telemetry import bucket_bounds_ms

    raws = [r for r in raws if r.get("enabled")]
    if not raws:
        return {"enabled": False, "members": []}
    nb = int(raws[0]["buckets"])
    usable = [r for r in raws if int(r["buckets"]) == nb]
    skipped = [r for r in raws if int(r["buckets"]) != nb]
    bounds = bucket_bounds_ms(nb)

    hist = [0] * nb
    counter_names = list(raws[0].get("counter_names") or [])
    counters = [0] * len(counter_names)
    invokers: dict = {}
    scalars = {"batches": 0, "shadow_batches": 0, "divergent_rows": 0,
               "shadow_rows": 0}
    regret_sum_ms = 0.0
    imbalance = []
    for r in usable:
        _sum_into(hist, (r.get("regret_hist") or [])[:nb])
        _sum_into(counters, (r.get("counters") or [])[:len(counters)])
        for name, row in (r.get("invokers") or {}).items():
            slot = invokers.setdefault(name, {"regret_ms": 0.0,
                                              "divergent_rows": 0})
            slot["regret_ms"] += float(row.get("regret_ms", 0.0))
            slot["divergent_rows"] += int(row.get("divergence", 0))
        for k in scalars:
            scalars[k] += int(r.get(k, 0))
        regret_sum_ms += float(r.get("regret_sum_ms", 0.0))
        imbalance.append({
            "identity": r.get("identity") or {},
            "fleet_imbalance_cov": round(
                float(r.get("fleet_imbalance_cov", 0.0)), 6),
        })

    bi = _pctl_from_hist(hist, 0.99)
    return {
        "enabled": True,
        "members": _members_of(usable),
        **({"members_skipped": _members_of(skipped)} if skipped else {}),
        "buckets_le_ms": bounds,
        "regret_hist": hist,
        "regret_p99_le_ms": ((bounds[bi] if bi < len(bounds) else None)
                             if sum(hist) else None),  # None: +Inf/empty
        "regret_sum_ms": round(regret_sum_ms, 3),
        **scalars,
        "divergence_ratio": round(
            scalars["divergent_rows"] / max(1, scalars["shadow_rows"]), 6),
        "counters": {name: counters[i]
                     for i, name in enumerate(counter_names)},
        "invokers": [
            {"invoker": name,
             "regret_ms": round(slot["regret_ms"], 3),
             "divergent_rows": slot["divergent_rows"]}
            for name, slot in sorted(invokers.items())],
        "imbalance_by_member": imbalance,
    }


def merged_host_report(raws) -> dict:
    """`GET /admin/fleet/host` body: loop-lag/gc histograms sum bucket-
    wise, stall/task/serde counters sum, percentiles re-derive from the
    merged counts via the same bucket-bound walk the per-process
    snapshot uses."""
    from ..utils.waterfall import bucket_bounds_ms as log2_bounds_ms

    raws = [r for r in raws if r.get("enabled")]
    if not raws:
        return {"enabled": False, "members": []}
    nb = int(raws[0]["buckets"])
    usable = [r for r in raws if int(r["buckets"]) == nb]
    skipped = [r for r in raws if int(r["buckets"]) != nb]
    bounds = log2_bounds_ms(nb)

    lag_hist = [0] * nb
    lag_sum = lag_max = lag_ticks = 0
    stalls = {"count": 0, "sum_us": 0}
    n_gens = max(len(r["gc"]["hist"]) for r in usable)
    gc_hist = [[0] * nb for _ in range(n_gens)]
    gc_sum = [0] * n_gens
    gc_count = [0] * n_gens
    gc_misc = {"collected": 0, "uncollectable": 0, "overlapping_dispatch": 0}
    tasks = {"created": 0, "finished": 0}
    serde: dict = {}
    for r in usable:
        _sum_into(lag_hist, r["lag"]["hist"])
        lag_sum += int(r["lag"]["sum_us"])
        lag_max = max(lag_max, int(r["lag"]["max_us"]))
        lag_ticks += int(r["lag"]["ticks"])
        stalls["count"] += int(r["stalls"]["count"])
        stalls["sum_us"] += int(r["stalls"]["sum_us"])
        for g, h in enumerate(r["gc"]["hist"]):
            _sum_into(gc_hist[g], h)
            gc_sum[g] += int(r["gc"]["sum_us"][g])
            gc_count[g] += int(r["gc"]["count"][g])
        for k in gc_misc:
            gc_misc[k] += int(r["gc"].get(k, 0))
        tasks["created"] += int(r["tasks"]["created"])
        tasks["finished"] += int(r["tasks"]["finished"])
        for hop, direction, count, nbytes, wall_ns in r.get("serde") or []:
            row = serde.setdefault((hop, direction), [0, 0, 0])
            row[0] += int(count)
            row[1] += int(nbytes)
            row[2] += int(wall_ns)

    def p_ms(hist, q):
        if not sum(hist):
            return None
        b = _pctl_from_hist(hist, q)
        return bounds[b] if b < len(bounds) else None  # None: +Inf bucket

    return {
        "enabled": True,
        "members": _members_of(usable),
        **({"members_skipped": _members_of(skipped)} if skipped else {}),
        "buckets_le_ms": bounds,
        "loop_lag": {
            "ticks": lag_ticks,
            "p50_le_ms": p_ms(lag_hist, 0.50),
            "p99_le_ms": p_ms(lag_hist, 0.99),
            "max_ms": round(lag_max / 1000.0, 3),
            "mean_ms": round(lag_sum / 1000.0 / lag_ticks, 3)
            if lag_ticks else None,
            "hist": lag_hist,
        },
        "stalls": {"count": stalls["count"],
                   "total_ms": round(stalls["sum_us"] / 1000.0, 3)},
        "gc": {
            "pauses": sum(gc_count),
            "pause_ms": round(sum(gc_sum) / 1000.0, 3),
            "p99_le_ms": p_ms([sum(col) for col in zip(*gc_hist)], 0.99)
            if any(gc_count) else None,
            "per_generation": [
                {"generation": g, "pauses": gc_count[g],
                 "pause_ms": round(gc_sum[g] / 1000.0, 3)}
                for g in range(n_gens)],
            **gc_misc,
        },
        "tasks": {**tasks, "active": tasks["created"] - tasks["finished"]},
        "serde": [
            {"hop": hop, "direction": direction, "count": row[0],
             "bytes": row[1], "ms": round(row[2] / 1e6, 3)}
            for (hop, direction), row in sorted(serde.items())],
    }


def merged_timeline(events_by_member: dict, limit: int = 0) -> dict:
    """`GET /admin/fleet/timeline` body: fold each member's event-log
    records into one wall-clock-ordered causal timeline. Records keep
    their origin `instance` stamp; ties break on (mono, seq) so one
    member's records never interleave out of causal order."""
    merged = []
    for member, records in events_by_member.items():
        for rec in records or []:
            rec = dict(rec)
            rec.setdefault("instance", member)
            merged.append(rec)
    merged.sort(key=lambda r: (r.get("ts", 0.0), r.get("mono", 0.0),
                               r.get("seq", 0)))
    if limit and len(merged) > limit:
        merged = merged[-limit:]
    return {
        "members": sorted(events_by_member.keys(), key=str),
        "count": len(merged),
        "events": merged,
    }


#: phase boundaries of a partition-failover reconstruction, in causal
#: order: the kill mark (recorded by whoever induced the failure), the
#: survivor noticing heartbeat silence, its epoch claim over the orphaned
#: partitions, the journal absorb finishing, and the first activation the
#: new owner actually placed. Adjacent differences name the downtime's
#: phases; on one mono clock they telescope to exactly (first_placement
#: - kill).
PHASE_MARKS = (
    ("chaos_kill", None),
    ("member_silent", "detect_s"),
    ("part_claim", "claim_s"),
    ("absorb_end", "absorb_s"),
    ("first_placement", "first_placement_s"),
)


def reconstruct_phases(events, key: str = "mono") -> dict:
    """Decompose a failover's downtime into named phases from the causal
    event timeline (the partition_chaos rider attaches this). Takes the
    FIRST occurrence of each mark at or after the previous mark's stamp —
    later duplicates (second absorb, steady-state placements) belong to
    the recovered regime, not the outage."""
    marks = {}
    floor = None
    timeline = sorted(events, key=lambda r: r.get(key, 0.0))
    for kind, _ in PHASE_MARKS:
        hit = next((r for r in timeline if r.get("kind") == kind
                    and (floor is None or r.get(key, 0.0) >= floor)), None)
        if hit is None:
            continue
        marks[kind] = hit
        floor = hit.get(key, 0.0)
    phases = {}
    prev = None
    for kind, phase_name in PHASE_MARKS:
        hit = marks.get(kind)
        if hit is None:
            prev = None if phase_name is None else prev
            continue
        if phase_name is not None and prev is not None:
            phases[phase_name] = round(hit[key] - prev[key], 6)
        prev = hit
    first = marks.get(PHASE_MARKS[0][0])
    last = marks.get(PHASE_MARKS[-1][0])
    return {
        "phases": phases,
        "downtime_s": round(last[key] - first[key], 6)
        if first is not None and last is not None else None,
        "complete": len(marks) == len(PHASE_MARKS),
        "marks": {k: {"seq": m.get("seq"), "ts": m.get("ts"),
                      key: m.get(key), "instance": m.get("instance")}
                  for k, m in marks.items()},
    }


class UserEventsRecorder:
    def __init__(self, messaging_provider, metrics: Optional[MetricEmitter] = None,
                 logger=None, group: str = "user-events"):
        self.provider = messaging_provider
        self.metrics = metrics or MetricEmitter()
        self.logger = logger
        self.group = group
        self._feed: Optional[MessageFeed] = None

    def start(self) -> None:
        self.provider.ensure_topic(EVENTS_TOPIC)
        consumer = self.provider.get_consumer(EVENTS_TOPIC, self.group, max_peek=256)
        box = {}

        async def handle(payload: bytes):
            try:
                self.record(EventMessage.parse(payload))
            except (ValueError, KeyError):
                pass
            box["feed"].processed()

        self._feed = MessageFeed("user-events", consumer, 256, handle,
                                 logger=self.logger)
        box["feed"] = self._feed
        self._feed.start()

    def record(self, event: EventMessage) -> None:
        """PrometheusRecorder.scala semantics: one series FAMILY per metric,
        fanned out by Prometheus labels — `action` for activations,
        `namespace`+`metric` for throttle events (the reference's Kamon tags
        become label sets, so dashboards can `sum by (action)`)."""
        if event.event_type == "Activation":
            b = event.body
            tags = {"action": b.get("name", "unknown")}
            self.metrics.counter("userevents_activations_total", tags=tags)
            self.metrics.counter(
                "userevents_activation_status_total",
                tags={**tags, "status": str(b.get("statusCode", 0))})
            self.metrics.histogram("userevents_duration_ms",
                                   b.get("duration", 0), tags=tags)
            if b.get("waitTime"):
                self.metrics.histogram("userevents_wait_time_ms",
                                       b["waitTime"], tags=tags)
            if b.get("initTime"):
                self.metrics.histogram("userevents_init_time_ms",
                                       b["initTime"], tags=tags)
                self.metrics.counter("userevents_cold_starts_total", tags=tags)
            self.metrics.gauge("userevents_memory_mb", b.get("memory", 0),
                               tags=tags)
        elif event.event_type == "Metric":
            b = event.body
            self.metrics.counter(
                "userevents_rate_limit_total", int(b.get("metricValue", 1)),
                tags={"namespace": event.namespace,
                      "metric": b.get("metricName", "unknown")})

    def prometheus_text(self) -> str:
        return self.metrics.prometheus_text()

    async def stop(self) -> None:
        if self._feed:
            await self._feed.stop()


def main() -> None:
    import argparse

    from aiohttp import web

    from ..messaging import provider_for_bus

    parser = argparse.ArgumentParser(description="user-events monitoring")
    parser.add_argument("--bus", default="127.0.0.1:4222")
    parser.add_argument("--port", type=int, default=9096)
    args = parser.parse_args()

    async def run():
        provider = provider_for_bus(args.bus)
        recorder = UserEventsRecorder(provider)
        recorder.start()

        async def metrics_handler(request):
            return web.Response(text=recorder.prometheus_text(),
                                content_type="text/plain")

        app = web.Application()
        app.router.add_get("/metrics", metrics_handler)
        runner = web.AppRunner(app)
        await runner.setup()
        await web.TCPSite(runner, "0.0.0.0", args.port).start()
        print(f"user-events metrics on :{args.port}/metrics", flush=True)
        try:
            await wait_for_shutdown()
        finally:
            await recorder.stop()
            await runner.cleanup()

    asyncio.run(run())


if __name__ == "__main__":
    main()
