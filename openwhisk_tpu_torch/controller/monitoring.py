"""Prometheus exposition helpers for the controller's /metrics page.

The part of `openwhisk_tpu/controller/monitoring.py` that the port's
planes render through: counter, gauge and histogram families (the
telemetry plane's latency histograms and outcome counters, the anomaly
plane's scores and alerts, the kernel profiler's phase histograms, the
latency waterfall's and the placement quality plane's families on
/metrics use them), and the quality plane's federation merge
(`merged_quality_report`, with `_members_of`, `_sum_into` and
`_pctl_from_hist`, copies). The other federation merges, the user-events
service and the monitoring service's main wait for the fleet
observatory.
"""
from __future__ import annotations

import math

from ..utils.logging import _prom_label_value


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


# -- Fleet federation merge math --------------------------------------------
# Pure functions over the `raw_counts()` exports of the per-process
# observability planes; deterministic integer math. Per-process log2
# bucket counts summed bucket-wise equal the histogram of the pooled
# samples, so merged percentiles re-derive from merged counts;
# percentiles themselves never merge.

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
