"""Prometheus exposition helpers for the controller's /metrics page.

The part of `openwhisk_tpu/controller/monitoring.py` that the port's
planes render through: counter, gauge and histogram families (the
telemetry plane's latency histograms and outcome counters, the anomaly
plane's scores and alerts, the kernel profiler's phase histograms and the
latency waterfall's families on /metrics use them). The user-events
service and the fleet federation merges are not ported yet.
"""
from __future__ import annotations

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
