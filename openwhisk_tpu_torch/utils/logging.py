"""Structured logging + in-process metrics.

Rebuilt from the reference's Logging/MetricEmitter
(common/scala/.../common/Logging.scala:37-120,241-258): log lines are prefixed
with the transaction id; MetricEmitter keeps counters/histograms/gauges that a
Prometheus endpoint can scrape (openwhisk_tpu.controller.monitoring).
"""
from __future__ import annotations

import sys
import threading
import time
from collections import defaultdict
from typing import Optional

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}


def _mkey(name: str, tags):
    """Series key: (family name, sorted tag tuple) — tags are the reference
    MetricEmitter's optional Kamon tags (Logging.scala:241-258), rendered as
    Prometheus labels so one family fans out by e.g. action or namespace."""
    return (name, tuple(sorted(tags.items())) if tags else ())


class MetricEmitter:
    """Thread-safe counters / histograms / gauges (ref Logging.scala:241-258).

    Histograms keep (count, sum, min, max) plus a sliding window of the
    last WINDOW samples for windowed percentile estimates — enough for the
    /metrics endpoint and tests. Every method takes optional `tags` (a flat
    str->str dict): tagged series share the family name and differ by label
    set, exactly Prometheus's model.

    `register_renderer(fn)` attaches extra exposition blocks (e.g. the
    balancer telemetry plane's device-accumulated histogram families) that
    prometheus_text() appends to the page, so every scrape surface sharing
    this emitter serves them without new wiring.
    """

    #: sliding-window size for percentile estimates
    WINDOW = 1024

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple, int] = defaultdict(int)
        self._gauges: dict[tuple, float] = {}
        # key -> [count, sum, min, max, window, cursor]
        self._hist: dict[tuple, list] = {}
        self._renderers: list = []

    def counter(self, name: str, delta: int = 1, tags=None) -> None:
        with self._lock:
            self._counters[_mkey(name, tags)] += delta

    def gauge(self, name: str, value: float, tags=None) -> None:
        with self._lock:
            self._gauges[_mkey(name, tags)] = value

    def histogram(self, name: str, value: float, tags=None) -> None:
        with self._lock:
            h = self._hist.get(_mkey(name, tags))
            if h is None:
                h = [0, 0.0, float("inf"), float("-inf"), [], 0]
                self._hist[_mkey(name, tags)] = h
            h[0] += 1
            h[1] += value
            h[2] = min(h[2], value)
            h[3] = max(h[3], value)
            res = h[4]
            if len(res) < self.WINDOW:
                res.append(value)
            else:
                # honest sliding window: overwrite the OLDEST sample via a
                # dedicated write cursor (keying on total count would skip
                # or double-hit slots whenever count and window drift)
                res[h[5]] = value
                h[5] = (h[5] + 1) % self.WINDOW

    def register_renderer(self, render_fn) -> None:
        """Append `render_fn()` (exposition-format text) to every
        prometheus_text() page."""
        with self._lock:
            self._renderers.append(render_fn)

    def unregister_renderer(self, render_fn) -> None:
        """Detach a renderer (a closed balancer must stop contributing —
        on a shared process-wide emitter a stale renderer would keep the
        balancer alive and duplicate its families on the page)."""
        with self._lock:
            try:
                self._renderers.remove(render_fn)
            except ValueError:
                pass

    # -- read side ---------------------------------------------------------
    def counter_value(self, name: str, tags=None) -> int:
        with self._lock:
            return self._counters.get(_mkey(name, tags), 0)

    def gauge_value(self, name: str, tags=None) -> Optional[float]:
        with self._lock:
            return self._gauges.get(_mkey(name, tags))

    def histogram_stats(self, name: str, tags=None) -> Optional[dict]:
        """count/sum/min/max are lifetime; p50/p99 are WINDOWED percentiles
        over the last WINDOW samples (the sliding window above), so they
        track current behavior rather than boot-to-now history."""
        with self._lock:
            h = self._hist.get(_mkey(name, tags))
            if not h or not h[0]:
                return None
            res = sorted(h[4])
            return {
                "count": h[0], "sum": h[1], "min": h[2], "max": h[3],
                "mean": h[1] / h[0],
                "p50": res[len(res) // 2],
                "p99": res[min(len(res) - 1, int(len(res) * 0.99))],
            }

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {
                    k: {"count": v[0], "sum": v[1],
                        "p50": _window_pctl(v[4], 0.5),
                        "p99": _window_pctl(v[4], 0.99)}
                    for k, v in self._hist.items()},
            }

    def prometheus_text(self, openmetrics: bool = False) -> str:
        """Render in Prometheus exposition format (ref core/monitoring):
        one # TYPE line per family, tagged series as labels. `openmetrics`
        is forwarded to renderers that declare the parameter (the phase
        histogram attaches trace exemplars only then — the classic text
        format has no exemplar syntax)."""
        import inspect
        out = []
        snap = self.snapshot()

        def emit(items, kind, render, om_total: bool = False):
            # OpenMetrics counter naming: the family (# TYPE line) is
            # suffix-free and every sample carries `_total` — the classic
            # format types the full sample name. A negotiated OM scrape
            # with the classic naming is rejected wholesale by
            # Prometheus's OM parser.
            seen = set()
            for key in sorted(items):
                fam = _prom_name(key[0])
                name = key[0]
                if om_total:
                    base = (name[:-len("_total")]
                            if name.endswith("_total") else name)
                    fam = _prom_name(base)
                    key = (base + "_total", key[1])
                if fam not in seen:
                    seen.add(fam)
                    out.append(f"# TYPE {fam} {kind}")
                out.append(render(_prom_series(key), items[(name, key[1])]))

        emit(snap["counters"], "counter", lambda s_, v: f"{s_} {v}",
             om_total=openmetrics)
        emit(snap["gauges"], "gauge", lambda s_, v: f"{s_} {v}")
        emit(snap["histograms"], "summary",
             lambda s_, v: _summary_lines(s_, v))
        with self._lock:
            renderers = list(self._renderers)
        for render in renderers:
            try:
                try:
                    params = inspect.signature(render).parameters
                except (TypeError, ValueError):
                    params = {}
                text = (render(openmetrics=openmetrics)
                        if "openmetrics" in params else render())
            except Exception:  # noqa: BLE001 — one broken renderer must
                continue      # not take the whole scrape page down
            if text:
                out.append(text.rstrip("\n"))
        return "\n".join(out) + "\n"


def _prom_name(name: str) -> str:
    return "openwhisk_" + "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _prom_label_value(v) -> str:
    """Prometheus exposition format: label values escape backslash,
    double-quote and newline. The `metric` label comes from user-event
    bodies, so arbitrary values must not corrupt the page."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_series(key) -> str:
    name, tags = key
    n = _prom_name(name)
    if tags:
        lbl = ",".join(f'{k}="{_prom_label_value(v)}"' for k, v in tags)
        return f"{n}{{{lbl}}}"
    return n


def _window_pctl(window, q: float):
    if not window:
        return None
    res = sorted(window)
    return res[min(len(res) - 1, int(len(res) * q))]


def _summary_lines(series: str, v: dict) -> str:
    # suffix goes on the NAME, before any label block; quantile lines carry
    # the windowed p50/p99 (histogram_stats already computed them — without
    # these lines Grafana latency panels need recording rules over _sum)
    lines = []
    if "{" in series:
        n, lbl = series.split("{", 1)
        lbl = lbl[:-1]  # strip the closing brace; each line re-adds it
        for q in (0.5, 0.99):
            p = v.get(f"p{int(q * 100)}")
            if p is not None:
                lines.append(f'{n}{{{lbl},quantile="{q}"}} {p}')
        lines.append(f"{n}_count{{{lbl}}} {v['count']}")
        lines.append(f"{n}_sum{{{lbl}}} {v['sum']}")
    else:
        for q in (0.5, 0.99):
            p = v.get(f"p{int(q * 100)}")
            if p is not None:
                lines.append(f'{series}{{quantile="{q}"}} {p}')
        lines.append(f"{series}_count {v['count']}")
        lines.append(f"{series}_sum {v['sum']}")
    return "\n".join(lines)


class Logging:
    """Base logger: level-filtered, transid-prefixed lines + metric sink."""

    def __init__(self, level: str = "info", metrics: Optional[MetricEmitter] = None,
                 stream=None):
        self.level = _LEVELS.get(level, 20)
        self.metrics = metrics or MetricEmitter()
        self.stream = stream or sys.stderr
        self._lock = threading.Lock()

    def emit(self, level: str, transid, message: str, component: str = "") -> None:
        if _LEVELS.get(level, 20) < self.level:
            return
        ts = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime())
        line = f"[{ts}] [{level.upper()}] [{transid}] [{component}] {message}"
        with self._lock:
            print(line, file=self.stream)

    def debug(self, transid, msg, component=""):
        self.emit("debug", transid, msg, component)

    def info(self, transid, msg, component=""):
        self.emit("info", transid, msg, component)

    def warn(self, transid, msg, component=""):
        self.emit("warn", transid, msg, component)

    def error(self, transid, msg, component=""):
        self.emit("error", transid, msg, component)


class PrintLogging(Logging):
    pass


class NullLogging(Logging):
    def emit(self, level, transid, message, component=""):
        pass
