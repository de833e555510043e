"""Anomaly & alerting plane: telemetry deltas -> scores -> alerts.

A copy of `openwhisk_tpu/controller/loadbalancer/anomaly.py`, except at
two device seams: `_ensure_state` pads the carry on the device, and
`_tick_device` harvests the previous tick's scores only once the CUDA
event recorded after their asynchronous copy to pinned host memory has
completed (`event.query()`), keeping the previous scores otherwise — the
tick never waits on the device. The plane counts its device ticks, the
harvests and the failed steps (`device_ticks`, `harvested`,
`step_failures`).

The fourth observability plane. The flight recorder records *where*
placements went, the telemetry plane measures *whether* the fleet meets
its SLOs, the kernel profiler profiles *how* the kernel runs — but an
operator still had to eyeball `/admin/slo` to notice a sick
invoker. This plane closes the loop: per-invoker anomaly scores computed
where the telemetry already lives (ops/anomaly.py — on device for the TPU
balancer, the NumPy twin for sharding/lean, through the same base-class
hook), and a Prometheus-style alert rules engine on top.

Detection (the kernel, one program per tick, vectorized over invokers):
EWMA latency mean/variance per invoker, robust z-score against the fleet
median (straggler score), error/timeout-rate spike z-tests against the
EWMA baseline, boolean flags gated on a minimum sample count. The device
path is pipelined one tick deep: tick N dispatches the program and starts
an async device->host copy; tick N+1 harvests it — the supervision tick
never blocks on a device sync (the same no-sync-on-the-loop rule the
telemetry burn-rate math follows).

Alerting (host, pure python): rules with (signal, threshold, `for`
duration, severity) — built-in defaults for straggler, error spike, SLO
fast/slow burn (reusing the telemetry plane's burn-rate windows) and the
kernel profiler's recompile watchdog counter, each overridable via
`CONFIG_whisk_alerts_rules` JSON. A pending -> firing -> resolved state
machine per (alert, label set), every transition appended to a pre-sized
SeqRingBuffer alert log and counted.

Read sides:
  * `/metrics` families (MetricEmitter.register_renderer):
    `openwhisk_loadbalancer_invoker_anomaly_score{invoker,signal}`,
    `openwhisk_alerts_firing{alertname,severity}`,
    `openwhisk_alert_transitions_total{alertname,transition}`.
  * `GET /admin/alerts`: rules, active (pending+firing) alerts, the
    transition log.
  * `GET /admin/anomalies`: per-invoker scores with evidence — which
    latency buckets moved since the last tick (the kernel's prev-bucket
    snapshot doubles as the evidence baseline; syncing it is an endpoint
    cold path, never a tick cost).
  * an advisory `unhealthy_hint` pushed to InvokerPool when
    `CONFIG_whisk_anomaly_hintUnhealthy` is set (default OFF: this plane
    observes, it does not steer placement).

Off-switch: `CONFIG_whisk_anomaly_enabled=false` makes every entry point a
true no-op (no state allocated, empty exposition, `{"enabled": false}`
reports).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...ops.anomaly import (S_ANOMALY_FLAG, S_ERR_SPIKE, S_EWMA_MS,
                            S_STRAGGLER, S_STRAGGLER_FLAG, S_TM_SPIKE,
                            S_TOTAL, AnomalyState, anomaly_step_np,
                            init_anomaly, init_anomaly_np,
                            make_anomaly_step)
from ...utils.config import load_config
from ...utils.ring_buffer import SeqRingBuffer
from .telemetry import FAST_WINDOW_S, SLOW_WINDOW_S

#: alert FSM states (`resolved`/`cancelled` appear only as transition
#: targets in the log: the instance itself is dropped)
PENDING, FIRING = "pending", "firing"
RESOLVED, CANCELLED, INACTIVE = "resolved", "cancelled", "inactive"

#: recompile-watchdog hold: churn within this window keeps the signal up
CHURN_WINDOW_S = 60.0

#: invoker-scoped score signals -> packed score-matrix rows
_SIGNAL_ROWS = {
    "straggler_score": S_STRAGGLER,
    "error_spike_score": S_ERR_SPIKE,
    "timeout_spike_score": S_TM_SPIKE,
}


@dataclass(frozen=True)
class AnomalyConfig:
    """`CONFIG_whisk_anomaly_*` env overrides."""
    enabled: bool = True
    #: EWMA smoothing factor for the per-tick latency / rate estimates
    alpha: float = 0.3
    #: robust z-score above which an invoker counts as straggling
    z_threshold: float = 3.5
    #: spike z-score above which an error/timeout burst counts as anomalous
    spike_threshold: float = 3.0
    #: cumulative completions an invoker needs before it may flag
    min_samples: int = 8
    #: absolute floor (ms) on the MAD scale — a tightly-clustered fleet
    #: must not z-score its own micro-jitter into stragglers
    mad_floor_ms: float = 1.0
    #: push firing invoker-scoped alerts to InvokerPool as advisory hints
    hint_unhealthy: bool = False


@dataclass(frozen=True)
class AlertsConfig:
    """`CONFIG_whisk_alerts_*` env overrides. `rules` is a JSON dict of
    per-rule overrides, e.g. CONFIG_whisk_alerts_rules=
    '{"straggler": {"threshold": 2.5, "for_s": 10, "severity": "critical"}}'
    (unknown keys are ignored; `"enabled": false` drops a built-in)."""
    enabled: bool = True
    log_size: int = 256
    rules: dict = field(default_factory=dict)


@dataclass
class AlertRule:
    name: str
    signal: str
    threshold: float
    for_s: float
    severity: str
    scope: str  # "invoker" | "global"
    enabled: bool = True

    def to_json(self) -> dict:
        return {"name": self.name, "signal": self.signal,
                "threshold": self.threshold, "for_s": self.for_s,
                "severity": self.severity, "scope": self.scope,
                "enabled": self.enabled}


#: the built-in rule set (burn thresholds are the classic multi-window
#: pair: fast burn pages, slow burn tickets). The straggler/spike
#: thresholds here are placeholders: build_rules() re-derives them from
#: AnomalyConfig so the kernel's flag gate and the alert gate are ONE
#: knob (CONFIG_whisk_anomaly_{z,spike}Threshold) — an explicit
#: CONFIG_whisk_alerts_rules threshold still wins.
DEFAULT_RULES: Tuple[AlertRule, ...] = (
    AlertRule("straggler", "straggler_score", 3.5, 30.0, "warning",
              "invoker"),
    AlertRule("error_spike", "error_spike_score", 3.0, 30.0, "warning",
              "invoker"),
    AlertRule("timeout_spike", "timeout_spike_score", 3.0, 30.0, "warning",
              "invoker"),
    AlertRule("slo_fast_burn", "burn_rate_1m", 14.4, 60.0, "critical",
              "global"),
    AlertRule("slo_slow_burn", "burn_rate_10m", 6.0, 300.0, "warning",
              "global"),
    AlertRule("recompile_churn", "recompile_churn_60s", 0.0, 0.0, "warning",
              "global"),
    # journal writer stall: the appended-vs-durable gap stays
    # above threshold for the window — an fsync device stall. The signal
    # is fed by TpuBalancer.attach_journal via `extra_signals`; the
    # firing state also surfaces in GET /admin/ready.
    AlertRule("journal_stall", "journal_lag_batches", 64.0, 10.0,
              "critical", "global"),
)


def _rule_override(rule: AlertRule, ov: dict) -> AlertRule:
    def pick(snake, camel, cur, cast):
        v = ov.get(snake, ov.get(camel, cur))
        return cast(v)

    return replace(
        rule,
        threshold=pick("threshold", "threshold", rule.threshold, float),
        for_s=pick("for_s", "forS", ov.get("for", rule.for_s), float),
        severity=str(ov.get("severity", rule.severity)),
        enabled=bool(ov.get("enabled", rule.enabled)),
    )


def build_rules(overrides: Optional[dict],
                anomaly: Optional[AnomalyConfig] = None
                ) -> Dict[str, AlertRule]:
    """Built-in rules + `CONFIG_whisk_alerts_rules` overrides; operators
    may also add NEW rules over any known signal by including `signal`.
    When the detector config is given, the built-in straggler/spike rule
    thresholds track its flag gates (an invoker the kernel flags is an
    invoker the alert watches — the two surfaces must not disagree when
    an operator tunes CONFIG_whisk_anomaly_zThreshold)."""
    rules = {r.name: replace(r) for r in DEFAULT_RULES}
    if anomaly is not None:
        rules["straggler"] = replace(rules["straggler"],
                                     threshold=float(anomaly.z_threshold))
        for n in ("error_spike", "timeout_spike"):
            rules[n] = replace(rules[n],
                               threshold=float(anomaly.spike_threshold))
    for name, ov in (overrides or {}).items():
        if not isinstance(ov, dict):
            continue
        base = rules.get(name)
        if base is None:
            signal = ov.get("signal")
            if not isinstance(signal, str):
                continue  # a new rule must say what it watches
            scope = "invoker" if signal in _SIGNAL_ROWS else "global"
            base = AlertRule(name, signal, 0.0, 0.0, "warning", scope)
        rules[name] = _rule_override(base, ov)
    return rules


@dataclass
class _Instance:
    state: str
    since: float   # monotonic stamp when the condition first held
    value: Optional[float] = None


LabelSet = Tuple[Tuple[str, str], ...]


class AlertEngine:
    """The pending -> firing -> resolved state machine, one instance per
    (rule, label set). evaluate() is fed every breaching subject plus the
    current value of every subject with a live instance; a live subject
    absent from the feed counts as vanished and resolves/cancels."""

    def __init__(self, rules: Dict[str, AlertRule], log_size: int = 256,
                 logger=None):
        self.rules = rules
        self.logger = logger
        self.log: SeqRingBuffer[dict] = SeqRingBuffer(max(1, int(log_size)))
        self._instances: Dict[Tuple[str, LabelSet], _Instance] = {}
        #: (alertname, transition) -> count, for the counter family
        self.transition_counts: Dict[Tuple[str, str], int] = {}
        #: (firing_counts, transition_counts) copies republished after
        #: every evaluate(): /metrics renders on a worker thread while the
        #: tick mutates the live dicts on the event loop — the renderer
        #: must only ever iterate these immutable-once-published copies
        self._exposition: Tuple[dict, dict] = ({}, {})
        #: transition observers `(now, rule, labels, old, new, value)` —
        #: the incident recorder's firing trigger. Synchronous,
        #: must never block or raise into the evaluation tick.
        self.listeners: List[Callable] = []

    def _transition(self, now: float, rule: AlertRule, labels: LabelSet,
                    old: str, new: str, value: Optional[float]) -> None:
        self.log.append({
            "ts": round(time.time(), 3),
            "alert": rule.name,
            "severity": rule.severity,
            "labels": dict(labels),
            "from": old,
            "to": new,
            "value": None if value is None else round(float(value), 4),
        })
        key = (rule.name, new)
        self.transition_counts[key] = self.transition_counts.get(key, 0) + 1
        if self.logger is not None and new in (FIRING, RESOLVED):
            self.logger.warn(
                None, f"alert {rule.name}{dict(labels)} {old} -> {new} "
                f"(value={value}, severity={rule.severity})", "AlertEngine")
        for fn in tuple(self.listeners):
            try:
                fn(now, rule, labels, old, new, value)
            except Exception:  # noqa: BLE001 — observability never blocks
                pass

    def evaluate(self, now: float,
                 signals: Dict[str, List[Tuple[LabelSet, float]]]) -> None:
        for name, rule in self.rules.items():
            if not rule.enabled:
                continue
            seen = set()
            for labels, value in signals.get(name, []):
                key = (name, labels)
                seen.add(key)
                inst = self._instances.get(key)
                if value > rule.threshold:
                    if inst is None:
                        state = PENDING if rule.for_s > 0 else FIRING
                        self._instances[key] = _Instance(state, now, value)
                        self._transition(now, rule, labels, INACTIVE, state,
                                         value)
                    else:
                        inst.value = value
                        if inst.state == PENDING \
                                and now - inst.since >= rule.for_s:
                            self._transition(now, rule, labels, PENDING,
                                             FIRING, value)
                            inst.state = FIRING
                elif inst is not None:
                    to = RESOLVED if inst.state == FIRING else CANCELLED
                    self._transition(now, rule, labels, inst.state, to,
                                     value)
                    del self._instances[key]
            # subjects that vanished entirely (invoker left the score
            # matrix): their alerts must not fire forever on stale data
            for key in [k for k in self._instances
                        if k[0] == name and k not in seen]:
                inst = self._instances.pop(key)
                to = RESOLVED if inst.state == FIRING else CANCELLED
                self._transition(now, rule, key[1], inst.state, to, None)
        self._exposition = (self.firing_counts(),
                            dict(self.transition_counts))

    # -- read side ---------------------------------------------------------
    def active(self, now: Optional[float] = None) -> List[dict]:
        now = time.monotonic() if now is None else now
        out = []
        for (name, labels), inst in sorted(self._instances.items()):
            rule = self.rules[name]
            out.append({
                "alert": name,
                "labels": dict(labels),
                "state": inst.state,
                "severity": rule.severity,
                "for_s": rule.for_s,
                "active_s": round(now - inst.since, 3),
                "value": inst.value,
            })
        return out

    def firing_counts(self) -> Dict[Tuple[str, str], int]:
        """(alertname, severity) -> number of firing instances."""
        out: Dict[Tuple[str, str], int] = {}
        for (name, _labels), inst in self._instances.items():
            if inst.state == FIRING:
                key = (name, self.rules[name].severity)
                out[key] = out.get(key, 0) + 1
        return out

    def subjects(self, name: str) -> List[LabelSet]:
        """Label sets with a live instance under rule `name` (the plane
        feeds these their current value each tick so resolutions carry
        the observed number, not None)."""
        return [labels for (n, labels) in self._instances if n == name]

    def exposition_snapshot(self) -> Tuple[dict, dict]:
        """(firing_counts, transition_counts) as of the last evaluate(),
        safe to iterate from the /metrics worker thread."""
        return self._exposition


class AnomalyPlane:
    """One per balancer (base-class hook, like the other three planes)."""

    def __init__(self, config: Optional[AnomalyConfig] = None,
                 alerts: Optional[AlertsConfig] = None, logger=None):
        self.config = config or AnomalyConfig()
        self.alerts_config = alerts or AlertsConfig()
        self.enabled = self.config.enabled
        self.logger = logger
        self.engine = AlertEngine(build_rules(self.alerts_config.rules,
                                              anomaly=self.config),
                                  log_size=self.alerts_config.log_size,
                                  logger=logger)
        #: host-provided global alert signals: name -> zero-arg provider
        #: returning the current value (None = subject vanished). The
        #: journal stall watchdog registers `journal_lag_batches` here.
        self.extra_signals: Dict[str, Callable[[], Optional[float]]] = {}
        # attached collaborators (base-class wiring)
        self._telemetry = None
        self._profiler = None
        self._names_fn: Optional[Callable[[], List[str]]] = None
        self.hint_sink: Optional[Callable[[Dict[int, str]], None]] = None
        # detector state: allocated lazily on the first enabled tick
        self._state: Optional[AnomalyState] = None
        self._state_kernel: Optional[str] = None
        self._step = None
        self._scores: Optional[np.ndarray] = None   # harvested [R, N]
        #: (host tensor, CUDA event or None) of the step in flight
        self._pending_scores = None
        #: device ticks run, scores harvested, steps that raised
        self.device_ticks = 0
        self.harvested = 0
        self.step_failures = 0
        self._names: List[str] = []
        self._name_idx: Dict[str, int] = {}
        self._last_tick = 0.0
        self._last_unexpected = 0
        self._churn_events: List[Tuple[float, int]] = []
        self.hints: Dict[int, str] = {}

    @classmethod
    def from_config(cls, logger=None) -> "AnomalyPlane":
        return cls(config=load_config(AnomalyConfig, env_path="anomaly"),
                   alerts=load_config(AlertsConfig, env_path="alerts"),
                   logger=logger)

    def attach(self, telemetry=None, profiler=None,
               invoker_names: Optional[Callable[[], List[str]]] = None,
               hint_sink=None) -> None:
        """Wire the plane to its data sources (called by the balancer base
        class; harmless when disabled — nothing allocates until a tick)."""
        self._telemetry = telemetry
        self._profiler = profiler
        self._names_fn = invoker_names
        if hint_sink is not None:
            self.hint_sink = hint_sink

    @property
    def SYNCS_DEVICE(self) -> bool:
        """True when the evidence read in anomalies_report forces a
        device->host sync (callers then use a worker thread)."""
        tp = self._telemetry
        return bool(tp is not None and tp.enabled and tp.SYNCS_DEVICE)

    # -- detector ticks ----------------------------------------------------
    def _cfg_args(self) -> tuple:
        c = self.config
        return (c.alpha, c.z_threshold, c.spike_threshold, c.min_samples,
                c.mad_floor_ms)

    def _ensure_state(self, kernel: str, n: int, n_buckets: int,
                      device=None) -> None:
        """(Re)allocate or zero-pad the carry state to the accumulator's
        current invoker axis. A kernel swap (cpu -> device via use_device)
        restarts the estimates — the accumulators are different arrays."""
        st = self._state
        # .shape is metadata on both numpy arrays and tensors — never a sync
        if st is not None and self._state_kernel == kernel \
                and tuple(st.prev_buckets.shape) == (n, n_buckets):
            return
        shape = tuple(st.prev_buckets.shape) if st is not None else None
        if st is not None and self._state_kernel == kernel \
                and shape[1] == n_buckets and shape[0] < n:
            # invoker axis grew: zero-pad every carry array, preserving the
            # estimates (a fleet join must not reset everyone's EWMAs). On
            # the device path the pad stays ON DEVICE — syncing the carry
            # through the host here would stall the supervision tick, the
            # exact stall the one-tick-deep harvest pipeline avoids.
            n_old = shape[0]
            if kernel == "device":
                grown = []
                for o in st:
                    g = o.new_zeros((n,) + tuple(o.shape[1:]))
                    g[:n_old] = o
                    grown.append(g)
            else:
                grown = []
                for o in st:
                    g = np.zeros((n,) + o.shape[1:], o.dtype)
                    g[:n_old] = o
                    grown.append(g)
            self._state = AnomalyState(*grown)
        else:
            self._state = (init_anomaly(n, n_buckets, device=device)
                           if kernel == "device"
                           else init_anomaly_np(n, n_buckets))
        self._state_kernel = kernel

    def tick(self, metrics=None, now: Optional[float] = None) -> dict:
        """One detection + alert-evaluation pass. Rides the supervision
        tick (TPU/sharding) or the completion stream (lean, maybe_tick)."""
        if not self.enabled:
            return {}
        now = time.monotonic() if now is None else now
        self._last_tick = now
        tp = self._telemetry
        if tp is not None and tp.enabled:
            acc = tp.accumulator
            if getattr(acc, "kernel", "cpu") == "device":
                self._tick_device(acc)
            else:
                self._tick_cpu(acc)
        self._refresh_names()
        self._evaluate(now)
        n_straggling = n_anomalous = 0
        if self._scores is not None:
            n_straggling = int(self._scores[S_STRAGGLER_FLAG].sum())
            n_anomalous = int(self._scores[S_ANOMALY_FLAG].sum())
        firing = sum(self.engine.firing_counts().values())
        if metrics is not None:
            metrics.gauge("loadbalancer_anomaly_stragglers", n_straggling)
            metrics.gauge("loadbalancer_alerts_firing_count", firing)
        return {"stragglers": n_straggling, "anomalous": n_anomalous,
                "firing": firing}

    def maybe_tick(self, metrics=None) -> None:
        """Rate-limited tick for balancers without a supervision scheduler
        (lean): detection freshness rides the completion stream."""
        if self.enabled and time.monotonic() - self._last_tick >= 1.0:
            self.tick(metrics)

    def _tick_cpu(self, acc) -> None:
        self._ensure_state("cpu", acc.inv_buckets.shape[0], acc.n_buckets)
        self._state, scores = anomaly_step_np(
            self._state, acc.inv_buckets, acc.inv_lat_ms, acc.inv_outcomes,
            *self._cfg_args())
        self._scores = scores

    def _tick_device(self, acc) -> None:
        st = acc.state
        self._ensure_state("device", st.inv_buckets.shape[0],
                           st.inv_buckets.shape[1], st.inv_buckets.device)
        if self._step is None:
            self._step = make_anomaly_step(*self._cfg_args())
        # harvest LAST tick's scores first, only if their copy to pinned
        # host memory has landed: otherwise the previous scores stand and
        # the newer step's copy replaces this one — never a blocking sync
        if self._pending_scores is not None:
            host, event = self._pending_scores
            if event is None or event.query():
                self._scores = host.numpy()
                self.harvested += 1
            self._pending_scores = None
        try:
            self._state, out = self._step(self._state, st.inv_buckets,
                                          st.inv_lat_ms, st.inv_outcomes)
            event = None
            if out.is_cuda:
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                out = host
            self._pending_scores = (out, event)
            self.device_ticks += 1
        except Exception as e:  # noqa: BLE001
            self.step_failures += 1
            if self.logger is not None:
                self.logger.warn(None, f"anomaly step failed: {e!r}",
                                 "AnomalyPlane")

    # -- alert evaluation --------------------------------------------------
    def _refresh_names(self) -> None:
        names = self._names_fn() if self._names_fn is not None else []
        self._names = names
        self._name_idx = {n: i for i, n in enumerate(names)}

    def _inv_name(self, i: int) -> str:
        return self._names[i] if i < len(self._names) else f"invoker{i}"

    def _global_signals(self, now: float) -> Dict[str, float]:
        gv: Dict[str, float] = {}
        # host-provided signals (e.g. journal_lag_batches from
        # attach_journal): a provider returning None means the subject
        # vanished — its live alert instances resolve/cancel
        for name, provider in self.extra_signals.items():
            try:
                v = provider()
            except Exception:  # noqa: BLE001 — a broken provider must not
                continue       # kill the supervision tick
            if v is not None:
                gv[name] = float(v)
        tp = self._telemetry
        if tp is not None and tp.enabled:
            gv["burn_rate_1m"] = tp._burn_rate(FAST_WINDOW_S, now)
            gv["burn_rate_10m"] = tp._burn_rate(SLOW_WINDOW_S, now)
        prof = self._profiler
        if prof is not None and getattr(prof, "enabled", False):
            cur = int(getattr(prof, "compiles_unexpected", 0))
            delta = cur - self._last_unexpected
            self._last_unexpected = cur
            if delta > 0:
                self._churn_events.append((now, delta))
            self._churn_events = [(t, d) for t, d in self._churn_events
                                  if t > now - CHURN_WINDOW_S]
            gv["recompile_churn_60s"] = float(
                sum(d for _, d in self._churn_events))
        return gv

    def _evaluate(self, now: float) -> None:
        if not self.alerts_config.enabled:
            return
        sc = self._scores
        gv = self._global_signals(now)
        signals: Dict[str, List[Tuple[LabelSet, float]]] = {}
        warm = (sc[S_TOTAL] >= max(1, self.config.min_samples)
                if sc is not None else None)
        for name, rule in self.engine.rules.items():
            if rule.scope == "invoker":
                row = _SIGNAL_ROWS.get(rule.signal)
                if row is None or sc is None:
                    signals[name] = []
                    continue
                # the breach test is one vectorized comparison — the
                # per-subject python list stays O(breaching + live
                # instances), not O(fleet), on the supervision tick
                vals = sc[row]
                entries = [
                    ((("invoker", self._inv_name(int(i))),),
                     float(vals[i]))
                    for i in np.nonzero(warm & (vals > rule.threshold))[0]]
                covered = {labels for labels, _ in entries}
                # live instances off the breach set are fed their current
                # value so resolutions carry the observed number; subjects
                # gone from the score matrix fall to the vanished path
                for labels in self.engine.subjects(name):
                    if labels in covered:
                        continue
                    idx = self._name_idx.get(dict(labels).get("invoker", ""))
                    if idx is not None and idx < vals.shape[0] \
                            and bool(warm[idx]):
                        entries.append((labels, float(vals[idx])))
                signals[name] = entries
            else:
                v = gv.get(rule.signal)
                signals[name] = [((), v)] if v is not None else []
        self.engine.evaluate(now, signals)
        # advisory hints: firing invoker-scoped alerts, pushed to the
        # supervision pool only when the operator opted in
        hints: Dict[int, str] = {}
        for (aname, labels), inst in self.engine._instances.items():
            rule = self.engine.rules.get(aname)
            if inst.state != FIRING or rule is None \
                    or rule.scope != "invoker":
                continue
            idx = self._name_idx.get(dict(labels).get("invoker", ""))
            if idx is not None and idx not in hints:
                hints[idx] = aname
        self.hints = hints
        if self.config.hint_unhealthy and self.hint_sink is not None:
            try:
                self.hint_sink(dict(hints))
            except Exception:  # noqa: BLE001 — a hint must never break
                pass           # the tick

    # -- exposition --------------------------------------------------------
    def prometheus_text(self, openmetrics: bool = False) -> str:
        # runs on the /metrics worker thread while the tick mutates the
        # plane on the event loop: read each racing reference ONCE into a
        # local (scores/names are replaced wholesale, never mutated) and
        # take the alert dicts from the engine's published snapshot
        if not self.enabled:
            return ""
        from ..monitoring import counter_family_text, gauge_family_text
        out: List[str] = []
        sc = self._scores
        names = self._names
        if sc is not None:
            rows = []
            for i in range(sc.shape[1]):
                if sc[S_TOTAL, i] <= 0:
                    continue
                name = names[i] if i < len(names) else f"invoker{i}"
                for label, row in (("straggler", S_STRAGGLER),
                                   ("error_spike", S_ERR_SPIKE),
                                   ("timeout_spike", S_TM_SPIKE)):
                    rows.append(({"invoker": name, "signal": label},
                                 round(float(sc[row, i]), 4)))
            out += gauge_family_text(
                "openwhisk_loadbalancer_invoker_anomaly_score", rows)
        firing, transitions = self.engine.exposition_snapshot()
        out += gauge_family_text(
            "openwhisk_alerts_firing",
            [({"alertname": n, "severity": s}, c)
             for (n, s), c in sorted(firing.items())])
        out += counter_family_text(
            "openwhisk_alert_transitions_total",
            [({"alertname": n, "transition": t}, c)
             for (n, t), c in sorted(transitions.items())],
            openmetrics=openmetrics)
        return "\n".join(out)

    # -- admin payloads ----------------------------------------------------
    def alerts_report(self, limit: int = 50) -> dict:
        """The `GET /admin/alerts` payload."""
        if not self.enabled:
            return {"enabled": False}
        return {
            "enabled": True,
            "alerts_enabled": self.alerts_config.enabled,
            "rules": [r.to_json()
                      for r in sorted(self.engine.rules.values(),
                                      key=lambda r: r.name)],
            "active": self.engine.active(),
            "transitions": self.engine.log.last(max(0, limit)),
            "transitions_dropped": self.engine.log.evicted,
        }

    def anomalies_report(self, invoker_names: Optional[List[str]] = None
                         ) -> dict:
        """The `GET /admin/anomalies` payload: per-invoker scores with
        evidence (which latency buckets moved since the last tick). A
        device sync on the TPU path — callers run it on a worker thread
        (SYNCS_DEVICE), same policy as `/admin/slo`."""
        if not self.enabled:
            return {"enabled": False}
        tp = self._telemetry
        names = invoker_names if invoker_names is not None else self._names
        sc = self._scores
        cur = prev = bounds = None
        if tp is not None and tp.enabled:
            cur = tp.counts()["inv_buckets"]
            bounds = tp.bounds_ms()
        if self._state is not None:
            prev = self._state.prev_buckets
            prev = (prev.cpu().numpy() if isinstance(prev, torch.Tensor)
                    else np.asarray(prev))
        invokers = []
        for i in range(sc.shape[1] if sc is not None else 0):
            if sc[S_TOTAL, i] <= 0:
                continue
            name = names[i] if i < len(names) else f"invoker{i}"
            row = {
                "invoker": name,
                "straggler_score": round(float(sc[S_STRAGGLER, i]), 4),
                "error_spike_score": round(float(sc[S_ERR_SPIKE, i]), 4),
                "timeout_spike_score": round(float(sc[S_TM_SPIKE, i]), 4),
                "straggler": bool(sc[S_STRAGGLER_FLAG, i]),
                "anomalous": bool(sc[S_ANOMALY_FLAG, i]),
                "ewma_latency_ms": round(float(sc[S_EWMA_MS, i]), 4),
                "samples": int(sc[S_TOTAL, i]),
                "unhealthy_hint": self.hints.get(i),
            }
            if cur is not None and prev is not None \
                    and i < min(cur.shape[0], prev.shape[0]):
                moved = []
                delta = np.asarray(cur[i], np.int64) - np.asarray(
                    prev[i], np.int64)
                for b in np.nonzero(delta > 0)[0]:
                    le = (bounds[b] if bounds is not None
                          and b < len(bounds) else None)  # None = +Inf
                    moved.append({"le_ms": le, "count": int(delta[b])})
                row["evidence"] = {"window": "since_last_tick",
                                   "buckets_moved": moved}
            invokers.append(row)
        ewma = (sc[S_EWMA_MS][sc[S_TOTAL] > 0]
                if sc is not None else np.zeros(0))
        return {
            "enabled": True,
            "kernel": ("device" if self._state_kernel == "device"
                       else "cpu"),
            "config": {
                "alpha": self.config.alpha,
                "z_threshold": self.config.z_threshold,
                "spike_threshold": self.config.spike_threshold,
                "min_samples": self.config.min_samples,
                "mad_floor_ms": self.config.mad_floor_ms,
                "hint_unhealthy": self.config.hint_unhealthy,
            },
            "fleet": {
                "active_invokers": int(ewma.shape[0]),
                "median_ewma_ms": (round(float(np.median(ewma)), 4)
                                   if ewma.shape[0] else None),
            },
            "invokers": invokers,
        }
