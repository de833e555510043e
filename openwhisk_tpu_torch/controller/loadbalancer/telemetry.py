"""Fleet telemetry plane: per-invoker / per-namespace latency SLOs.

A copy of `openwhisk_tpu/controller/loadbalancer/telemetry.py`, except
that `use_device` takes the balancer's device.

The flight recorder answers "why did activation X land on invoker Y";
this plane answers the operator's other question — is the fleet meeting its
latency/error SLOs, and which invokers or tenants are burning the budget.
Every balancer reports completions through the shared base-class hook
(loadbalancer/base.py `process_completion`): the TPU balancer into a
device-resident accumulator (ops/telemetry.py, one scatter-add folded into
its dispatch cadence), the CPU balancers (sharding, lean) into the NumPy
twin — one telemetry surface regardless of backend.

Three read sides:
  1. `/metrics`: real Prometheus `histogram` families with cumulative `le`
     buckets, rendered from the accumulated counts at scrape time
     (controller/monitoring.py owns the exposition format).
  2. `GET /admin/slo`: compliance / error budget / burn rates against the
     `CONFIG_whisk_slo_*` targets, globally, per namespace (with overrides)
     and per invoker.
  3. burn-rate gauges (`slo_burn_rate_1m`, `slo_burn_rate_10m`,
     `slo_error_budget_remaining`) refreshed on the existing supervision
     tick — dashboards and alerts need no new scrape target.

Hot-path budget: observe() is two int increments, one dict lookup and one
list append (device path) or six array increments (NumPy path); burn-rate
math runs on the 1 Hz tick from HOST counters only (never a device sync).
Off-switch: `CONFIG_whisk_telemetry_enabled=false`; bucket count via
`CONFIG_whisk_telemetry_buckets` (log2-spaced from 1 ms).
"""
from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...ops.telemetry import (DEFAULT_BUCKETS, N_OUTCOMES, OUTCOME_ERROR,
                              OUTCOME_NAMES, OUTCOME_SUCCESS, OUTCOME_TIMEOUT,
                              NumpyLatencyAccumulator, bucket_bounds_ms)
from ...utils.config import load_config
from ...utils.eventlog import identity

#: burn-rate windows (seconds): the classic fast/slow alerting pair
FAST_WINDOW_S = 60.0
SLOW_WINDOW_S = 600.0

#: cap on buffered device-path events; past it the newest events drop
#: (counted) rather than growing the host buffer without bound
MAX_PENDING_EVENTS = 65536


@dataclass(frozen=True)
class TelemetryConfig:
    """`CONFIG_whisk_telemetry_*` env overrides."""
    enabled: bool = True
    buckets: int = DEFAULT_BUCKETS
    #: namespace rows (dedicated tenants + the shared overflow tail)
    namespaces: int = 256
    #: tail sub-range reserved for overflow namespaces (the shared-tail
    #: idiom: conflation stays among overflow tenants)
    shared_namespace_buckets: int = 32


@dataclass(frozen=True)
class SloConfig:
    """`CONFIG_whisk_slo_*` targets: end-to-end p99 latency and error
    ratio, with per-namespace overrides as a JSON dict, e.g.
    CONFIG_whisk_slo_overrides='{"guest": {"e2e_p99_ms": 250}}'."""
    e2e_p99_ms: float = 1000.0
    error_ratio: float = 0.01
    overrides: dict = field(default_factory=dict)


def _override(ov: dict, snake: str, camel: str, default: float) -> float:
    """Per-namespace override lookup tolerant of both key spellings (env
    JSON typically arrives camelCase like the env vars themselves)."""
    v = ov.get(snake, ov.get(camel, default))
    return float(v)


def _pctl_bucket(counts: np.ndarray, q: float) -> int:
    """Index of the bucket holding the q-quantile (cumulative walk)."""
    total = int(counts.sum())
    target = max(1, int(np.ceil(q * total)))
    cum = np.cumsum(counts)
    return int(np.searchsorted(cum, target, side="left"))


def judge_scope(buckets, outcomes, bounds: List[float],
                p99_target_ms: float, err_target: float) -> dict:
    """One scope's SLO verdict from raw bucket/outcome counts. Module
    level (no plane instance) so the fleet federation can re-judge
    burn/budget over MERGED histograms with exactly the math a single
    process uses — the judgment of the pooled counts, not a vote over
    per-process verdicts."""
    buckets = np.asarray(buckets)
    outcomes = np.asarray(outcomes)
    total = int(buckets.sum())
    bad = int(outcomes[OUTCOME_ERROR] + outcomes[OUTCOME_TIMEOUT])
    err_ratio = (bad / total) if total else 0.0
    # the SLO is judged at bucket granularity: the target rounds UP to
    # the bound of the bucket containing it (a 1000 ms target is judged
    # at le=1024) — comparing the p99 bucket's upper bound against the
    # raw target would silently tighten any non-power-of-two target to
    # the next LOWER bound and flag compliant fleets as violating
    eff_target = next((b for b in bounds if b >= p99_target_ms), None)
    if total:
        bi = _pctl_bucket(buckets, 0.99)
        p99 = bounds[bi] if bi < len(bounds) else None  # None: +Inf bucket
        latency_ok = p99 is not None and (eff_target is None
                                          or p99 <= eff_target)
    else:
        p99, latency_ok = None, True
    error_ok = err_ratio <= err_target
    budget = (max(0.0, 1.0 - err_ratio / max(err_target, 1e-9))
              if total else 1.0)
    return {
        "count": total,
        "outcomes": {OUTCOME_NAMES[k]: int(outcomes[k])
                     for k in range(N_OUTCOMES)},
        "p99_le_ms": p99,
        "latency_target_ms": p99_target_ms,
        "latency_target_le_ms": eff_target,
        "latency_compliant": bool(latency_ok),
        "error_ratio": round(err_ratio, 6),
        "error_ratio_target": err_target,
        "error_ratio_compliant": bool(error_ok),
        "error_budget_remaining": round(budget, 4),
        "compliant": bool(latency_ok and error_ok),
    }


class TelemetryPlane:
    """One per balancer (base-class hook), accumulator-backed."""

    def __init__(self, config: Optional[TelemetryConfig] = None,
                 slo: Optional[SloConfig] = None, accumulator=None):
        self.config = config or TelemetryConfig()
        self.slo = slo or SloConfig()
        self.enabled = self.config.enabled
        self.n_namespaces = max(8, int(self.config.namespaces))
        self.shared_tail = min(max(1, int(self.config.shared_namespace_buckets)),
                               self.n_namespaces // 2)
        self.accumulator = accumulator or NumpyLatencyAccumulator(
            1, self.n_namespaces, max(2, int(self.config.buckets)))
        self._ns_slots: Dict[str, int] = {}
        #: reverse map for exposition labels — a plain dict GET, because
        #: scrape worker threads render while the event loop registers new
        #: namespaces (iterating _ns_slots there would race)
        self._slot_ns: Dict[int, str] = {}
        #: device-path event buffer: (inv, ns_slot, lat_us, outcome).
        #: Two locks: _buf_lock guards the buffer swap (held microseconds,
        #: so the event loop's observe() never waits out a compile) and
        #: _fold_serial serializes accumulator folds between the event loop
        #: and scrape worker threads (the state swap is a read-modify-write
        #: a concurrent fold would silently lose).
        self._pending: List[Tuple[int, int, int, int]] = []
        self._buf_lock = threading.Lock()
        self._fold_serial = threading.Lock()
        self.dropped_events = 0
        # host running totals: burn-rate math never needs a device sync
        self._events_total = 0
        self._bad_total = 0
        #: (monotonic, events_total, bad_total) ring for windowed burn
        #: rates, seeded at boot so the first window is partial rather than
        #: blind to events that landed before the first tick
        self._snapshots: List[Tuple[float, int, int]] = [
            (time.monotonic(), 0, 0)]
        self._last_tick = 0.0

    @classmethod
    def from_config(cls) -> "TelemetryPlane":
        return cls(config=load_config(TelemetryConfig, env_path="telemetry"),
                   slo=load_config(SloConfig, env_path="slo"))

    # -- accumulator selection --------------------------------------------
    @property
    def SYNCS_DEVICE(self) -> bool:
        """True when reading counts forces a device->host sync (readers then
        run on a worker thread, like the occupancy endpoint)."""
        return getattr(self.accumulator, "kernel", "cpu") == "device"

    def use_device(self, n_invokers: int, device) -> None:
        """Swap in the device-resident accumulator on `device` (the TPU
        balancer's)."""
        if not self.enabled:
            return
        from ...ops.telemetry import DeviceLatencyAccumulator
        self.accumulator = DeviceLatencyAccumulator(
            max(1, n_invokers), self.n_namespaces,
            max(2, int(self.config.buckets)), device=device)

    # -- namespace rows ----------------------------------------------------
    def _ns_slot(self, ns_id: str) -> int:
        slot = self._ns_slots.get(ns_id)
        if slot is None:
            dedicated = self.n_namespaces - self.shared_tail
            if len(self._ns_slots) < dedicated:
                slot = len(self._ns_slots)
                self._ns_slots[ns_id] = slot
                self._slot_ns[slot] = ns_id
            else:
                # dedicated rows full: hash into the reserved shared tail
                # (NOT memoized — crc32 beats unbounded dict growth)
                slot = dedicated + (zlib.crc32(ns_id.encode())
                                    % self.shared_tail)
        return slot

    def _ns_label(self, slot: int) -> str:
        dedicated = self.n_namespaces - self.shared_tail
        if slot >= dedicated:
            return f"~shared{slot - dedicated}"
        return self._slot_ns.get(slot, f"~slot{slot}")

    # -- write side --------------------------------------------------------
    def observe(self, invoker_index: int, ns_id: str, latency_ms: float,
                outcome: int) -> None:
        """One completed activation. Device path: buffers the event row for
        the balancer's next fold; NumPy path: applies immediately."""
        if not self.enabled or invoker_index < 0:
            return
        self._events_total += 1
        if outcome != OUTCOME_SUCCESS:
            self._bad_total += 1
        lat_us = min(int(max(0.0, latency_ms) * 1000.0), 2 ** 31 - 1)
        slot = self._ns_slot(ns_id)
        acc = self.accumulator
        if acc.kernel == "cpu":
            acc.add(invoker_index, slot, lat_us, outcome)
        else:
            with self._buf_lock:
                if len(self._pending) < MAX_PENDING_EVENTS:
                    self._pending.append((invoker_index, slot, lat_us,
                                          outcome))
                else:
                    self.dropped_events += 1

    @property
    def pending(self) -> int:
        return len(self._pending)

    def device_fold(self, max_events: int = 4096) -> bool:
        """Drain buffered events into the device accumulator as ONE packed
        scatter-add (called from the TPU balancer's dispatch cadence).
        Power-of-two padding keeps the jit cache key count logarithmic."""
        with self._fold_serial:
            with self._buf_lock:
                if not self._pending:
                    return False
                take, self._pending = (self._pending[:max_events],
                                       self._pending[max_events:])
            b = 8
            while b < len(take):
                b *= 2
            ev = np.zeros((5, b), np.int32)
            ev[:4, : len(take)] = np.asarray(take, np.int32).T
            ev[4, : len(take)] = 1
            # fold outside the buffer lock: a first-shape fold pays an XLA
            # trace/compile, and observe() must keep appending while it runs
            self.accumulator.fold(ev)
        return True

    # -- read side ---------------------------------------------------------
    def bounds_ms(self) -> List[float]:
        return bucket_bounds_ms(self.accumulator.n_buckets)

    def counts(self) -> dict:
        """Accumulated arrays as host numpy (device sync on the TPU path —
        cold path only; callers off the event loop when SYNCS_DEVICE)."""
        if self._pending:
            self.device_fold(max_events=MAX_PENDING_EVENTS)
        return self.accumulator.counts()

    def prometheus_text(self, invoker_names: Optional[List[str]] = None,
                        openmetrics: bool = False) -> str:
        """The telemetry families in Prometheus exposition format — real
        `histogram` families with cumulative `le` buckets plus outcome
        counters (rendering in controller/monitoring.py)."""
        if not self.enabled:
            return ""
        from ..monitoring import counter_family_text, histogram_family_text
        c = self.counts()
        names = invoker_names or []

        def inv_name(i: int) -> str:
            return names[i] if i < len(names) else f"invoker{i}"

        bounds = self.bounds_ms()
        out: List[str] = []
        inv_rows = [(inv_name(i), c["inv_buckets"][i], c["inv_lat_ms"][i])
                    for i in range(c["inv_buckets"].shape[0])
                    if c["inv_buckets"][i].sum()]
        ns_rows = [(self._ns_label(s), c["ns_buckets"][s], c["ns_lat_ms"][s])
                   for s in range(c["ns_buckets"].shape[0])
                   if c["ns_buckets"][s].sum()]
        out += histogram_family_text(
            "openwhisk_invoker_activation_latency_seconds", "invoker",
            inv_rows, bounds)
        out += histogram_family_text(
            "openwhisk_namespace_activation_latency_seconds", "namespace",
            ns_rows, bounds)
        out += counter_family_text(
            "openwhisk_invoker_activation_outcomes_total",
            [({"invoker": inv_name(i), "outcome": OUTCOME_NAMES[k]},
              int(c["inv_outcomes"][i, k]))
             for i in range(c["inv_outcomes"].shape[0])
             for k in range(N_OUTCOMES) if c["inv_outcomes"][i, k]],
            openmetrics=openmetrics)
        out += counter_family_text(
            "openwhisk_namespace_activation_outcomes_total",
            [({"namespace": self._ns_label(s), "outcome": OUTCOME_NAMES[k]},
              int(c["ns_outcomes"][s, k]))
             for s in range(c["ns_outcomes"].shape[0])
             for k in range(N_OUTCOMES) if c["ns_outcomes"][s, k]],
            openmetrics=openmetrics)
        return "\n".join(out)

    # -- burn rates (host counters only) -----------------------------------
    def _burn_rate(self, window_s: float, now: float) -> float:
        """Error-budget burn rate over the trailing window: observed error
        ratio / target ratio (1.0 = burning exactly the budget)."""
        if not self._snapshots:
            return 0.0
        # latest snapshot at least window_s old; a partial window (process
        # younger than the window) falls back to the oldest snapshot
        base = self._snapshots[0]
        for snap in self._snapshots:
            if snap[0] <= now - window_s:
                base = snap
            else:
                break
        d_total = self._events_total - base[1]
        d_bad = self._bad_total - base[2]
        if d_total <= 0:
            return 0.0
        return (d_bad / d_total) / max(self.slo.error_ratio, 1e-9)

    def error_budget_remaining(self) -> float:
        """Cumulative (since boot) fraction of the error budget left."""
        if self._events_total <= 0:
            return 1.0
        consumed = (self._bad_total
                    / (max(self.slo.error_ratio, 1e-9) * self._events_total))
        return max(0.0, 1.0 - consumed)

    def tick(self, metrics=None, now: Optional[float] = None) -> dict:
        """Refresh burn-rate gauges; rides the supervision tick (TPU and
        sharding balancers) and the completion path (maybe_tick)."""
        if not self.enabled:
            return {}
        now = time.monotonic() if now is None else now
        self._last_tick = now
        if not self._snapshots or now - self._snapshots[-1][0] >= 1.0:
            self._snapshots.append((now, self._events_total, self._bad_total))
            cutoff = now - (SLOW_WINDOW_S + 60.0)
            while len(self._snapshots) > 2 and self._snapshots[0][0] < cutoff:
                self._snapshots.pop(0)
        vals = {
            "slo_burn_rate_1m": round(self._burn_rate(FAST_WINDOW_S, now), 4),
            "slo_burn_rate_10m": round(self._burn_rate(SLOW_WINDOW_S, now), 4),
            "slo_error_budget_remaining": round(
                self.error_budget_remaining(), 4),
        }
        if metrics is not None:
            for k, v in vals.items():
                metrics.gauge(k, v)
        return vals

    def maybe_tick(self, metrics=None) -> None:
        """Rate-limited tick for balancers without a supervision scheduler
        (lean): gauge freshness rides the completion stream."""
        if self.enabled and time.monotonic() - self._last_tick >= 1.0:
            self.tick(metrics)

    # -- SLO evaluation ----------------------------------------------------
    _pctl_bucket = staticmethod(_pctl_bucket)

    def _scope_report(self, buckets: np.ndarray, outcomes: np.ndarray,
                      p99_target_ms: float, err_target: float) -> dict:
        return judge_scope(buckets, outcomes, self.bounds_ms(),
                           p99_target_ms, err_target)

    def slo_report(self, invoker_names: Optional[List[str]] = None) -> dict:
        """The `/admin/slo` payload: global + per-namespace + per-invoker
        compliance against the configured targets. A device sync on the TPU
        path — callers run it on a worker thread (SYNCS_DEVICE)."""
        if not self.enabled:
            return {"enabled": False}
        now = time.monotonic()
        c = self.counts()
        names = invoker_names or []
        g = self._scope_report(c["ns_buckets"].sum(axis=0),
                               c["ns_outcomes"].sum(axis=0),
                               self.slo.e2e_p99_ms, self.slo.error_ratio)
        g["burn_rate_fast"] = round(self._burn_rate(FAST_WINDOW_S, now), 4)
        g["burn_rate_slow"] = round(self._burn_rate(SLOW_WINDOW_S, now), 4)
        namespaces = []
        for s in range(c["ns_buckets"].shape[0]):
            if not c["ns_buckets"][s].sum():
                continue
            ns = self._ns_label(s)
            ov = self.slo.overrides.get(ns, {}) or {}
            namespaces.append({"namespace": ns, **self._scope_report(
                c["ns_buckets"][s], c["ns_outcomes"][s],
                _override(ov, "e2e_p99_ms", "e2eP99Ms", self.slo.e2e_p99_ms),
                _override(ov, "error_ratio", "errorRatio",
                          self.slo.error_ratio))})
        invokers = []
        for i in range(c["inv_buckets"].shape[0]):
            if not c["inv_buckets"][i].sum():
                continue
            name = names[i] if i < len(names) else f"invoker{i}"
            invokers.append({"invoker": name, **self._scope_report(
                c["inv_buckets"][i], c["inv_outcomes"][i],
                self.slo.e2e_p99_ms, self.slo.error_ratio)})
        return {
            "enabled": True,
            "kernel": getattr(self.accumulator, "kernel", "cpu"),
            "targets": {"e2e_p99_ms": self.slo.e2e_p99_ms,
                        "error_ratio": self.slo.error_ratio},
            "windows_s": {"fast": FAST_WINDOW_S, "slow": SLOW_WINDOW_S},
            "buckets_le_ms": self.bounds_ms(),
            "dropped_events": self.dropped_events,
            "global": g,
            "namespaces": namespaces,
            "invokers": invokers,
        }

    def raw_counts(self, invoker_names: Optional[List[str]] = None) -> dict:
        """The exact-merge export behind `/admin/slo?raw=1`:
        bucket/outcome counts keyed by LABEL, not slot — namespace slot
        assignment is first-come-first-served per process, so slot-wise
        merging would pool different tenants. Shares `counts()`'s device
        sync caveat (SYNCS_DEVICE callers run on a worker thread)."""
        if not self.enabled:
            # disabled payload stays byte-identical to pre-federation
            # builds — the fleet mergers drop disabled members anyway
            return {"enabled": False}
        c = self.counts()
        names = invoker_names or []
        namespaces = {}
        for s in range(c["ns_buckets"].shape[0]):
            if not c["ns_buckets"][s].sum():
                continue
            namespaces[self._ns_label(s)] = {
                "buckets": [int(v) for v in c["ns_buckets"][s]],
                "outcomes": [int(v) for v in c["ns_outcomes"][s]],
                "lat_ms": float(c["ns_lat_ms"][s]),
            }
        invokers = {}
        for i in range(c["inv_buckets"].shape[0]):
            if not c["inv_buckets"][i].sum():
                continue
            name = names[i] if i < len(names) else f"invoker{i}"
            invokers[name] = {
                "buckets": [int(v) for v in c["inv_buckets"][i]],
                "outcomes": [int(v) for v in c["inv_outcomes"][i]],
                "lat_ms": float(c["inv_lat_ms"][i]),
            }
        return {
            "identity": identity(),
            "enabled": True,
            "kernel": getattr(self.accumulator, "kernel", "cpu"),
            "buckets": int(self.accumulator.n_buckets),
            "targets": {"e2e_p99_ms": self.slo.e2e_p99_ms,
                        "error_ratio": self.slo.error_ratio},
            "overrides": dict(self.slo.overrides),
            "dropped_events": self.dropped_events,
            "namespaces": namespaces,
            "invokers": invokers,
        }
