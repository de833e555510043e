"""Placement quality plane: regret, imbalance, shadow counterfactuals.

A copy of `openwhisk_tpu/controller/loadbalancer/quality.py`, except
that `use_device` takes the balancer's device and `counts` reads the
accumulator through `host_state` (the port's state is torch tensors).

Telemetry measures realized latency and anomaly scores invokers; this
plane measures whether the placement DECISIONS are good. It scores every
committed micro-batch on the device (ops/decision_quality.py) against the
predictive signals the balancer already holds — per-invoker latency EWMAs
from the anomaly plane and the post-commit capacity books — and, every K
batches, runs the anomaly-penalty-augmented probe geometry as a
decision-only SHADOW pass over the same inputs and diffs it against
production: how much predicted latency the current geometry leaves on the
table (regret), and how differently the penalized geometry would have
placed (divergence).

Wiring mirrors the other planes (base-class hook):
  * TPU balancer: `use_device()` allocates the device `QualityState` and
    the scorer; the balancer dispatches the scorer right after the
    production step and feeds the per-batch summary row back through
    `note_summary()` from the readback worker, with the step's own
    readback (never a device sync on the API path).
  * CPU balancers (sharding, lean): `observe_decision()` rides the
    `record_placement` hook — attribution counters only, since those
    balancers hold no post-commit books or EWMAs at that point.

Read sides: three `/metrics` families
(`openwhisk_loadbalancer_placement_regret` histogram on the telemetry
bucket grid, `openwhisk_loadbalancer_decision_divergence_total` per
invoker, `openwhisk_loadbalancer_fleet_imbalance` gauge), the auth-gated
`GET /admin/placement/quality` report, and a `raw_counts()` export the
fleet federation merges bucket-wise bit-exactly.

Off-switch: `CONFIG_whisk_placementQuality_enabled` (default OFF: fleets
that have not opted in pay nothing); `CONFIG_whisk_placementQuality_
shadowEveryN` sets the shadow cadence (0 keeps regret scoring on with no
shadow pass). Disabled is a true no-op: nothing allocates, every entry
point returns immediately, and production decisions are bit-exact either
way — the shadow pass never writes the live books.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from ...ops.decision_quality import (C_FORCED, C_PLACED, C_ROWS,
                                     C_THROTTLED, C_UNPLACED, COUNTERS,
                                     N_SUMMARY, S_IMBALANCE_COV, S_ROWS,
                                     QualityState, host_state,
                                     init_quality_state, make_quality_step)
from ...ops.telemetry import DEFAULT_BUCKETS, bucket_bounds_ms
from ...utils.config import load_config
from ...utils.eventlog import identity


@dataclass(frozen=True)
class QualityConfig:
    """`CONFIG_whisk_placementQuality_*` env overrides."""
    #: default OFF: the plane is opt-in
    enabled: bool = False
    #: shadow counterfactual cadence (every N micro-batches; 0 = regret
    #: scoring only, no shadow pass)
    shadow_every_n: int = 16
    #: regret histogram buckets (telemetry log2 grid, so the fleet
    #: federation can merge regret and latency histograms the same way)
    buckets: int = DEFAULT_BUCKETS


class QualityPlane:
    """One per balancer (base-class hook, like the other four planes)."""

    def __init__(self, config: Optional[QualityConfig] = None):
        self.config = config or QualityConfig()
        self.enabled = self.config.enabled
        self.n_buckets = max(2, int(self.config.buckets))
        # attached collaborators (base-class wiring)
        self._anomaly = None
        self._names_fn: Optional[Callable[[], List[str]]] = None
        # accumulator state: allocated lazily (disabled allocates nothing)
        self._qstate: Optional[QualityState] = None
        self._kernel = "cpu"
        self._step = None
        #: host aggregates fed by note_summary() from readback workers
        #: while tick()/reports read on other threads — tiny critical
        #: sections under one lock, never a device handle inside
        self._lock = threading.Lock()
        self._batches = 0
        self._shadow_batches = 0
        self._rows_total = 0
        self._regret_sum_ms = 0.0
        self._divergent_total = 0
        self._shadow_rows_total = 0
        self._last_imbalance = 0.0
        self._last_summary: Optional[List[float]] = None
        self._last_tick = 0.0

    @classmethod
    def from_config(cls) -> "QualityPlane":
        return cls(config=load_config(QualityConfig,
                                      env_path="placement_quality"))

    def attach(self, anomaly=None,
               invoker_names: Optional[Callable[[], List[str]]] = None
               ) -> None:
        """Wire the plane to its collaborators (called by the balancer
        base class; harmless when disabled — nothing allocates)."""
        self._anomaly = anomaly
        self._names_fn = invoker_names

    @property
    def SYNCS_DEVICE(self) -> bool:
        """True when reading the accumulated state forces a device->host
        sync (report callers then use a worker thread, like /admin/slo)."""
        return self._kernel == "device"

    @property
    def shadow_every_n(self) -> int:
        return max(0, int(self.config.shadow_every_n))

    # -- device path (TPU balancer) ---------------------------------------
    def use_device(self, n_pad: int, transposed: bool = False,
                   device=None) -> None:
        """Allocate the QualityState on `device` (the balancer's; None
        means the card) and build the scorer. `transposed` follows the
        conc layout the scorer is handed ([A, N] or [N, A])."""
        if not self.enabled:
            return
        self._qstate = init_quality_state(max(1, n_pad), self.n_buckets,
                                          device=device)
        self._step = make_quality_step(self.n_buckets, transposed=transposed)
        self._kernel = "device"

    def device_step(self, free_post, conc_post, health, ewma_ms, cap_mb,
                    req, out_vec, shadow_vec=None):
        """Dispatch one scoring step on the balancer's dispatch thread
        (async — reads possibly-in-flight device buffers, writes only the
        plane's own state). Returns the summary device array; the caller
        hands it to the readback worker, which resolves it alongside the
        books it already pulls and calls note_summary()."""
        if not self.enabled or self._step is None:
            return None
        self._qstate, summary = self._step(
            self._qstate, free_post, conc_post, health, ewma_ms, cap_mb,
            req, out_vec, shadow_vec)
        return summary

    def note_summary(self, summary) -> None:
        """Fold one resolved per-batch summary row into the host
        aggregates (readback worker thread; `summary` is host numpy)."""
        if not self.enabled or summary is None:
            return
        s = np.asarray(summary, np.float32)
        if s.shape[0] < N_SUMMARY:
            return
        from ...ops.decision_quality import (S_DIVERGENT, S_REGRET_SUM_MS,
                                             S_SHADOW_ROWS)
        with self._lock:
            self._batches += 1
            self._rows_total += int(s[S_ROWS])
            self._regret_sum_ms += float(s[S_REGRET_SUM_MS])
            self._last_imbalance = float(s[S_IMBALANCE_COV])
            self._last_summary = [round(float(v), 6) for v in s]
            if s[S_SHADOW_ROWS] > 0:
                self._shadow_batches += 1
                self._shadow_rows_total += int(s[S_SHADOW_ROWS])
                self._divergent_total += int(s[S_DIVERGENT])

    # -- CPU path (record_placement hook) ---------------------------------
    def observe_decision(self, placed: bool, forced: bool,
                         throttled: bool) -> None:
        """Attribution counters for the CPU balancers (no books or EWMAs
        at the hook, so no regret — documented scope)."""
        if not self.enabled or self._kernel != "cpu":
            return
        if self._qstate is None:
            self._qstate = init_quality_state(1, self.n_buckets, numpy=True)
        ctr = self._qstate.counters
        ctr[C_ROWS] += 1
        if throttled:
            ctr[C_THROTTLED] += 1
        elif placed:
            ctr[C_PLACED] += 1
            if forced:
                ctr[C_FORCED] += 1
        else:
            ctr[C_UNPLACED] += 1

    # -- supervision tick (host aggregates only, never a device sync) -----
    def tick(self, metrics=None, now: Optional[float] = None) -> dict:
        if not self.enabled:
            return {}
        self._last_tick = time.monotonic() if now is None else now
        with self._lock:
            vals = {
                "placement_quality_batches": self._batches,
                "placement_fleet_imbalance": round(self._last_imbalance, 4),
                "placement_shadow_divergence_ratio": round(
                    self._divergent_total
                    / max(1, self._shadow_rows_total), 6),
            }
        if metrics is not None:
            for k, v in vals.items():
                metrics.gauge(f"loadbalancer_{k}", v)
        return vals

    def maybe_tick(self, metrics=None) -> None:
        """Rate-limited tick for balancers without a supervision
        scheduler (lean): freshness rides the completion stream."""
        if self.enabled and time.monotonic() - self._last_tick >= 1.0:
            self.tick(metrics)

    # -- read side ---------------------------------------------------------
    def counts(self) -> Optional[dict]:
        """Accumulated arrays as host numpy (device sync on the TPU path
        — cold path only; callers off the event loop when SYNCS_DEVICE)."""
        qs = host_state(self._qstate)
        if not self.enabled or qs is None:
            return None
        return {
            "regret_hist": np.asarray(qs.regret_hist, np.int64),
            "counters": np.asarray(qs.counters, np.int64),
            "inv_regret_ms": np.asarray(qs.inv_regret_ms, np.float64),
            "inv_divergence": np.asarray(qs.inv_divergence, np.int64),
        }

    def bounds_ms(self) -> List[float]:
        return bucket_bounds_ms(self.n_buckets)

    def prometheus_text(self, invoker_names: Optional[List[str]] = None,
                        openmetrics: bool = False) -> str:
        """The three quality families (rendering in monitoring.py). Reads
        the state reference once — the dispatch thread replaces it
        wholesale, never mutates it in place (device path)."""
        if not self.enabled:
            return ""
        from ..monitoring import (counter_family_text, gauge_family_text,
                                  histogram_family_text)
        c = self.counts()
        out: List[str] = []
        if c is not None and int(c["regret_hist"].sum()) > 0:
            out += histogram_family_text(
                "openwhisk_loadbalancer_placement_regret", "scope",
                [("fleet", c["regret_hist"],
                  float(c["inv_regret_ms"].sum()))],
                self.bounds_ms())
        if c is not None:
            names = invoker_names or []

            def inv_name(i: int) -> str:
                return names[i] if i < len(names) else f"invoker{i}"

            out += counter_family_text(
                "openwhisk_loadbalancer_decision_divergence_total",
                [({"invoker": inv_name(i)}, int(v))
                 for i, v in enumerate(c["inv_divergence"]) if v > 0],
                openmetrics=openmetrics)
        with self._lock:
            imb = self._last_imbalance
        out += gauge_family_text(
            "openwhisk_loadbalancer_fleet_imbalance",
            [({"scope": "fleet"}, round(imb, 6))])
        return "\n".join(out)

    def quality_report(self, invoker_names: Optional[List[str]] = None
                       ) -> dict:
        """The `GET /admin/placement/quality` payload. A device sync on
        the TPU path — callers run it on a worker thread (SYNCS_DEVICE)."""
        if not self.enabled:
            return {"enabled": False}
        from ..monitoring import _pctl_from_hist
        c = self.counts()
        names = invoker_names or []
        with self._lock:
            host = {
                "batches": self._batches,
                "shadow_batches": self._shadow_batches,
                "rows": self._rows_total,
                "regret_sum_ms": round(self._regret_sum_ms, 3),
                "divergent_rows": self._divergent_total,
                "shadow_rows": self._shadow_rows_total,
                "divergence_ratio": round(
                    self._divergent_total / max(1, self._shadow_rows_total),
                    6),
                "fleet_imbalance_cov": round(self._last_imbalance, 6),
                "last_batch": self._last_summary,
            }
        report = {
            "enabled": True,
            "kernel": self._kernel,
            "config": {"shadow_every_n": self.shadow_every_n,
                       "buckets": self.n_buckets},
            "buckets_le_ms": self.bounds_ms(),
            **host,
        }
        if c is not None:
            bounds = self.bounds_ms()
            hist = c["regret_hist"]
            bi = _pctl_from_hist([int(v) for v in hist], 0.99)
            report["regret_hist"] = [int(v) for v in hist]
            report["regret_p99_le_ms"] = (bounds[bi] if bi < len(bounds)
                                          else None)  # None: +Inf bucket
            report["counters"] = {name: int(c["counters"][i])
                                  for i, name in enumerate(COUNTERS)}
            invokers = []
            for i in range(c["inv_regret_ms"].shape[0]):
                reg = float(c["inv_regret_ms"][i])
                div = int(c["inv_divergence"][i])
                if reg <= 0.0 and div <= 0:
                    continue
                invokers.append({
                    "invoker": (names[i] if i < len(names)
                                else f"invoker{i}"),
                    "regret_ms": round(reg, 3),
                    "divergent_rows": div,
                })
            report["invokers"] = invokers
        return report

    def raw_counts(self, invoker_names: Optional[List[str]] = None) -> dict:
        """The exact-merge export behind `/admin/placement/quality?raw=1`:
        histogram + counters merge positionally,
        per-invoker series by LABEL. Shares counts()'s device-sync caveat."""
        if not self.enabled:
            return {"enabled": False}
        c = self.counts()
        names = invoker_names or []
        invokers = {}
        if c is not None:
            for i in range(c["inv_regret_ms"].shape[0]):
                reg = float(c["inv_regret_ms"][i])
                div = int(c["inv_divergence"][i])
                if reg <= 0.0 and div <= 0:
                    continue
                name = names[i] if i < len(names) else f"invoker{i}"
                invokers[name] = {"regret_ms": reg, "divergence": div}
        with self._lock:
            host = {
                "batches": self._batches,
                "shadow_batches": self._shadow_batches,
                "divergent_rows": self._divergent_total,
                "shadow_rows": self._shadow_rows_total,
                "regret_sum_ms": float(self._regret_sum_ms),
                "fleet_imbalance_cov": float(self._last_imbalance),
            }
        return {
            "identity": identity(),
            "enabled": True,
            "kernel": self._kernel,
            "buckets": self.n_buckets,
            "regret_hist": ([int(v) for v in c["regret_hist"]]
                            if c is not None else [0] * self.n_buckets),
            "counters": ([int(v) for v in c["counters"]]
                         if c is not None else [0] * len(COUNTERS)),
            "counter_names": list(COUNTERS),
            "invokers": invokers,
            **host,
        }
