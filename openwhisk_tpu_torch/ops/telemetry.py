"""On-device fleet telemetry: latency histograms + outcome counters.

The counterpart of `openwhisk_tpu/ops/telemetry.py`. The host-side
MetricEmitter keeps one Python dict update per activation — fine for a
laptop, unusable for per-invoker x per-namespace resolution at the
64k-invoker north star. This module keeps the telemetry the same way the
placement decision is kept: as dense device tensors updated by one
vectorized scatter-add per micro-batch, folded into the balancer's
dispatch/readback cycle (the event rows ride the same flush cadence as the
release fold, so no extra host<->device transfer shows up per activation).

State (static shapes; fleets grow into padding like PlacementState):

  inv_buckets  int32[N, B]  latency bucket counts per invoker
  ns_buckets   int32[M, B]  latency bucket counts per namespace slot
  inv_lat_ms   float32[N]   latency sum per invoker (Prometheus `_sum`)
  ns_lat_ms    float32[M]
  inv_outcomes int32[N, K]  completions per invoker by outcome
  ns_outcomes  int32[M, K]

Buckets are log2-spaced: bucket i counts latencies in (2^(i-1), 2^i] ms,
bucket 0 is <= 1 ms and the last bucket is the +Inf overflow — cumulative
`le` rendering happens host-side at scrape time (controller/monitoring.py).
Bucket assignment is integer-exact (comparisons against precomputed
microsecond bounds, no float log), so a 4.000 ms sample always lands in
`le=4`, never in a neighbouring bucket via rounding.

`record_packed` never writes a state in place: every fold returns a NEW
`TelemetryState`, as the JAX program does. A reader that took a reference
to the state (a scrape on a worker thread) therefore copies six tensors
that no later fold touches — one consistent snapshot while folds go on.

`NumpyLatencyAccumulator` is the host twin with the same bucket math: the
parity oracle of the device accumulator.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

#: completion outcome axis
OUTCOME_SUCCESS, OUTCOME_ERROR, OUTCOME_TIMEOUT = range(3)
N_OUTCOMES = 3
OUTCOME_NAMES = ("success", "error", "timeout")

DEFAULT_BUCKETS = 24

#: packed event-row layout (one int32[5, E] matrix per fold)
E_INV, E_NS, E_LAT_US, E_OUTCOME, E_VALID = range(5)

#: the largest latency a sample may carry, in microseconds (int32 max)
LAT_US_MAX = 2 ** 31 - 1


def bucket_bounds_ms(n_buckets: int = DEFAULT_BUCKETS) -> List[float]:
    """Finite upper bounds in ms: 1, 2, 4, ... 2^(n-2); the implicit last
    bucket is +Inf."""
    return [float(2 ** i) for i in range(max(1, n_buckets - 1))]


def _bounds_us(n_buckets: int) -> np.ndarray:
    """Bucket bounds in int32-safe microseconds. Samples are clipped to
    int32 max (~35.8 min) on the way in, so bounds past that saturate too:
    everything above lands in the first saturated bucket, identically on
    the device and NumPy paths."""
    return np.asarray(
        [min(1000 * 2 ** i, 2 ** 31 - 1)
         for i in range(max(1, n_buckets - 1))], np.int64)


def bucket_of_us(lat_us, n_buckets: int):
    """Exact bucket index for integer microsecond latencies (numpy in,
    numpy out): the first bucket whose bound covers the sample."""
    bounds = _bounds_us(n_buckets)
    return np.searchsorted(bounds, np.asarray(lat_us, np.int64),
                           side="left").astype(np.int64)


class TelemetryState(NamedTuple):
    inv_buckets: torch.Tensor   # int32[N, B]
    ns_buckets: torch.Tensor    # int32[M, B]
    inv_lat_ms: torch.Tensor    # float32[N]
    ns_lat_ms: torch.Tensor     # float32[M]
    inv_outcomes: torch.Tensor  # int32[N, K]
    ns_outcomes: torch.Tensor   # int32[M, K]


def init_telemetry(n_invokers: int, n_namespaces: int,
                   n_buckets: int = DEFAULT_BUCKETS, *,
                   device) -> TelemetryState:
    """Zeroed accumulators on `device` (no default: the caller names it)."""
    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return TelemetryState(
        z(n_invokers, n_buckets), z(n_namespaces, n_buckets),
        z(n_invokers, dtype=torch.float32),
        z(n_namespaces, dtype=torch.float32),
        z(n_invokers, N_OUTCOMES), z(n_namespaces, N_OUTCOMES))


def record_packed(state: TelemetryState, ev: torch.Tensor,
                  bounds: torch.Tensor) -> TelemetryState:
    """Six scatter-adds over a packed int32[5, E] event matrix (inv_idx,
    ns_slot, latency_us, outcome, valid) on the state's device, as the JAX
    package's `make_record_packed` program: the same integer-exact bucket
    (the number of `bounds` a sample exceeds; `bounds` is `_bounds_us` as
    int32 on the same device), the same clips, and
    `lat_ms = valid * float(lat_us) * 1e-3` in that order. Invalid
    (padding) rows scatter zeros. Duplicate indices accumulate
    (`index_put` with `accumulate=True`). Returns a NEW state; the old
    one is left as it was."""
    inv, ns, lat_us, outcome, valid = ev.unbind(0)
    n_inv = state.inv_buckets.shape[0]
    n_ns = state.ns_buckets.shape[0]
    b = (lat_us[:, None] > bounds[None, :]).sum(dim=1)
    v = valid.to(torch.int32)
    inv = inv.clamp(0, n_inv - 1).long()
    ns = ns.clamp(0, n_ns - 1).long()
    k = outcome.clamp(0, N_OUTCOMES - 1).long()
    lat_ms = valid * lat_us.to(torch.float32) * 1e-3
    return TelemetryState(
        state.inv_buckets.index_put((inv, b), v, accumulate=True),
        state.ns_buckets.index_put((ns, b), v, accumulate=True),
        state.inv_lat_ms.index_put((inv,), lat_ms, accumulate=True),
        state.ns_lat_ms.index_put((ns,), lat_ms, accumulate=True),
        state.inv_outcomes.index_put((inv, k), v, accumulate=True),
        state.ns_outcomes.index_put((ns, k), v, accumulate=True),
    )


def _grow_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    out[: t.shape[0]] = t
    return out


class DeviceLatencyAccumulator:
    """Device-resident accumulator for the TPU balancer: fold() enqueues
    the scatter-add asynchronously (no readback — counts stay on the device
    until a scrape), counts() is the cold-path device->host sync."""

    kernel = "device"

    def __init__(self, n_invokers: int, n_namespaces: int,
                 n_buckets: int = DEFAULT_BUCKETS, *, device):
        self.device = torch.device(device)
        self.n_buckets = n_buckets
        self.n_namespaces = n_namespaces
        self.n_invokers = max(1, n_invokers)
        self.state = init_telemetry(self.n_invokers, n_namespaces, n_buckets,
                                    device=self.device)
        #: the bucket bounds in microseconds, int32 on the device
        self.bounds = torch.from_numpy(
            _bounds_us(n_buckets).astype(np.int32)).to(self.device)
        #: folds enqueued (each one scatter-add program)
        self.folds = 0

    def ensure_invokers(self, n: int) -> None:
        """Grow the invoker axis to the next power of two >= n on the
        device, preserving accumulated counts (mirrors the balancer's
        padding growth). No host round trip."""
        if n <= self.n_invokers:
            return
        new_n = 1
        while new_n < n:
            new_n *= 2
        st = self.state
        self.state = TelemetryState(
            _grow_rows(st.inv_buckets, new_n), st.ns_buckets,
            _grow_rows(st.inv_lat_ms, new_n), st.ns_lat_ms,
            _grow_rows(st.inv_outcomes, new_n), st.ns_outcomes)
        self.n_invokers = new_n

    def _to_device(self, events: np.ndarray) -> torch.Tensor:
        """The host event matrix on the device: through pinned memory with
        an asynchronous copy on the card (a pageable copy is a blocking
        cudaMemcpy that waits behind every step in flight)."""
        t = torch.from_numpy(np.ascontiguousarray(events, np.int32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def fold(self, events: np.ndarray) -> None:
        """events: int32[5, E] packed rows (already padded by the caller)."""
        self.ensure_invokers(int(events[E_INV].max(initial=0)) + 1)
        self.state = record_packed(self.state, self._to_device(events),
                                   self.bounds)
        self.folds += 1

    def counts(self) -> dict:
        """Device->host sync of every accumulator array (cold path: one
        scrape or SLO evaluation, run off the event loop by callers). The
        state is read once, so the six arrays are one snapshot."""
        st = self.state
        return {f: getattr(st, f).cpu().numpy()
                for f in TelemetryState._fields}


class NumpyLatencyAccumulator:
    """Host twin with identical bucket math. add() is the O(1)
    per-completion fast path; fold() accepts the same packed matrix as the
    device accumulator (the parity oracle)."""

    kernel = "cpu"

    def __init__(self, n_invokers: int, n_namespaces: int,
                 n_buckets: int = DEFAULT_BUCKETS):
        self.n_buckets = n_buckets
        self.n_namespaces = n_namespaces
        self.n_invokers = max(1, n_invokers)
        self._bounds_us = _bounds_us(n_buckets)
        z = np.zeros
        self.inv_buckets = z((self.n_invokers, n_buckets), np.int64)
        self.ns_buckets = z((n_namespaces, n_buckets), np.int64)
        self.inv_lat_ms = z((self.n_invokers,), np.float64)
        self.ns_lat_ms = z((n_namespaces,), np.float64)
        self.inv_outcomes = z((self.n_invokers, N_OUTCOMES), np.int64)
        self.ns_outcomes = z((n_namespaces, N_OUTCOMES), np.int64)

    def ensure_invokers(self, n: int) -> None:
        if n <= self.n_invokers:
            return
        new_n = 1
        while new_n < n:
            new_n *= 2
        for name in ("inv_buckets", "inv_outcomes"):
            old = getattr(self, name)
            grown = np.zeros((new_n, old.shape[1]), old.dtype)
            grown[: old.shape[0]] = old
            setattr(self, name, grown)
        lat = np.zeros((new_n,), np.float64)
        lat[: self.inv_lat_ms.shape[0]] = self.inv_lat_ms
        self.inv_lat_ms = lat
        self.n_invokers = new_n

    def add(self, inv: int, ns_slot: int, lat_us: int, outcome: int) -> None:
        self.ensure_invokers(inv + 1)
        ns_slot = min(max(ns_slot, 0), self.n_namespaces - 1)
        outcome = min(max(outcome, 0), N_OUTCOMES - 1)
        b = int(np.searchsorted(self._bounds_us, lat_us, side="left"))
        self.inv_buckets[inv, b] += 1
        self.ns_buckets[ns_slot, b] += 1
        self.inv_lat_ms[inv] += lat_us * 1e-3
        self.ns_lat_ms[ns_slot] += lat_us * 1e-3
        self.inv_outcomes[inv, outcome] += 1
        self.ns_outcomes[ns_slot, outcome] += 1

    def fold(self, events: np.ndarray) -> None:
        for col in events.T:
            if col[E_VALID]:
                self.add(int(col[E_INV]), int(col[E_NS]),
                         int(col[E_LAT_US]), int(col[E_OUTCOME]))

    def counts(self) -> dict:
        return {f: getattr(self, f).copy()
                for f in TelemetryState._fields}
