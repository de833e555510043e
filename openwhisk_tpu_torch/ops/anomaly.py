"""On-device anomaly & straggler detection over the telemetry deltas.

The counterpart of `openwhisk_tpu/ops/anomaly.py`. The telemetry
accumulator (ops/telemetry.py) keeps per-invoker latency bucket counts,
latency sums and outcome counters as dense device tensors. This module
turns those *cumulative* counters into per-tick *signals*, computed where
the data lives — one program vectorized over the invoker axis, no
per-invoker host loop:

  1. The step takes the deltas of (bucket counts, latency sum, outcomes)
     since the previous tick and folds each invoker's per-tick mean latency
     into an EWMA mean/variance pair.
  2. A robust z-score compares every invoker's EWMA latency against the
     fleet median, scaled by the median absolute deviation (the classic
     0.6745·(x-med)/MAD estimator) — the *straggler score*. MAD is floored
     (absolute + relative) so a tightly-clustered fleet does not flag
     micro-jitter as straggling.
  3. Error/timeout *spike scores* are one-proportion z-tests of this tick's
     error rate against the pre-tick EWMA baseline, weighted by sqrt of the
     tick's sample count — a burst of errors scores high, a steady (already
     EWMA-absorbed) error floor does not; sustained burn is the SLO
     burn-rate alert's job, not this detector's.
  4. Boolean straggler/anomaly flags gate on a minimum cumulative sample
     count so a cold invoker's first noisy samples cannot flag it.

`make_anomaly_step` builds the torch step: elementwise ops, `torch.where`
and two masked medians by `torch.sort`. The median's index is a device
scalar read with `index_select`, so the step never asks the host for a
value (no `.item()`, `int(t)`, `bool(t)` or `.tolist()`): it enqueues and
returns. `anomaly_step_np` and `_masked_median_np` are copies of the JAX
package's NumPy twin, the parity oracle.

The step's outputs come back as ONE packed float32[N_SCORE_ROWS, N] matrix
(one transfer per tick, harvested a tick late on the device path so the
supervision tick never blocks on a device sync).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .telemetry import N_OUTCOMES, OUTCOME_ERROR, OUTCOME_TIMEOUT

#: normal-consistency constant: MAD * 1/0.6745 estimates sigma
MAD_SCALE = 0.6745

#: relative MAD floor: the scale never drops below this fraction of the
#: fleet median, so a near-identical fleet doesn't z-score its own jitter
REL_MAD_FLOOR = 0.05

#: denominator guard for the spike z-test when the EWMA baseline is 0
SPIKE_EPS = 0.05

#: scores are clipped here — a zero-MAD fleet with a floor of 0 would
#: otherwise emit inf/NaN into gauges and JSON
SCORE_CLIP = 1e6

#: packed score-matrix row layout (float32[N_SCORE_ROWS, N])
(S_STRAGGLER, S_ERR_SPIKE, S_TM_SPIKE, S_STRAGGLER_FLAG, S_ANOMALY_FLAG,
 S_EWMA_MS, S_TOTAL) = range(7)
N_SCORE_ROWS = 7


class AnomalyState(NamedTuple):
    """Carry between ticks. prev_* are the cumulative telemetry counters at
    the last tick (deltas form against them; prev_buckets doubles as the
    evidence baseline for `/admin/anomalies`); ewma_* are the running
    estimates; ticks counts ticks-with-traffic per invoker."""
    prev_buckets: object   # int32[N, B]
    prev_lat_ms: object    # float32[N]
    prev_outcomes: object  # int32[N, K]
    ewma_ms: object        # float32[N]
    ewma_var: object       # float32[N]
    ewma_err: object       # float32[N]
    ewma_tm: object        # float32[N]
    ticks: object          # float32[N]


def init_anomaly(n_invokers: int, n_buckets: int, *,
                 device) -> AnomalyState:
    """Zeroed carry on `device` (no default: the caller names it)."""
    n = max(1, n_invokers)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return AnomalyState(z(n, n_buckets, dtype=torch.int32), z(n),
                        z(n, N_OUTCOMES, dtype=torch.int32),
                        z(n), z(n), z(n), z(n), z(n))


def init_anomaly_np(n_invokers: int, n_buckets: int) -> AnomalyState:
    """NumPy twin of init_anomaly (host state for the CPU balancers)."""
    n = max(1, n_invokers)
    return AnomalyState(
        np.zeros((n, n_buckets), np.int64),
        np.zeros((n,), np.float64),
        np.zeros((n, N_OUTCOMES), np.int64),
        np.zeros((n,), np.float64),
        np.zeros((n,), np.float64),
        np.zeros((n,), np.float64),
        np.zeros((n,), np.float64),
        np.zeros((n,), np.float64),
    )


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The median of `x` over `mask` as a 0-d device tensor (0 when the
    mask is empty): sort with the masked-out entries at +inf, then gather
    the two middle entries by device-side index."""
    n = mask.sum()
    s = torch.sort(torch.where(mask, x, torch.inf)).values
    cap = x.shape[0] - 1
    mid = torch.stack([((n - 1) // 2).clamp(0, cap), (n // 2).clamp(0, cap)])
    lo, hi = s.index_select(0, mid).unbind(0)
    return torch.where(n > 0, 0.5 * (lo + hi), 0.0)


def make_anomaly_step(alpha: float, z_threshold: float,
                      spike_threshold: float, min_samples: int,
                      mad_floor_ms: float):
    """Build the per-tick step. Thresholds are fixed at build time (they
    come from frozen config, never change at runtime). The float32
    constants are rounded to float32 once, as the JAX program holds them."""
    f32 = np.float32
    a = float(f32(alpha))
    one_minus_a = float(f32(1) - f32(alpha))
    mad_floor = float(f32(mad_floor_ms))
    F = torch.float32

    def step(state: AnomalyState, inv_buckets, inv_lat_ms, inv_outcomes
             ) -> Tuple[AnomalyState, torch.Tensor]:
        count = inv_buckets.sum(dim=1).to(F)
        prev_count = state.prev_buckets.sum(dim=1).to(F)
        d_count = count - prev_count
        d_lat = inv_lat_ms.to(F) - state.prev_lat_ms
        d_err = (inv_outcomes[:, OUTCOME_ERROR]
                 - state.prev_outcomes[:, OUTCOME_ERROR]).to(F)
        d_tm = (inv_outcomes[:, OUTCOME_TIMEOUT]
                - state.prev_outcomes[:, OUTCOME_TIMEOUT]).to(F)

        active = d_count > 0
        safe = d_count.clamp_min(1.0)
        x = torch.where(active, d_lat / safe, 0.0)     # mean latency, ms
        er = torch.where(active, d_err / safe, 0.0)    # error rate this tick
        tr = torch.where(active, d_tm / safe, 0.0)

        first = active & (state.ticks == 0)
        # EWMA of mean/variance, seeded at the first sample (a zero seed
        # would make every young invoker look like it just got 'slower')
        base_m = torch.where(first, x, state.ewma_ms)
        m_new = torch.where(first, x,
                            one_minus_a * state.ewma_ms + a * x)
        dev = x - base_m
        v_new = torch.where(first, 0.0,
                            one_minus_a * state.ewma_var + a * dev * dev)
        # spike z-tests run against the PRE-tick baseline: a burst must be
        # judged before the EWMA has absorbed it
        e_base = torch.where(first, er, state.ewma_err)
        t_base = torch.where(first, tr, state.ewma_tm)
        e_new = torch.where(first, er, one_minus_a * state.ewma_err + a * er)
        t_new = torch.where(first, tr, one_minus_a * state.ewma_tm + a * tr)

        ewma_ms = torch.where(active, m_new, state.ewma_ms)
        ewma_var = torch.where(active, v_new, state.ewma_var)
        ewma_err = torch.where(active, e_new, state.ewma_err)
        ewma_tm = torch.where(active, t_new, state.ewma_tm)
        ticks = state.ticks + active.to(F)

        ever = count > 0
        med = _masked_median(ewma_ms, ever)
        mad = _masked_median((ewma_ms - med).abs(), ever)
        scale = torch.maximum(mad.clamp_min(mad_floor),
                              REL_MAD_FLOOR * med.abs())
        straggler = torch.where(ever, MAD_SCALE * (ewma_ms - med) / scale,
                                0.0).clamp(-SCORE_CLIP, SCORE_CLIP)

        rootn = safe.sqrt()
        err_spike = torch.where(
            active, (er - e_base) * rootn
            / ((e_base * (1 - e_base)).sqrt() + SPIKE_EPS),
            0.0).clamp(-SCORE_CLIP, SCORE_CLIP)
        tm_spike = torch.where(
            active, (tr - t_base) * rootn
            / ((t_base * (1 - t_base)).sqrt() + SPIKE_EPS),
            0.0).clamp(-SCORE_CLIP, SCORE_CLIP)

        warm = ever & (count >= min_samples)
        straggler_flag = warm & (straggler > z_threshold)
        anomaly_flag = straggler_flag | (warm & (
            (err_spike > spike_threshold) | (tm_spike > spike_threshold)))

        scores = torch.stack([
            straggler, err_spike, tm_spike,
            straggler_flag.to(F), anomaly_flag.to(F), ewma_ms, count])
        new_state = AnomalyState(inv_buckets, inv_lat_ms.to(F),
                                 inv_outcomes, ewma_ms, ewma_var,
                                 ewma_err, ewma_tm, ticks)
        return new_state, scores

    return step


def _masked_median_np(x: np.ndarray, mask: np.ndarray) -> float:
    n = int(mask.sum())
    if n == 0:
        return 0.0
    s = np.sort(np.where(mask, x, np.inf))
    return 0.5 * (float(s[(n - 1) // 2]) + float(s[n // 2]))


def anomaly_step_np(state: AnomalyState, inv_buckets, inv_lat_ms,
                    inv_outcomes, alpha: float, z_threshold: float,
                    spike_threshold: float, min_samples: int,
                    mad_floor_ms: float) -> Tuple[AnomalyState, np.ndarray]:
    """The host twin: identical formulas over numpy arrays (the CPU
    balancers' path, and the parity oracle for the device step)."""
    inv_buckets = np.asarray(inv_buckets)
    inv_lat_ms = np.asarray(inv_lat_ms, np.float64)
    inv_outcomes = np.asarray(inv_outcomes)

    count = inv_buckets.sum(axis=1).astype(np.float64)
    prev_count = np.asarray(state.prev_buckets).sum(axis=1).astype(np.float64)
    d_count = count - prev_count
    d_lat = inv_lat_ms - np.asarray(state.prev_lat_ms, np.float64)
    prev_out = np.asarray(state.prev_outcomes)
    d_err = (inv_outcomes[:, OUTCOME_ERROR]
             - prev_out[:, OUTCOME_ERROR]).astype(np.float64)
    d_tm = (inv_outcomes[:, OUTCOME_TIMEOUT]
            - prev_out[:, OUTCOME_TIMEOUT]).astype(np.float64)

    active = d_count > 0
    safe = np.maximum(d_count, 1.0)
    x = np.where(active, d_lat / safe, 0.0)
    er = np.where(active, d_err / safe, 0.0)
    tr = np.where(active, d_tm / safe, 0.0)

    ticks0 = np.asarray(state.ticks, np.float64)
    first = active & (ticks0 == 0)
    a = alpha
    base_m = np.where(first, x, state.ewma_ms)
    m_new = np.where(first, x, (1 - a) * state.ewma_ms + a * x)
    dev = x - base_m
    v_new = np.where(first, 0.0, (1 - a) * state.ewma_var + a * dev * dev)
    e_base = np.where(first, er, state.ewma_err)
    t_base = np.where(first, tr, state.ewma_tm)
    e_new = np.where(first, er, (1 - a) * state.ewma_err + a * er)
    t_new = np.where(first, tr, (1 - a) * state.ewma_tm + a * tr)

    ewma_ms = np.where(active, m_new, state.ewma_ms)
    ewma_var = np.where(active, v_new, state.ewma_var)
    ewma_err = np.where(active, e_new, state.ewma_err)
    ewma_tm = np.where(active, t_new, state.ewma_tm)
    ticks = ticks0 + active.astype(np.float64)

    ever = count > 0
    med = _masked_median_np(ewma_ms, ever)
    mad = _masked_median_np(np.abs(ewma_ms - med), ever)
    scale = max(mad, mad_floor_ms, REL_MAD_FLOOR * abs(med))
    straggler = np.clip(
        np.where(ever, MAD_SCALE * (ewma_ms - med) / scale, 0.0),
        -SCORE_CLIP, SCORE_CLIP)

    rootn = np.sqrt(safe)
    err_spike = np.clip(np.where(
        active, (er - e_base) * rootn
        / (np.sqrt(e_base * (1 - e_base)) + SPIKE_EPS), 0.0),
        -SCORE_CLIP, SCORE_CLIP)
    tm_spike = np.clip(np.where(
        active, (tr - t_base) * rootn
        / (np.sqrt(t_base * (1 - t_base)) + SPIKE_EPS), 0.0),
        -SCORE_CLIP, SCORE_CLIP)

    warm = ever & (count >= min_samples)
    straggler_flag = warm & (straggler > z_threshold)
    anomaly_flag = straggler_flag | (warm & (
        (err_spike > spike_threshold) | (tm_spike > spike_threshold)))

    scores = np.stack([
        straggler, err_spike, tm_spike,
        straggler_flag.astype(np.float64), anomaly_flag.astype(np.float64),
        ewma_ms, count]).astype(np.float32)
    new_state = AnomalyState(inv_buckets.copy(), inv_lat_ms.copy(),
                             inv_outcomes.copy(), ewma_ms, ewma_var,
                             ewma_err, ewma_tm, ticks)
    return new_state, scores
