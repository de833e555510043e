"""Placement decision-quality scoring on the device, in PyTorch.

The counterpart of `openwhisk_tpu/ops/decision_quality.py`. Every committed
micro-batch is scored against the predictive signals the balancer already
holds on the device (the anomaly plane's per-invoker latency EWMAs and the
post-commit capacity books):

  regret       per placed row, `max(0, cost[chosen] - min cost over the
               feasible alternatives)`: cost is the invoker's predicted
               latency (EWMA, ms), feasibility re-applies the production
               constraints (partition, health, spare warm permit OR free
               memory) against the POST-commit books. Invokers with no
               latency signal cost 0 (optimistic).
  imbalance    the post-commit fleet occupancy CoV (stddev/mean of
               `1 - free/cap` over healthy, non-padding invokers).
  attribution  forced / overflow (placed off the home invoker) / throttled
               / unplaced counts, plus the cold-start approximation
               (placed rows whose slot shows no spare warm permit at the
               chosen invoker post-commit).

A shadow decision vector (the counterfactual pass's output for the same
batch) folds in the same step: divergent rows, the predicted-cost delta
over divergent rows, and per-invoker divergence at the production choice.

Two copies of the arithmetic take the same inputs and types (int32 books,
float32 costs):

  `make_quality_step` — torch ops on the books' device (the TPU balancer's
                        scorer; plain torch, no hand kernel), out of place:
                        each step returns a new `QualityState`, so a reader
                        on another thread copies one consistent state;
  `quality_step_np`   — the NumPy twin, a copy of the JAX package's, for
                        the CPU balancers and the parity tests.

Integer outputs (histogram, counters, divergence) agree exactly; the
float32 sums (`inv_regret_ms`, the summary row) agree to reduction order:
on the card `index_add_` accumulates with atomics, so their order varies
from run to run.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .placement import I32, resolve_device
from .telemetry import DEFAULT_BUCKETS, _bounds_us

F32 = torch.float32

#: counter-vector layout (int32[N_COUNTERS]); the plane exposes these by
#: name, the fleet merger sums them positionally
COUNTERS = ("rows", "placed", "forced", "overflow", "throttled", "unplaced",
            "cold_start", "shadow_rows", "shadow_divergent")
(C_ROWS, C_PLACED, C_FORCED, C_OVERFLOW, C_THROTTLED, C_UNPLACED,
 C_COLDSTART, C_SHADOW_ROWS, C_SHADOW_DIVERGENT) = range(len(COUNTERS))
N_COUNTERS = len(COUNTERS)

#: per-batch summary row (float32[N_SUMMARY]) returned by the step
(S_REGRET_SUM_MS, S_REGRET_MAX_MS, S_REGRET_ROWS, S_ROWS, S_IMBALANCE_COV,
 S_DIVERGENT, S_SHADOW_DELTA_MS, S_SHADOW_ROWS) = range(8)
N_SUMMARY = 8

#: regret clip before the us conversion: keeps `regret_ms * 1000` inside
#: int32 on both paths (2e6 ms ~ 33 min, far past any sane EWMA)
_REGRET_CLIP_MS = 2.0e6

#: the no-feasible-alternative sentinel cost (float32)
_INF = 3.0e38


class QualityState(NamedTuple):
    regret_hist: object     # int32[n_buckets]  (telemetry bucket grid)
    counters: object        # int32[N_COUNTERS]
    inv_regret_ms: object   # float32[N] cumulative regret at the chosen
    inv_divergence: object  # int32[N] shadow-divergent rows by prod choice


def init_quality_state(n_pad: int, n_buckets: int = DEFAULT_BUCKETS,
                       numpy: bool = False, device=None) -> QualityState:
    """A zero accumulator: numpy arrays with `numpy=True`, else tensors on
    `device` (None means the card)."""
    if numpy:
        return QualityState(np.zeros((n_buckets,), np.int32),
                            np.zeros((N_COUNTERS,), np.int32),
                            np.zeros((n_pad,), np.float32),
                            np.zeros((n_pad,), np.int32))
    dev = resolve_device(device)
    return QualityState(torch.zeros((n_buckets,), dtype=I32, device=dev),
                        torch.zeros((N_COUNTERS,), dtype=I32, device=dev),
                        torch.zeros((n_pad,), dtype=F32, device=dev),
                        torch.zeros((n_pad,), dtype=I32, device=dev))


def quality_state_from_numpy(qs: QualityState, device=None) -> QualityState:
    """A numpy (or JAX) accumulator as the port's tensors on `device`, so
    one package's accumulation can continue in the other."""
    dev = resolve_device(device)
    return QualityState(*(torch.from_numpy(np.array(x, dtype)).to(dev)
                          for x, dtype in zip(qs, (np.int32, np.int32,
                                                   np.float32, np.int32))))


def pad_quality_state(qs: QualityState, n_pad: int) -> QualityState:
    """`qs` with its per-invoker vectors zero-padded to `n_pad` rows (the
    books grew), on their device; the histogram and counters stand."""
    def pad(v):
        if v.shape[0] >= n_pad:
            return v
        out = torch.zeros((n_pad,), dtype=v.dtype, device=v.device)
        out[:v.shape[0]] = v
        return out

    return qs._replace(inv_regret_ms=pad(qs.inv_regret_ms),
                       inv_divergence=pad(qs.inv_divergence))


def host_state(qs: Optional[QualityState]) -> Optional[QualityState]:
    """The accumulator as host numpy arrays (a device sync for tensors on
    the card); numpy states pass through. None stays None."""
    if qs is None:
        return None
    return QualityState(*(x.cpu().numpy() if isinstance(x, torch.Tensor)
                          else x for x in qs))


def _decode(out_vec, xp=None):
    """(chosen, forced, throttled) of a packed decision vector; numpy or
    torch alike (`xp` is kept for the reference's signature)."""
    chosen = (out_vec >> 2) - 1
    forced = (out_vec & 1) > 0
    throttled = ((out_vec >> 1) & 1) > 0
    return chosen, forced, throttled


def _score_math(xp, free_post, conc_bn, health, ewma_ms, cap_mb,
                req, out_vec, shadow_vec, bounds_us):
    """The NumPy twin's scoring arithmetic, a copy of the JAX package's
    `_score_math` (run here with `xp=np` only); `conc_bn` arrives
    pre-gathered as [B, N] so the caller owns the layout difference."""
    b = req.shape[1]
    n = free_post.shape[0]
    offset, size, home = req[0], req[1], req[2]
    need, slot = req[4], req[5]
    valid = req[8] > 0
    chosen, forced, throttled = _decode(out_vec[:b], xp)
    placed = valid & (chosen >= 0)
    chosen_c = xp.clip(chosen, 0, n - 1)

    idx = xp.arange(n, dtype=xp.int32)
    local = idx[None, :] - offset[:, None]
    in_part = (local >= 0) & (local < size[:, None])
    feasible = (in_part & health[None, :]
                & ((conc_bn > 0) | (free_post[None, :] >= need[:, None])))
    inf = xp.float32(_INF)
    cost = ewma_ms.astype(xp.float32)
    alt = xp.where(feasible, cost[None, :], inf)
    best = xp.min(alt, axis=1)
    any_feasible = best < inf
    regret_ms = xp.where(
        placed & any_feasible,
        xp.maximum(cost[chosen_c] - best, xp.float32(0.0)),
        xp.float32(0.0)).astype(xp.float32)
    regret_ms = xp.minimum(regret_ms, xp.float32(_REGRET_CLIP_MS))
    regret_us = (regret_ms * xp.float32(1000.0)).astype(xp.int32)
    bucket = xp.sum((regret_us[:, None] > bounds_us[None, :])
                    .astype(xp.int32), axis=1)

    home_g = offset + home
    overflow = placed & ~forced & (chosen != home_g)
    unplaced = valid & ~placed & ~throttled
    conc_at = xp.sum(xp.where(idx[None, :] == chosen_c[:, None], conc_bn, 0),
                     axis=1)
    cold = placed & (conc_at <= 0)

    m = health & (cap_mb > 0)
    k = xp.maximum(xp.sum(m.astype(xp.int32)), 1).astype(xp.float32)
    occ = xp.where(m, xp.float32(1.0)
                   - free_post.astype(xp.float32)
                   / xp.maximum(cap_mb, 1).astype(xp.float32),
                   xp.float32(0.0)).astype(xp.float32)
    mean = xp.sum(occ) / k
    var = xp.sum(xp.where(m, (occ - mean) * (occ - mean),
                          xp.float32(0.0))) / k
    cov = xp.sqrt(var) / xp.maximum(mean, xp.float32(1e-6))

    counters = [
        xp.sum(valid.astype(xp.int32)), xp.sum(placed.astype(xp.int32)),
        xp.sum((forced & valid).astype(xp.int32)),
        xp.sum(overflow.astype(xp.int32)),
        xp.sum(throttled.astype(xp.int32)),
        xp.sum(unplaced.astype(xp.int32)), xp.sum(cold.astype(xp.int32))]

    if shadow_vec is not None:
        s_chosen, _, _ = _decode(shadow_vec[:b], xp)
        divergent = valid & (s_chosen != chosen)
        both = divergent & placed & (s_chosen >= 0)
        s_c = xp.clip(s_chosen, 0, n - 1)
        delta_ms = xp.sum(xp.where(both, cost[chosen_c] - cost[s_c],
                                   xp.float32(0.0)))
        counters += [xp.sum(valid.astype(xp.int32)),
                     xp.sum(divergent.astype(xp.int32))]
    else:
        divergent = xp.zeros((b,), bool)
        delta_ms = xp.float32(0.0)
        counters += [xp.int32(0), xp.int32(0)]

    summary = [xp.sum(regret_ms), xp.max(regret_ms),
               xp.sum((placed & any_feasible).astype(xp.int32))
               .astype(xp.float32),
               xp.sum(valid.astype(xp.int32)).astype(xp.float32), cov,
               xp.sum(divergent.astype(xp.int32)).astype(xp.float32),
               delta_ms,
               (xp.sum(valid.astype(xp.int32)).astype(xp.float32)
                if shadow_vec is not None else xp.float32(0.0))]
    return (chosen_c, placed, bucket, regret_ms, divergent, counters,
            summary)


def _score_math_torch(free_post, conc_bn, health, ewma_ms, cap_mb, req,
                      out_vec, shadow_vec, bounds_us):
    """`_score_math` in torch ops, term for term: the same float32 and
    int32 operations, so every integer output and every elementwise float
    is the twin's; only the float sums' reduction order differs. The
    chosen invoker's warm permits are one gather (one column of each row
    matches the clipped choice). Nothing reads a value on the host and no
    constant is copied to the device (Python scalars convert to float32
    as the twin's float32 constants do), so the step never waits for the
    stream."""
    b = req.shape[1]
    n = free_post.shape[0]
    dev = free_post.device
    offset, size, home = req[0], req[1], req[2]
    need = req[4]
    valid = req[8] > 0
    chosen, forced, throttled = _decode(out_vec[:b])
    placed = valid & (chosen >= 0)
    chosen_c = chosen.clamp(0, n - 1)
    at = chosen_c.long()

    idx = torch.arange(n, dtype=I32, device=dev)
    local = idx[None, :] - offset[:, None]
    in_part = (local >= 0) & (local < size[:, None])
    feasible = (in_part & health[None, :]
                & ((conc_bn > 0) | (free_post[None, :] >= need[:, None])))
    cost = ewma_ms.to(F32)
    alt = torch.where(feasible, cost[None, :], _INF)
    best = alt.amin(dim=1)
    any_feasible = best < _INF
    regret_ms = torch.where(placed & any_feasible,
                            (cost[at] - best).clamp_min(0.0), 0.0)
    regret_ms = torch.clamp_max(regret_ms, _REGRET_CLIP_MS)
    regret_us = (regret_ms * 1000.0).to(I32)
    bucket = (regret_us[:, None] > bounds_us[None, :]).sum(1, dtype=I32)

    home_g = offset + home
    overflow = placed & ~forced & (chosen != home_g)
    unplaced = valid & ~placed & ~throttled
    conc_at = conc_bn.gather(1, at[:, None])[:, 0]
    cold = placed & (conc_at <= 0)

    m = health & (cap_mb > 0)
    k = m.sum(dtype=I32).clamp_min(1).to(F32)
    occ = torch.where(m, 1.0 - free_post.to(F32)
                      / cap_mb.clamp_min(1).to(F32), 0.0)
    mean = occ.sum() / k
    var = torch.where(m, (occ - mean) * (occ - mean), 0.0).sum() / k
    cov = torch.sqrt(var) / mean.clamp_min(1e-6)

    def count(mask):
        return mask.sum(dtype=I32)

    counters = [count(valid), count(placed), count(forced & valid),
                count(overflow), count(throttled), count(unplaced),
                count(cold)]
    if shadow_vec is not None:
        s_chosen = _decode(shadow_vec[:b])[0]
        divergent = valid & (s_chosen != chosen)
        both = divergent & placed & (s_chosen >= 0)
        s_at = s_chosen.clamp(0, n - 1).long()
        delta_ms = torch.where(both, cost[at] - cost[s_at], 0.0).sum()
        counters += [count(valid), count(divergent)]
        shadow_rows = count(valid).to(F32)
    else:
        divergent = torch.zeros((b,), dtype=torch.bool, device=dev)
        delta_ms = torch.zeros((), dtype=F32, device=dev)
        counters += [torch.zeros((), dtype=I32, device=dev)] * 2
        shadow_rows = delta_ms
    summary = torch.stack([
        regret_ms.sum(), regret_ms.max(),
        count(placed & any_feasible).to(F32), count(valid).to(F32), cov,
        count(divergent).to(F32), delta_ms, shadow_rows])
    return (chosen_c, placed, bucket, regret_ms, divergent,
            torch.stack(counters), summary)


def make_quality_step(n_buckets: int = DEFAULT_BUCKETS,
                      transposed: bool = False):
    """The per-micro-batch scorer over tensors on one device.

    step(qstate, free_post, conc_post, health, ewma_ms, cap_mb, req,
         out_vec, shadow_vec=None) -> (new_qstate, summary float32[N_SUMMARY])

    Reads the books, never writes them, and makes no host sync: the
    balancer enqueues it right after the production step (post-commit
    books) and reads the summary back with that step's readback.
    `transposed=True` takes the kernels' [A, N] conc layout, False the
    [N, A] one. Out-of-range concurrency slots read the clamped row, as
    the JAX gather does, and per-invoker adds past the accumulator's
    length are dropped, as the JAX scatter drops them."""
    bounds_np = np.minimum(_bounds_us(n_buckets), 2 ** 31 - 1).astype(
        np.int32)
    bounds = {}

    def step(qstate: QualityState, free_post, conc_post, health, ewma_ms,
             cap_mb, req, out_vec, shadow_vec=None
             ) -> Tuple[QualityState, torch.Tensor]:
        dev = free_post.device
        bounds_us = bounds.get(dev)
        if bounds_us is None:
            bounds_us = bounds[dev] = torch.from_numpy(bounds_np).to(dev)
        a = conc_post.shape[0] if transposed else conc_post.shape[1]
        slot = req[5].clamp(0, a - 1).long()
        conc_bn = conc_post[slot] if transposed else conc_post.T[slot]
        chosen_c, placed, bucket, regret_ms, divergent, counters, summary = \
            _score_math_torch(free_post, conc_bn, health, ewma_ms, cap_mb,
                              req, out_vec, shadow_vec, bounds_us)
        hist = qstate.regret_hist.index_add(0, bucket.long(),
                                            placed.to(I32))
        ctr = qstate.counters + counters
        keep = chosen_c < qstate.inv_regret_ms.shape[0]
        at = torch.where(keep, chosen_c, 0).long()
        inv_r = qstate.inv_regret_ms.index_add(
            0, at, torch.where(placed & keep, regret_ms, 0.0))
        inv_d = qstate.inv_divergence.index_add(
            0, at, (divergent & placed & keep).to(I32))
        return QualityState(hist, ctr, inv_r, inv_d), summary

    return step


def quality_step_np(qstate: QualityState, free_post, conc_post, health,
                    ewma_ms, cap_mb, req, out_vec,
                    shadow_vec: Optional[np.ndarray] = None,
                    transposed: bool = False
                    ) -> Tuple[QualityState, np.ndarray]:
    """NumPy twin of `make_quality_step` for the CPU balancers and the
    parity tests: identical arithmetic over the same float32/int32 types.
    Mutates nothing; returns a fresh QualityState of numpy arrays."""
    bounds = np.minimum(_bounds_us(qstate.regret_hist.shape[0]),
                        2 ** 31 - 1).astype(np.int32)
    req = np.asarray(req, np.int32)
    out_vec = np.asarray(out_vec, np.int32)
    free_post = np.asarray(free_post, np.int32)
    health = np.asarray(health, bool)
    ewma_ms = np.asarray(ewma_ms, np.float32)
    cap_mb = np.asarray(cap_mb, np.int32)
    conc_post = np.asarray(conc_post, np.int32)
    if shadow_vec is not None:
        shadow_vec = np.asarray(shadow_vec, np.int32)
    slot = req[5]
    conc_bn = conc_post[slot, :] if transposed else conc_post[:, slot].T
    chosen_c, placed, bucket, regret_ms, divergent, counters, summary = \
        _score_math(np, free_post, conc_bn, health, ewma_ms,
                    cap_mb, req, out_vec, shadow_vec, bounds)
    hist = np.array(qstate.regret_hist, np.int32, copy=True)
    np.add.at(hist, bucket, placed.astype(np.int32))
    ctr = qstate.counters + np.stack(counters).astype(np.int32)
    inv_r = np.array(qstate.inv_regret_ms, np.float32, copy=True)
    np.add.at(inv_r, chosen_c, np.where(placed, regret_ms,
                                        np.float32(0.0)))
    inv_d = np.array(qstate.inv_divergence, np.int32, copy=True)
    np.add.at(inv_d, chosen_c, (divergent & placed).astype(np.int32))
    return (QualityState(hist, ctr, inv_r, inv_d),
            np.asarray(summary, np.float32))
