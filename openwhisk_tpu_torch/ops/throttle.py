"""Vectorized token-bucket admission, as plain PyTorch on the state's device.

The counterpart of `openwhisk_tpu/ops/throttle.py` (the device side of the
entitlement rate throttler, Entitlement.scala:86-153 / RateThrottler.scala):
per-namespace buckets are a dense float32 array; admitting a micro-batch is
a one-hot segmented prefix count per namespace followed by one clamped
subtraction — no per-request locks. The one-hot counts are sums of 0s and
1s in float32, exact below 2^24, as in the JAX package.

Clock contract: `now` must be a SMALL-MAGNITUDE monotonic second count
(e.g. time.monotonic() - t0 since the balancer started), NOT wall-clock
epoch seconds — the state is float32, whose resolution at epoch magnitudes
(~1.7e9) is ~2 minutes, which would quantize refills to nothing or bursts.
At process-uptime magnitudes (< ~1e6 s) resolution is sub-0.1 s.

Unlike the placement books, the bucket state is never updated in place:
`admit_batch` returns a new state, so a step that fails after admission
leaves the caller's buckets as they were.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .placement import resolve_device

F32 = torch.float32


class TokenBucketState(NamedTuple):
    tokens: torch.Tensor       # float32[M] current tokens per namespace slot
    rate_per_s: torch.Tensor   # float32[M] refill rate
    burst: torch.Tensor        # float32[M] bucket capacity
    last_refill: torch.Tensor  # float32[] timestamp of last refill


def init_buckets(n_namespaces: int, rate_per_minute, burst=None,
                 device=None) -> TokenBucketState:
    """Full buckets on `device` (None = the card): `rate_per_minute` tokens
    a minute each, holding at most `burst` (default: one minute's worth)."""
    dev = resolve_device(device)
    rate = (torch.as_tensor(rate_per_minute, dtype=F32) / 60.0).expand(
        n_namespaces).to(dev)
    burst_arr = torch.as_tensor(
        rate_per_minute if burst is None else burst, dtype=F32).expand(
        n_namespaces).to(dev)
    return TokenBucketState(burst_arr.clone(), rate, burst_arr,
                            torch.zeros((), dtype=F32, device=dev))


def admit_batch(state: TokenBucketState, now, ns_slot: torch.Tensor,
                valid: torch.Tensor) -> Tuple[TokenBucketState, torch.Tensor]:
    """Admit a batch of requests (ns_slot int32[B], valid bool[B]) at time
    `now` (seconds, float or float32 tensor). Returns (new state, admitted
    bool[B]). Requests from the same namespace inside one batch contend in
    batch order via a segmented prefix count; a slot outside [0, M)
    matches no bucket (its one-hot row is zero) and reads the clamped
    bucket, as the JAX one_hot / gather pair does."""
    dev = state.tokens.device
    now_t = torch.as_tensor(now, dtype=F32).to(dev) if torch.is_tensor(now) \
        else torch.full((), float(now), dtype=F32, device=dev)
    dt = torch.clamp_min(now_t - state.last_refill, 0.0)
    # the refill rounds once, as the fused multiply-add XLA compiles
    # `tokens + rate * dt` into: the float32 product is exact in float64
    refill = (state.tokens.double()
              + state.rate_per_s.double() * dt.double()).to(F32)
    tokens = torch.minimum(refill, state.burst)

    m = tokens.shape[0]
    hot = (ns_slot[:, None] == torch.arange(m, dtype=ns_slot.dtype,
                                            device=dev)[None, :]).to(F32)
    onehot = hot * valid[:, None].to(F32)
    # position of each request within its namespace inside this batch
    prior = torch.cumsum(onehot, 0) - onehot
    position = torch.sum(prior * onehot, 1)
    available = tokens[ns_slot.long().clamp(0, m - 1)]
    admitted = valid & (position < torch.floor(available))
    spent = torch.sum(hot * admitted[:, None].to(F32), 0)
    return TokenBucketState(tokens - spent, state.rate_per_s, state.burst,
                            now_t), admitted
