"""Batched front-door admission: vectorized throttle checks for the
controller's ACTIVATE path.

The serial entitlement pipeline pays one rolling-window deque scan (rate
throttle) plus one in-flight counter read (concurrency throttle) per
request, on the event loop, per arrival. Under open-loop load those
per-request costs compound into the tail (PAPERS.md: Schroeder et al. —
open vs. closed loops; Dean & Barroso — amortize serial work over
batches). This module coalesces concurrent `_invoke_action` arrivals and
decides them in ONE vectorized pass:

  * `rate_admit_batch` — the host-side NumPy twin of the device token
    bucket's batch admission (`ops/throttle.py:admit_batch`), but with the
    HTTP front door's semantics: the reference's rolling-minute window with
    per-user overrides (RateThrottler.scala). One deque prune per TOUCHED
    namespace per batch (instead of per request) + one segmented position
    count across the batch replaces N serial scans. It operates directly
    on the serial `RateThrottler`'s deques, so the serial and batched
    paths interleave safely (triggers vs. actions, off-switch flips).
  * `AdmissionPlane` — the coalescer: concurrent checks enqueue, a drainer
    flushes on size (`max_batch`) or a bounded window (`window_ms`, same
    Nagle rule as the bus coalescer), and rejections surface as the exact
    serial `ThrottleRejectRequest`s (same messages, same throttle events).

Bit-parity with the serial path (fuzzed in tests/test_admission.py): the
batch shares one clock, so serial calls with that same clock produce the
same admit/reject decisions AND the same deque state afterward. Two
deliberate, documented divergences: (1) events aging out *during* a
sub-millisecond window are pruned at the shared flush clock instead of
per-arrival clocks; (2) the CONCURRENCY throttle does intra-batch
accounting — each admission in a flush counts against its namespace's
limit for later batch-mates — which is STRICTER than the serial race,
where N arrivals between counter updates all read the same in-flight
count and can collectively overshoot the limit.

Off switch: `CONFIG_whisk_admission_batch_enabled=false` keeps
`LocalEntitlementProvider` on the serial `_check_throttles` path —
bit-exact with today's behavior.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..utils.config import load_config
from ..utils.microbatch import MicroCoalescer


@dataclass(frozen=True)
class AdmissionBatchConfig:
    """`CONFIG_whisk_admission_batch_*` env overrides."""
    enabled: bool = True
    #: bounded accumulation delay before a flush. Default 0 = end of the
    #: current event-loop sweep: concurrent arrivals in one sweep still
    #: coalesce, and a lone request at idle pays NO added latency (the
    #: same zero-idle-tax rule as the bus coalescer's window)
    window_ms: float = 0.0
    #: flush as soon as this many checks are pending
    max_batch: int = 256

    @classmethod
    def from_env(cls) -> "AdmissionBatchConfig":
        return load_config(cls, env_path="admission.batch")


def rate_admit_batch(throttler, ns_ids: List[str], limits,
                     now: Optional[float] = None) -> np.ndarray:
    """Vectorized equivalent of N serial `RateThrottler.check(ns, limit,
    now)` calls in arrival order, against the same throttler state.

    Returns bool[B] admissions. Per TOUCHED namespace: one expiry prune of
    its deque (the serial path prunes per request); across the batch: one
    segmented position count (arrival rank within the namespace), so
    request i admits iff `len(queue) + rank_i < limit_i`. Admitted
    requests append the shared `now`, exactly like serial admits."""
    b = len(ns_ids)
    if b == 0:
        return np.zeros((0,), bool)
    now = time.monotonic() if now is None else now
    default = throttler.default_per_minute
    limits_arr = np.asarray(
        [default if lim is None else lim for lim in limits], np.int64)
    codes, idx = np.unique(np.asarray(ns_ids, object), return_inverse=True)
    horizon = now - 60.0
    base = np.empty(len(codes), np.int64)
    queues = []
    for k, ns in enumerate(codes):
        q = throttler._events.setdefault(ns, deque())
        while q and q[0] <= horizon:
            q.popleft()
        queues.append(q)
        base[k] = len(q)
    # the segmented count: arrival rank of each request within its
    # namespace, computed once for the whole batch (the NumPy analogue of
    # ops/throttle.admit_batch's one-hot prefix count)
    order = np.argsort(idx, kind="stable")
    sidx = idx[order]
    starts = np.flatnonzero(np.r_[True, sidx[1:] != sidx[:-1]])
    lens = np.diff(np.r_[starts, b])
    rank = np.empty(b, np.int64)
    rank[order] = np.arange(b) - np.repeat(starts, lens)
    admitted = base[idx] + rank < limits_arr
    # Heterogeneous per-request limits WITHIN one namespace re-introduce
    # the serial dependency (an early rejection consumes no slot, so a
    # later larger-limit request can pass where rank math says no): replay
    # exactly those groups serially. Vanishingly rare — the override comes
    # from the namespace's own identity record — but parity is parity.
    slim = limits_arr[order]
    gmin = np.minimum.reduceat(slim, starts)
    gmax = np.maximum.reduceat(slim, starts)
    for g in np.flatnonzero(gmin != gmax):
        members = order[starts[g]: starts[g] + lens[g]]  # arrival order
        count = int(base[sidx[starts[g]]])
        for i in members:
            admitted[i] = count < limits_arr[i]
            count += int(admitted[i])
    for i in range(b):
        if admitted[i]:
            queues[idx[i]].append(now)
    return admitted


class AdmissionPlane:
    """Coalesces concurrent ACTIVATE throttle checks into vectorized
    flushes (see module doc). One instance per LocalEntitlementProvider;
    the coalescing loop is the shared MicroCoalescer (utils/microbatch.py,
    the same drainer the bus producer wrapper rides)."""

    def __init__(self, provider, config: Optional[AdmissionBatchConfig] = None):
        self.provider = provider
        cfg = config if config is not None else AdmissionBatchConfig.from_env()
        self._co = MicroCoalescer(self._flush, cfg.max_batch,
                                  max(0.0, float(cfg.window_ms)) / 1e3,
                                  name="admission-batch")
        self.batches = 0
        self.checked = 0

    async def check_throttles(self, identity, is_trigger_fire: bool) -> None:
        """The batched stand-in for `_check_throttles`: returns on admit,
        raises the serial path's exact `ThrottleRejectRequest` on reject."""
        await self._co.submit((identity, is_trigger_fire))

    async def _flush(self, batch: List[tuple]) -> None:
        """One vectorized admission pass over the whole batch
        (`[((identity, is_trigger_fire), fut), ...]`). Decision order
        mirrors the serial pipeline exactly: rate first (its rejection
        skips the concurrency read), then concurrency. Rejected futures
        get their exception here; admitted ones are resolved by the
        coalescer on return."""
        from .entitlement import (CONCURRENT_LIMIT_MESSAGE,
                                  ThrottleRejectRequest, rate_limit_message)
        self.batches += 1
        self.checked += len(batch)
        p = self.provider
        now = time.monotonic()
        fire_idx = [i for i, ((_id, fire), _f) in enumerate(batch) if fire]
        invoke_idx = [i for i, ((_id, fire), _f) in enumerate(batch)
                      if not fire]
        rejection: List[Optional[Exception]] = [None] * len(batch)
        for idxs, throttler, limit_of in (
                (fire_idx, p.fire_rate,
                 lambda ident: ident.limits.fires_per_minute),
                (invoke_idx, p.invoke_rate,
                 lambda ident: ident.limits.invocations_per_minute)):
            if not idxs:
                continue
            admitted = rate_admit_batch(
                throttler,
                [batch[i][0][0].namespace.uuid.asString for i in idxs],
                [limit_of(batch[i][0][0]) for i in idxs], now)
            for j, i in enumerate(idxs):
                if not admitted[j]:
                    # the serial path's exact text (one shared copy keyed
                    # on the throttler's own description)
                    rejection[i] = ThrottleRejectRequest(
                        rate_limit_message(throttler.description))
                    p._throttle_event("TimedRateLimit", batch[i][0][0])
        # Concurrency (invoke only, rate-admitted only): ONE in-flight
        # counter read per namespace PLUS intra-batch accounting — each
        # admission here counts against the limit for later batch-mates.
        # Deliberately STRICTER than the serial race (N arrivals between
        # counter updates all read the same count and can collectively
        # blow past the limit); a coalesced burst cannot.
        if p.load_balancer is not None:
            lb = p.load_balancer
            default = p.concurrent.default_concurrent
            active_cache: dict = {}
            granted: dict = {}
            for i in invoke_idx:
                if rejection[i] is not None:
                    continue
                ident = batch[i][0][0]
                ns = ident.namespace.uuid.asString
                limit = ident.limits.concurrent_invocations
                limit = default if limit is None else limit
                active = active_cache.get(ns)
                if active is None:
                    active = lb.active_activations_for(ns)
                    active_cache[ns] = active
                if active + granted.get(ns, 0) >= limit:
                    rejection[i] = ThrottleRejectRequest(
                        CONCURRENT_LIMIT_MESSAGE)
                    p._throttle_event("ConcurrentRateLimit", ident)
                else:
                    granted[ns] = granted.get(ns, 0) + 1
        for ((_ident, _fire), fut), rej in zip(batch, rejection):
            if rej is not None and not fut.done():
                fut.set_exception(rej)
