"""Plain NumPy reference of the balancer core behind per-namespace rate
limits: `sharding.Reference` (OpenWhisk's `ShardingContainerPoolBalancer`
as the port's `BalancerCore` serves it) behind OpenWhisk's per-namespace
invocation limit, `invocationsPerMinute` (Entitlement.scala's rate
throttler), as `BalancerCore(rate_limit_per_minute=R)` admits rows with
token buckets on the card. It imports nothing of the port.

- The buckets: 1,024, each holding at most one minute's worth (R tokens),
  full at the start, refilled at R / 60 tokens a second. A namespace gets a
  dedicated bucket in order of first sight, up to 1,024 - 64 of them; past
  that, crc32 of its name picks one of the 64 shared at the tail. A row
  carries its namespace's bucket as a tenth field.
- A step with rows first refills every bucket to the clock the last
  `set_clock` gave, then admits each namespace's first floor(tokens) rows in
  batch order and takes their count from its bucket. Only the admitted rows
  are placed, each seeing the books as the earlier ones left them. A
  throttled row carries chosen -1 and `throttled`, gives its concurrency
  slot back as an unplaced row does, and books nothing. A step without rows
  touches no bucket.

The comparison that decides `correct` allows no difference, and a token one
ulp off flips a floor at an integer. So the arithmetic is the port's
float32 arithmetic, operation for operation (`ops/throttle.py`
`admit_batch`):

  now    = float32(now_s)
  dt     = max(float32(now - last), 0)
  tokens = float32(float64(tokens) + float64(rate) * float64(dt))
           (the product of two float32 is exact in float64: one rounding to
           float64, then one to float32)
  tokens = min(tokens, burst), burst = float32(R), rate = float32(R) / 60
  tokens = float32(tokens - admitted), last = now

Nothing is tolerated.
"""
from __future__ import annotations

import zlib
from collections import deque
from typing import Dict, List, NamedTuple

import numpy as np

from owbench.reference.sharding import Reference as Sharding

#: namespace buckets, and the tail shared by namespaces past the dedicated
BUCKETS = 1024
SHARED_BUCKETS = 64
F32 = np.float32


class Result(NamedTuple):
    chosen: np.ndarray       # int32[b]; -1: throttled, or no healthy invoker
    forced: np.ndarray       # bool[b]
    rows: np.ndarray         # int32[10, b]: the nine columns, then the bucket
    slot_keys: List[str]
    throttled: np.ndarray    # bool[b]


class Reference(Sharding):
    """The sharding reference with a token bucket a namespace."""

    def __init__(self, memory_mb, *, rate_limit_per_minute: int,
                 sequential: bool = True, **kw):
        super().__init__(memory_mb, sequential=sequential, **kw)
        self.burst = F32(rate_limit_per_minute)
        self.rate = F32(rate_limit_per_minute) / F32(60)
        self.tokens = np.full(BUCKETS, self.burst, F32)
        self.last = F32(0)
        self._bucket_of: Dict[str, int] = {}
        #: the queued rows' buckets, in the order of `_queued`
        self._ns_queued: deque = deque()
        #: per row of the step being placed, in order: throttled or not
        self._held = iter(())

    def bucket(self, namespace: str) -> int:
        slot = self._bucket_of.get(namespace)
        if slot is None:
            dedicated = BUCKETS - SHARED_BUCKETS
            if len(self._bucket_of) < dedicated:
                slot = self._bucket_of[namespace] = len(self._bucket_of)
            else:
                slot = dedicated + zlib.crc32(namespace.encode()) \
                    % SHARED_BUCKETS
        return slot

    def build_row(self, namespace: str, fqn: str, memory_mb: int,
                  max_conc: int, blackbox: bool):
        row, key, step = super().build_row(namespace, fqn, memory_mb,
                                           max_conc, blackbox)
        return row, key, step, self.bucket(namespace)

    def submit(self, rows) -> None:
        for row, key, step, ns in rows:
            self._queued.append((row, key, step))
            self._ns_queued.append(ns)

    def _admit(self, ns: List[int]) -> np.ndarray:
        """Refill every bucket to the clock, then admit each namespace's
        first floor(tokens) rows: the throttled flags, in batch order."""
        now = F32(self.now_s)
        dt = max(F32(now - self.last), F32(0))
        tokens = np.minimum(
            (self.tokens.astype(np.float64)
             + np.float64(self.rate) * np.float64(dt)).astype(F32),
            self.burst)
        floor = np.floor(tokens).tolist()
        seen: Dict[int, int] = {}
        held = np.zeros(len(ns), bool)
        for i, k in enumerate(ns):
            before = seen.get(k, 0)
            seen[k] = before + 1
            held[i] = before >= floor[k]
        spent = np.bincount(np.asarray(ns, np.int64)[~held],
                            minlength=BUCKETS).astype(F32)
        self.tokens = tokens - spent
        self.last = now
        return held

    def step(self) -> Result:
        b = min(len(self._queued), self.max_batch)
        ns = [self._ns_queued.popleft() for _ in range(b)]
        held = self._admit(ns) if b else np.zeros(0, bool)
        self._held = iter(held.tolist())
        res = super().step()
        if self.keep_work and b:
            # a throttled row is not a row of the schedule: it probed nothing
            self.work[-1]["schedule"]["rows"] -= int(held.sum())
        rows = np.vstack([res.rows, np.asarray(ns, np.int32).reshape(1, b)])
        return Result(res.chosen, res.forced, rows, res.slot_keys, held)

    def _probe(self, key, offset, size, home, step, step_inv, need, slot,
               rand):
        """A throttled row probes nothing: (-1, False), which the step
        takes as a row that found no invoker (its slot released, nothing
        booked)."""
        if next(self._held):
            self._cost = (0, 0)
            return -1, False
        return super()._probe(key, offset, size, home, step, step_inv, need,
                              slot, rand)
