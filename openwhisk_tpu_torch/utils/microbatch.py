"""MicroCoalescer: the shared micro-batching drainer.

One implementation of the submit/flush coalescing loop that both the bus
producer wrapper (messaging/coalesce.py) and the admission plane
(controller/admission.py) ride — the loop's liveness argument is subtle
enough that copies drift (database/batcher.py keeps its own variant
because its flushes run CONCURRENTLY under a semaphore; this one
serializes flushes to preserve submission order).

Liveness (same argument as database/batcher.py): the drainer's only exit
is an empty queue checked synchronously before the coroutine returns, and
submitters re-arm whenever the previous drainer is done() — a submission
can never strand between the check and the task finishing.

Window semantics: `window_s == 0` flushes at the end of the current
event-loop sweep, so everything scheduled in the same sweep (e.g. one
readback fan-out wave) joins the batch at ZERO idle latency; `window_s >
0` is an age-based Nagle bound — the OLDEST pending item waits at most
window_s, a full batch short-circuits.
"""
from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, List, Optional, Tuple

#: flush receives [(item, future), ...] and may resolve futures itself
#: (e.g. set per-item exceptions); any future still pending when flush
#: returns is resolved with None, a raising flush fails them all instead
FlushFn = Callable[[List[Tuple[object, asyncio.Future]]], Awaitable[None]]


class MicroCoalescer:
    """Coalesce concurrent submissions into bounded, ordered micro-batches
    (see module doc). `submit(item)` returns when the item's batch has
    flushed — or raises what flush assigned to its future."""

    def __init__(self, flush: FlushFn, max_batch: int, window_s: float,
                 name: str = "microbatch"):
        self._flush = flush
        self.max_batch = max(1, int(max_batch))
        self.window_s = max(0.0, float(window_s))
        self.name = name
        self._pending: List[tuple] = []  # (item, fut, t_enqueue)
        self._drainer: Optional[asyncio.Task] = None
        #: set by submit() when the batch fills — interrupts a window sleep
        #: so max_batch really bounds latency DURING the window, not just
        #: between windows
        self._full = asyncio.Event()

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    async def submit(self, item) -> None:
        await self.submit_nowait(item)

    def submit_nowait(self, item) -> asyncio.Future:
        """Enqueue without awaiting; returns the item's flush future.
        Callers submitting a whole wave await the futures together
        (`asyncio.gather(*futs)` over FUTURES costs no task per item —
        gather only wraps coroutines in tasks)."""
        loop = asyncio.get_event_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending.append((item, fut, loop.time()))
        if len(self._pending) >= self.max_batch:
            self._full.set()  # wake a drainer sleeping out its window
        self._arm()
        return fut

    def _arm(self) -> None:
        if self._drainer is None or self._drainer.done():
            self._drainer = asyncio.get_event_loop().create_task(
                self._drain(), name=self.name)

    #: post-drain linger: how many ZERO-DELAY sweeps an emptied drainer
    #: waits for the next wave before exiting. Steady traffic re-fills
    #: within a sweep or two, and re-arming a fresh drainer task per wave
    #: was measurable churn (~0.2 tasks/activation at 4k/s across the
    #: process's producers). A submission landing during the linger
    #: flushes on the NEXT sweep — exactly when a freshly-armed drainer
    #: would have — so the zero-idle-latency contract is unchanged.
    LINGER_SWEEPS = 32

    async def _drain(self) -> None:
        loop = asyncio.get_event_loop()
        batch: List[tuple] = []
        try:
            while True:
                while self._pending:
                    if len(self._pending) < self.max_batch:
                        if self.window_s > 0:
                            lag = self.window_s - (loop.time()
                                                   - self._pending[0][2])
                            if lag > 0:
                                # interruptible window: a batch filling
                                # while we sleep flushes NOW (submit
                                # sets _full)
                                self._full.clear()
                                if len(self._pending) < self.max_batch:
                                    try:
                                        await asyncio.wait_for(
                                            self._full.wait(), lag)
                                    except asyncio.TimeoutError:
                                        pass
                        else:
                            await asyncio.sleep(0)  # end-of-sweep coalesce
                    batch = [(item, fut) for (item, fut, _t)
                             in self._pending[:self.max_batch]]
                    del self._pending[:len(batch)]
                    try:
                        await self._flush(batch)
                    except Exception as e:  # noqa: BLE001 — fan out to
                        # waiters
                        for _item, fut in batch:
                            if not fut.done():
                                fut.set_exception(e)
                    else:
                        for _item, fut in batch:
                            if not fut.done():
                                fut.set_result(None)
                for _ in range(self.LINGER_SWEEPS):
                    await asyncio.sleep(0)
                    if self._pending:
                        break
                # liveness: the empty check is SYNCHRONOUS right before
                # the return (no await in between), and submitters re-arm
                # whenever the previous drainer is done() — a submission
                # can never strand between the check and the task
                # finishing
                if not self._pending:
                    return
        except asyncio.CancelledError:
            # the loop is going down mid-drain (sleep or flush cancelled):
            # nobody will ever flush the remainder — cancel every waiter
            # (the popped in-flight batch included) instead of leaving
            # them pending forever
            for _item, fut in batch:
                if not fut.done():
                    fut.cancel()
            for (_item, fut, _t) in self._pending:
                if not fut.done():
                    fut.cancel()
            self._pending.clear()
            raise

    async def drain_all(self) -> None:
        """Wait until everything submitted so far has flushed (or failed)."""
        while self._pending or (self._drainer and not self._drainer.done()):
            if self._pending:
                self._arm()
            if self._drainer and not self._drainer.done():
                await asyncio.gather(self._drainer, return_exceptions=True)
            else:
                await asyncio.sleep(0)
