"""Batcher: request coalescing for high-rate document writes.

Rebuild of common/scala/.../core/database/Batcher.scala — activation-record
writes arrive per-invocation; the batcher groups pending writes and flushes
them with bounded concurrency so the store sees large batches instead of a
write per activation.
"""
from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Generic, List, Optional, Tuple, TypeVar

T = TypeVar("T")
R = TypeVar("R")


class Batcher(Generic[T, R]):
    def __init__(self, operation: Callable[[List[T]], Awaitable[List[R]]],
                 batch_size: int = 500, concurrency: int = 2):
        self.operation = operation
        self.batch_size = batch_size
        self._sem = asyncio.Semaphore(concurrency)
        self._queue: List[Tuple[T, asyncio.Future]] = []
        self._flusher: Optional[asyncio.Task] = None
        self._inflight: set = set()

    async def put(self, item: T) -> R:
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._queue.append((item, fut))
        self._schedule_flush()
        return await fut

    def _schedule_flush(self) -> None:
        if self._flusher is None or self._flusher.done():
            self._flusher = asyncio.get_event_loop().create_task(self._flush())

    async def _flush(self) -> None:
        # Up to `concurrency` batches in flight at once: batches run as
        # independent tasks bounded by the semaphore. The drain loop's ONLY
        # await is the semaphore — it must not end while the queue is
        # non-empty, or puts that raced with its last check would never be
        # flushed (put() only spawns a new flusher once this one is done()).
        while self._queue:
            await self._sem.acquire()
            batch = self._queue[:self.batch_size]
            del self._queue[:len(batch)]
            if not batch:
                self._sem.release()
                break
            t = asyncio.get_event_loop().create_task(self._run_batch(batch))
            self._inflight.add(t)
            t.add_done_callback(self._inflight.discard)

    async def drain(self) -> None:
        """Wait for everything queued and in flight to complete."""
        while self._queue or self._inflight or (self._flusher and not self._flusher.done()):
            tasks = list(self._inflight)
            if self._flusher and not self._flusher.done():
                tasks.append(self._flusher)
            if tasks:
                await asyncio.gather(*tasks, return_exceptions=True)
            else:
                await asyncio.sleep(0)

    async def _run_batch(self, batch) -> None:
        try:
            items = [i for i, _ in batch]
            try:
                results = await self.operation(items)
                for (item, fut), r in zip(batch, results):
                    if not fut.done():
                        fut.set_result(r)
                    self._stamp_written(item)
            except Exception as e:  # noqa: BLE001 — propagate to each waiter
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
        finally:
            self._sem.release()

    @staticmethod
    def _stamp_written(item) -> None:
        """Waterfall `record_write` edge for activation-record batches:
        the item's write is durable the moment its flush lands, which under
        coalescing can be well after the invoker queued it — stamping here
        (not at put()) keeps the stage honest about batching delay. Items
        without an activation_id (other document types) no-op."""
        aid = getattr(item, "activation_id", None)
        if aid is not None:
            from ..utils.waterfall import (GLOBAL_WATERFALL,
                                           STAGE_RECORD_WRITE)
            GLOBAL_WATERFALL.stamp(aid.asString, STAGE_RECORD_WRITE)
