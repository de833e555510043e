"""Repeating-task scheduler on asyncio.

Rebuild of the reference's Scheduler actor
(common/scala/.../common/Scheduler.scala): run a (possibly async) closure
every `interval` seconds, either fixed-rate ("scheduleAtFixedRate") or
wait-at-least ("scheduleWaitAtLeast" — next run starts `interval` after the
previous run *completed*). Errors are logged, never fatal.
"""
from __future__ import annotations

import asyncio
import inspect
from typing import Awaitable, Callable, Optional, Union

Work = Callable[[], Union[None, Awaitable[None]]]


class Scheduler:
    def __init__(self, interval: float, work: Work, *, fixed_rate: bool = False,
                 initial_delay: float = 0.0, logger=None, name: str = "scheduler"):
        self.interval = interval
        self.work = work
        self.fixed_rate = fixed_rate
        self.initial_delay = initial_delay
        self.logger = logger
        self.name = name
        self._task: Optional[asyncio.Task] = None
        self._stopped = asyncio.Event()

    def start(self) -> "Scheduler":
        self._stopped.clear()
        self._task = asyncio.get_event_loop().create_task(self._run(), name=self.name)
        return self

    async def _run(self) -> None:
        try:
            if self.initial_delay:
                await asyncio.sleep(self.initial_delay)
            loop = asyncio.get_event_loop()
            next_at = loop.time()
            while not self._stopped.is_set():
                try:
                    r = self.work()
                    if inspect.isawaitable(r):
                        await r
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 — scheduler must survive task errors
                    if self.logger:
                        from .transaction import TransactionId
                        self.logger.warn(TransactionId.SYSTEM,
                                         f"scheduled task {self.name} failed: {e!r}")
                if self.fixed_rate:
                    next_at += self.interval
                    delay = max(0.0, next_at - loop.time())
                else:
                    delay = self.interval
                try:
                    await asyncio.wait_for(self._stopped.wait(), timeout=delay)
                except asyncio.TimeoutError:
                    pass
        except asyncio.CancelledError:
            pass

    async def stop(self) -> None:
        self._stopped.set()
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None
