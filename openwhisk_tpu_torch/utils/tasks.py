"""Fire-and-forget task spawning that survives garbage collection.

asyncio only holds weak references to tasks: an unreferenced
`loop.create_task(...)` can be collected before it runs. `spawn` keeps a
strong reference until the task completes (and swallows/loggs its errors —
these are best-effort side channels like telemetry events).
"""
from __future__ import annotations

import asyncio
from typing import Coroutine, Optional

_background: set = set()


def spawn(coro: Coroutine, logger=None, name: Optional[str] = None) -> asyncio.Task:
    task = asyncio.get_event_loop().create_task(coro, name=name)
    _background.add(task)

    def _done(t: asyncio.Task) -> None:
        _background.discard(t)
        if not t.cancelled() and t.exception() is not None and logger is not None:
            from .transaction import TransactionId
            logger.warn(TransactionId.SYSTEM,
                        f"background task {name or ''} failed: {t.exception()!r}")

    task.add_done_callback(_done)
    return task


async def wait_for_shutdown() -> None:
    """Block until SIGTERM/SIGINT so service mains can run their `finally`
    cleanup (destroy sandboxes, close servers). A bare
    `await asyncio.Event().wait()` dies uncleanly on SIGTERM — the default
    handler terminates the process before any cleanup runs."""
    import signal

    stop = asyncio.Event()
    loop = asyncio.get_event_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError):
            pass
    await stop.wait()
