"""ContainerPool: warm/prewarm/cold scheduling within one invoker.

Behavioral rebuild of core/invoker/.../containerpool/ContainerPool.scala
(:59-216 receive, :219-245 warm matching, :306-326 buffering, :440-500
schedule/remove): the pool owns free/busy/prewarmed proxy sets and a FIFO
`run_buffer` for memory pressure. Scheduling order for a job:
  1. warm container initialized with the same (action@rev, namespace) that
     still has concurrency capacity,
  2. if memory allows: a prewarmed stem cell of matching (kind, memory),
  3. if memory allows: a cold container,
  4. evict idle warm containers (LRU) to make room, then 2/3,
  5. otherwise buffer the job until capacity frees up.
Prewarm pools are backfilled when stem cells are consumed (:backfillPrewarms).
"""
from __future__ import annotations

import asyncio
import time
from collections import Counter, deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ..core.entity import ExecutableWhiskAction, MB
from ..messaging.message import ActivationMessage
from ..utils.transaction import TransactionId
from ..utils.waterfall import GLOBAL_WATERFALL, STAGE_CONTAINER_ACQUIRE
from .factory import ContainerPoolConfig
from .proxy import ContainerProxy, PAUSED, PAUSING, READY

Job = Tuple[ExecutableWhiskAction, ActivationMessage]


class Run:
    """A scheduling request (ref ContainerProxy.Run message)."""

    __slots__ = ("action", "msg", "retry")

    def __init__(self, action: ExecutableWhiskAction, msg: ActivationMessage,
                 retry: bool = False):
        self.action = action
        self.msg = msg
        self.retry = retry


class ContainerPool:
    def __init__(self, proxy_factory: Callable[[], ContainerProxy],
                 config: ContainerPoolConfig, prewarm_config: Optional[List] = None,
                 logger=None, metrics=None):
        self.make_proxy = proxy_factory
        self.config = config
        self.prewarm_config = prewarm_config or []  # [(kind, image, memory_mb, count)]
        self.logger = logger
        self.metrics = metrics
        self.free: List[ContainerProxy] = []
        self.busy: List[ContainerProxy] = []
        self.prewarmed: List[ContainerProxy] = []
        self.prewarm_starting = 0
        self._prewarm_starting_mb = 0
        self.run_buffer: Deque[Run] = deque()
        #: activations scheduled on a proxy whose run task has not started
        #: yet: `active_count` counts an activation only once its task
        #: runs, so jobs scheduled in one event-loop sweep would otherwise
        #: all match the same warm container past its concurrency limit
        self._reserved: Counter = Counter()
        self._tasks: set = set()
        self._shutdown = False

    # -- capacity accounting ----------------------------------------------
    def memory_consumption_mb(self) -> int:
        # includes in-flight prewarm starts (ref counts prewarmStartingPool)
        return (sum(p.data.memory_mb for p in self.free) +
                sum(p.data.memory_mb for p in self.busy) +
                sum(p.data.memory_mb for p in self.prewarmed) +
                self._prewarm_starting_mb)

    def has_pool_space(self, memory_mb: int) -> bool:
        return self.memory_consumption_mb() + memory_mb <= self.config.user_memory.to_mb

    # -- startup -----------------------------------------------------------
    async def start(self) -> None:
        """Start prewarm stem cells (ref ContainerPool init + backfill)."""
        awaitables = []
        for kind, image, memory_mb, count in self.prewarm_config:
            for _ in range(count):
                if self.has_pool_space(memory_mb):
                    awaitables.append(self._start_prewarm(kind, image, memory_mb))
        if awaitables:
            await asyncio.gather(*awaitables)

    async def _start_prewarm(self, kind: str, image: str, memory_mb: int) -> None:
        proxy = self._new_proxy()
        self.prewarm_starting += 1
        self._prewarm_starting_mb += memory_mb
        try:
            await proxy.prestart(kind, image, memory_mb)
        finally:
            self.prewarm_starting -= 1
            self._prewarm_starting_mb -= memory_mb
        if proxy.container is not None:
            self.prewarmed.append(proxy)

    # -- scheduling --------------------------------------------------------
    def run(self, job: Run) -> None:
        """Entry point from the invoker (non-blocking)."""
        # Preserve arrival order under memory pressure: new jobs go behind
        # the buffer (ref ContainerPool.scala:108-141).
        if self.run_buffer and not job.retry:
            self.run_buffer.append(job)
            return
        if not self._try_schedule(job):
            if job.retry:
                self.run_buffer.appendleft(job)
            else:
                self.run_buffer.append(job)
            self._emit_gauges()

    def _try_schedule(self, job: Run) -> bool:
        action, msg = job.action, job.msg
        memory_mb = action.limits.memory.megabytes
        max_concurrent = action.limits.concurrency.max_concurrent
        key = _job_key(action, msg)

        # 1. warm match with concurrency capacity (free first, then busy)
        proxy = self._warm_match(key, max_concurrent)
        # 2./3. prewarm or cold if space
        if proxy is None and self.has_pool_space(memory_mb):
            proxy = self._take_prewarm(action) or self._cold(action)
        # 4. evict idle warm containers, then retry
        if proxy is None:
            freed = self._evict_for(memory_mb)
            if freed and self.has_pool_space(memory_mb):
                proxy = self._take_prewarm(action) or self._cold(action)
        if proxy is None:
            return False

        if proxy in self.free:
            self.free.remove(proxy)
        if proxy not in self.busy:
            self.busy.append(proxy)
        # waterfall: a container (warm, prewarmed or cold shell) is now
        # committed to this activation — the acquire->run delta is the
        # cold-start / init cost the waterfall attributes to this stage
        GLOBAL_WATERFALL.stamp(msg.activation_id.asString,
                               STAGE_CONTAINER_ACQUIRE)
        self._reserved[proxy] += 1
        self._spawn(self._run_reserved(proxy, action, msg))
        self._emit_gauges()
        return True

    def _warm_match(self, key: str, max_concurrent: int) -> Optional[ContainerProxy]:
        # idle warm containers first; with intra-container concurrency > 1 a
        # busy container with spare slots also matches (ref :219-231)
        for pool in (self.free, self.busy):
            for p in pool:
                if (not p._destroyed and p.data.action_id is not None and
                        f"{p.data.action_id}/{p.data.invocation_namespace}" == key and
                        p.active_count + self._reserved[p] < max_concurrent):
                    return p
        return None

    async def _run_reserved(self, proxy: ContainerProxy,
                            action: ExecutableWhiskAction,
                            msg: ActivationMessage) -> None:
        # proxy.run counts the activation before its first await, so the
        # reservation hands over with no window between the two counts
        self._reserved[proxy] -= 1
        if not self._reserved[proxy]:
            del self._reserved[proxy]
        await proxy.run(action, msg)

    def _take_prewarm(self, action: ExecutableWhiskAction) -> Optional[ContainerProxy]:
        kind = action.exec.kind
        memory_mb = action.limits.memory.megabytes
        for p in self.prewarmed:
            if p.data.kind == kind and p.data.memory_mb == memory_mb:
                self.prewarmed.remove(p)
                self._backfill_prewarm(kind, memory_mb)
                return p
        return None

    def _backfill_prewarm(self, kind: str, memory_mb: int) -> None:
        for k, image, mem, _count in self.prewarm_config:
            if k == kind and mem == memory_mb and self.has_pool_space(memory_mb):
                self._spawn(self._start_prewarm(k, image, mem))
                return

    def _cold(self, action: ExecutableWhiskAction) -> ContainerProxy:
        if self.metrics:
            self.metrics.counter("invoker_containerStart_cold_count")
        proxy = self._new_proxy()
        # account the job's memory from scheduling time, not from container
        # creation — concurrent cold starts must not overcommit the pool
        proxy.data.memory_mb = action.limits.memory.megabytes
        proxy.data.kind = action.exec.kind
        return proxy

    def _evict_for(self, memory_mb: int) -> bool:
        """LRU-evict idle free containers until memory_mb fits
        (ref ContainerPool.remove :440-477)."""
        evictable = sorted(
            [p for p in self.free if p.active_count == 0 and
             not self._reserved[p] and p.state in (READY, PAUSED, PAUSING)],
            key=lambda p: p.data.last_used)
        freed_any = False
        for p in evictable:
            if self.has_pool_space(memory_mb):
                break
            self.free.remove(p)
            self._spawn(p.halt())
            freed_any = True
        return freed_any

    # -- proxy callbacks ---------------------------------------------------
    def _need_work(self, proxy: ContainerProxy) -> None:
        """Container became idle/warm again (ref NeedWork)."""
        if proxy in self.busy:
            self.busy.remove(proxy)
        if proxy not in self.free and not proxy._destroyed:
            self.free.append(proxy)
        self._process_buffer()

    def _removed(self, proxy: ContainerProxy) -> None:
        for pool in (self.free, self.busy, self.prewarmed):
            if proxy in pool:
                pool.remove(proxy)
        self._process_buffer()

    def _reschedule(self, job: Job) -> None:
        action, msg = job
        self.run(Run(action, msg, retry=True))

    def _process_buffer(self) -> None:
        while self.run_buffer:
            job = self.run_buffer.popleft()
            if not self._try_schedule(job):
                self.run_buffer.appendleft(job)
                break
        self._emit_gauges()

    # -- helpers -----------------------------------------------------------
    def _new_proxy(self) -> ContainerProxy:
        proxy = self.make_proxy()
        proxy.on_need_work = self._need_work
        proxy.on_removed = self._removed
        proxy.on_reschedule = self._reschedule
        return proxy

    def _spawn(self, coro) -> None:
        t = asyncio.get_event_loop().create_task(coro)
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)

    def _emit_gauges(self) -> None:
        if self.metrics:
            self.metrics.gauge("invoker_containerPool_free", len(self.free))
            self.metrics.gauge("invoker_containerPool_busy", len(self.busy))
            self.metrics.gauge("invoker_containerPool_prewarmed", len(self.prewarmed))
            self.metrics.gauge("invoker_containerPool_runBuffer", len(self.run_buffer))
            self.metrics.gauge("invoker_containerPool_memory_mb", self.memory_consumption_mb())

    async def shutdown(self) -> None:
        self._shutdown = True
        all_proxies = self.free + self.busy + self.prewarmed
        self.free, self.busy, self.prewarmed = [], [], []
        for p in all_proxies:
            try:
                await p.halt()
            except Exception:  # noqa: BLE001
                pass
        for t in list(self._tasks):
            t.cancel()


def _job_key(action: ExecutableWhiskAction, msg: ActivationMessage) -> str:
    rev = action.rev.rev or ""
    return f"{action.fully_qualified_name}@{rev}/{msg.user.namespace.name}"
