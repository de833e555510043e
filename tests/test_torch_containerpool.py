"""The port's container pool never runs more activations on one container
than the action's concurrency limit, even when a burst of jobs is scheduled
in one event-loop sweep (the burst a batched publish delivers to the
in-process invoker). Stub containers record how many runs overlap."""
import asyncio
import time

import pytest

from openwhisk_tpu_torch.containerpool import (Container, ContainerPool,
                                               ContainerPoolConfig,
                                               ContainerProxy, Run)
from openwhisk_tpu_torch.containerpool.container import RunResult
from openwhisk_tpu_torch.containerpool.logstore import ContainerLogStore
from openwhisk_tpu_torch.core.entity import (ActionLimits, ActivationId,
                                             CodeExec, ConcurrencyLimit,
                                             ControllerInstanceId, EntityName,
                                             EntityPath, ExecutableWhiskAction,
                                             Identity, MB, MemoryLimit,
                                             TimeLimit)
from openwhisk_tpu_torch.core.entity.ids import DocRevision
from openwhisk_tpu_torch.messaging.message import ActivationMessage
from openwhisk_tpu_torch.utils.transaction import TransactionId


class OverlapContainer(Container):
    """Runs take `run_s` and count how many were in flight at once."""

    def __init__(self, cid, run_s):
        super().__init__(cid, ("127.0.0.1", 0))
        self.run_s = run_s
        self.in_flight = 0
        self.most = 0
        self.runs = 0

    async def initialize(self, init_payload, timeout=60.0):
        return 1

    async def run(self, args, environment, timeout=60.0):
        self.in_flight += 1
        self.most = max(self.most, self.in_flight)
        self.runs += 1
        start = time.time()
        await asyncio.sleep(self.run_s)
        self.in_flight -= 1
        return RunResult(start, time.time(), {"echo": args}, ok=True)

    async def suspend(self):
        pass

    async def resume(self):
        pass

    async def logs(self, limit_bytes=10 * 1024 * 1024, wait_for_sentinel=True):
        return []


class Factory:
    def __init__(self, run_s):
        self.run_s = run_s
        self.created = []

    async def create_container(self, transid, name, image, memory,
                               cpu_shares=0, action=None):
        c = OverlapContainer(f"c{len(self.created)}", self.run_s)
        self.created.append(c)
        return c


def make_action(concurrency):
    old_max = ConcurrencyLimit.MAX
    ConcurrencyLimit.MAX = max(concurrency, 1)
    try:
        limits = ActionLimits(TimeLimit(10_000), MemoryLimit(MB(256)), None,
                              ConcurrencyLimit(concurrency))
    finally:
        ConcurrencyLimit.MAX = old_max
    a = ExecutableWhiskAction(EntityPath("guest"), EntityName("hello"),
                              CodeExec(kind="python:3",
                                       code="def main(a): return a"),
                              limits=limits)
    a.rev = DocRevision("1-test")
    return a


def make_msg(action, i):
    return ActivationMessage(
        TransactionId(), action.fully_qualified_name, action.rev.rev,
        Identity.generate("guest"), ActivationId.generate(),
        ControllerInstanceId("0"), True, {"i": i})


async def burst(concurrency, jobs, user_memory_mb):
    factory = Factory(run_s=0.05)
    acks = []
    done = asyncio.Event()

    async def active_ack(transid, activation, blocking, controller, user,
                         kind):
        if kind in ("completion", "combined"):
            acks.append(activation)
            if len(acks) == jobs + 1:
                done.set()

    async def store(transid, activation, user):
        pass

    config = ContainerPoolConfig(user_memory=MB(user_memory_mb),
                                 pause_grace=5.0, idle_container_timeout=60)
    logstore = ContainerLogStore()
    pool = ContainerPool(
        lambda: ContainerProxy(factory, active_ack, store,
                               logstore.collect_logs, instance=0,
                               pool_config=config),
        config)
    action = make_action(concurrency)
    # one run warms a container, then the burst arrives in one sweep
    pool.run(Run(action, make_msg(action, -1)))
    while not pool.free:
        await asyncio.sleep(0.005)
    for i in range(jobs):
        pool.run(Run(action, make_msg(action, i)))
    await asyncio.wait_for(done.wait(), 10)
    await pool.shutdown()
    return factory.created, acks


@pytest.mark.parametrize("concurrency,jobs,user_memory_mb", [
    (1, 6, 512), (1, 12, 1024), (2, 6, 512), (4, 9, 512)])
def test_a_burst_in_one_sweep_respects_the_concurrency_limit(
        concurrency, jobs, user_memory_mb):
    created, acks = asyncio.run(burst(concurrency, jobs, user_memory_mb))
    assert len(acks) == jobs + 1
    assert all(a.response.is_success for a in acks)
    assert sum(c.runs for c in created) == jobs + 1
    assert max(c.most for c in created) <= concurrency
    assert len(created) <= user_memory_mb // 256
