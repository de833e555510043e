"""Controller membership in the port
(`openwhisk_tpu_torch/controller/loadbalancer/membership.py`): the five
convergence cases of the JAX package's `tests/test_membership.py`, then a
JAX controller and a port controller heartbeating over one TCP bus, and the
port's `Controller` joining and leaving as the JAX package's does."""
import asyncio
import json

import pytest

from openwhisk_tpu_torch.controller.loadbalancer.membership import \
    ControllerMembership
from openwhisk_tpu_torch.core.entity import ControllerInstanceId
from openwhisk_tpu_torch.messaging import MemoryMessagingProvider


class BalancerStub:
    def __init__(self, cluster_size=1):
        self.cluster_size = cluster_size
        self.calls = []

    def update_cluster(self, n):
        self.calls.append(n)
        self.cluster_size = n


def run(coro, timeout=30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def make(provider, i, seed=1, heartbeat=0.05, timeout=0.25,
         cls=ControllerMembership, ids=ControllerInstanceId):
    bal = BalancerStub(cluster_size=seed)
    m = cls(provider, ids(str(i)), bal, heartbeat_s=heartbeat,
            member_timeout_s=timeout)
    return m, bal


async def until(cond, timeout=5.0, step=0.02):
    for _ in range(int(timeout / step)):
        if cond():
            return True
        await asyncio.sleep(step)
    return cond()


def test_two_controllers_converge_to_two():
    async def go():
        provider = MemoryMessagingProvider()
        m0, b0 = make(provider, 0)
        m1, b1 = make(provider, 1)
        m0.start(); m1.start()
        ok = await until(lambda: b0.cluster_size == 2 and
                         b1.cluster_size == 2)
        await m0.stop(); await m1.stop()
        return ok, b0.calls, b1.calls

    ok, c0, c1 = run(go())
    assert ok, (c0, c1)


def test_graceful_leave_reshards_immediately():
    async def go():
        provider = MemoryMessagingProvider()
        m0, b0 = make(provider, 0)
        m1, b1 = make(provider, 1)
        m0.start(); m1.start()
        assert await until(lambda: b0.cluster_size == 2)
        await m1.stop()  # graceful: sends the leave message
        # well inside the heartbeat timeout: the leave acts at once
        ok = await until(lambda: b0.cluster_size == 1, timeout=0.2)
        await m0.stop()
        return ok

    assert run(go())


def test_crash_reshards_after_timeout():
    async def go():
        provider = MemoryMessagingProvider()
        m0, b0 = make(provider, 0)
        m1, b1 = make(provider, 1)
        m0.start(); m1.start()
        assert await until(lambda: b0.cluster_size == 2)
        # crash: silence the heartbeats without a leave
        await m1._ticker.stop()
        await m1._feed.stop()
        ok = await until(lambda: b0.cluster_size == 1, timeout=3.0)
        await m0.stop()
        return ok

    assert run(go())


def test_boot_grace_respects_seed_size():
    """A 1-of-2 controller must not claim the whole fleet before its peer
    had a chance to heartbeat; after the grace window with no peer it
    converges down."""
    async def go():
        provider = MemoryMessagingProvider()
        m0, b0 = make(provider, 0, seed=2, timeout=0.4)
        m0.start()
        await asyncio.sleep(0.15)  # inside the grace window
        held = b0.cluster_size == 2 and b0.calls == []
        ok = await until(lambda: b0.cluster_size == 1, timeout=3.0)
        await m0.stop()
        return held, ok

    held, ok = run(go())
    assert held, "folded below the seed size during the boot grace"
    assert ok, "never converged after the grace window"


def test_rejoin_after_crash_recovers_size():
    async def go():
        provider = MemoryMessagingProvider()
        m0, b0 = make(provider, 0)
        m1, b1 = make(provider, 1)
        m0.start(); m1.start()
        assert await until(lambda: b0.cluster_size == 2)
        await m1._ticker.stop(); await m1._feed.stop()
        assert await until(lambda: b0.cluster_size == 1, timeout=3.0)
        m2, b2 = make(provider, 1)  # restart of controller1
        m2.start()
        ok = await until(lambda: b0.cluster_size == 2 and
                         b2.cluster_size == 2)
        await m0.stop(); await m2.stop()
        return ok

    assert run(go())


def test_a_jax_and_a_port_controller_converge_over_one_tcp_bus():
    """One membership of each package on the port's broker: both see two,
    and the JAX one's graceful leave re-shards the port's at once."""
    from openwhisk_tpu.controller.loadbalancer.membership import \
        ControllerMembership as JaxMembership
    from openwhisk_tpu.core.entity import ControllerInstanceId as JaxId
    from openwhisk_tpu.messaging.tcp import TcpMessagingProvider as JaxTcp
    from openwhisk_tpu_torch.messaging.tcp import (TcpBusServer,
                                                   TcpMessagingProvider)

    async def go():
        server = TcpBusServer("127.0.0.1", 0)
        await server.start()
        port = server._server.sockets[0].getsockname()[1]
        m0, b0 = make(TcpMessagingProvider("127.0.0.1", port), 0,
                      heartbeat=0.1, timeout=3.0)
        m1, b1 = make(JaxTcp("127.0.0.1", port), 1, heartbeat=0.1,
                      timeout=3.0, cls=JaxMembership, ids=JaxId)
        m0.start(); m1.start()
        both = await until(lambda: b0.cluster_size == 2 and
                           b1.cluster_size == 2, timeout=10.0)
        await m1.stop()
        # well inside the member timeout: the leave, not the silence
        left = await until(lambda: b0.cluster_size == 1, timeout=1.5)
        await m0.stop()
        await server.stop()
        return both, left

    assert run(go()) == (True, True)


@pytest.mark.parametrize("balancer", ["tpu", "sharding", "lean"])
def test_controller_joins_only_with_a_clustering_balancer(balancer):
    """`Controller.start` runs membership for a balancer that overrides
    `update_cluster` (the TPU and sharding balancers), not for lean; `stop`
    sends the leave."""
    from openwhisk_tpu_torch.controller.core import Controller
    from openwhisk_tpu_torch.controller.loadbalancer import (
        LeanBalancer, ShardingBalancer, TpuBalancer)
    from openwhisk_tpu_torch.utils.logging import NullLogging

    async def go():
        provider = MemoryMessagingProvider()
        ctrl = ControllerInstanceId("0")
        logger = NullLogging()
        if balancer == "tpu":
            lb = TpuBalancer(provider, ctrl, logger=logger, device="cpu")
        elif balancer == "sharding":
            lb = ShardingBalancer(provider, ctrl, logger=logger)
        else:
            async def factory(_inv, _provider):
                return None
            lb = LeanBalancer(provider, ctrl, factory, logger=logger)
        watcher = provider.get_consumer("controllers", "watch")
        await watcher.peek(1, timeout=0.01)
        c = Controller(ctrl, provider, logger=logger, load_balancer=lb)
        await c.start(port=0)
        joined = c.membership is not None
        await asyncio.sleep(0.1)
        await c.stop()
        msgs = [p for (*_x, p) in await watcher.peek(100, timeout=0.2)]
        return joined, msgs

    joined, msgs = run(go())
    assert joined == (balancer != "lean")
    if joined:
        kinds = [json.loads(m).get("kind") for m in msgs]
        assert "heartbeat" in kinds and kinds[-1] == "leave", kinds
    else:
        assert msgs == []
