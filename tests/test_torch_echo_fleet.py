"""The load generator's echo fleet registers 10,000 invokers on the
in-memory bus.

The echo fleet (`openwhisk_tpu_torch/tools/echo_fleet.py`, a copy of three
functions of `bench.py`) pings every invoker once a second. The
reference's pinger sends all of a second's pings in one burst, and a
health topic on the in-memory bus keeps the last 4,096 messages
(`messaging/memory.py` DEFAULT_MAX_MESSAGES): at 10,000 invokers the
supervision sees only the burst's tail, so the reference's fleet never
registers (the difference asserted below). The port's named cut sends
the pings `PING_CHUNK` (256) at a time, spread over the second.

  * each package's supervision pool (its health consumer and state
    machine, over its own bus and fleet), read once all 10,000 are healthy
    or once the pinger has made two passes over the fleet and the pool has
    drained the health topic: the port's holds all 10,000 invokers
    healthy, the reference's at most what the topic keeps;
  * the port's `TpuBalancer(device="cpu")` over its fleet: 10,000
    invokers healthy.
"""
import asyncio
import importlib

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch_ha_cases import balancer, side  # noqa: E402

N = 10_000
#: what the health topic keeps on the in-memory bus (512 KB of retention
#: at ~128 B a message, capped at DEFAULT_MAX_MESSAGES)
TOPIC_KEEPS = 4096


def run(coro, timeout=60.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _echo_fleet(name):
    if name == "jax":
        import bench
        return bench._echo_fleet
    from openwhisk_tpu_torch.tools import echo_fleet
    return echo_fleet._echo_fleet


@pytest.mark.parametrize("name", ["jax", "port"])
def test_each_packages_supervision_over_its_10k_echo_fleet(name, monkeypatch):
    """Each package's supervision pool (its health consumer and FSM, no
    balancer) over its own echo fleet, read when every invoker is healthy
    or when the fleet has sent its registration pings and two passes of
    the pinger and the pool has taken in all the topic kept: the port's
    sees 10,000 invokers healthy; the reference's misses the invokers
    whose pings fell off the health topic in a burst."""
    S = side(name)
    Sup = importlib.import_module(f"{S.root}.controller.loadbalancer."
                                  "supervision")
    pings = {"sent": 0, "seen": 0}
    append = S.Mem.MemoryProducer._append_locked

    def counted(self, t, payload):
        pings["sent"] += t.name == "health"
        append(self, t, payload)

    monkeypatch.setattr(S.Mem.MemoryProducer, "_append_locked", counted)

    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        pool = Sup.InvokerPool(provider)
        on_ping = pool.on_ping

        def seen(instance):
            pings["seen"] += 1
            on_ping(instance)

        pool.on_ping = seen
        pool.start()
        feeds, stop = await _echo_fleet(name)(provider, N)
        topic = provider.bus.topic("health")
        healthy, last = 0, -1
        try:
            while True:
                await asyncio.sleep(0.25)
                healthy = sum(h.status == S.Base.HEALTHY
                              for h in pool.health())
                drained = (not topic.queue_for(pool.group)
                           and pings["seen"] == last)
                if healthy >= N or (pings["sent"] >= 3 * N and drained):
                    break
                last = pings["seen"]
        finally:
            await stop()
            for f in feeds:
                await f.stop()
            await pool.stop()
        return healthy

    healthy = run(go())
    if name == "port":
        assert healthy == N
    else:
        # the reference's burst: pings past what the topic keeps are lost
        assert 0 < healthy <= TOPIC_KEEPS < N


def test_the_ports_balancer_registers_a_10k_echo_fleet():
    S = side("port")

    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        bal = balancer(S, provider, action_slots=8)
        await bal.start()
        feeds, stop = await _echo_fleet("port")(provider, N)
        try:
            healthy = 0
            for _ in range(120):
                health = await bal.invoker_health()
                healthy = sum(h.status == S.Base.HEALTHY for h in health)
                if healthy >= N:
                    break
                await asyncio.sleep(0.25)
            return healthy
        finally:
            await stop()
            for f in feeds:
                await f.stop()
            await bal.close()

    assert run(go()) == N
