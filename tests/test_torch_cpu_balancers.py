"""The port's CPU balancers: `ShardingBalancer` and `LeanBalancer`
(`openwhisk_tpu_torch/controller/loadbalancer/{sharding_balancer,lean}.py`)
and the completed `models/sharding_policy.py`.

The JAX package's `tests/test_balancers.py::TestBalancers` cases over the
port's sharding balancer and the lean balancer; the same seeded traffic
through the JAX and the port `ShardingBalancer` choosing the same invoker
for every activation; a seeded fuzz of `schedule` / `release` against the
JAX module; and the NumPy planes counting every completion in the
`/admin/slo` numbers.
"""
import asyncio
import random
import types

import pytest

from openwhisk_tpu_torch.controller.loadbalancer import (
    ActiveAckTimeout, HEALTHY, LeanBalancer, LoadBalancerException,
    ShardingBalancer, UNHEALTHY)
from openwhisk_tpu_torch.core import entity as E
from openwhisk_tpu_torch.messaging import (MemoryMessagingProvider,
                                           PingMessage)
from openwhisk_tpu_torch.models import sharding_policy as TS
from openwhisk_tpu.models import sharding_policy as JS
from test_torch_balancer_front import (SimInvoker, _fleet, make_action,
                                       make_msg)

CTRL = E.ControllerInstanceId("0")


def run(coro, timeout=30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def sharding(provider, **kw):
    kw.setdefault("managed_fraction", 1.0)
    kw.setdefault("blackbox_fraction", 0.0)
    return ShardingBalancer(provider, CTRL, **kw)


async def _ping_all(invokers, producer, bal, timeout=5.0):
    for inv in invokers:
        await inv.ping(producer)
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    n = len(invokers)
    while not (len(bal._usable) >= n and all(bal._usable[:n])):
        assert loop.time() - t0 < timeout, "pings were not handled"
        await asyncio.sleep(0.005)


async def _stop(bal, invokers=()):
    await bal.close()
    for inv in invokers:
        await inv.stop()


# -- ref tests/test_balancers.py::TestBalancers --------------------------------
def test_publish_roundtrip_and_release():
    async def go():
        provider = MemoryMessagingProvider()
        bal = sharding(provider)
        await bal.start()
        invokers, producer = await _fleet(provider, 4)
        await _ping_all(invokers, producer, bal)
        ident = E.Identity.generate("guest")
        action = make_action()
        promises = [await bal.publish(action, make_msg(action, ident, True))
                    for _ in range(8)]
        results = await asyncio.gather(*[asyncio.wait_for(p, 5)
                                         for p in promises])
        for _ in range(100):
            if not bal.total_active_activations:
                break
            await asyncio.sleep(0.01)
        out = (results, bal.total_active_activations,
               len(bal.activation_slots), [len(i.handled) for i in invokers],
               [s.semaphore.available_permits for s in bal.policy.invokers])
        await _stop(bal, invokers)
        return out

    results, total, slots, handled, permits = run(go())
    assert len(results) == 8
    assert all(r.response.is_success for r in results)
    assert total == 0 and slots == 0
    assert sum(handled) == 8
    assert permits == [2048] * 4  # every slot released


def test_affinity_same_action_same_invoker():
    async def go():
        provider = MemoryMessagingProvider()
        bal = sharding(provider)
        await bal.start()
        invokers, producer = await _fleet(provider, 8)
        await _ping_all(invokers, producer, bal)
        ident = E.Identity.generate("guest")
        action = make_action("affine", memory=128)
        for _ in range(4):
            p = await bal.publish(action, make_msg(action, ident, True))
            await asyncio.wait_for(p, 5)
            await asyncio.sleep(0.05)  # release between invokes
        handled = [len(i.handled) for i in invokers]
        await _stop(bal, invokers)
        return handled

    # all 4 sequential invokes land on the home invoker (warm affinity)
    assert sorted(run(go())) == [0, 0, 0, 0, 0, 0, 0, 4]


def test_no_invokers_raises():
    async def go():
        bal = ShardingBalancer(MemoryMessagingProvider(), CTRL)
        await bal.start()
        ident = E.Identity.generate("guest")
        action = make_action()
        try:
            with pytest.raises(LoadBalancerException):
                await bal.publish(action, make_msg(action, ident))
        finally:
            await bal.close()

    run(go())


def test_unhealthy_invoker_not_scheduled():
    async def go():
        provider = MemoryMessagingProvider()
        bal = sharding(provider)
        await bal.start()
        invokers, producer = await _fleet(provider, 4)
        await _ping_all(invokers, producer, bal)
        ident = E.Identity.generate("guest")
        action = make_action("affine2", memory=128)
        p = await bal.publish(action, make_msg(action, ident, True))
        await asyncio.wait_for(p, 5)
        home = max(range(4), key=lambda i: len(invokers[i].handled))
        # flap the home invoker to unhealthy via system-error outcomes
        for _ in range(5):
            bal.supervision.on_invocation_finished(
                invokers[home].instance, is_system_error=True, forced=False)
        await asyncio.sleep(0.05)
        status = dict((h.id.instance, h.status)
                      for h in await bal.invoker_health())[home]
        p = await bal.publish(action, make_msg(action, ident, True))
        await asyncio.wait_for(p, 5)
        handled = [len(i.handled) for i in invokers]
        await _stop(bal, invokers)
        return home, status, handled

    home, status, handled = run(go())
    assert status == UNHEALTHY
    assert handled[home] == 1  # the second invoke avoided the unhealthy home
    assert sum(handled) == 2


def test_forced_timeout_self_heals_slots():
    async def go():
        provider = MemoryMessagingProvider()
        bal = sharding(provider)
        bal.TIMEOUT_FACTOR = 0
        bal.TIMEOUT_ADDON = 0.2  # completion-ack timeout ~0.2 s
        bal.STD_TIMEOUT = 0.0
        await bal.start()
        # an invoker that never acks
        provider.ensure_topic("invoker0")
        await provider.get_producer().send("health", PingMessage(
            E.InvokerInstanceId(0, user_memory=E.MB(2048))))
        await asyncio.sleep(0.1)
        ident = E.Identity.generate("guest")
        action = make_action()
        promise = await bal.publish(action, make_msg(action, ident, True))
        assert bal.total_active_activations == 1
        with pytest.raises(ActiveAckTimeout):
            await asyncio.wait_for(promise, 5)
        healed = (bal.total_active_activations,
                  bal.policy.invokers[0].semaphore.available_permits)
        await bal.close()
        return healed

    assert run(go()) == (0, 2048)


def test_out_of_order_first_ping():
    """Invoker 3 pinging first must not make 0..2 usable (the registry
    backfill must not misdispatch)."""
    async def go():
        provider = MemoryMessagingProvider()
        bal = sharding(provider)
        await bal.start()
        producer = provider.get_producer()
        inv3 = SimInvoker(provider, E.InvokerInstanceId(
            3, user_memory=E.MB(2048)))
        await inv3.start()
        await inv3.ping(producer)
        await asyncio.sleep(0.1)
        ident = E.Identity.generate("guest")
        for i in range(6):
            action = make_action(f"ooo{i}", memory=128)
            p = await bal.publish(action, make_msg(action, ident, True))
            await asyncio.wait_for(p, 5)
        handled = len(inv3.handled)
        await _stop(bal, [inv3])
        return handled

    assert run(go()) == 6


def test_cluster_resharding_divides_every_invoker():
    async def go():
        provider = MemoryMessagingProvider()
        bal = sharding(provider)
        await bal.start()
        invokers, producer = await _fleet(provider, 2, memory_mb=4096)
        await _ping_all(invokers, producer, bal)
        before = [s.semaphore.available_permits for s in bal.policy.invokers]
        bal.update_cluster(4)
        after = [s.semaphore.available_permits for s in bal.policy.invokers]
        size = bal.cluster_size
        occ = bal.occupancy()
        await _stop(bal, invokers)
        return before, after, size, occ

    before, after, size, occ = run(go())
    assert before == [4096, 4096] and after == [1024, 1024] and size == 4
    assert occ["kernel"] == "cpu" and len(occ["invokers"]) == 2


def test_lean_balancer_roundtrip_through_its_in_process_invoker():
    async def go():
        provider = MemoryMessagingProvider()
        made = []

        async def factory(invoker_id, messaging_provider):
            inv = SimInvoker(messaging_provider, invoker_id)
            await inv.start()
            made.append(inv)
            return inv

        bal = LeanBalancer(provider, CTRL, factory, user_memory=E.MB(1024))
        await bal.start()
        ident = E.Identity.generate("guest")
        action = make_action("lean", memory=256)
        ps = [await bal.publish(action, make_msg(action, ident, True))
              for _ in range(5)]
        results = await asyncio.gather(*[asyncio.wait_for(p, 5) for p in ps])
        for _ in range(100):
            if not bal.total_active_activations:
                break
            await asyncio.sleep(0.01)
        health = await bal.invoker_health()
        occ = bal.occupancy()
        slo = bal.telemetry.slo_report(bal._telemetry_invoker_names())
        out = (results, len(made[0].handled), bal.total_active_activations,
               [(h.id.as_string, h.status) for h in health], occ, slo)
        await bal.close()
        return out

    results, handled, active, health, occ, slo = run(go())
    assert all(r.response.is_success for r in results) and handled == 5
    assert active == 0
    assert health == [("invoker0", HEALTHY)]
    assert occ["invokers"][0]["invoker"] == "invoker0"
    assert slo["global"]["count"] == 5
    assert [r["invoker"] for r in slo["invokers"]] == ["invoker0"]


# -- the same traffic through both packages ------------------------------------
def _jax_package():
    from openwhisk_tpu.controller.loadbalancer.base import HEALTHY as JH
    from openwhisk_tpu.controller.loadbalancer.base import UNHEALTHY as JU
    from openwhisk_tpu.controller.loadbalancer.sharding_balancer import \
        ShardingBalancer as JB
    from openwhisk_tpu.core import entity as JE
    from openwhisk_tpu.core.entity.ids import DocRevision as JRev
    from openwhisk_tpu.messaging import memory as JMem
    from openwhisk_tpu.messaging.message import ActivationMessage as JMsg
    from openwhisk_tpu.utils.transaction import TransactionId as JTx
    return types.SimpleNamespace(E=JE, Rev=JRev, Mem=JMem, Msg=JMsg, Tx=JTx,
                                 Balancer=JB, HEALTHY=JH, UNHEALTHY=JU)


def _port_package():
    from openwhisk_tpu_torch.core.entity.ids import DocRevision as TRev
    from openwhisk_tpu_torch.messaging import memory as TMem
    from openwhisk_tpu_torch.messaging.message import \
        ActivationMessage as TMsg
    from openwhisk_tpu_torch.utils.transaction import TransactionId as TTx
    return types.SimpleNamespace(E=E, Rev=TRev, Mem=TMem, Msg=TMsg, Tx=TTx,
                                 Balancer=ShardingBalancer, HEALTHY=HEALTHY,
                                 UNHEALTHY=UNHEALTHY)


def _traffic(seed, n_ops=240):
    """A seeded script: fleet memories, then publishes of 24 actions
    (128-512 MB, a fifth with concurrency 2-8, a tenth blackbox) over 6
    namespaces, interleaved with acks of random outstanding activations and
    health flips."""
    rng = random.Random(seed)
    fleet = [rng.choice((1024, 2048, 4096)) for _ in range(rng.randint(3, 12))]
    actions = [(f"a{k}", rng.choice((128, 256, 512)),
                rng.choice((2, 4, 8)) if rng.random() < 0.2 else 1,
                rng.random() < 0.1) for k in range(24)]
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.6:
            ops.append(("pub", rng.randrange(len(actions)), rng.randrange(6)))
        elif r < 0.95:
            ops.append(("ack", rng.random()))
        else:
            ops.append(("flip", rng.randrange(len(fleet)),
                        rng.random() < 0.5))
    return fleet, actions, ops


async def _drive(pkg, seed, managed, blackbox):
    """Run the script through one package's ShardingBalancer with the
    invoker sends stubbed out; returns (invoker, forced) per publish."""
    fleet, actions, ops = _traffic(seed)
    E_ = pkg.E
    provider = pkg.Mem.MemoryMessagingProvider()
    bal = pkg.Balancer(provider, E_.ControllerInstanceId("0"),
                       managed_fraction=managed, blackbox_fraction=blackbox)

    async def no_send(msg, invoker):
        return None

    bal.send_activation_to_invoker = no_send
    for i, mem in enumerate(fleet):
        bal._status_change(E_.InvokerInstanceId(
            i, user_memory=E_.MB(mem)), pkg.HEALTHY)
    idents = [E_.Identity.generate(f"ns{k}") for k in range(6)]
    made = []
    for name, mem, conc, bb in actions:
        kind = "blackbox" if bb else "python:3"
        ex = (E_.BlackBoxExec(image="img/x", code="x") if bb
              else E_.CodeExec(kind=kind, code="x"))
        a = E_.ExecutableWhiskAction(
            E_.EntityPath("guest"), E_.EntityName(name), ex,
            limits=E_.ActionLimits(E_.TimeLimit(5000),
                                   E_.MemoryLimit(E_.MB(mem)),
                                   concurrency=E_.ConcurrencyLimit(conc)))
        a.rev = pkg.Rev("1-b")
        made.append(a)
    random.seed(seed)  # forced placements draw from the module's RNG
    chosen, outstanding = [], []
    try:
        for op in ops:
            if op[0] == "pub":
                action, ident = made[op[1]], idents[op[2]]
                msg = pkg.Msg(pkg.Tx(), action.fully_qualified_name,
                              action.rev.rev, ident,
                              E_.ActivationId.generate(),
                              E_.ControllerInstanceId("0"), False, {})
                try:
                    await bal.publish(action, msg)
                except Exception as e:  # noqa: BLE001 — no invoker
                    chosen.append(("refused", type(e).__name__))
                    continue
                entry = bal.activation_slots[msg.activation_id.asString]
                chosen.append((entry.invoker.instance, entry.is_blackbox))
                outstanding.append(msg.activation_id)
            elif op[0] == "ack" and outstanding:
                aid = outstanding.pop(int(op[1] * len(outstanding)))
                bal.process_completion(aid, forced=False,
                                       is_system_error=False, invoker=None)
            elif op[0] == "flip":
                inv = bal._registry[op[1]]
                bal._status_change(inv, pkg.HEALTHY if op[2]
                                   else pkg.UNHEALTHY)
        books = [(s.usable, s.semaphore.available_permits)
                 for s in bal.policy.invokers]
        forced = bal.metrics.counter_value("loadbalancer_forced_placements")
    finally:
        await bal.close()
    return chosen, books, forced


@pytest.mark.parametrize("managed,blackbox", [(1.0, 0.0), (0.9, 0.1),
                                              (0.5, 0.5)])
@pytest.mark.parametrize("seed", [3, 17])
def test_sharding_balancer_places_as_the_jax_one(seed, managed, blackbox,
                                                 monkeypatch):
    for pkg in (_jax_package(), _port_package()):
        monkeypatch.setattr(pkg.E.ConcurrencyLimit, "MAX", 16)
    jax_run = run(_drive(_jax_package(), seed, managed, blackbox))
    port_run = run(_drive(_port_package(), seed, managed, blackbox))
    chosen, books, forced = port_run
    assert len(chosen) > 100
    assert port_run == jax_run


# -- sharding_policy against the JAX module ------------------------------------
@pytest.mark.parametrize("seed", range(6))
def test_schedule_and_release_match_the_jax_policy(seed):
    rng = random.Random(seed)
    mems = [rng.choice((256, 512, 1024, 2048, 4096))
            for _ in range(rng.randint(1, 40))]
    cluster = rng.choice((1, 2, 3, 8))
    managed = rng.choice((1.0, 0.9, 0.5))
    states = [mod.ShardingPolicyState.build(mems, cluster_size=cluster,
                                            managed_fraction=managed,
                                            blackbox_fraction=1 - managed)
              for mod in (JS, TS)]
    held = []
    for step in range(400):
        r = rng.random()
        if r < 0.55:
            ns, act = f"ns{rng.randrange(5)}", f"act{rng.randrange(30)}"
            mem = rng.choice((128, 256, 512, 1024))
            conc = rng.choice((1, 1, 1, 4, 16))
            bb = rng.random() < 0.2
            forced_rand = rng.randrange(1 << 20) if rng.random() < 0.5 \
                else None
            outs = [mod.schedule(st, ns, act, mem, conc, blackbox=bb,
                                 rng=random.Random(step),
                                 forced_rand=forced_rand)
                    for mod, st in zip((JS, TS), states)]
            assert outs[0] == outs[1], (step, outs)
            if outs[1][0] is not None:
                held.append((outs[1][0], act, mem, conc))
        elif r < 0.9 and held:
            inv, act, mem, conc = held.pop(rng.randrange(len(held)))
            for mod, st in zip((JS, TS), states):
                mod.release(st, inv, act, mem, conc)
        elif r < 0.95:
            i, usable = rng.randrange(len(mems)), rng.random() < 0.5
            for st in states:
                st.set_health(i, usable)
        else:
            n = rng.choice((1, 2, 4))
            for st in states:
                st.update_cluster(n)
        books = [[(s.usable, s.semaphore.available_permits,
                   s.user_memory_mb) for s in st.invokers] for st in states]
        assert books[0] == books[1], step
    assert [st.step_sizes_managed for st in states][0] == \
        states[1].step_sizes_managed


# -- the NumPy planes -----------------------------------------------------------
def test_numpy_planes_count_every_completion():
    """The sharding balancer feeds the NumPy telemetry twin on every
    completion and runs the NumPy anomaly step on its supervision tick:
    `/admin/slo`'s numbers count every activation."""
    from openwhisk_tpu_torch.ops.telemetry import NumpyLatencyAccumulator

    async def go():
        provider = MemoryMessagingProvider()
        bal = sharding(provider)
        await bal.start()
        invokers, producer = await _fleet(provider, 3)
        await _ping_all(invokers, producer, bal)
        ident = E.Identity.generate("guest")
        ps = []
        for k in range(12):
            action = make_action(f"slo{k % 4}", memory=128)
            ps.append(await bal.publish(action, make_msg(action, ident,
                                                         True)))
        await asyncio.gather(*[asyncio.wait_for(p, 5) for p in ps])
        for _ in range(100):
            if not bal.total_active_activations:
                break
            await asyncio.sleep(0.01)
        bal._plane_tick()
        acc = bal.telemetry.accumulator
        slo = bal.telemetry.slo_report(bal._telemetry_invoker_names())
        scores = bal.anomaly._scores
        handled = [len(i.handled) for i in invokers]
        text = bal.metrics.prometheus_text()
        await _stop(bal, invokers)
        return acc, slo, scores, handled, text

    acc, slo, scores, handled, text = run(go())
    assert isinstance(acc, NumpyLatencyAccumulator)
    assert slo["kernel"] == "cpu" and slo["global"]["count"] == 12
    per_inv = {r["invoker"]: r["count"] for r in slo["invokers"]}
    assert per_inv == {f"invoker{i}": n for i, n in enumerate(handled) if n}
    assert sum(r["count"] for r in slo["namespaces"]) == 12
    assert scores is not None and scores.shape[1] >= 3
    assert "openwhisk_bus_consumer_reconnects" in text
