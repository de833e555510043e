"""Placement parity through each package's controller, over HTTP.

Each package's `Controller` runs over its own in-memory bus with its
`TpuBalancer` (the JAX package: `kernel="xla"`, no prewarm, no
calibration; the port: `device="cpu"`) and 8 simulated invokers of mixed
memory that register by pings. Both controllers share one event loop in a
thread of their own.

  (a) 40 sequential blocking invokes over HTTP across 6 actions: each
      invoker answers the result at once and holds the slot release until
      the end, so the books fill and later invokes leave their home
      invokers, down to forced placements. Sequential invokes are one-row
      batches, so every activation must land on the same invoker in both
      packages. Tolerance: none, invoker indices are compared.
  (b) a 64-invoke concurrent burst to the port: every invoke 200 with its
      result, nothing active afterwards and the books back at full
      capacity.
  (c) the health test action: an invoker driven unhealthy by four system
      errors receives `whisk.system/invokerHealthTestAction0` and returns
      to healthy on its acks, in both packages.
"""
import asyncio
import base64
import importlib
import socket
import threading

import aiohttp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import openwhisk_tpu as JP  # noqa: E402
import openwhisk_tpu.controller.core  # noqa: E402,F401
import openwhisk_tpu.controller.loadbalancer.supervision  # noqa: E402,F401
import openwhisk_tpu.controller.loadbalancer.tpu_balancer  # noqa: E402,F401
import openwhisk_tpu.messaging.memory  # noqa: E402,F401
import openwhisk_tpu_torch as TP  # noqa: E402
import openwhisk_tpu_torch.controller.core  # noqa: E402,F401
import openwhisk_tpu_torch.controller.loadbalancer.supervision  # noqa: E402,F401
import openwhisk_tpu_torch.controller.loadbalancer.tpu_balancer  # noqa: E402,F401
import openwhisk_tpu_torch.messaging.memory  # noqa: E402,F401

GUEST_UUID = "2c9f4ad1-4a5e-4d7e-9b11-2c9f4ad10e66"
GUEST_KEY = "controller-parity-guest-key-" + "0" * 36
HDRS = {"Authorization": "Basic " + base64.b64encode(
    f"{GUEST_UUID}:{GUEST_KEY}".encode()).decode()}
INVOKER_MB = (512, 1024, 512, 2048, 1024, 512, 1024, 768)
#: (memory MB, max concurrent) of the six actions
ACTIONS = ((128, 1), (256, 1), (384, 1), (512, 1), (256, 4), (128, 1))
SEQUENTIAL, BURST = 40, 64
CODE = "def main(args):\n    return args\n"
HEALTH_ACTION = "whisk.system/invokerHealthTestAction0"


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Fleet:
    """len(INVOKER_MB) simulated invokers on one bus: each drains its
    topic, answers with the activation's arguments as its result (a whisk
    error while it is `failing`, except for health test actions), and
    either acks completion at once or, with `hold`, keeps the slot release
    until `release_held()`."""

    def __init__(self, pkg, provider):
        self.E, self.M = pkg.core.entity, pkg.messaging.message
        self.C = importlib.import_module(pkg.__name__ + ".messaging.columnar")
        self.provider = provider
        self.producer = provider.get_producer()
        self.instances = [self.E.InvokerInstanceId(
            i, user_memory=self.E.MB(mb)) for i, mb in enumerate(INVOKER_MB)]
        self.landed = []        # (invoker, action name) in arrival order
        self.probes = []        # (invoker, action) of health test actions
        self.held = []
        self.hold = False
        self.failing = set()
        self.tasks = []

    def start(self):
        loop = asyncio.get_event_loop()
        self.tasks = [loop.create_task(self._ping())] + [
            loop.create_task(self._serve(inv)) for inv in self.instances]

    async def stop(self):
        for t in self.tasks:
            t.cancel()
        await asyncio.gather(*self.tasks, return_exceptions=True)

    async def _ping(self):
        while True:
            for inv in self.instances:
                await self.producer.send("health", self.M.PingMessage(inv))
            await asyncio.sleep(0.1)

    async def _serve(self, inv):
        E, M = self.E, self.M
        topic = inv.as_string
        self.provider.ensure_topic(topic)
        consumer = self.provider.get_consumer(topic, topic)
        while True:
            got = await consumer.peek(64, timeout=0.05)
            consumer.commit()
            msgs = []
            for _, _, _, payload in got:
                # one columnar frame per coalesced micro-batch, lone
                # messages in the plain format
                if self.C.is_batch_payload(payload):
                    msgs.extend(self.C.parse_batch(payload)[1])
                else:
                    msgs.append(M.ActivationMessage.parse(payload))
            for msg in msgs:
                action = str(msg.action)
                probe = action == HEALTH_ACTION
                if probe:
                    self.probes.append((inv.instance, action))
                else:
                    self.landed.append((inv.instance, str(msg.action.name)))
                response = (E.ActivationResponse.whisk_error("sick")
                            if inv.instance in self.failing and not probe
                            else E.ActivationResponse.success(msg.content))
                act = E.WhiskActivation(
                    E.EntityPath(str(msg.user.namespace.name)),
                    msg.action.name, msg.user.subject, msg.activation_id,
                    0.0, 0.0, response, duration=1)
                to = f"completed{msg.root_controller_index.as_string}"
                if self.hold and not probe:
                    await self.producer.send(to, M.ResultMessage(
                        msg.transid, act))
                    self.held.append((to, M.CompletionMessage(
                        msg.transid, msg.activation_id, False, inv)))
                else:
                    await self.producer.send(
                        to, M.CombinedCompletionAndResultMessage(
                            msg.transid, act, inv))

    async def release_held(self):
        held, self.held = self.held, []
        for to, msg in held:
            await self.producer.send(to, msg)


class Assembly:
    """One package's controller + balancer + fleet."""

    def __init__(self, pkg, port):
        self.pkg, self.port = pkg, port
        self.url = f"http://127.0.0.1:{port}/api/v1/namespaces/_"

    async def start(self):
        pkg, E = self.pkg, self.pkg.core.entity
        provider = pkg.messaging.memory.MemoryMessagingProvider()
        ctrl = E.ControllerInstanceId("0")
        kw = ({"kernel": "xla", "prewarm": False, "calibrate_kernel": "off"}
              if pkg is JP else {"device": "cpu"})
        self.bal = pkg.controller.loadbalancer.tpu_balancer.TpuBalancer(
            provider, ctrl, managed_fraction=1.0, blackbox_fraction=0.0,
            **kw)
        self.controller = pkg.controller.core.Controller(
            ctrl, provider, load_balancer=self.bal,
            invocations_per_minute=10 ** 6, concurrent_invocations=10 ** 6)
        ident = E.Identity(
            E.Subject("guest-subject"),
            E.Namespace(E.EntityName("guest"), E.UUID(GUEST_UUID)),
            E.BasicAuthenticationAuthKey(E.UUID(GUEST_UUID),
                                         E.Secret(GUEST_KEY)))
        await self.controller.auth_store.put(E.WhiskAuthRecord(
            ident.subject, [ident.namespace], [ident.authkey]))
        await self.controller.start(port=self.port)
        self.fleet = Fleet(pkg, provider)
        self.fleet.start()
        for _ in range(200):
            if len(self.bal._registry) == len(INVOKER_MB) and all(
                    self.bal._healthy):
                return
            await asyncio.sleep(0.05)
        raise AssertionError("the fleet did not register")

    async def stop(self):
        await self.fleet.stop()
        await self.controller.stop()

    def status(self, idx):
        return self.bal.supervision.invokers[idx].status


class Loop:
    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout=120.0):
        return asyncio.run_coroutine_threadsafe(
            asyncio.wait_for(coro, timeout), self.loop).result(timeout + 5)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


@pytest.fixture(scope="module")
def assemblies():
    with pytest.MonkeyPatch.context() as mp:
        for pkg in (JP, TP):
            # deployments opt in to intra-container concurrency
            mp.setattr(pkg.core.entity.ConcurrencyLimit, "MAX", 4)
            # probe an unhealthy invoker on its next ping
            mp.setattr(pkg.controller.loadbalancer.supervision,
                       "RECOVERY_COOLDOWN_S", 0.0)
        loop = Loop()
        built = {name: Assembly(pkg, free_port())
                 for name, pkg in (("jax", JP), ("port", TP))}
        try:
            for a in built.values():
                loop.run(a.start())
                loop.run(create_actions(a))
            yield loop, built
        finally:
            try:
                for a in built.values():
                    loop.run(a.stop())
            finally:
                loop.close()


async def create_actions(a):
    async with aiohttp.ClientSession(headers=HDRS) as s:
        for k, (mem, conc) in enumerate(ACTIONS):
            async with s.put(f"{a.url}/actions/a{k}", json={
                    "exec": {"kind": "python:3", "code": CODE},
                    "limits": {"memory": mem, "concurrency": conc}}) as r:
                assert r.status == 200, await r.text()


async def invoke(s, a, name, args):
    async with s.post(f"{a.url}/actions/{name}?blocking=true&result=true",
                      json=args) as r:
        return r.status, await r.json()


async def sequential(a, picks):
    a.fleet.hold = True
    out = []
    async with aiohttp.ClientSession(headers=HDRS) as s:
        for i, k in enumerate(picks):
            out.append(await invoke(s, a, f"a{k}", {"i": i}))
    a.fleet.hold = False
    await a.fleet.release_held()
    await drained(a)
    return out, list(a.fleet.landed), books_full(a), forced(a)


def forced(a):
    """Forced placements so far (the port counts them in `counters`, the
    JAX package on its metric emitter)."""
    if a.pkg is JP:
        return a.bal.metrics.counter_value("loadbalancer_forced_placements")
    return a.bal.counters["forced_placements"]


async def drained(a, timeout=30.0):
    loop = asyncio.get_event_loop()
    t0 = loop.time()
    while a.bal.total_active_activations or a.bal._pending or getattr(
            a.bal, "_releases", None):
        assert loop.time() - t0 < timeout, "activations stayed active"
        await asyncio.sleep(0.02)
    await asyncio.sleep(0.2)  # the last idle fold lands in the books


def books_full(a):
    occ = a.bal.occupancy()
    return [(row["capacity_mb"], row["free_mb"]) for row in occ["invokers"]]


def test_sequential_invokes_land_on_the_same_invokers(assemblies):
    loop, built = assemblies
    picks = np.random.RandomState(5).choice(len(ACTIONS), SEQUENTIAL,
                                            p=[.3, .2, .2, .1, .1, .1])
    res = {name: loop.run(sequential(a, picks))
           for name, a in built.items()}
    (jax_out, jax_landed, _, jax_forced), \
        (port_out, port_landed, port_books, port_forced) = \
        res["jax"], res["port"]
    assert port_out == [(200, {"i": i}) for i in range(SEQUENTIAL)]
    assert port_out == jax_out
    assert len(port_landed) == SEQUENTIAL
    assert port_landed == jax_landed
    # the held releases filled the books: placements left home invokers,
    # down to forced placements
    assert len({inv for inv, _ in port_landed}) > 3
    assert port_forced == jax_forced > 0
    assert all(cap == free for cap, free in port_books)


def test_concurrent_burst_on_the_port(assemblies):
    loop, built = assemblies
    a = built["port"]

    async def burst():
        async with aiohttp.ClientSession(headers=HDRS) as s:
            out = await asyncio.gather(*[
                invoke(s, a, f"a{i % len(ACTIONS)}", {"i": i})
                for i in range(BURST)])
        await drained(a)
        return out, books_full(a), a.bal.total_active_activations

    out, books, active = loop.run(burst())
    assert out == [(200, {"i": i}) for i in range(BURST)]
    assert active == 0
    assert all(cap == free for cap, free in books)


def test_health_test_action_heals_an_unhealthy_invoker(assemblies):
    loop, built = assemblies

    async def sicken_and_heal(a):
        async with aiohttp.ClientSession(headers=HDRS) as s:
            first = len(a.fleet.landed)
            await invoke(s, a, "a0", {"probe": 0})
            k = a.fleet.landed[first][0]
            a.fleet.failing.add(k)
            statuses = [(await invoke(s, a, "a0", {"sick": j}))[0]
                        for j in range(4)]
            sick = a.status(k)
            a.fleet.failing.discard(k)
            t0 = asyncio.get_event_loop().time()
            while a.status(k) != "up":
                assert asyncio.get_event_loop().time() - t0 < 30, \
                    "the invoker did not heal"
                await asyncio.sleep(0.05)
            probes = [p for p in a.fleet.probes if p[0] == k]
        await drained(a)
        return k, statuses, sick, probes[0], len(probes) >= 1

    out = {name: loop.run(sicken_and_heal(a)) for name, a in built.items()}
    k, statuses, sick, probe, probed = out["port"]
    assert sick == "unhealthy"
    assert probe == (k, HEALTH_ACTION)
    assert probed
    assert out["port"][:4] == out["jax"][:4]
