"""The anomaly plane under the server's echo fleet, in both packages.

Each package's `Controller` with its `TpuBalancer` (the JAX package:
`kernel="xla"`, no prewarm, no calibration; the port: `device="cpu"`)
serves an echo fleet over its in-memory bus: ECHO_INVOKERS simulated
invokers that ack every activation as soon as it arrives, with its
arguments as the result. Over HTTP the client sends the server phase's
shape at a small size: ECHO_CONCURRENT blocking invokes at ECHO_INFLIGHT
in flight over a Zipf(1.1) mix of ECHO_ACTIONS actions, then ECHO_TRICKLE
one at a time. The supervision's 1 Hz tick runs the anomaly step as it
does in a server, plus two ticks after each segment.

Tick by tick, the anomaly step's input (the telemetry accumulator's
cumulative counts) is kept, and the JAX package's NumPy twin
(`anomaly_step_np`, through the JAX plane's own CPU tick) is chained over
it: the flags each plane harvests equal the twin's for the tick before,
exactly, and the scores within rtol 1e-4, atol 1e-3. `/admin/anomalies`
reports the last harvested flags. The flagged counts of both runs are
printed (`-s`): latencies are wall-clock, so the two runs differ and only
each run's agreement with the twin is held.
"""
import asyncio
import base64
import socket

import aiohttp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import openwhisk_tpu as JPKG  # noqa: E402
import openwhisk_tpu.controller.core  # noqa: E402,F401
import openwhisk_tpu.controller.loadbalancer.tpu_balancer  # noqa: E402,F401
import openwhisk_tpu.messaging.columnar  # noqa: E402,F401
import openwhisk_tpu.messaging.memory  # noqa: E402,F401
import openwhisk_tpu_torch as TPKG  # noqa: E402
import openwhisk_tpu_torch.controller.core  # noqa: E402,F401
import openwhisk_tpu_torch.controller.loadbalancer.tpu_balancer  # noqa: E402,F401,E501
import openwhisk_tpu_torch.messaging.columnar  # noqa: E402,F401
import openwhisk_tpu_torch.messaging.memory  # noqa: E402,F401
from openwhisk_tpu.controller.loadbalancer import anomaly as JA  # noqa: E402
from openwhisk_tpu.ops.anomaly import (S_ANOMALY_FLAG,  # noqa: E402
                                       S_STRAGGLER_FLAG)

ECHO_INVOKERS, ECHO_ACTIONS = 48, 20
ECHO_CONCURRENT, ECHO_INFLIGHT, ECHO_TRICKLE = 480, 32, 48
GUEST_UUID = "7a1c3e55-0b1d-4a0e-9f3c-7a1c3e550b1d"
GUEST_KEY = "anomaly-echo-guest-key-" + "0" * 41
HDRS = {"Authorization": "Basic " + base64.b64encode(
    f"{GUEST_UUID}:{GUEST_KEY}".encode()).decode()}
CODE = "def main(args):\n    return args\n"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class EchoFleet:
    """ECHO_INVOKERS invokers that ping every 0.1 s and ack each
    activation at once with its arguments (the server phase's fleet)."""

    def __init__(self, pkg, provider):
        self.E, self.M = pkg.core.entity, pkg.messaging.message
        self.C = pkg.messaging.columnar
        self.provider = provider
        self.producer = provider.get_producer()
        self.instances = [self.E.InvokerInstanceId(
            i, user_memory=self.E.MB(4096)) for i in range(ECHO_INVOKERS)]
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
            got = await consumer.peek(256, timeout=0.05)
            consumer.commit()
            msgs = []
            for _, _, _, payload in got:
                if self.C.is_batch_payload(payload):
                    msgs.extend(self.C.parse_batch(payload)[1])
                else:
                    msgs.append(M.ActivationMessage.parse(payload))
            for msg in msgs:
                act = E.WhiskActivation(
                    E.EntityPath(str(msg.user.namespace.name)),
                    msg.action.name, msg.user.subject, msg.activation_id,
                    0.0, 0.0, E.ActivationResponse.success(msg.content),
                    duration=1)
                await self.producer.send(
                    f"completed{msg.root_controller_index.as_string}",
                    M.CombinedCompletionAndResultMessage(msg.transid, act,
                                                         inv))


class Ticks:
    """Keeps each anomaly tick's input (host copies of the accumulator's
    cumulative arrays) and the scores the plane holds after it."""

    def __init__(self, plane):
        self.inputs, self.scores = [], []
        real = plane._tick_device

        def tick_device(acc):
            st = acc.state
            self.inputs.append(tuple(np.array(np.asarray(x)) for x in (
                st.inv_buckets, st.inv_lat_ms, st.inv_outcomes)))
            real(acc)
            sc = plane._scores
            self.scores.append(None if sc is None else np.array(sc))

        plane._tick_device = tick_device


async def _run(pkg):
    E = pkg.core.entity
    provider = pkg.messaging.memory.MemoryMessagingProvider()
    ctrl = E.ControllerInstanceId("0")
    kw = ({"kernel": "xla", "prewarm": False, "calibrate_kernel": "off"}
          if pkg is JPKG else {"device": "cpu"})
    bal = pkg.controller.loadbalancer.tpu_balancer.TpuBalancer(
        provider, ctrl, managed_fraction=1.0, blackbox_fraction=0.0, **kw)
    ticks = Ticks(bal.anomaly)
    controller = pkg.controller.core.Controller(
        ctrl, provider, load_balancer=bal, invocations_per_minute=10 ** 6,
        concurrent_invocations=10 ** 6)
    ident = E.Identity(
        E.Subject("guest-subject"),
        E.Namespace(E.EntityName("guest"), E.UUID(GUEST_UUID)),
        E.BasicAuthenticationAuthKey(E.UUID(GUEST_UUID), E.Secret(GUEST_KEY)))
    await controller.auth_store.put(E.WhiskAuthRecord(
        ident.subject, [ident.namespace], [ident.authkey]))
    port = _free_port()
    await controller.start(port=port)
    fleet = EchoFleet(pkg, provider)
    fleet.start()
    base = f"http://127.0.0.1:{port}"
    url = base + "/api/v1/namespaces/_/actions"
    rng = np.random.RandomState(17)
    p = np.arange(1, ECHO_ACTIONS + 1, dtype=float) ** -1.1
    picks = rng.choice(ECHO_ACTIONS, ECHO_CONCURRENT + ECHO_TRICKLE,
                       p=p / p.sum())
    try:
        for _ in range(200):
            if len(bal._registry) == ECHO_INVOKERS and all(bal._healthy):
                break
            await asyncio.sleep(0.05)
        async with aiohttp.ClientSession(headers=HDRS) as s:
            for k in range(ECHO_ACTIONS):
                async with s.put(f"{url}/a{k}", json={
                        "exec": {"kind": "python:3", "code": CODE},
                        "limits": {"memory": int(rng.choice(
                            range(128, 513, 64)))}}) as r:
                    assert r.status == 200, await r.text()

            async def invoke(i):
                async with s.post(f"{url}/a{picks[i]}?blocking=true"
                                  "&result=true", json={"i": i}) as r:
                    return r.status, await r.json()

            sem = asyncio.Semaphore(ECHO_INFLIGHT)

            async def bounded(i):
                async with sem:
                    return await invoke(i)

            out = await asyncio.gather(*[bounded(i) for i in
                                         range(ECHO_CONCURRENT)])
            for _ in range(2):
                bal._telemetry_tick()
            for i in range(ECHO_CONCURRENT,
                           ECHO_CONCURRENT + ECHO_TRICKLE):
                out.append(await invoke(i))
            for _ in range(2):
                await asyncio.sleep(0.05)
                bal._telemetry_tick()
            async with s.get(base + "/admin/anomalies") as r:
                anomalies = (r.status, await r.json())
        assert out == [(200, {"i": i}) for i in range(len(out))]
        return ticks, anomalies, bal.anomaly.config
    finally:
        await fleet.stop()
        await controller.stop()


def _twin_scores(ticks, cfg):
    """The JAX package's NumPy twin chained over the kept inputs through
    the JAX plane's CPU tick (its carry padding included)."""
    plane = JA.AnomalyPlane(JA.AnomalyConfig(
        alpha=cfg.alpha, z_threshold=cfg.z_threshold,
        spike_threshold=cfg.spike_threshold, min_samples=cfg.min_samples,
        mad_floor_ms=cfg.mad_floor_ms))
    out = []
    for buckets, lat, outcomes in ticks.inputs:
        acc = type("Acc", (), dict(inv_buckets=buckets, inv_lat_ms=lat,
                                   inv_outcomes=outcomes,
                                   n_buckets=buckets.shape[1]))()
        plane._tick_cpu(acc)
        out.append(np.array(plane._scores))
    return out


@pytest.mark.parametrize("pkg", [JPKG, TPKG], ids=["jax", "port"])
def test_echo_fleet_flags_match_the_reference_twin_tick_by_tick(pkg,
                                                                 monkeypatch):
    monkeypatch.setattr(pkg.core.entity.ConcurrencyLimit, "MAX", 4)
    ticks, (status, report), cfg = asyncio.run(
        asyncio.wait_for(_run(pkg), 120))
    assert status == 200
    twin = _twin_scores(ticks, cfg)
    compared = 0
    for k in range(1, len(ticks.scores)):
        got = ticks.scores[k]  # harvested at tick k: tick k-1's step
        if got is None:
            continue
        want = twin[k - 1]
        n = min(got.shape[1], want.shape[1])
        for row in (S_STRAGGLER_FLAG, S_ANOMALY_FLAG):
            np.testing.assert_array_equal(got[row, :n], want[row, :n],
                                          err_msg=f"tick {k} row {row}")
        np.testing.assert_allclose(got[:, :n], want[:, :n], rtol=1e-4,
                                   atol=1e-3)
        compared += 1
    assert compared >= 3
    last = ticks.scores[-1]
    flagged = sorted(int(i) for i in np.nonzero(last[S_ANOMALY_FLAG])[0])
    rows = {r["invoker"]: r for r in report["invokers"]}
    assert sorted(int(name[len("invoker"):]) for name, r in rows.items()
                  if r["anomalous"]) == flagged
    print(f"\n{pkg.__name__}: ticks {len(ticks.scores)}, compared "
          f"{compared}, anomalous after the run {len(flagged)} of "
          f"{ECHO_INVOKERS}: {flagged}, stragglers "
          f"{int(last[S_STRAGGLER_FLAG].sum())}")
