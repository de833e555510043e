"""The container proxy's pause against a warm run's resume, on real
process containers, in both packages.

`ContainerProxy._pause_later` stops an idle container (SIGSTOP on a
process container) `pause_grace` seconds after its last run, and
`_run_warm` resumes it (SIGCONT) before posting /run. A stop that lands
while a /run is in flight holds that run to the action's time limit: the
suspect of one 502 "action exceeded its time limit" in a deployment run
of the port on the card (ROADMAP Queue 3).

Each case drives one process container of the in-repo action proxy with
a pause grace of 10 ms and warm runs whose gaps straddle the grace (and
bursts of concurrent runs on a max_conc 4 action), so that pauses, resumes
and runs interleave at every offset the grace allows. It holds three
things: every run returns the action's result; no run nears the time
limit; and no SIGSTOP is sent while a run is active on the proxy. It also
requires that the pauses and resumes happened, so the race windows were
exercised. The two packages' proxies and process containers are the
same code; each is driven the same way.
"""
import asyncio
import importlib
import time

import numpy as np
import pytest

GRACE_S = 0.01
#: the action's time limit, and the most a warm run of `main` may take
LIMIT_MS, SLOW_S = 10_000, 5.0
SERIAL_RUNS, BURSTS, BURST = 120, 24, 4


def _pkg(side):
    root = "openwhisk_tpu" if side == "jax" else "openwhisk_tpu_torch"
    mod = {n: importlib.import_module(f"{root}.{n}") for n in (
        "containerpool", "core.entity", "core.entity.ids", "messaging",
        "utils.transaction")}
    return mod


class _Recorder:
    def __init__(self):
        self.stored = []

    async def active_ack(self, *args):
        return None

    async def store_activation(self, transid, activation, user):
        self.stored.append(activation)


async def _race(side, mode, seed):
    m = _pkg(side)
    cp, E = m["containerpool"], m["core.entity"]
    E.ConcurrencyLimit.MAX = max(E.ConcurrencyLimit.MAX, 4)
    factory = cp.ProcessContainerFactory()
    rec = _Recorder()
    proxy = cp.ContainerProxy(
        factory, rec.active_ack, rec.store_activation,
        cp.ContainerLogStore().collect_logs, instance=0,
        pool_config=cp.ContainerPoolConfig(pause_grace=GRACE_S,
                                           idle_container_timeout=600))
    action = E.ExecutableWhiskAction(
        E.EntityPath("guest"), E.EntityName("race"),
        E.CodeExec(kind="python:3",
                   code="def main(a):\n    return {'n': a.get('n')}\n"),
        limits=E.ActionLimits(E.TimeLimit(LIMIT_MS), E.MemoryLimit(E.MB(256)),
                              None, E.ConcurrencyLimit(
                                  BURST if mode == "bursts" else 1)))
    action.rev = m["core.entity.ids"].DocRevision("1-race")
    ident = E.Identity.generate("guest")
    msg_cls, tx = m["messaging"].ActivationMessage, m["utils.transaction"]
    counter = [0]

    def msg():
        counter[0] += 1
        return msg_cls(tx.TransactionId(), action.fully_qualified_name,
                       "1-race", ident, E.ActivationId.generate(),
                       E.ControllerInstanceId("0"), True,
                       {"n": counter[0]})

    events = {"suspend": 0, "resume": 0, "stop_while_active": 0}
    durations = []

    async def run_one():
        t0 = time.monotonic()
        await asyncio.wait_for(proxy.run(action, msg()), LIMIT_MS / 1e3 + 5)
        durations.append(time.monotonic() - t0)

    rng = np.random.RandomState(seed)
    try:
        await run_one()  # cold: create + /init + /run
        container = proxy.container
        suspend, resume = container.suspend, container.resume

        async def counted_suspend():
            events["suspend"] += 1
            events["stop_while_active"] += int(proxy.active_count > 0)
            await suspend()

        async def counted_resume():
            events["resume"] += 1
            await resume()

        container.suspend, container.resume = counted_suspend, counted_resume
        if mode == "serial":
            for _ in range(SERIAL_RUNS):
                await asyncio.sleep(float(rng.uniform(0.0, 2 * GRACE_S)))
                await run_one()
        else:
            for _ in range(BURSTS):
                await asyncio.sleep(float(rng.uniform(0.0, 2 * GRACE_S)))
                await asyncio.gather(*[run_one() for _ in range(BURST)])
        assert proxy.container is container, "the warm container survived"
    finally:
        await factory.cleanup()
    return rec.stored, events, durations, counter[0]


@pytest.mark.parametrize("mode", ["serial", "bursts"])
@pytest.mark.parametrize("side", ["jax", "port"])
def test_pause_never_stops_a_running_container(side, mode):
    stored, events, durations, n = asyncio.run(
        _race(side, mode, seed=7 if mode == "serial" else 11))
    assert len(stored) == n
    bad = [a.response.to_json() for a in stored if not a.response.is_success]
    assert not bad, bad[:3]
    assert sorted(a.response.result["n"] for a in stored) == \
        list(range(1, n + 1))
    assert max(durations[1:]) < SLOW_S, max(durations[1:])
    assert events["stop_while_active"] == 0, events
    # the race windows were exercised: the container paused and resumed
    assert events["suspend"] >= 10 and events["resume"] >= 10, events
