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

On a process container `suspend` has no await point, so a pause is
atomic on the loop. The docker factory's `suspend` awaits a `docker
pause` subprocess (here the CLI shim of `tests/fake_docker/`, whose
containers are real action proxy processes, paused with SIGSTOP): a run
can arrive while that pause is in flight. The docker cases run the same
schedule through that factory and also count the runs that met a pause
in flight. There the JAX package's proxy can stall a run to its time
limit; the port's waits for the pause to land and resumes once for the
runs that met it (`openwhisk_tpu_torch/containerpool/proxy.py`).
"""
import asyncio
import importlib
import os
import pathlib
import time

import numpy as np
import pytest

GRACE_S = 0.01
#: the action's time limit, and the most a warm run of `main` may take
LIMIT_MS, SLOW_S = 10_000, 5.0
SERIAL_RUNS, BURSTS, BURST = 120, 24, 4
#: the CLI shim on addresses of its own (`tests/fake_docker_port/docker`)
SHIM_DIR = str(pathlib.Path(__file__).parent / "fake_docker_port")


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


async def _race(side, mode, seed, factory_kind="process"):
    m = _pkg(side)
    cp, E = m["containerpool"], m["core.entity"]
    E.ConcurrencyLimit.MAX = max(E.ConcurrencyLimit.MAX, 4)
    factory = cp.ProcessContainerFactory() if factory_kind == "process" \
        else cp.DockerContainerFactory(f"race{side}")
    rec = _Recorder()
    events = {"suspend": 0, "resume": 0, "stop_while_active": 0,
              "met_pause_in_flight": 0, "rescheduled": 0}

    def rescheduled(job):  # a failed resume hands the job back to the pool
        events["rescheduled"] += 1

    proxy = cp.ContainerProxy(
        factory, rec.active_ack, rec.store_activation,
        cp.ContainerLogStore().collect_logs, instance=0,
        pool_config=cp.ContainerPoolConfig(pause_grace=GRACE_S,
                                           idle_container_timeout=600),
        on_reschedule=rescheduled)
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

    durations = []
    pausing = [0]

    async def run_one():
        t0 = time.monotonic()
        events["met_pause_in_flight"] += int(pausing[0] > 0)
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
            pausing[0] += 1
            try:
                await suspend()
            finally:
                pausing[0] -= 1

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
        events["replaced"] = int(proxy.container is not container)
    finally:
        await factory.cleanup()
    return rec.stored, events, durations, counter[0]


@pytest.mark.parametrize("mode", ["serial", "bursts"])
@pytest.mark.parametrize("side", ["jax", "port"])
def test_pause_never_stops_a_running_container(side, mode):
    stored, events, durations, n = asyncio.run(
        _race(side, mode, seed=7 if mode == "serial" else 11))
    _hold(stored, events, durations, n)


@pytest.fixture
def docker_shim(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", SHIM_DIR + os.pathsep + os.environ["PATH"])
    monkeypatch.setenv("FAKE_DOCKER_STATE", str(tmp_path / "state"))


@pytest.mark.parametrize("mode", ["serial", "bursts"])
@pytest.mark.parametrize("side", ["jax", "port"])
def test_runs_that_meet_a_docker_pause_in_flight(side, mode, docker_shim):
    """The port holds every run to the contract above. The JAX package's
    proxy is run the same way for the record: there a run that meets a
    pause in flight cancels the pause timer but not the `docker pause`,
    its `docker unpause` can land first, and the run then waits out the
    time limit on a stopped container (or, with concurrent runs, a resume
    fails and the job is handed back). Its faults are printed, not held:
    whether a given run meets one is a race."""
    stored, events, durations, n = asyncio.run(
        _race(side, mode, seed=7 if mode == "serial" else 11,
              factory_kind="docker"))
    failed = [a.response.result for a in stored if not a.response.is_success]
    print(f"{side} {mode} docker: {events}, failed runs {failed[:2]} "
          f"({len(failed)}), longest warm run "
          f"{max(durations[1:]) * 1e3:.1f} ms")
    assert events["met_pause_in_flight"] >= 1, events
    assert len(stored) + events["rescheduled"] == n
    if side == "port":
        _hold(stored, events, durations, n)


def _hold(stored, events, durations, n):
    assert events["rescheduled"] == 0, events
    assert not events["replaced"], "the warm container survived"
    assert len(stored) == n
    bad = [a.response.to_json() for a in stored if not a.response.is_success]
    assert not bad, bad[:3]
    assert sorted(a.response.result["n"] for a in stored) == \
        list(range(1, n + 1))
    assert max(durations[1:]) < SLOW_S, max(durations[1:])
    assert events["stop_while_active"] == 0, events
    # the race windows were exercised: the container paused and resumed
    assert events["suspend"] >= 10 and events["resume"] >= 10, events
