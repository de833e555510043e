"""Controller HA in the port: active/standby in process, then the
deployment's processes (the counterpart of the HA cases of
`tests/test_ha_chaos.py`).

In process, on both packages (`[jax]` / `[port]`) and across them:
  * a standby refuses placement with the reference's text, on `publish`
    and on `publish_many` (one fresh exception a row), and journals
    nothing;
  * demotion abandons the journal's buffered tail (`abandon` is called,
    later appends are dropped) and keeps the fence epoch;
  * promotion: a standby restores the active's snapshot and replays its
    journal tail (the front's seeded scenario written by an active at
    epoch 1, a snapshot mid-run) to the active's live books, bit for bit,
    with no parity mismatch, then stamps its own epoch; each package
    promotes from the other's files;
  * the sharding balancer under `--ha` fences only: the leadership epoch
    stamps its dispatches, and it has no absorb.

As processes (the port's CLIs on localhost, controllers `--device cpu`):
  * tier-1, one case: the broker, one invoker, two active/active
    controllers (`--ha`, `CONFIG_whisk_ha_activeActive`, 8 partitions,
    a journal and a snapshot each) and the edge; SIGKILL the owner of the
    guest namespace's partition; the survivor claims every partition at
    higher epochs (`/admin/ready`), absorbs, and serves the guest again
    through the edge, with no action executed twice;
  * `slow`, as the reference's chaos tests: an edge failing over between
    two controllers, journaled active/standby failover mid-burst, three
    active/active controllers losing one mid-burst, and the funnel's
    frontend/balancer roles behind the edge.
"""
import asyncio
import base64
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_balancer_front import (INITIAL_PAD, MAX_BATCH,  # noqa: E402
                                       SLOTS, _jax_package, _port_package,
                                       _scenario, run)
from torch_ha_cases import (SIDES, balancer, books, fleet,  # noqa: E402
                           make_action, make_msg, ping_all, side, stop_all)

ROOT = Path(__file__).resolve().parents[1]
both = pytest.mark.parametrize("S", [side(s) for s in SIDES], ids=SIDES)
STANDBY_TEXT = ("standby controller: placement is fenced to the active "
                "leader")


# -- active/standby in process ----------------------------------------------------
@both
def test_a_standby_refuses_placement_and_journals_nothing(S, tmp_path):
    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        bal = balancer(S, provider)
        bal.attach_journal(S.J.PlacementJournal(str(tmp_path / "w")))
        await bal.start()
        invokers, producer = await fleet(S, provider, 2)
        await ping_all(invokers, producer, [bal])
        seq0 = bal._journal_seq
        bal.set_leadership(0, False)
        action = make_action(S, "sb", memory=128)
        ident = S.E.Identity.generate("guest")
        texts = []
        try:
            await bal.publish(action, make_msg(S, action, ident, True))
        except S.Base.LoadBalancerException as e:
            texts.append(str(e))
        outs = bal.publish_many([(action, make_msg(S, action, ident))
                                 for _ in range(3)])
        excs = [o.exception() for o in outs]
        texts += [str(e) for e in excs]
        bal._journal_append({"t": "fold", "health": []})
        out = (texts, len({id(e) for e in excs}), bal._journal_seq - seq0,
               sum(len(i.handled) for i in invokers))
        await stop_all([bal], invokers)
        return out

    texts, distinct, appended, handled = run(go(), 60)
    assert texts == [STANDBY_TEXT] * 4
    assert distinct == 3, "one exception a row, as N publish calls raise"
    assert appended == 0 and handled == 0


@both
def test_demotion_abandons_the_journal_tail(S, tmp_path):
    async def go():
        bal = balancer(S, S.Mem.MemoryMessagingProvider())
        bal.attach_journal(S.J.PlacementJournal(str(tmp_path / "w")))
        calls = []
        real = bal.journal.abandon
        bal.journal.abandon = lambda: (calls.append(1), real())[1]
        bal.set_leadership(3, True)
        assert bal._journal_append({"t": "fold", "health": []}) == 1
        assert bal.journal.flush()
        bal.set_leadership(5, False)
        dropped = bal._journal_append({"t": "fold", "health": []})
        out = (len(calls), bal.ha_standby, bal.fence_epoch, dropped)
        await bal.close()
        return out

    assert run(go()) == (1, True, 5, 0)


def test_the_journal_writer_survives_an_abandon_while_it_lingers(tmp_path):
    """A demotion's `abandon()` that empties the queue while the port's
    writer thread waits out its linger leaves the writer alive: a later
    append (a re-promoted active's) is written and flushed. (The JAX
    package's writer thread dies there on an IndexError, and its later
    appends never reach the disk: ROADMAP Queue 3.)"""
    J = side("port").J
    j = J.PlacementJournal(str(tmp_path / "w"), fsync_batch=64)
    j.linger_s = 0.3
    j.append({"t": "x", "seq": 1})
    time.sleep(0.1)  # the writer is inside its linger wait now
    j.abandon()
    time.sleep(0.4)
    j.append({"t": "x", "seq": 2})
    assert j.flush(5.0)
    assert j._writer.is_alive()
    assert [r["seq"] for r in j.records(0)] == [2]
    j.close()


def _promotion_setup(S, jdir, snap):
    """`_scenario`'s setup: the active at epoch 1 with a journal, and a
    snapshot written right after publish wave 4."""
    def setup(bal):
        bal.attach_journal(S.J.PlacementJournal(jdir))
        bal.set_leadership(1, True)
        real, calls = bal.publish_many, [0]

        def publish_many(pairs):
            outs = real(pairs)
            calls[0] += 1
            if calls[0] == 4:
                S.CK.write_snapshot(bal, snap)
            return outs

        bal.publish_many = publish_many
    return setup


@pytest.fixture(scope="module")
def active_runs(tmp_path_factory):
    out = {}
    for name in SIDES:
        S = side(name)
        pkg = _jax_package() if name == "jax" else _port_package()
        d = tmp_path_factory.mktemp(f"active-{name}")
        jdir, snap = str(d / "wal"), str(d / "bal.snap")
        mp = pytest.MonkeyPatch()
        mp.setattr(pkg.E.ConcurrencyLimit, "MAX", 16)
        coalesce = __import__(f"{S.root}.messaging.coalesce",
                              fromlist=["maybe_coalesce"])
        try:
            res = run(_scenario(
                pkg, None, False, 71,
                ack_producer=lambda prov, co=coalesce:
                co.maybe_coalesce(prov.get_producer()),
                setup=_promotion_setup(S, jdir, snap),
                inspect=lambda bal: (bal.journal.flush(),
                                     bal.journal.close())), 120)
        finally:
            mp.undo()
        res.update(jdir=jdir, snap=snap)
        out[name] = res
    return out


@pytest.mark.parametrize("writer,standby", [
    ("jax", "jax"), ("port", "port"), ("jax", "port"), ("port", "jax")],
    ids=["jax_in_jax", "port_in_port", "jax_in_port", "port_in_jax"])
def test_promotion_restores_and_replays_to_the_actives_books(active_runs,
                                                             writer, standby):
    w, S = active_runs[writer], side(standby)
    recs = list(S.J.PlacementJournal(w["jdir"]).records(0))
    assert recs and all(r["epoch"] == 1 for r in recs)

    async def go():
        bal = balancer(S, S.Mem.MemoryMessagingProvider(), "1",
                       managed_fraction=0.75, blackbox_fraction=0.25,
                       max_batch=MAX_BATCH, action_slots=SLOTS,
                       initial_pad=INITIAL_PAD)
        bal.set_leadership(0, False)  # boots as the standby
        journal = S.J.PlacementJournal(w["jdir"])
        ok = S.CK.load_snapshot(bal, w["snap"], journal=journal)
        bal.set_leadership(2, True)  # the promotion's epoch
        got = books(bal)
        seq = bal._journal_seq
        journal.close()
        await bal.close()
        return ok, got, seq

    ok, got, seq = run(go(), 60)
    assert ok is True
    assert seq == recs[-1]["seq"], "the promoted active claims every seq"
    for k, name in enumerate(("free", "conc", "health")):
        np.testing.assert_array_equal(got[k], w[name], err_msg=name)


def test_both_actives_write_the_same_epoch_journal(active_runs):
    J = side("port").J
    recs = {s: list(J.PlacementJournal(r["jdir"]).records(0))
            for s, r in active_runs.items()}
    assert recs["port"] == recs["jax"]
    assert open(active_runs["port"]["snap"], "rb").read() == \
        open(active_runs["jax"]["snap"], "rb").read()


@both
def test_the_sharding_balancer_fences_only(S):
    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        sb = __import__(f"{S.root}.controller.loadbalancer.sharding_balancer",
                        fromlist=["ShardingBalancer"])
        bal = sb.ShardingBalancer(provider, S.E.ControllerInstanceId("0"))
        await bal.start()
        invokers, producer = await fleet(S, provider, 2)
        for inv in invokers:
            await inv.ping(producer)
        await asyncio.sleep(0.3)
        bal.set_leadership(3, True)
        action = make_action(S, "sh", memory=128)
        p = await bal.publish(action, make_msg(
            S, action, S.E.Identity.generate("guest"), True))
        await asyncio.wait_for(p, 10)
        stamps = [(m.fence_part, m.fence_epoch) for i in invokers
                  for m in i.handled]
        out = (stamps, hasattr(bal, "absorb_partitions"))
        await stop_all([bal], invokers)
        return out

    assert run(go(), 60) == ([(None, 3)], False)


# -- processes --------------------------------------------------------------------
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _auth(ident=None):
    from openwhisk_tpu_torch.standalone import GUEST_KEY, GUEST_UUID
    key = (f"{GUEST_UUID}:{GUEST_KEY}" if ident is None
           else ident.authkey.compact)
    return {"Authorization": "Basic " + base64.b64encode(
        key.encode()).decode(), "Content-Type": "application/json"}


#: one file per execution: a double execution leaves two files for one n
EFFECT_CODE = (
    "import os, uuid\n"
    "def main(a):\n"
    "    p = os.path.join(a['dir'], '%s-%s' % (a['n'], uuid.uuid4().hex))\n"
    "    open(p, 'w').close()\n"
    "    return {'n': a['n']}\n")
LIMITS = {"CONFIG_whisk_limits_invocationsPerMinute": "100000",
          "CONFIG_whisk_limits_concurrentInvocations": "1000"}
ACTIVE_ACTIVE = {"CONFIG_whisk_ha_activeActive": "true",
                 "CONFIG_whisk_ha_activeActive_partitions": "8"}


class Cluster:
    """The port's broker, invokers, controllers and edge as OS processes
    on localhost, each through its CLI, logs under `work`."""

    def __init__(self, work, n_controllers=2, env=None, ctrl_argv=(),
                 roles=None, n_invokers=1, frontend_argv=()):
        self.work = Path(work)
        self.db = str(self.work / "whisks.db")
        self.bus = _free_port()
        self.ctrl_ports = [_free_port() for _ in range(n_controllers)]
        self.edge_port = _free_port()
        self.env = {k: v for k, v in os.environ.items()
                    if k != "PYTHONPATH"}
        # one torch thread a process: the spawned controllers' step ops are
        # tiny, and idle pool threads would spin on the shared CPU
        self.env.update(PYTHONUNBUFFERED="1", OMP_NUM_THREADS="1",
                        MKL_NUM_THREADS="1", **LIMITS, **(env or {}))
        self.ctrl_argv = list(ctrl_argv)
        self.roles = roles or ["all"] * n_controllers
        self.frontend_argv = list(frontend_argv)
        self.n_invokers = n_invokers
        self.procs = {}

    def spawn(self, name, argv):
        log = open(self.work / f"{name}.log", "w")
        self.procs[name] = (subprocess.Popen(
            [sys.executable, "-m", *argv], cwd=ROOT, env=self.env,
            stdout=log, stderr=subprocess.STDOUT), log)

    def log(self, name):
        return (self.work / f"{name}.log").read_text()

    def start(self, edge_to=None):
        bus = f"127.0.0.1:{self.bus}"
        self.spawn("broker", ["openwhisk_tpu_torch.messaging", "--port",
                              str(self.bus)])
        for i in range(self.n_invokers):
            self.spawn(f"invoker{i}", [
                "openwhisk_tpu_torch.invoker", "--bus", bus, "--db",
                self.db, "--unique-name", f"ha-{i}", "--memory", "2048"])
        for i, port in enumerate(self.ctrl_ports):
            role = self.roles[i]
            argv = ["openwhisk_tpu_torch.controller", "--bus", bus, "--db",
                    self.db, "--port", str(port), "--instance", str(i),
                    "--cluster-size", str(self.roles.count("all")
                                          + self.roles.count("balancer")),
                    "--role", role]
            if role == "frontend":
                argv += ["--funnel-to", str(self.roles.index("balancer")),
                         *self.frontend_argv]
            else:
                argv += ["--balancer", "tpu", "--device", "cpu"]
                argv += self.ctrl_argv
            if i == 0:
                argv.append("--seed-guest")
            self.spawn(f"controller{i}", argv)
        ports = edge_to if edge_to is not None else self.ctrl_ports
        self.spawn("edge", ["openwhisk_tpu_torch.edge", "--port",
                            str(self.edge_port), "--controllers",
                            *[f"http://127.0.0.1:{p}" for p in ports]])

    def kill(self, name):
        proc, _log = self.procs[name]
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)

    def stop(self):
        for proc, _log in self.procs.values():
            if proc.poll() is None:
                proc.terminate()
        for proc, log in self.procs.values():
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log.close()

    def dump_logs(self):
        for name in self.procs:
            print(f"--- {name}:\n{self.log(name)[-3000:]}", file=sys.stderr)


async def _get(s, url, **kw):
    import aiohttp
    kw.setdefault("headers", _auth())
    try:
        async with s.get(url, **kw) as r:
            return r.status, await r.json(content_type=None)
    except (aiohttp.ClientError, asyncio.TimeoutError, ValueError):
        return 0, {}


async def _wait_fleet(s, port, n=1, timeout=60.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        st, body = await _get(s, f"http://127.0.0.1:{port}/invokers",
                              headers=_auth())
        if st == 200 and sum(v == "up" for v in body.values()) >= n:
            return True
        await asyncio.sleep(0.2)
    return False


async def _put_action(s, base, name, code):
    async with s.put(f"{base}/namespaces/_/actions/{name}", headers=_auth(),
                     json={"exec": {"kind": "python:3", "code": code}}) as r:
        assert r.status == 200, await r.text()


async def _invoke(s, base, name, n, effects, headers=None):
    """One blocking invoke, no retry: True on 200 with its echo."""
    import aiohttp
    try:
        async with s.post(f"{base}/namespaces/_/actions/{name}"
                          "?blocking=true&result=true",
                          headers=headers or _auth(),
                          json={"n": n, "dir": str(effects)}) as r:
            body = await r.json(content_type=None)
            return r.status == 200 and body.get("n") == n
    except (aiohttp.ClientError, asyncio.TimeoutError, ValueError):
        return False


def _doubles(effects):
    seen = {}
    for name in os.listdir(effects):
        n = name.split("-", 1)[0]
        seen[n] = seen.get(n, 0) + 1
    return seen, {n: c for n, c in seen.items() if c > 1}


def _owned(doc):
    return {p["partition"]: p["epoch"] for p in doc.get("partitions", [])
            if p["role"] == "active"}


def test_active_active_survivor_absorbs_the_killed_owners_partitions(
        tmp_path):
    """Two active/active controllers behind the edge; SIGKILL the owner of
    the guest's partition; the survivor owns all 8 at higher epochs and
    serves the guest again, no execution doubled."""
    import aiohttp
    effects = tmp_path / "effects"
    effects.mkdir()
    ring = side("port").Parts.PartitionRing(8)
    guest_pid = ring.partition_of("guest")
    cluster = Cluster(tmp_path, 2, env=ACTIVE_ACTIVE, ctrl_argv=[
        "--ha", "--balancer-journal", str(tmp_path / "wal"),
        "--balancer-snapshot", str(tmp_path / "bal.snap"),
        "--balancer-snapshot-interval", "1"])
    t_start = time.monotonic()
    cluster.start()

    async def drive():
        timeout = aiohttp.ClientTimeout(total=10)
        async with aiohttp.ClientSession(timeout=timeout) as s:
            for p in cluster.ctrl_ports:
                assert await _wait_fleet(s, p), "the invoker never came up"
            ready = {}
            t0 = time.monotonic()
            while time.monotonic() - t0 < 20:
                ready = {i: await _get(s, f"http://127.0.0.1:{p}/admin/ready")
                         for i, p in enumerate(cluster.ctrl_ports)}
                if sum(len(_owned(d)) for _st, d in ready.values()) == 8 \
                        and all(st == 200 for st, _d in ready.values()):
                    break
                await asyncio.sleep(0.2)
            owners = [i for i, (_st, d) in ready.items()
                      if guest_pid in _owned(d)]
            assert len(owners) == 1, ready
            victim = owners[0]
            before = _owned(ready[victim][1])
            base = f"http://127.0.0.1:{cluster.edge_port}/api/v1"
            await _put_action(s, base, "fx", EFFECT_CODE)
            assert await _invoke(s, base, "fx", 1, effects)
            assert await _invoke(s, base, "fx", 2, effects)
            cluster.kill(f"controller{victim}")
            t_kill = time.monotonic()
            survivor = cluster.ctrl_ports[1 - victim]
            served, n = False, 100
            while time.monotonic() - t_kill < 20 and not served:
                n += 1
                served = await _invoke(s, base, "fx", n, effects)
                if not served:
                    await asyncio.sleep(0.25)
            downtime = time.monotonic() - t_kill
            st, doc = await _get(s, f"http://127.0.0.1:{survivor}/admin/ready")
            return served, downtime, before, st, doc, n

    try:
        served, downtime, before, st, doc, n = asyncio.run(
            asyncio.wait_for(drive(), 60))
    except BaseException:
        cluster.dump_logs()
        raise
    finally:
        cluster.stop()
    wall = time.monotonic() - t_start
    assert served, f"the guest was not served again ({downtime:.1f} s)"
    owned = _owned(doc)
    assert st == 200 and set(owned) == set(range(8)), doc
    for pid, ep in before.items():
        assert owned[pid] > ep, "absorbed at a higher epoch"
    assert all(p["replay"] == "ready" for p in doc["partitions"])
    seen, doubles = _doubles(effects)
    assert not doubles and seen, doubles
    assert wall < 40.0, f"the case took {wall:.1f} s"


# -- slow: the reference's chaos cases --------------------------------------------
async def _open_loop(one, rate, duration):
    """Arrivals at fixed times (never waiting on earlier completions)."""
    t0 = time.monotonic()
    tasks = []
    for i in range(int(rate * duration)):
        delay = t0 + i / rate - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(asyncio.ensure_future(one(i)))
    return await asyncio.gather(*tasks)


@pytest.mark.slow
def test_kill_controller0_traffic_survives_via_edge(tmp_path):
    """ref TestControllerFailover: two controllers behind the edge, one
    dies, requests keep succeeding."""
    import aiohttp
    effects = tmp_path / "effects"
    effects.mkdir()
    cluster = Cluster(tmp_path, 2, ctrl_argv=[])
    cluster.start()

    async def drive():
        async with aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=30)) as s:
            for p in cluster.ctrl_ports:
                assert await _wait_fleet(s, p)
            base = f"http://127.0.0.1:{cluster.edge_port}/api/v1"
            await _put_action(s, base, "ha", EFFECT_CODE)
            assert await _invoke(s, base, "ha", 1, effects)
            cluster.kill("controller0")
            ok = 0
            for n in range(12):
                ok += await _invoke(s, base, "ha", 100 + n, effects)
                await asyncio.sleep(0.25)
            return ok

    try:
        ok = asyncio.run(asyncio.wait_for(drive(), 180))
    finally:
        cluster.stop()
    assert ok >= 8, f"only {ok}/12 invokes survived controller kill"


@pytest.mark.slow
def test_hard_kill_active_mid_burst_fails_over_without_double_placement(
        tmp_path):
    """ref TestJournaledFailover: two `--ha` controllers share a snapshot
    and a journal; the active is SIGKILLed mid-burst; the standby
    promotes (restore + replay) and serves; nothing runs twice."""
    import aiohttp
    effects = tmp_path / "effects"
    effects.mkdir()
    cluster = Cluster(tmp_path, 2, env={
        "CONFIG_whisk_ha_failover_enabled": "true"}, ctrl_argv=[
        "--ha", "--balancer-journal", str(tmp_path / "wal"),
        "--balancer-snapshot", str(tmp_path / "ha.snap"),
        "--balancer-snapshot-interval", "1"])
    cluster.start()

    async def drive():
        async with aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=30)) as s:
            for p in cluster.ctrl_ports:
                assert await _wait_fleet(s, p, timeout=120)
            base = f"http://127.0.0.1:{cluster.edge_port}/api/v1"
            await _put_action(s, base, "haj", EFFECT_CODE)
            for n in range(120):
                if await _invoke(s, base, "haj", 10000 + n, effects):
                    break
                await asyncio.sleep(0.5)
            else:
                raise AssertionError("no active leader emerged")
            ready = [await _get(s, f"http://127.0.0.1:{p}/admin/ready")
                     for p in cluster.ctrl_ports]
            active = next(i for i, (st, _d) in enumerate(ready) if st == 200)
            success = []

            async def one(i):
                if await _invoke(s, base, "haj", i, effects):
                    success.append(time.monotonic())

            async def killer():
                await asyncio.sleep(15.0)
                cluster.kill(f"controller{active}")
                return time.monotonic()

            kill = asyncio.ensure_future(killer())
            await _open_loop(one, 4.0, 45.0)
            t_kill = await kill
            assert [t for t in success if t > t_kill], "no success after"
            assert await _invoke(s, base, "haj", 99999, effects)
            st, doc = await _get(
                s, f"http://127.0.0.1:{cluster.ctrl_ports[1 - active]}"
                   "/admin/ready")
            return st, doc

    try:
        st, doc = asyncio.run(asyncio.wait_for(drive(), 300))
    except BaseException:
        cluster.dump_logs()
        raise
    finally:
        cluster.stop()
    assert st == 200 and doc["mode"] == "active_standby"
    assert doc["role"] == "active" and doc["epoch"] >= 2
    seen, doubles = _doubles(effects)
    assert seen and not doubles, doubles


@pytest.mark.slow
def test_kill_one_of_three_actives_survivors_absorb_partitions(tmp_path):
    """ref TestActiveActivePartitionChaos: three active/active controllers
    behind the edge, open-loop traffic over several namespaces, one
    SIGKILLed mid-burst: the survivors own all 8 partitions, every
    namespace is served after the kill, nothing runs twice, and each
    journal's seqs are unique and ordered."""
    import aiohttp
    from openwhisk_tpu_torch.controller.loadbalancer.journal import \
        PlacementJournal
    from openwhisk_tpu_torch.core.entity import Identity, WhiskAuthRecord
    from openwhisk_tpu_torch.database import AuthStore, SqliteArtifactStore
    effects = tmp_path / "effects"
    effects.mkdir()
    idents = [Identity.generate(f"tenant{k}") for k in range(6)]

    async def seed():
        store = SqliteArtifactStore(str(tmp_path / "whisks.db"))
        auth = AuthStore(store)
        for ident in idents:
            await auth.put(WhiskAuthRecord(ident.subject, [ident.namespace],
                                           [ident.authkey]))
        await store.close()

    asyncio.run(seed())
    jdir = tmp_path / "wal"
    cluster = Cluster(tmp_path, 3, env=ACTIVE_ACTIVE, ctrl_argv=[
        "--ha", "--balancer-journal", str(jdir),
        "--balancer-snapshot", str(tmp_path / "aa.snap"),
        "--balancer-snapshot-interval", "1"])
    cluster.start()

    async def drive():
        async with aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=30)) as s:
            for p in cluster.ctrl_ports:
                assert await _wait_fleet(s, p, timeout=120)
            base = f"http://127.0.0.1:{cluster.edge_port}/api/v1"
            for ident in idents:
                async with s.put(f"{base}/namespaces/_/actions/aaj",
                                 headers=_auth(ident), json={"exec": {
                                     "kind": "python:3",
                                     "code": EFFECT_CODE}}) as r:
                    assert r.status == 200, await r.text()
            for _ in range(240):
                rs = [await _get(s, f"http://127.0.0.1:{p}/admin/ready")
                      for p in cluster.ctrl_ports]
                if sum(len(_owned(d)) for _st, d in rs) == 8:
                    break
                await asyncio.sleep(0.5)
            success = {}

            async def one(i):
                ident = idents[i % len(idents)]
                if await _invoke(s, base, "aaj", i, effects,
                                 headers=_auth(ident)):
                    success.setdefault(i % len(idents), []).append(
                        time.monotonic())

            async def killer():
                await asyncio.sleep(15.0)
                cluster.kill("controller0")
                return time.monotonic()

            kill = asyncio.ensure_future(killer())
            await _open_loop(one, 4.0, 45.0)
            t_kill = await kill
            for k, ident in enumerate(idents):
                assert await _invoke(s, base, "aaj", 90000 + k, effects,
                                     headers=_auth(ident)), ident.namespace
            owned = set()
            for p in cluster.ctrl_ports[1:]:
                _st, d = await _get(s, f"http://127.0.0.1:{p}/admin/ready")
                owned |= set(_owned(d))
            return owned, {k: [t for t in v if t > t_kill]
                           for k, v in success.items()}

    try:
        owned, after = asyncio.run(asyncio.wait_for(drive(), 300))
    except BaseException:
        cluster.dump_logs()
        raise
    finally:
        cluster.stop()
    assert owned == set(range(8))
    seen, doubles = _doubles(effects)
    assert seen and not doubles, doubles
    for i in range(3):
        d = jdir / f"ctrl{i}"
        if d.is_dir():
            seqs = [int(r["seq"]) for r in PlacementJournal(str(d)).records(0)]
            assert len(seqs) == len(set(seqs)) and seqs == sorted(seqs)


@pytest.mark.slow
def test_frontends_funnel_to_the_balancer_behind_the_edge(tmp_path):
    """The funnel's roles as processes: two `--role frontend` controllers
    (`--funnel-depth 4`) behind the edge funnel to one `--role balancer`
    (`--device cpu`); blocking invokes through the edge come back with
    their echo, and a burst of 32 at one frontend past its depth answers
    the front door's exact 429 text for the overflow."""
    import aiohttp
    from openwhisk_tpu_torch.controller.entitlement import \
        CONCURRENT_LIMIT_MESSAGE
    effects = tmp_path / "effects"
    effects.mkdir()
    cluster = Cluster(tmp_path, 3, roles=["balancer", "frontend",
                                          "frontend"],
                      frontend_argv=["--funnel-depth", "4"])
    cluster.start(edge_to=None)

    async def drive():
        async with aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=30)) as s:
            assert await _wait_fleet(s, cluster.ctrl_ports[0], timeout=120)
            base = f"http://127.0.0.1:{cluster.edge_port}/api/v1"
            await _put_action(s, base, "fn", EFFECT_CODE)
            ok = 0
            for n in range(8):
                ok += await _invoke(s, base, "fn", n, effects)
            front = f"http://127.0.0.1:{cluster.ctrl_ports[1]}/api/v1"

            async def raw(n):
                async with s.post(f"{front}/namespaces/_/actions/fn"
                                  "?blocking=true&result=true",
                                  headers=_auth(),
                                  json={"n": n, "dir": str(effects)}) as r:
                    return r.status, await r.json(content_type=None)

            burst = await asyncio.gather(*[raw(1000 + n) for n in range(32)])
            return ok, burst

    try:
        ok, burst = asyncio.run(asyncio.wait_for(drive(), 240))
    except BaseException:
        cluster.dump_logs()
        raise
    finally:
        cluster.stop()
    assert ok == 8
    codes = [st for st, _b in burst]
    assert set(codes) <= {200, 429} and 429 in codes and 200 in codes
    assert all(b.get("error") == CONCURRENT_LIMIT_MESSAGE
               for st, b in burst if st == 429)
    assert all(b == {"n": 1000 + n} for n, (st, b) in enumerate(burst)
               if st == 200)
    for i in (1, 2):
        assert "role=frontend" in cluster.log(f"controller{i}")
    seen, doubles = _doubles(effects)
    assert not doubles
