"""The port's balancer snapshot/restore and its standalone restart on the
CPU (the JAX suite's tests/test_balancer_checkpoint.py and the standalone
case of tests/test_journal.py, run against the port):

  (a) a snapshot carries `version` + `crc32`; write and restore keep the
      in-flight books (memory holds and concurrency permits); a missing,
      unreadable, tampered or truncated snapshot means a cold start, and so
      does a journal tail whose base snapshot is gone; a stale
      `cluster_size` gives way to the topology;
  (b) the snapshotter's periodic dump (driven by calling `_dump()`, never
      by polling for the file) captures on the loop and writes on a
      worker thread, prunes the journal it covers, and `stop()` writes the
      final dump;
  (c) the standalone with `snapshot_path` and `journal_dir` writes its
      final dump at `stop()`, and a second standalone from the same files
      restores the registry and the books; `/admin/ready`'s journal block
      is the JAX standalone's; `--help` names the three flags as options.

Every comparison is exact (integers and flags).
"""
import asyncio
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from openwhisk_tpu_torch.controller.loadbalancer.checkpoint import (  # noqa: E402
    BalancerSnapshotter, load_snapshot, write_snapshot)
from openwhisk_tpu_torch.controller.loadbalancer.journal import \
    PlacementJournal  # noqa: E402
from openwhisk_tpu_torch.core import entity as E  # noqa: E402
from openwhisk_tpu_torch.messaging import (MemoryMessagingProvider,  # noqa: E402
                                           PingMessage)
from test_torch_balancer_front import (_healthy_balancer, _drain,  # noqa: E402
                                       front, make_action, make_msg, run)

ROOT = Path(__file__).resolve().parent.parent


def _auth():
    """The standalones' guest credentials (the same in both packages)."""
    import base64

    from openwhisk_tpu_torch.standalone import GUEST_KEY, GUEST_UUID
    return {"Authorization": "Basic " + base64.b64encode(
        f"{GUEST_UUID}:{GUEST_KEY}".encode()).decode()}


class Log:
    """Collects the warnings a cold start logs."""

    def __init__(self):
        self.warnings = []

    def warn(self, _tid, msg, *_):
        self.warnings.append(msg)

    def info(self, *_):
        pass

    def error(self, *_):
        pass


def _conc_action(monkeypatch, name="conc", memory=256, maxc=4):
    monkeypatch.setattr(E.ConcurrencyLimit, "MAX", 16)
    a = E.ExecutableWhiskAction(
        E.EntityPath("guest"), E.EntityName(name),
        E.CodeExec(kind="python:3", code="x"),
        limits=E.ActionLimits(E.TimeLimit(5000),
                              E.MemoryLimit(E.MB(memory)),
                              concurrency=E.ConcurrencyLimit(maxc)))
    a.rev = E.DocRevision("1-b")
    return a


async def _holding(monkeypatch, n_invokers=4, rows=11, **kw):
    """A balancer whose healthy fleet holds `rows` placements (nothing
    acks), a mix of a concurrency-4 action and a plain one."""
    bal = await _healthy_balancer(MemoryMessagingProvider(), n_invokers,
                                  **kw)
    ident = E.Identity.generate("guest")
    conc, plain = _conc_action(monkeypatch), make_action("plain", 128)
    outs = bal.publish_many([(conc if i % 3 else plain,
                              make_msg(conc if i % 3 else plain, ident))
                             for i in range(rows)])
    await asyncio.gather(*outs)
    await _drain(bal)
    return bal


def _same_books(a, b):
    return (torch.equal(a.state.free_mb, b.state.free_mb)
            and torch.equal(a.state.conc_free, b.state.conc_free)
            and torch.equal(a.state.health, b.state.health))


# ----------------------------------------------------------------- (a)
def test_snapshot_carries_version_and_crc(tmp_path):
    path = str(tmp_path / "bal.snap")

    async def go():
        bal = front(MemoryMessagingProvider())
        write_snapshot(bal, path)
        await bal.close()

    run(go())
    doc = json.load(open(path))
    assert doc["version"] == 2 and isinstance(doc["crc32"], int)
    assert doc["journal_seq"] == 0 and doc["fleet_shards"] == 1


def test_write_restore_preserves_in_flight_books(tmp_path, monkeypatch):
    path = str(tmp_path / "bal.snap")

    async def go():
        bal = await _holding(monkeypatch)
        write_snapshot(bal, path)
        cold = front(MemoryMessagingProvider())
        ok = load_snapshot(cold, path)
        out = (ok, _same_books(bal, cold),
               [i.instance for i in cold._registry], cold._healthy,
               dict(cold._slots.refcount) == dict(bal._slots.refcount),
               cold._slots.free == bal._slots.free,
               cold.state.conc_free.T.is_contiguous())
        await bal.close()
        await cold.close()
        return out

    ok, same, regs, healthy, refs, free, layout = run(go())
    assert ok is True and same, "restored books must match, holds included"
    assert regs == [0, 1, 2, 3] and healthy == [True] * 4
    assert refs and free
    assert layout, "conc is restored as the [N, A] view of [A, N] storage"
    doc = json.load(open(path))
    assert doc["conc_nonzero"], "the concurrency action holds permits"


def test_missing_and_corrupt_snapshots_cold_start(tmp_path):
    async def go():
        bal = front(MemoryMessagingProvider())
        out = [load_snapshot(bal, str(tmp_path / "nope"))]
        bad = tmp_path / "bad.snap"
        bad.write_text("{not json")
        out.append(load_snapshot(bal, str(bad)))
        ugly = tmp_path / "ugly.snap"
        ugly.write_text(json.dumps({"n_pad": "wat"}))
        out.append(load_snapshot(bal, str(ugly)))
        await bal.close()
        return out

    assert run(go()) == [False, False, False]


def test_truncated_and_tampered_snapshots_are_rejected(tmp_path,
                                                       monkeypatch):
    """A torn file breaks the JSON; bit rot that keeps valid JSON fails
    the crc32: both mean a cold start, the books untouched."""
    path = str(tmp_path / "torn.snap")

    async def go():
        bal = await _holding(monkeypatch, n_invokers=2, rows=4)
        write_snapshot(bal, path)
        raw = open(path).read()
        cold = front(MemoryMessagingProvider())
        fresh = cold.state.free_mb.clone()
        open(path, "w").write(raw[: len(raw) // 2])
        torn = load_snapshot(cold, path)
        results = [torn]
        for field, bump in (("free_mb", lambda v: [x + 1 for x in v]),
                            ("n_pad", lambda v: v * 2)):
            doc = json.loads(raw)
            doc[field] = bump(doc[field])
            json.dump(doc, open(path, "w"))
            results.append(load_snapshot(cold, path))
        untouched = (torch.equal(cold.state.free_mb, fresh)
                     and not cold._registry)
        await bal.close()
        await cold.close()
        return results, untouched

    results, untouched = run(go())
    assert results == [False, False, False]
    assert untouched


def test_a_pruned_tail_without_its_snapshot_cold_starts(tmp_path,
                                                        monkeypatch):
    """A journal whose first record is past seq 1 cannot rebuild the
    books without its base snapshot: cold start, and the log says so. A
    full history (first record seq 1) does rebuild them."""
    full, tail = tmp_path / "full", tmp_path / "tail"

    async def go():
        bal = await _healthy_balancer(MemoryMessagingProvider(), 2)
        # the registration pings went out before the journal: attach,
        # then journal the traffic only
        bal.attach_journal(PlacementJournal(str(full)))
        outs = bal.publish_many([(make_action("a", 256),
                                  make_msg(make_action("a", 256),
                                           E.Identity.generate("g")))
                                 for _ in range(8)])
        await asyncio.gather(*outs)
        await _drain(bal)
        bal.journal.close()
        recs = list(PlacementJournal(str(full)).records(0))
        j = PlacementJournal(str(tail))
        for r in recs[1:]:
            j.append(r)
        assert j.flush()
        j.close()
        log = Log()
        cold = front(MemoryMessagingProvider(), logger=log)
        ok = load_snapshot(cold, str(tmp_path / "missing.snap"), log,
                           journal=PlacementJournal(str(tail)))
        out = (ok, log.warnings, cold._journal_seq,
               cold.state.free_mb.tolist(), recs[0]["seq"])
        await bal.close()
        await cold.close()
        return out

    ok, warnings, seq, free, first = run(go())
    assert first == 1
    assert ok is False and seq == 0
    assert any("base snapshot is missing" in w for w in warnings)
    assert not any(free), "cold start: no registry, no books"


def test_stale_cluster_size_yields_to_topology(tmp_path):
    path = str(tmp_path / "stale.snap")

    async def go():
        bal = await _healthy_balancer(MemoryMessagingProvider(), 2,
                                      mem=2048)
        write_snapshot(bal, path)  # cluster_size=1 inside
        cold = front(MemoryMessagingProvider())
        ok = load_snapshot(cold, path, cluster_size=2)
        out = (ok, cold.cluster_size, cold.state.free_mb[:2].tolist())
        await bal.close()
        await cold.close()
        return out

    ok, cs, shares = run(go())
    assert ok is True and cs == 2, "topology wins over the stale snapshot"
    assert shares == [1024, 1024]


# ----------------------------------------------------------------- (b)
def test_snapshotter_periodic_and_final_dumps(tmp_path, monkeypatch):
    """`_dump()` (what the periodic scheduler calls) captures on the loop,
    writes on a worker thread and prunes the journal segments the dump
    covers; after the fleet grows, `stop()` writes the final dump."""
    path = str(tmp_path / "periodic.snap")
    jdir = tmp_path / "wal"

    async def go():
        provider = MemoryMessagingProvider()
        bal = front(provider, max_batch=8)
        bal.attach_journal(PlacementJournal(str(jdir), segment_bytes=256,
                                            fsync_batch=1))
        await bal.start()
        producer = provider.get_producer()
        for i in range(2):
            await producer.send("health", PingMessage(
                E.InvokerInstanceId(i, user_memory=E.MB(2048))))
        while len(bal._registry) < 2:
            await asyncio.sleep(0.005)
        snap = BalancerSnapshotter(bal, path, interval=3600.0,
                                   journal=bal.journal).start()
        assert not os.path.exists(path)  # the first dump waits an interval
        ident = E.Identity.generate("guest")
        action = make_action("p", 256)
        outs = bal.publish_many([(action, make_msg(action, ident))
                                 for _ in range(8)])
        await asyncio.gather(*outs)
        await _drain(bal)
        assert bal.journal.flush()
        segs_before = len(bal.journal._segments())
        await snap._dump()
        first = json.load(open(path))
        segs_after = len(bal.journal._segments())
        for i in range(2, 4):
            await producer.send("health", PingMessage(
                E.InvokerInstanceId(i, user_memory=E.MB(2048))))
        while len(bal._registry) < 4:
            await asyncio.sleep(0.005)
        await snap.stop()
        final = json.load(open(path))
        seq = bal._journal_seq
        await bal.close()
        bal.journal.close()
        return first, final, segs_before, segs_after, seq

    first, final, before, after, seq = run(go())
    assert len(first["registry"]) == 2
    assert first["journal_seq"] > 0
    assert before > after >= 1, "the dump pruned the segments it covers"
    assert len(final["registry"]) == 4, "final dump captures fleet growth"
    assert final["journal_seq"] == seq


# ----------------------------------------------------------------- (c)
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_standalone_restarts_from_its_own_snapshot(tmp_path, monkeypatch):
    """First boot: two invokers register by ping, eleven placements hold
    (nothing acks), `stop()` writes the final dump. Second boot from the
    same files: the registry and the books are the dump's, the journal is
    attached, and /admin/ready says so."""
    import aiohttp

    from openwhisk_tpu_torch.standalone import make_standalone
    snap, jdir = str(tmp_path / "sa.snap"), str(tmp_path / "wal")
    conc = _conc_action(monkeypatch)

    async def boot(provider):
        port = _free_port()
        c = await make_standalone(
            port=port, ui=False, device="cpu", invoker=False,
            messaging_provider=provider, snapshot_path=snap,
            snapshot_interval=3600.0, journal_dir=jdir)
        return c, port

    async def first():
        provider = MemoryMessagingProvider()
        c, _port = await boot(provider)
        lb = c.load_balancer
        assert lb.journal is not None and not os.path.exists(snap)
        producer = provider.get_producer()
        for i in range(2):
            await producer.send("health", PingMessage(
                E.InvokerInstanceId(i, user_memory=E.MB(2048))))
        while not (len(lb._registry) == 2 and all(lb._healthy)):
            await asyncio.sleep(0.005)
        ident = E.Identity.generate("guest")
        outs = lb.publish_many([(conc, make_msg(conc, ident))
                                for _ in range(11)])
        await asyncio.gather(*outs)
        await _drain(lb)
        books = [t.clone() for t in (lb.state.free_mb, lb.state.conc_free)]
        await c.stop()
        return books

    async def second():
        c, port = await boot(MemoryMessagingProvider())
        lb = c.load_balancer
        out = dict(regs=[i.instance for i in lb._registry],
                   books=[t.clone() for t in (lb.state.free_mb,
                                              lb.state.conc_free)],
                   seq=lb._journal_seq)
        async with aiohttp.ClientSession() as s:
            async with s.get(f"http://127.0.0.1:{port}/admin/ready",
                             headers=_auth()) as r:
                out["ready"] = (r.status, await r.json())
        await c.stop()
        return out

    books = run(first(), 60)
    doc = json.load(open(snap))
    assert doc["registry"] and doc["version"] == 2
    assert doc["free_mb"] == books[0].tolist()
    out = run(second(), 60)
    assert out["regs"] == [0, 1]
    assert torch.equal(out["books"][0], books[0])
    assert torch.equal(out["books"][1], books[1])
    assert out["seq"] == doc["journal_seq"] > 0
    status, ready = out["ready"]
    assert status == 200
    # the TPU balancer clusters, so the controller runs the membership
    # protocol and reports its live size
    assert ready == {"mode": "single", "ready": True, "cluster_size": 1,
                     "journal": {"attached": True, "lag_batches": 0,
                                 "stall_firing": False}}


def test_admin_ready_journal_block_is_the_jax_standalones(tmp_path,
                                                          monkeypatch):
    import aiohttp

    from openwhisk_tpu.standalone import make_standalone as jax_standalone
    from openwhisk_tpu_torch.standalone import make_standalone
    for k, v in {"CONFIG_whisk_loadBalancer_kernel": "xla",
                 "CONFIG_whisk_loadBalancer_prewarm": "false",
                 "CONFIG_whisk_loadBalancer_calibrateKernel": "off"}.items():
        monkeypatch.setenv(k, v)

    async def ready(make, journal, **kw):
        port = _free_port()
        if journal:
            kw["journal_dir"] = str(tmp_path / f"wal-{port}")
        c = await make(port=port, ui=False, **kw)
        try:
            async with aiohttp.ClientSession() as s:
                async with s.get(f"http://127.0.0.1:{port}/admin/ready",
                                 headers=_auth()) as r:
                    return r.status, await r.json()
        finally:
            await c.stop()

    async def go():
        return [(await ready(jax_standalone, j, balancer="tpu"),
                 await ready(make_standalone, j, device="cpu",
                             invoker=False))
                for j in (True, False)]

    results = run(go(), 120)
    for (ref_status, ref), (status, port) in results:
        assert status == ref_status == 200
        # both controllers run the membership protocol and report its
        # cluster_size; the journal's lag is a moment's reading (the JAX
        # standalone's in-process invoker registers as it boots)
        assert port.keys() == ref.keys()
        assert port["journal"].keys() == ref["journal"].keys()
        for doc in (port, ref):
            doc["journal"].pop("lag_batches", None)
        assert port == ref
    assert results[0][1][1]["journal"] == {"attached": True,
                                           "stall_firing": False}
    assert results[1][1][1]["journal"] == {"attached": False,
                                           "stall_firing": False}


def test_help_lists_the_snapshot_and_journal_flags():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "openwhisk_tpu_torch.standalone", "--help"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    text = out.stdout
    # every flag of the JAX standalone is ported: no option is named as
    # missing, and the lean balancer is a choice beside the default tpu
    assert "not ported" not in text.lower()
    assert "--balancer {tpu,lean}" in text
    for flag in ("--balancer-snapshot", "--balancer-snapshot-interval",
                 "--balancer-journal"):
        assert flag in text
