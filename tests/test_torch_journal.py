"""The port's placement journal, replay and time-travel debugger on the CPU,
held against the JAX package.

  (a) framing and corruption: the cases of the JAX suite's
      `TestJournalFraming` / `TestJournalCorruption` run through both
      packages' `PlacementJournal`, and the two write byte-identical
      segments for the same records and read each other's;
  (b) cross-package replay: the front's seeded scenario
      (tests/test_torch_balancer_front.py `_scenario`) runs through the JAX
      `TpuBalancer` and the port's `TpuBalancer(device="cpu")`, each with a
      journal attached before the fleet registers and a snapshot written
      mid-run — with device rate admission off and on, and with a fleet
      that grows past `initial_pad`. The two journals are equal record for
      record (the scenario fixes the activation ids) and the two snapshot
      files byte for byte. Each package restores the other's snapshot and
      replays the other's tail, then replays the other's full history
      with no snapshot: the books equal the writer's live books bit for
      bit and `parity_mismatches == 0`. Tolerance: none, every compared
      value is an integer or a flag;
  (c) the port's own journal behaviours: off means no records; the
      stale-epoch filter; a tail written at another shard count
      cold-starts; a snapshot taken between two dispatched steps holds
      the first step's books;
  (d) the time-travel debugger over a port journal and over an incident
      bundle the port's recorder captured, and the owdebug CLI's exit
      codes;
  (e) the new modules import neither jax nor the JAX package, and the
      copied modules are copies.

Acks go out as one batch frame a round, so each round's releases fold in
one deterministic idle step in both packages.
"""
import asyncio
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from openwhisk_tpu.controller.loadbalancer import checkpoint as JC  # noqa: E402
from openwhisk_tpu.controller.loadbalancer import journal as JJ  # noqa: E402
from openwhisk_tpu.messaging import coalesce as JCo  # noqa: E402
from openwhisk_tpu.utils.logging import MetricEmitter as JMetrics  # noqa: E402
from openwhisk_tpu_torch.controller.loadbalancer import \
    checkpoint as TC  # noqa: E402
from openwhisk_tpu_torch.controller.loadbalancer import \
    journal as TJ  # noqa: E402
from openwhisk_tpu_torch.controller.loadbalancer.timetravel import \
    JournalDebugger  # noqa: E402
from openwhisk_tpu_torch.messaging import coalesce as TCo  # noqa: E402
from openwhisk_tpu_torch.utils.logging import \
    MetricEmitter as TMetrics  # noqa: E402
from test_torch_balancer_front import (INITIAL_PAD, MAX_BATCH,  # noqa: E402
                                       RATE, SLOTS, _jax_package,
                                       _port_package, _scenario, run)
from test_torch_balancer_wire import code_lines  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _pkg(side):
    """The package's journal and checkpoint modules, its metric emitter,
    its coalescing module and its `_scenario` namespace."""
    if side == "jax":
        return types.SimpleNamespace(J=JJ, C=JC, Metrics=JMetrics, Co=JCo,
                                     scenario=_jax_package())
    return types.SimpleNamespace(J=TJ, C=TC, Metrics=TMetrics, Co=TCo,
                                 scenario=_port_package())


def _offline(side):
    """A traffic-free balancer of the package to replay onto."""
    from openwhisk_tpu.core.entity import ControllerInstanceId as JCtrl
    from openwhisk_tpu.messaging import MemoryMessagingProvider as JMem
    from openwhisk_tpu_torch.core.entity import ControllerInstanceId
    from openwhisk_tpu_torch.messaging import MemoryMessagingProvider
    if side == "jax":
        from openwhisk_tpu.controller.loadbalancer import TpuBalancer
        return TpuBalancer(JMem(), JCtrl("1"), kernel="xla", prewarm=False,
                           calibrate_kernel="off", managed_fraction=0.75,
                           blackbox_fraction=0.25, max_batch=MAX_BATCH,
                           action_slots=SLOTS, initial_pad=INITIAL_PAD)
    from openwhisk_tpu_torch.controller.loadbalancer.tpu_balancer import \
        TpuBalancer
    return TpuBalancer(MemoryMessagingProvider(), ControllerInstanceId("1"),
                       device="cpu", managed_fraction=0.75,
                       blackbox_fraction=0.25, max_batch=MAX_BATCH,
                       action_slots=SLOTS, initial_pad=INITIAL_PAD)


def _books(bal):
    st = bal.state
    return [np.asarray(t) if not isinstance(t, torch.Tensor)
            else t.cpu().numpy() for t in (st.free_mb, st.conc_free,
                                           st.health)]


# ----------------------------------------------------------------- (a)
def _write(J, path, n=10):
    j = J.PlacementJournal(str(path), fsync_batch=1)
    for s in range(1, n + 1):
        j.append({"t": "x", "seq": s})
    assert j.flush()
    j.close()
    segs = sorted(p for p in os.listdir(path) if p.endswith(".seg"))
    return os.path.join(str(path), segs[-1])


def case_roundtrip_rotation_prune_and_lag(p, tmp_path, monkeypatch):
    j = p.J.PlacementJournal(str(tmp_path), segment_bytes=256, fsync_batch=2)
    for s in range(1, 40):
        j.append({"t": "x", "seq": s})
    assert j.flush()
    assert j.lag_batches == 0
    assert [r["seq"] for r in j.records(0)] == list(range(1, 40))
    assert [r["seq"] for r in j.records(30)] == list(range(31, 40))
    assert j.last_seq() == 39
    assert len(j._segments()) > 3, "segment rotation must split the log"
    assert j.prune(20) >= 1
    assert [r["seq"] for r in j.records(20)] == list(range(21, 40))
    j.close()


def case_fsync_p99_and_gauges(p, tmp_path, monkeypatch):
    j = p.J.PlacementJournal(str(tmp_path))
    j.append({"t": "x", "seq": 1})
    assert j.flush()
    m = p.Metrics()
    j.export_gauges(m)
    assert m.gauge_value("loadbalancer_journal_lag_batches") == 0
    assert m.gauge_value("loadbalancer_journal_bytes") > 0
    assert m.gauge_value("loadbalancer_journal_fsync_p99_ms") is not None
    j.close()


def case_config_off_switch(p, tmp_path, monkeypatch):
    monkeypatch.setenv("CONFIG_whisk_ha_journal_enabled", "false")
    assert p.J.journal_from_config(str(tmp_path)) is None
    monkeypatch.setenv("CONFIG_whisk_ha_journal_enabled", "true")
    j = p.J.journal_from_config(str(tmp_path))
    assert j is not None
    j.close()


def case_torn_tail_truncates_at_last_good_frame(p, tmp_path, monkeypatch):
    path = _write(p.J, tmp_path)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 3)  # half-written record
    j = p.J.PlacementJournal(str(tmp_path))
    assert [r["seq"] for r in j.records(0)] == list(range(1, 10))
    j.append({"t": "x", "seq": 10})
    assert j.flush()
    assert j.last_seq() == 10
    j.close()


def case_crc_flip_truncates(p, tmp_path, monkeypatch):
    path = _write(p.J, tmp_path)
    data = bytearray(open(path, "rb").read())
    data[-2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    recs = list(p.J.PlacementJournal(str(tmp_path)).records(0))
    assert [r["seq"] for r in recs] == list(range(1, 10))


def case_mid_log_corruption_stops_replay_there(p, tmp_path, monkeypatch):
    path = _write(p.J, tmp_path)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    recs = list(p.J.PlacementJournal(str(tmp_path)).records(0))
    assert recs and recs[-1]["seq"] < 10


def case_torn_old_epoch_segment_does_not_hide_newer_epoch(p, tmp_path,
                                                          monkeypatch):
    old = p.J.PlacementJournal(str(tmp_path), fsync_batch=1)
    for s in range(1, 6):
        old.append({"t": "x", "seq": s, "epoch": 1})
    assert old.flush()
    old.close()
    new = p.J.PlacementJournal(str(tmp_path), fsync_batch=1)
    for s in range(6, 9):
        new.append({"t": "x", "seq": s, "epoch": 2})
    assert new.flush()
    new.close()
    segs = sorted(x for x in os.listdir(tmp_path) if x.endswith(".seg"))
    assert len(segs) == 2, "each writer must own its own segment"
    first = os.path.join(str(tmp_path), segs[0])
    with open(first, "r+b") as f:
        f.truncate(os.path.getsize(first) - 3)
    recs = list(p.J.PlacementJournal(str(tmp_path)).records(0))
    assert [r["seq"] for r in recs] == [1, 2, 3, 4, 6, 7, 8]


def case_zombie_flush_lands_in_own_segment_and_replay_drops_it(
        p, tmp_path, monkeypatch):
    zombie = p.J.PlacementJournal(str(tmp_path), fsync_batch=1)
    for s in range(1, 11):
        zombie.append({"t": "x", "seq": s, "epoch": 1})
    assert zombie.flush()
    active = p.J.PlacementJournal(str(tmp_path), fsync_batch=1)
    assert active.last_seq() == 10
    for s in range(11, 16):
        active.append({"t": "x", "seq": s, "epoch": 2})
    assert active.flush()
    for s in range(11, 14):
        zombie.append({"t": "x", "seq": s, "epoch": 1})
    assert zombie.flush()
    zombie.close()
    active.close()
    recs = list(p.J.PlacementJournal(str(tmp_path)).records(0))
    assert [r["seq"] for r in recs if r.get("epoch") == 2] == \
        [11, 12, 13, 14, 15]

    async def go():
        bal = _offline(p.side)
        stats = bal.replay_journal(recs)
        await bal.close()
        return stats

    assert run(go())["stale_epoch_dropped"] == 3


def case_unknown_record_type_skipped_not_fatal(p, tmp_path, monkeypatch):
    async def go():
        bal = _offline(p.side)
        stats = bal.replay_journal([{"t": "from_the_future", "seq": 1}])
        await bal.close()
        return stats

    stats = run(go())
    assert stats["replayed"] == 1 and stats["last_seq"] == 1


JOURNAL_CASES = {f.__name__[5:]: f for f in (
    case_roundtrip_rotation_prune_and_lag, case_fsync_p99_and_gauges,
    case_config_off_switch, case_torn_tail_truncates_at_last_good_frame,
    case_crc_flip_truncates, case_mid_log_corruption_stops_replay_there,
    case_torn_old_epoch_segment_does_not_hide_newer_epoch,
    case_zombie_flush_lands_in_own_segment_and_replay_drops_it,
    case_unknown_record_type_skipped_not_fatal)}


@pytest.mark.parametrize("side", ["port", "jax"])
@pytest.mark.parametrize("case", sorted(JOURNAL_CASES))
def test_journal_framing_and_corruption(case, side, tmp_path, monkeypatch):
    p = _pkg(side)
    p.side = side
    JOURNAL_CASES[case](p, tmp_path, monkeypatch)


def test_frames_are_byte_identical_and_cross_the_packages(tmp_path):
    recs = [{"t": "batch", "R": 8, "H": 64, "B": 8, "rows": 9, "b": 3,
             "buf": TJ.encode_array(np.arange(-5, 100, dtype=np.int32)),
             "aids": ["a", "b", "c"], "seq": 1},
            {"t": "ack", "for": 1, "out": [5, 9, 2], "seq": 2},
            {"t": "fold", "health": [[3, True]], "seq": 3},
            {"t": "reg", "reg": [{"instance": 0, "userMemory": "1024 MB"}],
             "healthy": [True], "seq": 4, "epoch": 2}]
    dirs = {}
    for side, J in (("jax", JJ), ("port", TJ)):
        d = tmp_path / side
        j = J.PlacementJournal(str(d), segment_bytes=300, fsync_batch=3)
        for r in recs:
            j.append(dict(r))
        assert j.flush()
        j.close()
        dirs[side] = d
    segs = {side: sorted(os.listdir(d)) for side, d in dirs.items()}
    assert segs["jax"] == segs["port"] and len(segs["jax"]) > 1
    for name in segs["jax"]:
        assert (dirs["jax"] / name).read_bytes() == \
            (dirs["port"] / name).read_bytes(), name
    # each package reads the other's log, record for record
    assert list(TJ.PlacementJournal(str(dirs["jax"])).records(0)) == recs
    assert list(JJ.PlacementJournal(str(dirs["port"])).records(0)) == recs
    assert np.array_equal(TJ.decode_array(recs[0]["buf"]),
                          JJ.decode_array(recs[0]["buf"]))


# ----------------------------------------------------------------- (b)
#: the scenario's configurations: (rate limit, grows past initial_pad)
CONFIGS = {"no_rate-fixed": (None, False), "rate-fixed": (RATE, False),
           "no_rate-grow": (None, True), "rate-grow": (RATE, True)}
#: the publish_many wave before which the mid-run snapshot is written
SNAP_WAVE = 6


def _journaled_setup(p, jdir, snap):
    """`_scenario`'s setup hook: attach a journal before the fleet
    registers, and write a snapshot on the loop right after publish wave
    SNAP_WAVE dispatched (after the growth of the growing configurations),
    its readback still in flight."""
    def setup(bal):
        bal.attach_journal(p.J.PlacementJournal(jdir))
        real, calls = bal.publish_many, [0]

        def publish_many(pairs):
            outs = real(pairs)
            calls[0] += 1
            if calls[0] == SNAP_WAVE:
                p.C.write_snapshot(bal, snap)
            return outs

        bal.publish_many = publish_many
    return setup


@pytest.fixture(scope="module")
def journaled_runs(tmp_path_factory):
    """Each configuration's scenario through both packages, cached for the
    module: {config: {side: run}} with the journal directory, the snapshot
    path and the live books."""
    cache = {}

    def get(config):
        if config not in cache:
            rate, grow = CONFIGS[config]
            seed = 31 + (rate or 0) + 7 * grow
            out = {}
            for side in ("port", "jax"):
                p = _pkg(side)
                d = tmp_path_factory.mktemp(f"{config}-{side}")
                jdir, snap = str(d / "wal"), str(d / "bal.snap")
                mp = pytest.MonkeyPatch()
                mp.setattr(p.scenario.E.ConcurrencyLimit, "MAX", 16)
                try:
                    res = run(_scenario(
                        p.scenario, rate, grow, seed,
                        ack_producer=lambda prov, co=p.Co:
                        co.maybe_coalesce(prov.get_producer()),
                        setup=_journaled_setup(p, jdir, snap),
                        inspect=lambda bal: (bal.journal.flush(),
                                             bal.journal.close())), 120)
                finally:
                    mp.undo()
                res.update(jdir=jdir, snap=snap, side=side)
                out[side] = res
            cache[config] = out
        return cache[config]
    return get


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_both_packages_write_the_same_journal_and_snapshot(journaled_runs,
                                                           config):
    runs = journaled_runs(config)
    recs = {s: list(TJ.PlacementJournal(r["jdir"]).records(0))
            for s, r in runs.items()}
    assert recs["port"] == recs["jax"]
    kinds = {r["t"] for r in recs["port"]}
    assert {"reg", "batch", "ack", "fold", "slots"} <= kinds
    assert ("grow" in kinds) == CONFIGS[config][1]
    assert all(r["aids"] for r in recs["port"] if r["t"] == "batch")
    assert Path(runs["port"]["snap"]).read_bytes() == \
        Path(runs["jax"]["snap"]).read_bytes()
    doc = json.loads(Path(runs["port"]["snap"]).read_text())
    assert list(doc) == [
        "journal_seq", "n_pad", "fleet_shards", "cluster_size",
        "action_slots", "registry", "healthy", "slots", "slot_refcount",
        "slot_overflow", "free_mb", "conc_nonzero", "version", "crc32"]
    assert 0 < doc["journal_seq"] < recs["port"][-1]["seq"]
    assert any(f < 1024 for f in doc["free_mb"][:doc["n_pad"]]), \
        "the snapshot holds the in-flight wave"
    # the journal and the books of the two packages agree at the end too
    for k, name in ((0, "free"), (1, "conc"), (2, "health")):
        assert np.array_equal(runs["port"][name], runs["jax"][name])


def _replay_both_ways(runs, writer, replayer):
    """The writer's snapshot + tail, then its full history with no
    snapshot, replayed on fresh balancers of the replaying package:
    (stats, books) for each."""
    p, w = _pkg(replayer), runs[writer]

    async def go():
        out = []
        bal = _offline(replayer)
        journal = p.J.PlacementJournal(w["jdir"])
        assert p.C.load_snapshot(bal, w["snap"], journal=journal) is True
        out.append((journal, bal))
        cold = _offline(replayer)
        journal2 = p.J.PlacementJournal(w["jdir"])
        stats = cold.replay_journal(journal2.records(0))
        out.append((stats, cold))
        res = []
        for _, b in out:
            res.append(_books(b))
        seqs = [out[0][1]._journal_seq, cold._journal_seq]
        for _, b in out:
            await b.close()
        journal.close()
        journal2.close()
        return stats, res, seqs

    return run(go(), 120)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("writer,replayer", [("jax", "port"),
                                             ("port", "jax")],
                         ids=["jax_journal_in_port", "port_journal_in_jax"])
def test_journal_replays_across_the_packages(journaled_runs, config, writer,
                                             replayer):
    runs = journaled_runs(config)
    stats, books, seqs = _replay_both_ways(runs, writer, replayer)
    w = runs[writer]
    last = list(TJ.PlacementJournal(w["jdir"]).records(0))[-1]["seq"]
    assert stats["parity_mismatches"] == 0 and stats["batches"] >= 1
    assert stats["last_seq"] == last and seqs == [last, last]
    for got in books:  # snapshot + tail, and full history
        for k, name in ((0, "free"), (1, "conc"), (2, "health")):
            np.testing.assert_array_equal(got[k], w[name], err_msg=name)


def test_the_replay_counts_every_mismatch_it_derives(journaled_runs):
    """A tampered ack (a kernel-knob change across a restart, say) shows
    as parity mismatches, and the books still follow the recorded
    inputs."""
    runs = journaled_runs("no_rate-fixed")
    recs = list(TJ.PlacementJournal(runs["port"]["jdir"]).records(0))
    ack = next(r for r in recs if r["t"] == "ack")
    ack["out"] = [v + 4 for v in ack["out"]]  # every row one invoker over

    async def go():
        bal = _offline("port")
        stats = bal.replay_journal(recs)
        books = _books(bal)
        await bal.close()
        return stats, books

    stats, books = run(go())
    assert stats["parity_mismatches"] == len(ack["out"])
    np.testing.assert_array_equal(books[0], runs["port"]["free"])


# ----------------------------------------------------------------- (c)
def test_journal_off_writes_nothing(journaled_runs, tmp_path):
    """No journal attached: no records, no seq movement, and the snapshot
    says seq 0 (ref test_journal.py::test_journal_off_is_bitexact_noop)."""
    p = _pkg("port")
    mp = pytest.MonkeyPatch()
    mp.setattr(p.scenario.E.ConcurrencyLimit, "MAX", 16)
    try:
        res = run(_scenario(p.scenario, None, False, 31,
                            inspect=lambda bal: (bal._journal_seq,
                                                 bal.snapshot())), 60)
    finally:
        mp.undo()
    seq, snap = res["inspect"]
    assert seq == 0 and snap["journal_seq"] == 0
    # the same traffic as the journaled run: same decisions, same books
    ref = journaled_runs("no_rate-fixed")["port"]
    assert res["decisions"] == ref["decisions"]
    np.testing.assert_array_equal(res["free"], ref["free"])


def test_a_tail_written_at_another_shard_count_cold_starts(journaled_runs):
    runs = journaled_runs("no_rate-fixed")
    recs = list(TJ.PlacementJournal(runs["port"]["jdir"]).records(0))
    for r in recs:
        if r["t"] == "batch":
            r["S"] = 2

    async def go():
        bal = _offline("port")
        stats = bal.replay_journal(recs)
        free = bal.state.free_mb.clone()
        await bal.close()
        return stats, free

    stats, free = run(go())
    assert stats["skipped"] == "mesh_topology"
    assert stats["journal_shards"] == 2 and stats["balancer_shards"] == 1
    assert stats["last_seq"] == recs[-1]["seq"]
    # the registrations before the first batch were replayed, then the
    # books restarted at full capacity over that registry: no holds
    regs = [r for r in recs if r["t"] == "reg"]
    n = sum(len(r["reg"]) for r in regs
            if r["seq"] < next(x["seq"] for x in recs if x["t"] == "batch"))
    assert free[:n].tolist() == [1024] * n


def test_snapshot_between_two_dispatched_steps_holds_the_first(monkeypatch):
    """The steps write the books in place: snapshot_parts clones them, so
    a snapshot captured between two steps holds the books after the first
    even when its worker reads them after the second."""
    from openwhisk_tpu_torch.core import entity as E
    from test_torch_balancer_front import (_healthy_balancer, make_action,
                                           make_msg)

    monkeypatch.setattr(E.ConcurrencyLimit, "MAX", 16)
    action = make_action("snap", memory=256)
    action.limits.concurrency = E.ConcurrencyLimit(4)

    async def go():
        bal = await _healthy_balancer(
            _port_package().Mem.MemoryMessagingProvider(), 4, max_batch=8,
            pipeline_depth=4)
        ident = E.Identity.generate("guest")
        plain = make_action("plain", memory=128)
        # five rows of the concurrency-4 action leave spare permits
        bal.publish_many([(a, make_msg(a, ident))
                          for a in [action] * 5 + [plain] * 3])
        assert bal._inflight_steps == 1  # dispatched inline
        after_first = [t.clone() for t in (bal.state.free_mb,
                                           bal.state.conc_free)]
        parts = bal.snapshot_parts()
        bal.publish_many([(action, make_msg(action, ident))
                          for _ in range(8)])
        assert bal._inflight_steps == 2
        after_second = bal.state.free_mb.clone()
        doc = await asyncio.to_thread(bal.snapshot, parts)
        await bal.close()
        return after_first, after_second, doc

    (free1, conc1), free2, doc = run(go())
    assert doc["free_mb"] == free1.tolist()
    assert doc["free_mb"] != free2.tolist()
    conc = conc1.numpy()
    assert doc["conc_nonzero"] == [[int(i), int(j), int(conc[i, j])]
                                   for i, j in zip(*np.nonzero(conc))]
    assert doc["conc_nonzero"], "the concurrency action holds permits"


# ----------------------------------------------------------------- (d)
def test_time_travel_debugger_steps_over_a_port_journal(journaled_runs):
    runs = journaled_runs("rate-grow")
    w = runs["port"]
    recs = list(TJ.PlacementJournal(w["jdir"]).records(0))
    snap = json.loads(Path(w["snap"]).read_text())
    batches = [r for r in recs if r["t"] == "batch"]
    late = [r for r in batches if r["seq"] > snap["journal_seq"]][-1]
    # acks apply through their batch records and are not steps: the books
    # at the snapshot are those after its last other record
    at_snap = max(r["seq"] for r in recs
                  if r["seq"] <= snap["journal_seq"] and r["t"] != "ack")

    async def go():
        dbg = JournalDebugger(recs, device="cpu")
        try:
            assert dbg.balancer.device.type == "cpu"
            stepped = dbg.step(3)
            assert [s["seq"] for s in stepped] == [1, 2, 3]
            stop = dbg.run_to_seq(at_snap)
            assert stop["seq"] == at_snap
            diff = dbg.diff_books(snap)
            stop = dbg.run_to_activation(late["aids"][0])
            assert stop["seq"] == late["seq"] and stop["t"] == "batch"
            dec = dbg.decisions()
            # throttled rows replay with their valid bit cleared: parity
            # holds on the rows the device admitted
            assert [d for d, t in zip(dec["derived"], dec["throttled"])
                    if not t] == [r for r, t in zip(dec["recorded"],
                                                    dec["throttled"])
                                  if not t]
            # the offline balancer's default pad (64) exceeds the
            # writer's: diff_books compares the extra rows as padding
            assert len(dbg.books()) >= len(w["free"])
            stats = dbg.run_to_end()
            end = dbg.diff_books({"free_mb": w["free"].tolist(),
                                  "conc_nonzero": [
                                      [int(i), int(j), int(w["conc"][i, j])]
                                      for i, j in zip(*np.nonzero(w["conc"]))],
                                  "journal_seq": recs[-1]["seq"]})
            return diff, stats, end
        finally:
            await dbg.aclose()

    diff, stats, end = run(go())
    assert diff["match"], diff
    assert diff["replayed_seq"] == at_snap
    assert diff["captured_seq"] == snap["journal_seq"]
    assert stats["parity_mismatches"] == 0
    assert end["match"], end


def test_incident_bundle_carries_books_and_journal_and_replays(
        tmp_path, monkeypatch):
    """The port's incident recorder freezes the books (snapshot_parts)
    and the journal window; the debugger replays the bundle to the same
    books (ref tests/test_blackbox.py::TestCaptureAndReplay)."""
    from openwhisk_tpu_torch.core import entity as E
    from openwhisk_tpu_torch.messaging import MemoryMessagingProvider
    from openwhisk_tpu_torch.utils.blackbox import (GLOBAL_INCIDENTS,
                                                    read_bundle)
    from openwhisk_tpu_torch.utils.eventlog import GLOBAL_EVENT_LOG
    from test_torch_balancer_front import (_fleet, _ping_all, _settled,
                                           front, make_action, make_msg)
    inc_dir = tmp_path / "incidents"
    monkeypatch.setenv("CONFIG_whisk_incidents_enabled", "true")
    monkeypatch.setenv("CONFIG_whisk_incidents_directory", str(inc_dir))
    monkeypatch.setenv("CONFIG_whisk_incidents_debounceS", "600")
    base = GLOBAL_INCIDENTS.stats()["captured"]

    async def go():
        provider = MemoryMessagingProvider()
        bal = front(provider)
        assert GLOBAL_INCIDENTS.stats()["installed"]
        bal.attach_journal(TJ.PlacementJournal(str(tmp_path / "wal")))
        await bal.start()
        invokers, producer = await _fleet(provider, 2, delay=0.05)
        try:
            await _ping_all(invokers, producer, bal)
            ident = E.Identity.generate("guest")
            action = make_action("fx", memory=256)
            ps = [await bal.publish(action, make_msg(action, ident, True))
                  for _ in range(6)]
            await asyncio.gather(*[asyncio.wait_for(q, 15) for q in ps])
            await _settled(bal)
            GLOBAL_EVENT_LOG.record("journal_stall", lag_batches=9)
            # the capture runs on the recorder's worker, which needs this
            # loop for the books: bounded wait, not a timing assumption
            for _ in range(500):
                if GLOBAL_INCIDENTS.stats()["captured"] > base:
                    break
                await asyncio.sleep(0.02)
        finally:
            await bal.close()
            bal.journal.close()
            for inv in invokers:
                await inv.stop()
        return GLOBAL_INCIDENTS.stats()

    stats = run(go(), 60)
    assert stats["captured"] == base + 1
    files = sorted(inc_dir.glob("inc-*.wbb"))
    assert len(files) == 1
    payload = read_bundle(str(files[0]))
    planes = payload["planes"]
    assert planes.get("books") and planes.get("journal"), \
        payload["plane_errors"]
    window = planes["journal"]
    assert window["records"]
    assert window["to_seq"] == planes["books"]["journal_seq"]
    batch_aids = [a for r in window["records"] if r["t"] == "batch"
                  for a in r["aids"]]
    assert batch_aids and set(batch_aids) <= set(payload["activation_ids"])

    async def replay():
        dbg = JournalDebugger.from_bundle(str(files[0]), device="cpu")
        try:
            stop = dbg.run_to_activation(batch_aids[0])
            assert stop is not None and batch_aids[0] in stop["aids"]
            assert dbg.decisions()["derived"] == dbg.decisions()["recorded"]
            stats = dbg.run_to_end()
            return stats, dbg.diff_books()
        finally:
            await dbg.aclose()

    stats, diff = run(replay())
    assert stats["parity_mismatches"] == 0, stats
    assert diff["match"], diff
    assert diff["captured_seq"] == window["to_seq"]


def _owdebug(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-m", "openwhisk_tpu_torch.tools.owdebug", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)


def test_owdebug_replay_exit_codes(journaled_runs, tmp_path):
    """`owdebug replay <dir> --device cpu` exits 0 on a clean journal and
    1 on a parity mismatch; without a card the default device exits 2."""
    src = journaled_runs("rate-fixed")["port"]["jdir"]
    ok = _owdebug("replay", src, "--device", "cpu")
    assert ok.returncode == 0, ok.stderr
    out = json.loads(ok.stdout)
    assert out["stats"]["parity_mismatches"] == 0
    assert out["stats"]["batches"] > 0
    bad_dir = tmp_path / "bad"
    recs = list(TJ.PlacementJournal(src).records(0))
    for r in recs:
        if r["t"] == "ack":
            r["out"] = [v + 4 for v in r["out"]]
            break
    j = TJ.PlacementJournal(str(bad_dir))
    for r in recs:
        j.append(r)
    assert j.flush()
    j.close()
    bad = _owdebug("replay", str(bad_dir), "--device", "cpu")
    assert bad.returncode == 1, bad.stderr
    assert json.loads(bad.stdout)["stats"]["parity_mismatches"] > 0
    if not torch.cuda.is_available():
        card = _owdebug("replay", src)
        assert card.returncode == 2
        assert "no CUDA device" in card.stderr


# ----------------------------------------------------------------- (e)
def test_the_new_modules_import_no_jax():
    code = (
        "import sys, json\n"
        "import openwhisk_tpu_torch.controller.loadbalancer.journal\n"
        "import openwhisk_tpu_torch.controller.loadbalancer.checkpoint\n"
        "import openwhisk_tpu_torch.controller.loadbalancer.timetravel\n"
        "import openwhisk_tpu_torch.tools.owdebug\n"
        "import openwhisk_tpu_torch.standalone\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'openwhisk_tpu' or "
        "m.startswith('openwhisk_tpu.'))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


#: module -> its named cuts (the reference's text, the port's text)
COPY_CUTS = {
    "controller/loadbalancer/journal.py": [
        # the writer survives an abandon() that empties the queue while it
        # lingers (the JAX journal's writer thread dies there on an
        # IndexError; ROADMAP Queue 3)
        ("                batch, self._pending = self._pending, []\n",
         "                batch, self._pending = self._pending, []\n"
         "            if not batch:\n"
         "                continue\n")],
    "controller/loadbalancer/checkpoint.py": []}


@pytest.mark.parametrize("rel", ["controller/loadbalancer/journal.py",
                                 "controller/loadbalancer/checkpoint.py"])
def test_copied_modules_are_copies(rel):
    ref = (ROOT / "openwhisk_tpu" / rel).read_text()
    port = (ROOT / "openwhisk_tpu_torch" / rel).read_text()
    for old, new in COPY_CUTS[rel]:
        assert ref.count(old) == 1
        ref = ref.replace(old, new)
    assert code_lines(port) == code_lines(ref)
    head = port.partition("\n\n")[0]
    assert head.replace(f"\nA copy of `openwhisk_tpu/{rel}`.", "") == \
        ref.partition("\n\n")[0]
