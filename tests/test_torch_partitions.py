"""Active/active partitioned controllers in the port, held against the JAX
package (the counterpart of `tests/test_partitions.py`).

Every case of the JAX suite runs on both packages (`[jax]` / `[port]`):
the partition ring, membership convergence, death, join and zombie
demotion, the balancer's refusal and fence stamping, the spillover
credential, the invoker's per-partition fence, the journal's `parts` /
`pe` records and the absorb that filters to them, stale epochs dropping
per partition, the off switch, spillover, the edge's ring routing,
`/admin/ready` in its three modes and the journal-stall alert. Then the
cross-package cases:

  * ring ownership and ranking identical over many namespaces and member
    sets;
  * refusal texts and fence stamps identical;
  * the front's seeded scenario (tests/test_torch_balancer_front.py
    `_scenario`) in partition mode and in active/standby mode writes
    journal segments byte-identical across the packages, with `parts` /
    `pe` or `epoch` on the records, and with a ring owning every
    partition (n = 1) it places exactly as with no ring;
  * each package absorbs the other's partition-mode tail to the books the
    other's absorb derives, bit for bit, with the same statistics;
  * spilled rows cross the packages over one TCP bus (a JAX owner spills
    to a port peer, and back), fenced at the owner's epoch, each executed
    once; the spill frames are byte-identical;
  * `/admin/ready` answers the same document in every mode.

Tolerance: none; every compared value is an integer, a flag, a string or
a byte.
"""
import asyncio
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_balancer_front import (INITIAL_PAD, MAX_BATCH,  # noqa: E402
                                       SLOTS, _jax_package, _port_package,
                                       _scenario, run)
from torch_ha_cases import (SIDES, FakeJournal, balancer, books,  # noqa: E402
                           drained, fleet, make_action, make_msg,
                           ns_for_partition, ping_all, side, stop_all,
                           until)

both = pytest.mark.parametrize("S", [side(s) for s in SIDES], ids=SIDES)


# -- the ring -------------------------------------------------------------------
@pytest.mark.parametrize("n", [8, 10, 16, 64])
def test_ring_ownership_and_ranking_match_jax(n):
    rings = [side(s).Parts.PartitionRing(n) for s in SIDES]
    assert rings[0].n_partitions == rings[1].n_partitions
    names = [f"ns{i}" for i in range(400)] + ["guest", "_", "hot-ns", ""]
    assert [rings[0].partition_of(x) for x in names] == \
        [rings[1].partition_of(x) for x in names]
    for members in ([0], [0, 1, 2], [0, 2], [1, 3, 5, 7], [4, 0, 9]):
        assert rings[0].ownership(members) == rings[1].ownership(members)
        for pid in range(rings[0].n_partitions):
            assert rings[0].rank(pid, members) == rings[1].rank(pid, members)
            assert rings[0].owner_of(pid, members) == \
                rings[1].owner_of(pid, members)
        for m in members:
            assert rings[0].partitions_of(m, members) == \
                rings[1].partitions_of(m, members)


@both
def test_pow2_rounding_and_determinism(S):
    R = S.Parts.PartitionRing
    assert R(10).n_partitions == 16
    r1, r2 = R(16), R(16)
    for ns in ("guest", "alice", "bob", "hot-ns"):
        assert r1.partition_of(ns) == r2.partition_of(ns)
        assert 0 <= r1.partition_of(ns) < 16


@both
def test_ownership_covers_all_partitions_disjointly(S):
    ring = S.Parts.PartitionRing(32)
    own = ring.ownership([0, 1, 2])
    assert sorted(own) == list(range(32))
    assert set(own.values()) <= {0, 1, 2}
    for m in (0, 1, 2):
        assert ring.partitions_of(m, [0, 1, 2]) == \
            [p for p, o in own.items() if o == m]


@both
def test_rendezvous_stability_on_member_death(S):
    ring = S.Parts.PartitionRing(64)
    before = ring.ownership([0, 1, 2])
    after = ring.ownership([0, 2])
    for pid, owner in before.items():
        assert after[pid] == owner if owner != 1 else after[pid] in (0, 2)


@both
def test_rank_walks_owner_first(S):
    ring = S.Parts.PartitionRing(16)
    for pid in range(16):
        ranked = ring.rank(pid, [0, 1, 2])
        assert sorted(ranked) == [0, 1, 2]
        assert ranked[0] == ring.owner_of(pid, [0, 1, 2])


@both
def test_config_off_switch_and_forms(S, monkeypatch):
    P = S.Parts
    for k in ("CONFIG_whisk_ha_activeActive",
              "CONFIG_whisk_ha_activeActive_enabled",
              "CONFIG_whisk_ha_activeActive_partitions",
              "CONFIG_whisk_ha_activeActive_spillover",
              "CONFIG_whisk_ha_activeActive_spilloverDepth"):
        monkeypatch.delenv(k, raising=False)
    assert P.ring_from_config() is None  # default off
    monkeypatch.setenv("CONFIG_whisk_ha_activeActive", "true")
    assert P.ring_from_config().n_partitions == 16
    monkeypatch.setenv("CONFIG_whisk_ha_activeActive", "false")
    assert P.ring_from_config() is None
    monkeypatch.delenv("CONFIG_whisk_ha_activeActive")
    monkeypatch.setenv("CONFIG_whisk_ha_activeActive_enabled", "true")
    monkeypatch.setenv("CONFIG_whisk_ha_activeActive_partitions", "8")
    monkeypatch.setenv("CONFIG_whisk_ha_activeActive_spillover", "true")
    cfg = P.active_active_config()
    assert cfg.enabled and cfg.partitions == 8 and cfg.spillover
    assert P.ring_from_config(cfg).n_partitions == 8
    monkeypatch.delenv("CONFIG_whisk_ha_activeActive_enabled")
    monkeypatch.setenv("CONFIG_whisk_ha_activeActive", "true")
    monkeypatch.setenv("CONFIG_whisk_ha_activeActive_spilloverDepth", "64")
    cfg = P.active_active_config()
    assert cfg.enabled and cfg.partitions == 8 and cfg.spillover_depth == 64
    # the balancer package's re-export is the same ring
    lbp = pytest.importorskip(f"{S.root}.controller.loadbalancer.partitions")
    assert lbp.PartitionRing is P.PartitionRing


# -- membership -----------------------------------------------------------------
class _BalancerStub:
    cluster_size = 3
    metrics = None

    def update_cluster(self, n):
        self.cluster_size = n


def _membership(S, provider, i, ring, events, heartbeat=0.05, timeout=1.0):
    def cb(gained, lost):
        events[i].append(("gain", gained) if gained else ("lose", lost))

    m = S.Membership.ControllerMembership(
        provider, S.E.ControllerInstanceId(str(i)), _BalancerStub(),
        heartbeat_s=heartbeat, member_timeout_s=timeout, ring=ring,
        on_partitions=cb, load_hint=lambda: float(i))
    m.start()
    return m


@both
def test_three_actives_converge_to_disjoint_full_ownership(S):
    ring = S.Parts.PartitionRing(16)

    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        events = {0: [], 1: [], 2: []}
        ms = [_membership(S, provider, i, ring, events) for i in range(3)]
        ok = await until(lambda: sum(len(m.owned_partitions) for m in ms)
                         == 16 and all(m.owned_partitions for m in ms),
                         timeout=10.0)
        owned = [set(m.owned_partitions) for m in ms]
        loads = dict(ms[0].peer_loads)
        for m in ms:
            await m.stop()
        return ok, owned, loads

    ok, owned, loads = run(go(), 30)
    assert ok, owned
    expected = ring.ownership([0, 1, 2])
    for i in range(3):
        assert owned[i] == {p for p, o in expected.items() if o == i}
    assert loads.get(1) == 1.0 and loads.get(2) == 2.0


@both
def test_member_death_moves_its_partitions_with_epoch_bump(S):
    ring = S.Parts.PartitionRing(16)

    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        events = {0: [], 1: [], 2: []}
        ms = [_membership(S, provider, i, ring, events) for i in range(3)]
        assert await until(lambda: sum(
            len(m.owned_partitions) for m in ms) == 16, timeout=10.0)
        dead_parts = set(ms[0].owned_partitions)
        await ms[0]._ticker.stop()  # hard death: silence, no leave
        await ms[0]._feed.stop()
        ok = await until(lambda: (ms[1].owned_partitions
                                  | ms[2].owned_partitions) >= dead_parts,
                         timeout=12.0)
        absorbed = {pid: (epoch, prev) for i in (1, 2)
                    for kind, g in events[i] if kind == "gain"
                    for pid, epoch, prev in g}
        for m in ms[1:]:
            await m.stop()
        return ok, dead_parts, absorbed

    ok, dead_parts, absorbed = run(go(), 40)
    assert ok
    for pid in dead_parts:
        epoch, prev = absorbed[pid]
        assert epoch >= 2 and prev == 0


@both
def test_join_rebalances_only_the_joiners_partitions(S):
    ring = S.Parts.PartitionRing(16)

    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        events = {0: [], 1: [], 2: []}
        ms = {i: _membership(S, provider, i, ring, events) for i in (0, 1)}
        assert await until(lambda: sum(
            len(m.owned_partitions) for m in ms.values()) == 16,
            timeout=10.0)
        before = {i: set(ms[i].owned_partitions) for i in (0, 1)}
        ms[2] = _membership(S, provider, 2, ring, events)
        want2 = set(ring.partitions_of(2, [0, 1, 2]))
        ok = await until(
            lambda: (ms[2].owned_partitions == want2
                     and ms[0].owned_partitions == before[0] - want2
                     and ms[1].owned_partitions == before[1] - want2),
            timeout=12.0)
        for m in ms.values():
            await m.stop()
        return ok

    assert run(go(), 40)


@both
def test_zombie_demotes_per_partition_keeping_the_rest(S):
    ring = S.Parts.PartitionRing(16)

    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        events = {0: []}
        m = _membership(S, provider, 0, ring, events)
        assert await until(lambda: len(m.owned_partitions) == 16,
                           timeout=10.0)
        victim = sorted(m.owned_partitions)[:4]
        for pid in victim:
            m._observe_part_claim(pid, m._pepoch[pid] + 3, 9)
        owned_after = set(m.owned_partitions)
        lost = {pid for kind, ls in events[0] if kind == "lose"
                for pid, _e in ls}
        await m.stop()
        return victim, owned_after, lost

    victim, owned_after, lost = run(go(), 30)
    assert owned_after == set(range(16)) - set(victim)
    assert lost == set(victim)


def test_a_jax_and_a_port_controller_split_the_ring_over_one_tcp_bus():
    """One membership of each package on the port's broker: they converge
    to the ring's ownership map for {0, 1}; the JAX one's death hands its
    partitions to the port's at higher epochs naming it."""
    J, T = side("jax"), side("port")
    ring = T.Parts.PartitionRing(8)

    async def go():
        server = T.Tcp.TcpBusServer("127.0.0.1", 0)
        await server.start()
        port = server._server.sockets[0].getsockname()[1]
        events = {0: [], 1: []}
        m0 = _membership(T, T.Tcp.TcpMessagingProvider("127.0.0.1", port),
                         0, ring, events, heartbeat=0.1, timeout=2.0)
        m1 = _membership(J, J.Tcp.TcpMessagingProvider("127.0.0.1", port),
                         1, J.Parts.PartitionRing(8), events, heartbeat=0.1,
                         timeout=2.0)
        want = ring.ownership([0, 1])
        ok = await until(lambda: m0.owned_partitions == {
            p for p, o in want.items() if o == 0} and m1.owned_partitions
            == {p for p, o in want.items() if o == 1}, timeout=15.0)
        jax_parts = set(m1.owned_partitions)
        await m1._ticker.stop()
        await m1._feed.stop()

        def gains():
            return {pid: (e, prev) for kind, g in events[0]
                    if kind == "gain" for pid, e, prev in g}

        # the claim fires its callback once the announcement is sent
        took = await until(lambda: m0.owned_partitions == set(range(8))
                           and set(gains()) == set(range(8)), timeout=15.0)
        await m0.stop()
        await server.stop()
        return ok, took, jax_parts, gains()

    ok, took, jax_parts, gains = run(go(), 60)
    assert ok and took and jax_parts
    for pid in jax_parts:
        assert gains[pid][0] >= 2 and gains[pid][1] == 1


# -- the balancer's fence ---------------------------------------------------------
async def _fenced_run(S, ring, owned, stale_stamp=None):
    """A balancer in partition mode owning `owned` {pid: epoch}; publishes
    one row to an owned partition and one to another; returns the
    refusal text, the stamps the invokers saw and partitions_json()."""
    provider = S.Mem.MemoryMessagingProvider()
    bal = balancer(S, provider)
    bal.set_partition_mode(ring)
    await bal.start()
    invokers, producer = await fleet(S, provider, 2)
    await ping_all(invokers, producer, [bal])
    action = make_action(S, "pf", memory=128)
    for pid, ep in owned.items():
        bal.set_partition_leadership(pid, ep, True)
    pid_own = min(owned)
    pid_other = next(p for p in range(ring.n_partitions) if p not in owned)
    refusal = None
    try:
        await bal.publish(action, make_msg(S, action, S.E.Identity.generate(
            ns_for_partition(ring, pid_other, "oth"))))
    except S.Base.LoadBalancerException as e:
        refusal = str(e)
    p = await bal.publish(action, make_msg(S, action, S.E.Identity.generate(
        ns_for_partition(ring, pid_own, "own")), True))
    await asyncio.wait_for(p, 10)
    await until(lambda: sum(len(i.handled) for i in invokers) >= 1)
    stamps = [(m.fence_part, m.fence_epoch) for i in invokers
              for m in i.handled]
    ready = bal.partitions_json()
    await stop_all([bal], invokers)
    return refusal, stamps, ready


@both
def test_refuses_unowned_partition_and_stamps_owned(S):
    ring = S.Parts.PartitionRing(8)
    refusal, stamps, ready = run(_fenced_run(S, ring, {3: 7}), 60)
    assert refusal == "partition 0 is owned by another controller"
    assert stamps and all(s == (3, 7) for s in stamps)
    assert ready[3] == {"partition": 3, "epoch": 7, "role": "active",
                        "replay": "ready"}
    assert all(r["role"] == "standby" for r in ready if r["partition"] != 3)


def test_refusals_and_stamps_are_the_jax_packages():
    out = {s: run(_fenced_run(side(s), side(s).Parts.PartitionRing(8),
                              {2: 4, 6: 9}), 60) for s in SIDES}
    assert out["port"] == out["jax"]


@both
def test_spillover_credential_admits_fenced_row(S):
    ring = S.Parts.PartitionRing(8)

    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        bal = balancer(S, provider)
        bal.set_partition_mode(ring)
        await bal.start()
        invokers, producer = await fleet(S, provider, 2)
        await ping_all(invokers, producer, [bal])
        action = make_action(S, "sc", memory=128)
        ident = S.E.Identity.generate(ns_for_partition(ring, 2, "sp"))
        bal.partition_epochs[2] = 5  # a peer claimed epoch 5
        fresh = make_msg(S, action, ident, True)
        fresh.fence_part, fresh.fence_epoch = 2, 5
        stale = make_msg(S, action, ident, True)
        stale.fence_part, stale.fence_epoch = 2, 4
        with pytest.raises(S.Base.LoadBalancerException):
            await bal.publish(action, stale)
        p = await bal.publish(action, fresh)
        await asyncio.wait_for(p, 10)
        await until(lambda: sum(len(i.handled) for i in invokers) >= 1)
        stamps = [(m.fence_part, m.fence_epoch) for i in invokers
                  for m in i.handled]
        await stop_all([bal], invokers)
        return stamps

    assert run(go(), 60) == [(2, 5)]


@both
def test_invoker_discards_stale_epoch_per_partition(S):
    """The invoker's per-partition fence: a superseded owner's late batch
    (its epoch below the partition's newest) is discarded and still
    releases its feed capacity; other partitions and the global fence are
    untouched."""
    import importlib
    cp = importlib.import_module(f"{S.root}.containerpool")
    db = importlib.import_module(f"{S.root}.database")
    reactive = importlib.import_module(f"{S.root}.invoker.reactive")
    E = S.E

    async def go():
        E.ExecManifest.initialize()
        provider = S.Mem.MemoryMessagingProvider()
        store = db.MemoryArtifactStore()

        class FactoryStub:
            async def cleanup(self):
                pass

        inv = reactive.InvokerReactive(
            E.InvokerInstanceId(0, user_memory=E.MB(1024)), provider,
            db.EntityStore(store), db.ArtifactActivationStore(store),
            FactoryStub(), pool_config=cp.ContainerPoolConfig(
                user_memory=E.MB(1024)))
        released = []

        class FeedStub:
            def processed(self):
                released.append(1)

        ident = E.Identity.generate("guest")
        action = make_action(S, "pfence", memory=128)

        def payload(part, epoch):
            return S.Msg.ActivationMessage(
                S.Tx.TransactionId(), action.fully_qualified_name, None,
                ident, E.ActivationId.generate(),
                E.ControllerInstanceId("0"), False, {},
                fence_epoch=epoch, fence_part=part).serialize()

        await inv._process(payload(1, 4), FeedStub())
        await inv._process(payload(2, 1), FeedStub())
        assert inv.fenced_discards == 0
        before = len(released)
        await inv._process(payload(1, 2), FeedStub())  # the late batch
        assert inv.fenced_discards == 1
        assert len(released) == before + 1
        await inv._process(payload(2, 1), FeedStub())
        assert inv.fenced_discards == 1 and inv._max_fence_epoch == -1
        return inv._fence_epochs

    assert run(go(), 30) == {1: 4, 2: 1}


# -- journal records and the absorb -------------------------------------------------
def _drive(S, bal, namespaces, per_ns=3):
    async def go():
        action = make_action(S, "pj", memory=128)
        for ns in namespaces:
            ident = S.E.Identity.generate(ns)
            for _ in range(per_ns):
                p = await bal.publish(action, make_msg(S, action, ident,
                                                       True))
                await asyncio.wait_for(p, 10)
    return go()


@both
def test_records_carry_parts_and_absorb_filters_to_them(S, tmp_path):
    ring = S.Parts.PartitionRing(8)
    jdir = str(tmp_path / "wal0")

    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        bal = balancer(S, provider)
        bal.set_partition_mode(ring)
        bal.attach_journal(S.J.PlacementJournal(jdir))
        await bal.start()
        invokers, producer = await fleet(S, provider, 4)
        await ping_all(invokers, producer, [bal])
        ns_a = ns_for_partition(ring, 1, "a")
        ns_b = ns_for_partition(ring, 6, "b")
        bal.set_partition_leadership(1, 2, True)
        bal.set_partition_leadership(6, 3, True)
        await _drive(S, bal, [ns_a, ns_b])
        await drained(bal)
        assert bal.journal.flush()
        recs = list(S.J.PlacementJournal(jdir).records(0))
        surv = balancer(S, provider, "1")
        surv.set_partition_mode(ring)
        await surv.start()
        await ping_all(invokers, producer, [surv])
        surv.set_partition_leadership(1, 3, True)
        stats = surv.absorb_partitions([1], S.J.PlacementJournal(jdir))
        own_seq = surv._journal_seq
        replay = dict(surv.partition_replay)
        await stop_all([bal, surv], invokers)
        return recs, stats, own_seq, replay

    recs, stats, own_seq, replay = run(go(), 90)
    batches = [r for r in recs if r.get("t") == "batch"]
    assert batches
    for b in batches:
        assert b["parts"] and set(b["parts"]) <= {1, 6}
        assert set(b["pe"]) == {str(p) for p in b["parts"]}
    only_a = [b for b in batches if b["parts"] == [1]]
    only_b = [b for b in batches if b["parts"] == [6]]
    assert only_a and only_b
    assert {b["pe"]["1"] for b in only_a} == {2}
    assert {b["pe"]["6"] for b in only_b} == {3}
    assert stats["replayed"] >= len(only_a)
    assert stats["filtered_out"] >= len(only_b)
    assert stats["absorbed_partitions"] == [1]
    assert "skipped" not in stats
    assert own_seq == 0, "foreign seqs must not move the own cursor"
    assert replay == {1: "ready"}


@both
def test_replay_drops_stale_epochs_per_partition(S, tmp_path):
    ring = S.Parts.PartitionRing(8)
    jdir = str(tmp_path / "walz")

    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        bal = balancer(S, provider)
        bal.set_partition_mode(ring)
        bal.attach_journal(S.J.PlacementJournal(jdir))
        await bal.start()
        invokers, producer = await fleet(S, provider, 4)
        await ping_all(invokers, producer, [bal])
        ns_a = ns_for_partition(ring, 1, "a")
        ns_b = ns_for_partition(ring, 6, "b")
        bal.set_partition_leadership(1, 2, True)
        bal.set_partition_leadership(6, 2, True)
        await _drive(S, bal, [ns_a])
        bal.set_partition_leadership(1, 3, False)
        await _drive(S, bal, [ns_b])
        await drained(bal)
        bal._journal_append({"t": "batch", "R": 1, "H": 1, "B": 8,
                             "rows": 0, "b": 0, "buf": "", "aids": [],
                             "parts": [1], "pe": {"1": 3}})
        assert bal.journal.flush()
        recs = list(S.J.PlacementJournal(jdir).records(0))
        surv = balancer(S, provider, "1")
        surv.set_partition_mode(ring)
        await surv.start()
        await ping_all(invokers, producer, [surv])
        forged = dict(recs[-1], seq=0)  # the supersession, first
        stats = surv.absorb_partitions([1, 6],
                                       FakeJournal([forged] + recs[:-1]))
        await stop_all([bal, surv], invokers)
        return recs, stats

    recs, stats = run(go(), 90)
    a_batches = [r for r in recs if r.get("t") == "batch"
                 and r.get("parts") == [1] and r.get("pe", {}).get("1") == 2]
    b_batches = [r for r in recs if r.get("t") == "batch"
                 and r.get("parts") == [6]]
    assert a_batches and b_batches
    assert stats["stale_epoch_dropped"] >= len(a_batches)
    assert stats["replayed"] >= len(b_batches)


@both
def test_off_journal_wire_format_unchanged(S, tmp_path):
    """No ring and no HA: records carry no `parts`, `pe` or `epoch`, and
    dispatches carry no fence stamp."""
    jdir = str(tmp_path / "waloff")

    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        bal = balancer(S, provider)
        bal.attach_journal(S.J.PlacementJournal(jdir))
        await bal.start()
        invokers, producer = await fleet(S, provider, 2)
        await ping_all(invokers, producer, [bal])
        action = make_action(S, "off", memory=128)
        p = await bal.publish(action, make_msg(
            S, action, S.E.Identity.generate("guest"), True))
        await asyncio.wait_for(p, 10)
        await until(lambda: sum(len(i.handled) for i in invokers) >= 1)
        await drained(bal)
        assert bal.journal.flush()
        recs = list(S.J.PlacementJournal(jdir).records(0))
        stamps = [(m.fence_part, m.fence_epoch) for i in invokers
                  for m in i.handled]
        await stop_all([bal], invokers)
        return recs, stamps

    recs, stamps = run(go(), 60)
    assert recs and any(r["t"] == "batch" for r in recs)
    for r in recs:
        assert not {"parts", "pe", "epoch"} & set(r)
    assert stamps == [(None, None)]


# -- the seeded scenario through both packages ------------------------------------
#: the scenario's modes: a ring of 8 with every partition owned at its own
#: epoch (n = 1), the active of an active/standby pair at epoch 3, and off
MODES = ("partitions", "active_standby", "off")
#: the ring mode's per-partition epochs
PART_EPOCHS = {p: 1 + (3 * p) % 5 for p in range(8)}


def _mode_setup(S, mode, jdir):
    def setup(bal):
        bal.attach_journal(S.J.PlacementJournal(jdir))
        if mode == "partitions":
            bal.set_partition_mode(S.Parts.PartitionRing(8))
            for pid, ep in PART_EPOCHS.items():
                bal.set_partition_leadership(pid, ep, True)
        elif mode == "active_standby":
            bal.set_leadership(3, True)
    return setup


@pytest.fixture(scope="module")
def mode_runs(tmp_path_factory):
    """The front's scenario (no rate admission, no growth) per mode and
    package, cached for the module: {(mode, side): run} with its journal
    directory."""
    cache = {}

    def get(mode, name):
        if (mode, name) not in cache:
            S = side(name)
            pkg = _jax_package() if name == "jax" else _port_package()
            jdir = str(tmp_path_factory.mktemp(f"{mode}-{name}") / "wal")
            mp = pytest.MonkeyPatch()
            mp.setattr(pkg.E.ConcurrencyLimit, "MAX", 16)
            try:
                res = run(_scenario(
                    pkg, None, False, 53,
                    ack_producer=lambda prov, co=S.Conn:
                    __import__(f"{S.root}.messaging.coalesce",
                               fromlist=["x"]).maybe_coalesce(
                        prov.get_producer()),
                    setup=_mode_setup(S, mode, jdir),
                    inspect=lambda bal: (bal.journal.flush(),
                                         bal.journal.close())), 120)
            finally:
                mp.undo()
            res["jdir"] = jdir
            cache[(mode, name)] = res
        return cache[(mode, name)]
    return get


def _segments(jdir):
    return {f: open(os.path.join(jdir, f), "rb").read()
            for f in sorted(os.listdir(jdir))}


@pytest.mark.parametrize("mode", ["partitions", "active_standby"])
def test_mode_journals_are_byte_identical_across_packages(mode_runs, mode):
    runs = {s: mode_runs(mode, s) for s in SIDES}
    assert runs["port"]["decisions"] == runs["jax"]["decisions"]
    segs = {s: _segments(r["jdir"]) for s, r in runs.items()}
    assert segs["port"] == segs["jax"]
    recs = list(side("port").J.PlacementJournal(runs["port"]["jdir"])
                .records(0))
    batches = [r for r in recs if r["t"] == "batch"]
    assert batches
    if mode == "partitions":
        for b in batches:
            assert b["parts"] == sorted(int(p) for p in b["pe"])
            assert all(b["pe"][str(p)] == PART_EPOCHS[p] for p in b["parts"])
        ring = side("port").Parts.PartitionRing(8)
        seen = set().union(*(b["parts"] for b in batches))
        assert seen == {ring.partition_of(f"ns{k}") for k in range(16)}
        assert not any("epoch" in r for r in recs)
    else:
        assert all(r["epoch"] == 3 for r in recs)
        assert not any("parts" in r for r in recs)


def test_n1_ring_places_exactly_as_no_ring(mode_runs):
    """One controller owning every partition places bit-identically to the
    ring-off path, and its records differ only by the additive
    `parts` / `pe` keys."""
    on, off = mode_runs("partitions", "port"), mode_runs("off", "port")
    assert on["decisions"] == off["decisions"]
    for k in ("free", "conc", "health"):
        np.testing.assert_array_equal(on[k], off[k])
    J = side("port").J
    r_on = list(J.PlacementJournal(on["jdir"]).records(0))
    r_off = list(J.PlacementJournal(off["jdir"]).records(0))
    strip = [{k: v for k, v in r.items() if k not in ("parts", "pe")}
             for r in r_on]
    assert strip == r_off


def _absorb(absorber, recs, pids):
    """A fresh balancer of the absorbing package, given the writer's
    topology by replaying its structural records, absorbs `pids` from the
    tail: (stats, books)."""
    S = side(absorber)

    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        bal = balancer(S, provider, "1", managed_fraction=0.75,
                       blackbox_fraction=0.25, max_batch=MAX_BATCH,
                       action_slots=SLOTS, initial_pad=INITIAL_PAD)
        bal.set_partition_mode(S.Parts.PartitionRing(8))
        bal.replay_journal([r for r in recs if r["t"] in (
            "reg", "grow", "slots", "cluster")])
        pre = books(bal)
        for pid in pids:
            bal.set_partition_leadership(pid, PART_EPOCHS[pid] + 1, True)
        stats = bal.absorb_partitions(pids, FakeJournal(recs))
        out = books(bal)
        await bal.close()
        return stats, pre, out

    return run(go(), 60)


@pytest.mark.parametrize("writer", SIDES, ids=["jax_tail", "port_tail"])
def test_each_package_absorbs_the_others_tail_to_the_same_books(mode_runs,
                                                                writer):
    recs = list(side(writer).J.PlacementJournal(
        mode_runs("partitions", writer)["jdir"]).records(0))
    pids = [0, 3, 5, 6]
    res = {s: _absorb(s, recs, pids) for s in SIDES}
    (js, jpre, jout), (ts, tpre, tout) = res["jax"], res["port"]
    for a, b in zip(jpre, tpre):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(a, b)
    assert js == ts
    assert ts["batches"] >= 1 and ts["filtered_out"] >= 1
    assert "skipped" not in ts
    assert not np.array_equal(tpre[0], tout[0]), "the absorb held capacity"


# -- spillover ------------------------------------------------------------------
class _MembershipStub:
    def __init__(self, peer):
        self.peer = peer

    def least_loaded_peer(self):
        return self.peer


def _store_stub(action):
    class StoreStub:
        @staticmethod
        async def get_action(name, rev=None):
            class Doc:
                @staticmethod
                def to_executable():
                    return action
            return Doc()
    return StoreStub()


async def _spill(So, Sp, po, pp, invokers, producer):
    """Owner (package So, provider po) spills to a peer (package Sp,
    provider pp): 6 non-blocking rows at depth 2, over one fleet that
    both balancers register."""
    ring = So.Parts.PartitionRing(8)
    b0, b1 = balancer(So, po, "0"), balancer(Sp, pp, "1")
    b0.set_partition_mode(ring)
    b1.set_partition_mode(Sp.Parts.PartitionRing(8))
    for b in (b0, b1):
        await b.start()
    await ping_all(invokers, producer, [b0, b1])
    action = make_action(So, "hot", memory=128)
    ns = ns_for_partition(ring, 4, "hot")
    ident = So.E.Identity.generate(ns)
    b0.set_partition_leadership(4, 2, True)
    b1.partition_epochs[4] = 2
    b0.spillover_sink = So.Spill.SpilloverSender(po, _MembershipStub(1))
    b0.spillover_depth = 2
    receiver = Sp.Spill.SpilloverReceiver(
        pp, Sp.E.ControllerInstanceId("1"), b1,
        _store_stub(make_action(Sp, "hot", memory=128)))
    receiver.start()
    outs = b0.publish_many([(action, make_msg(So, action, ident, False))
                            for _ in range(6)])
    await asyncio.gather(*outs)
    await until(lambda: sum(len(i.handled) for i in invokers) >= 6,
                timeout=10.0)
    await asyncio.sleep(0.1)
    handled = [m for i in invokers for m in i.handled]
    out = dict(
        n=len(handled),
        spilled=sum(m.root_controller_index.name == "1" for m in handled),
        local=sum(m.root_controller_index.name == "0" for m in handled),
        stamps={(m.fence_part, m.fence_epoch) for m in handled},
        counts=(b0.spilled_rows, receiver.received, receiver.refused))
    await receiver.stop()
    await stop_all([b0, b1])
    return out


@both
def test_overflow_batch_forwards_to_peer_and_executes(S):
    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        invokers, producer = await fleet(S, provider, 2)
        try:
            return await _spill(S, S, provider, provider, invokers,
                                producer)
        finally:
            await stop_all((), invokers)

    out = run(go(), 60)
    assert out["n"] == 6 and out["spilled"] == 4 and out["local"] == 2
    assert out["stamps"] == {(4, 2)}
    assert out["counts"] == (4, 4, 0)


@pytest.mark.parametrize("owner,peer", [("jax", "port"), ("port", "jax")],
                         ids=["jax_owner_port_peer", "port_owner_jax_peer"])
def test_spillover_crosses_the_packages_over_one_tcp_bus(owner, peer):
    """The owner's spill frame reaches the other package's receiver over
    the port's broker; each row executes once, fenced at the owner's
    epoch. Two simulated invokers of the peer's package serve both
    balancers (the wire is byte-identical across the packages)."""
    So, Sp = side(owner), side(peer)

    async def go():
        T = side("port")
        server = T.Tcp.TcpBusServer("127.0.0.1", 0)
        await server.start()
        port = server._server.sockets[0].getsockname()[1]
        po = So.Tcp.TcpMessagingProvider("127.0.0.1", port)
        pp = Sp.Tcp.TcpMessagingProvider("127.0.0.1", port)
        invokers, producer = await fleet(Sp, pp, 2)
        try:
            return await _spill(So, Sp, po, pp, invokers, producer)
        finally:
            await stop_all((), invokers)
            await server.stop()

    out = run(go(), 90)
    assert out["n"] == 6 and out["stamps"] == {(4, 2)}
    assert out["spilled"] == 4 and out["local"] == 2
    assert out["counts"] == (4, 4, 0)


def test_spill_frames_are_byte_identical_across_packages():
    """The same rows forwarded by each package's SpilloverSender ship the
    same bytes on `ctrlspill<peer>`."""
    from test_torch_messaging import JAX_PKG, PORT_PKG, build

    async def capture(S, pkg):
        provider = S.Mem.MemoryMessagingProvider()
        sender = S.Spill.SpilloverSender(provider, _MembershipStub(3))
        msgs = [build(pkg, "activation", k) for k in range(5)]
        for m in msgs:
            m.fence_part, m.fence_epoch = 4, 7
        action = make_action(S, "hot", memory=128)
        sent = sender.forward([(action, m) for m in msgs])
        await asyncio.gather(*sent)
        topic = S.Spill.spill_topic(3)
        consumer = provider.get_consumer(topic, "cap")
        frames = [p for *_x, p in await consumer.peek(16, timeout=0.2)]
        return topic, frames

    jax_out = run(capture(side("jax"), JAX_PKG))
    port_out = run(capture(side("port"), PORT_PKG))
    assert jax_out[1] and port_out == jax_out


# -- the edge --------------------------------------------------------------------
def _proxy(S, n=3, ring=None, **kw):
    return S.Edge.EdgeProxy.for_controllers(
        [f"http://127.0.0.1:{3000 + i}" for i in range(n)], ring=ring, **kw)


@both
def test_edge_owner_first_order_and_fallback(S):
    ring = S.Parts.PartitionRing(16)
    proxy = _proxy(S, ring=ring)
    for ns in ("alice", "bob", "hot-ns"):
        ranked = ring.rank(ring.partition_of(ns), [0, 1, 2])
        assert [u.url for u in proxy._pick_order(ns)] == \
            [f"http://127.0.0.1:{3000 + i}" for i in ranked]
    assert len(proxy._pick_order(None)) == 3


def test_edge_routes_every_namespace_as_the_jax_edge():
    orders = {}
    for s in SIDES:
        S = side(s)
        proxy = _proxy(S, n=4, ring=S.Parts.PartitionRing(8))
        orders[s] = [[u.url for u in proxy._pick_order(f"ns{i}")]
                     for i in range(64)]
    assert orders["port"] == orders["jax"]


@both
def test_edge_path_namespace_backoff_and_retry_counter(S):
    proxy = _proxy(S, retry_backoff_ms=20, retry_backoff_max_ms=100)
    f = proxy._path_namespace
    assert f("/api/v1/namespaces/alice/actions/x") == "alice"
    assert f("/api/v1/namespaces/_/actions/x") is None
    assert f("/metrics") is None
    assert f("/api/v1/namespaces/") is None
    for attempt in (1, 2, 3, 8):
        for _ in range(16):
            assert 0.0 <= proxy._backoff_s(attempt) <= 0.1
    assert proxy.retry_attempts == 0
    proxy._count_retry("http_503")
    proxy._count_retry("http_503")
    proxy._count_retry("connect")
    assert proxy.retry_total == {"http_503": 2, "connect": 1}


# -- /admin/ready -------------------------------------------------------------------
async def _ready_docs(S, tmp_path):
    """(status, doc) of /admin/ready in the three modes."""
    out = {}

    class C:
        membership = None

    for mode in ("single", "active_active_standby_for_all", "active_active",
                 "active_standby"):
        provider = S.Mem.MemoryMessagingProvider()
        bal = balancer(S, provider)
        if mode.startswith("active_active"):
            bal.set_partition_mode(S.Parts.PartitionRing(8))
            if mode == "active_active":
                bal.set_partition_leadership(2, 5, True)
        elif mode == "active_standby":
            bal.set_leadership(4, False)
            bal.attach_journal(S.J.PlacementJournal(
                str(tmp_path / f"w-{S.name}")))
        C.load_balancer = bal
        resp = await S.Api.ControllerApi(C()).admin_ready(None)
        out[mode] = (resp.status, json.loads(resp.body))
        await bal.close()
    return out


@both
def test_admin_ready_in_its_three_modes(S, tmp_path):
    docs = run(_ready_docs(S, tmp_path), 60)
    st, doc = docs["single"]
    assert st == 200 and doc["mode"] == "single" and doc["ready"]
    st, _doc = docs["active_active_standby_for_all"]
    assert st == 503
    st, doc = docs["active_active"]
    assert st == 200 and doc["mode"] == "active_active"
    assert doc["owned_partitions"] == 1 and doc["n_partitions"] == 8
    assert doc["partitions"][2]["role"] == "active"
    assert doc["journal"] == {"attached": False, "stall_firing": False}
    st, doc = docs["active_standby"]
    assert st == 503
    assert doc == {"mode": "active_standby", "role": "standby", "epoch": 4,
                   "ready": False,
                   "journal": {"attached": True, "lag_batches": 0,
                               "stall_firing": False}}


def test_admin_ready_answers_as_the_jax_controller(tmp_path):
    docs = {s: run(_ready_docs(side(s), tmp_path / s), 60) for s in SIDES}
    assert docs["port"] == docs["jax"]


# -- the journal-stall alert ------------------------------------------------------
@both
def test_journal_stall_rule_fires_on_sustained_lag(S):
    rules = S.Anomaly.build_rules(None)
    rule = rules["journal_stall"]
    assert rule.scope == "global" and rule.severity == "critical"
    engine = S.Anomaly.AlertEngine({"journal_stall": rule})
    engine.evaluate(0.0, {"journal_stall": [((), 100.0)]})
    assert not engine.firing_counts()
    engine.evaluate(rule.for_s + 1.0, {"journal_stall": [((), 120.0)]})
    assert ("journal_stall", "critical") in engine.firing_counts()
    engine.evaluate(rule.for_s + 2.0, {"journal_stall": [((), 0.0)]})
    assert not engine.firing_counts()


@both
def test_attach_journal_registers_the_stall_signal(S, tmp_path):
    async def go():
        bal = balancer(S, S.Mem.MemoryMessagingProvider())
        bal.attach_journal(S.J.PlacementJournal(str(tmp_path / "w")))
        sig = bal.anomaly.extra_signals["journal_lag_batches"]
        v0 = sig()
        bal.journal = None
        v1 = sig()
        await bal.close()
        return v0, v1

    assert run(go()) == (0.0, None)
