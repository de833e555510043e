"""The port's fleet mesh (`openwhisk_tpu_torch/parallel/`) against the JAX
package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX mesh on its 8
virtual CPU devices and through the port's mesh at S = 8 with
`device="cpu"`, and through each package's single-device functions.
Tolerance: none — decisions, forced flags, books and repair-round counts
are integers and flags, compared exactly.

  (a) the kernels: every case of `tests/test_fleet_mesh.py`'s
      `TestFleetKernelParity` (repair fuzz, forced overload, container-open
      burst, the release vector with conflation, chained steps with
      releases, the scan pair, the auto hybrid, grow-reshard), and the
      sharded scan of `tests/test_placement_kernel.py` at 64 and 64k
      invokers (the int32-wraparound row);
  (b) the fused, release-only and shadow steps on the mesh against the
      single-device ones;
  (c) the balancer: `TestFleetBalancer`'s cases through each package's
      `TpuBalancer`, and the front's seeded scenario
      (`tests/test_torch_balancer_front.py`) on both packages' meshes and
      on the port's single device: placements and books equal;
  (d) the journal: `tests/test_journal.py`'s `TestMeshTopologyReplay` on
      the port, and the two packages' 8-shard journals, which are byte
      identical and replay in each other's balancer bit for bit;
  (e) the quality plane's mesh shadow: kept passes and scores equal the
      JAX plane's on a mesh;
  (f) the device rule: `device="cpu"` puts every shard on the CPU, no
      device means the card and raises without one, nothing falls back.

Per-shard calibration is not ported (the port has one backend a device),
so `TestPerShardCalibration` and `TestFleetSweepRider` have no
counterpart here.
"""
import asyncio
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from openwhisk_tpu.ops import placement as JP  # noqa: E402
from openwhisk_tpu.parallel import fleet_mesh as JF  # noqa: E402
from openwhisk_tpu.parallel import sharded_state as JS  # noqa: E402
from openwhisk_tpu_torch.controller.loadbalancer import \
    tpu_balancer as TB  # noqa: E402
from openwhisk_tpu_torch.ops import placement as TP  # noqa: E402
from openwhisk_tpu_torch.parallel import fleet_mesh as TF  # noqa: E402
from openwhisk_tpu_torch.parallel import sharded_state as TS  # noqa: E402
from test_fleet_mesh import _dirty_state, _rand_batch  # noqa: E402
from test_placement_kernel import (_batch_from_trace,  # noqa: E402
                                   _make_slot_allocator, _random_trace)
from torch_mesh_cases import books_of, drive, entities  # noqa: E402
from openwhisk_tpu.models.sharding_policy import \
    ShardingPolicyState  # noqa: E402

pytestmark = pytest.mark.mesh

N_SHARDS = 8
CPU = "cpu"


@pytest.fixture(scope="module")
def meshes():
    """(the JAX package's 8-device mesh, the port's 8-shard CPU mesh)."""
    return JF.make_fleet_mesh(N_SHARDS), TF.make_fleet_mesh(N_SHARDS,
                                                            device=CPU)


# -- conversions ----------------------------------------------------------------
def _port_state(st):
    """JAX books -> the port's books on the CPU (conc [N, A] view of
    [A, N] storage)."""
    return TP.placement_state_from_numpy(np.asarray(st.free_mb),
                                         np.asarray(st.conc_free),
                                         np.asarray(st.health), CPU)


def _port_batch(b):
    return TP.request_batch_from_numpy(*(np.asarray(c) for c in b),
                                       device=CPU)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _assert_same(*outs):
    """Every output tuple (state, chosen, forced[, rounds]) equal."""
    ref = outs[0]
    for i, o in enumerate(outs[1:], 1):
        for a, b, what in zip(books_of(ref[0]), books_of(o[0]),
                              ("free", "conc", "health")):
            np.testing.assert_array_equal(a, b, err_msg=f"{i}: {what}")
        for j in range(1, len(ref)):
            np.testing.assert_array_equal(_np(ref[j]), _np(o[j]),
                                          err_msg=f"{i}: output {j}")


def _clone(st):
    return TP.PlacementState(st.free_mb.clone(), st.conc_free.T.clone().T,
                             st.health.clone())


def _four_ways(meshes, st, batch, jax_single, jax_mesh, port_single,
               port_mesh):
    """One JAX state/batch through the JAX single-device function, the
    JAX mesh, the port's single-device function and the port's mesh."""
    jm, tm = meshes
    pst, pb = _port_state(st), _port_batch(batch)
    outs = (jax_single(st, batch),
            jax_mesh(JS.shard_state(st, jm), batch),
            port_single(_clone(pst), pb),
            port_mesh(TS.shard_state(pst, tm), pb))
    _assert_same(*outs)
    return outs


# -- (a) the kernels ---------------------------------------------------------------
@pytest.mark.parametrize("n,b", [(16, 8), (32, 32), (64, 64), (128, 96)])
def test_repair_parity_fuzz(meshes, n, b):
    jm, tm = meshes
    rng = np.random.RandomState(7 + n)
    for _trial in range(3):
        st = _dirty_state(rng, n)
        batch = _rand_batch(rng, n, b)
        _four_ways(meshes, st, batch, JP.schedule_batch_repair,
                   JF.make_fleet_repair_schedule(jm),
                   TP.schedule_batch_repair,
                   TF.make_fleet_repair_schedule(tm))


def test_forced_overload_parity(meshes):
    """Needs far beyond capacity: every placement forces; the forced
    candidate's election must match the single-device argmin."""
    jm, tm = meshes
    rng = np.random.RandomState(11)
    n, b = 32, 48
    st = _dirty_state(rng, n)
    batch = _rand_batch(rng, n, b, need=np.full(b, 1900, np.int32),
                        maxc_pool=(1,))
    outs = _four_ways(meshes, st, batch, JP.schedule_batch_repair,
                      JF.make_fleet_repair_schedule(jm),
                      TP.schedule_batch_repair,
                      TF.make_fleet_repair_schedule(tm))
    assert _np(outs[3][2]).any(), "the case must force"


def test_container_open_burst_parity(meshes):
    """Same-action bursts opening shared containers (max_conc > 1): the
    permit-grant cascade."""
    jm, tm = meshes
    rng = np.random.RandomState(13)
    n, b = 32, 64
    st = JP.init_state(n, [2048] * n, n_pad=n, action_slots=16)
    batch = _rand_batch(rng, n, b, maxc_pool=(4,), slots=4,
                        invalid_frac=0.0)
    _four_ways(meshes, st, batch, JP.schedule_batch_repair,
               JF.make_fleet_repair_schedule(jm), TP.schedule_batch_repair,
               TF.make_fleet_repair_schedule(tm))


def test_release_vector_parity_incl_conflation(meshes):
    """The owner-masked vector release, with the heterogeneous
    slot-conflation residue."""
    jm, tm = meshes
    rng = np.random.RandomState(17)
    n, r = 32, 48
    st = _dirty_state(rng, n)
    cols = (rng.randint(0, n, r), rng.randint(0, 4, r),
            rng.choice([128, 256], r), rng.choice([1, 4, 6], r))
    valid = rng.rand(r) > 0.15
    jargs = [jnp.asarray(c, jnp.int32) for c in cols] + [jnp.asarray(valid)]
    targs = [torch.from_numpy(np.asarray(c, np.int32)) for c in cols] + [
        torch.from_numpy(valid)]
    pst = _port_state(st)
    outs = [(JP.release_batch_vector(st, *jargs),),
            (JF.make_fleet_release_vector(jm)(JS.shard_state(st, jm),
                                              *jargs),),
            (TP.release_batch_vector(_clone(pst), *targs),),
            (TF.make_fleet_release_vector(tm)(TS.shard_state(pst, tm),
                                              *targs),),
            (TS.make_sharded_release(tm)(TS.shard_state(pst, tm), *targs),)]
    _assert_same(*outs)


@pytest.mark.parametrize("family,r", [("scan", 8), ("scan", 31),
                                      ("repair", 32), ("repair", 96)])
def test_cpu_mesh_release_runs_the_plain_folds(meshes, family, r,
                                               monkeypatch):
    """On CPU books each family's mesh fold runs its plain fold on every
    shard (the row loop below 32 rows, the vector from 32 on; never the
    card kernel's wrapper) and equals the JAX mesh's fold."""
    jm, tm = meshes
    if family == "scan":  # the scan pair's meshes: sharded_state's axis
        jm, tm = JS.make_mesh(N_SHARDS), TS.make_mesh(N_SHARDS, device=CPU)
    rng = np.random.RandomState(r)
    n = 32
    st = _dirty_state(rng, n)
    cols = (rng.randint(0, n, r), rng.randint(0, 4, r),
            rng.choice([128, 256], r), rng.choice([1, 2, 4, 6], r))
    valid = rng.rand(r) > 0.15
    jargs = [jnp.asarray(c, jnp.int32) for c in cols] + [jnp.asarray(valid)]
    targs = [torch.from_numpy(np.asarray(c, np.int32)) for c in cols] + [
        torch.from_numpy(valid)]
    calls = []

    def card(*_a):
        raise AssertionError("the card's release kernel on CPU books")

    monkeypatch.setattr(TS, "release_batch_cuda", card)
    if family == "scan":
        plain, mod = TS.release_batch, TS
        ref = JS.make_sharded_release(jm)
    else:
        plain, mod = TF.release_batch_vector, TF
        ref = JF.make_fleet_release_vector(jm)
    monkeypatch.setattr(mod, plain.__name__,
                        lambda *a: calls.append(1) or plain(*a))
    port = (TS.make_sharded_release(tm) if family == "scan"
            else TF.make_fleet_release_vector(tm))
    _assert_same((ref(JS.shard_state(st, jm), *jargs),),
                 (port(TS.shard_state(_port_state(st), tm), *targs),))
    assert len(calls) == N_SHARDS


def test_chained_steps_with_releases_parity(meshes):
    """Schedule, release what placed, schedule again on the dirtied books,
    four times: the production steady state."""
    jm, tm = meshes
    jsched, jrel = (JF.make_fleet_repair_schedule(jm),
                    JF.make_fleet_release_vector(jm))
    tsched, trel = (TF.make_fleet_repair_schedule(tm),
                    TF.make_fleet_release_vector(tm))
    rng = np.random.RandomState(19)
    n, b = 64, 48
    st1 = JP.init_state(n, [2048] * n, n_pad=n, action_slots=16)
    st2 = JS.shard_state(st1, jm)
    pst = TS.shard_state(_port_state(st1), tm)
    for step in range(4):
        batch = _rand_batch(rng, n, b)
        st1, c1, f1, r1 = JP.schedule_batch_repair(st1, batch)
        st2, c2, f2, r2 = jsched(st2, batch)
        pst, c3, f3, r3 = tsched(pst, _port_batch(batch))
        _assert_same((st1, c1, f1, r1), (st2, c2, f2, r2), (pst, c3, f3, r3))
        inv = np.clip(np.asarray(c1), 0, None).astype(np.int32)
        ok = np.asarray(c1) >= 0
        args = (batch.conc_slot, batch.need_mb, batch.max_conc)
        st1 = JP.release_batch_vector(st1, jnp.asarray(inv), *args,
                                      jnp.asarray(ok))
        st2 = jrel(st2, jnp.asarray(inv), *args, jnp.asarray(ok))
        pst = trel(pst, torch.from_numpy(inv),
                   *(torch.from_numpy(np.array(a)) for a in args),
                   torch.from_numpy(ok))
        _assert_same((st1,), (st2,), (pst,))


def test_scan_pair_parity(meshes):
    """fleet_pair('scan'): the sharded scan, exact with the single-device
    scan."""
    jm, tm = meshes
    jsched, _jrel, jres = JF.fleet_pair(jm, "scan")
    tsched, _trel, tres = TF.fleet_pair(tm, "scan")
    assert jres == tres == "scan"
    rng = np.random.RandomState(23)
    n, b = 32, 24
    _four_ways(meshes, _dirty_state(rng, n), _rand_batch(rng, n, b),
               JP.schedule_batch, jsched, TP.schedule_batch, tsched)


def test_auto_pair_is_per_bucket_hybrid(meshes):
    """fleet_pair('auto'): the scan below repair_min_batch (no rounds
    element), the repair at and above it."""
    jm, tm = meshes
    jsched, _jrel, jres = JF.fleet_pair(jm, "auto", repair_min_batch=32)
    tsched, _trel, tres = TF.fleet_pair(tm, "auto", repair_min_batch=32)
    assert jres == tres == "repair"
    assert getattr(tsched, "_placement_hybrid", False)
    rng = np.random.RandomState(29)
    n = 32
    st = _dirty_state(rng, n)
    small, big = _rand_batch(rng, n, 8), _rand_batch(rng, n, 64)
    outs = _four_ways(meshes, st, small, JP.schedule_batch, jsched,
                      TP.schedule_batch, tsched)
    assert len(outs[3]) == 3
    outs = _four_ways(meshes, st, big, JP.schedule_batch_repair, jsched,
                      TP.schedule_batch_repair, tsched)
    assert len(outs[3]) == 4 and int(outs[3][3]) >= 1


def test_grow_reshard_continues_bit_exact(meshes):
    """Growth re-pads the invoker axis (holds kept) and reshards onto the
    same mesh; placement keeps tracking the single device."""
    jm, tm = meshes
    jsched, tsched = (JF.make_fleet_repair_schedule(jm),
                      TF.make_fleet_repair_schedule(tm))
    rng = np.random.RandomState(31)
    n1, n2, b = 32, 64, 24
    st1 = _dirty_state(rng, n1)
    st2 = JS.shard_state(st1, jm)
    pst = TS.shard_state(_port_state(st1), tm)
    batch = _rand_batch(rng, n1, b)
    st1, c1, f1, r1 = JP.schedule_batch_repair(st1, batch)
    st2, c2, f2, r2 = jsched(st2, batch)
    pst, c3, f3, r3 = tsched(pst, _port_batch(batch))
    _assert_same((st1, c1, f1, r1), (st2, c2, f2, r2), (pst, c3, f3, r3))

    def grow(st, pad):
        free, conc, health = books_of(st)
        f2_ = np.full((pad,), 2048, np.int32)
        f2_[:n1] = free
        c2_ = np.zeros((pad, conc.shape[1]), np.int32)
        c2_[:n1] = conc
        h2_ = np.ones((pad,), bool)
        h2_[:n1] = health
        return f2_, c2_, h2_

    st1 = JP.PlacementState(*(jnp.asarray(x) for x in grow(st1, n2)))
    st2 = JS.shard_state(JP.PlacementState(
        *(jnp.asarray(x) for x in grow(st2, n2))), jm)
    pst = TS.shard_state(TP.placement_state_from_numpy(*grow(pst, n2), CPU),
                         tm)
    batch2 = _rand_batch(rng, n2, b)
    _assert_same(JP.schedule_batch_repair(st1, batch2), jsched(st2, batch2),
                 tsched(pst, _port_batch(batch2)))


@pytest.mark.parametrize("n,trace", [
    (64, dict(n_actions=20, B=128, seed=11, conc_choices=(1, 4),
              mems=(128, 256), bb_prob=0.1)),
    (65536, dict(n_actions=16, B=32, seed=65, conc_choices=(1,),
                 mems=(128, 256, 512)))], ids=["64", "64k"])
def test_sharded_scan_and_release_match(meshes, n, trace):
    """`tests/test_placement_kernel.py`'s sharded scan: the JAX package's
    `make_sharded_schedule` on its 8-device mesh and the port's on 8 CPU
    shards, at 64 invokers and at 64k (step inverses whose products pass
    2^31), then the sharded release of what placed."""
    jm = JS.make_mesh(N_SHARDS)
    tm = TS.make_mesh(N_SHARDS, device=CPU)
    mem = 1024 if n == 64 else 2048
    st = ShardingPolicyState.build([mem] * n)
    batch = _batch_from_trace(st, _random_trace(**trace),
                              _make_slot_allocator())
    if n == 65536:
        assert int(np.asarray(batch.step_inv).max()) * (n - 1) > 2 ** 31
    slots = 64 if n == 64 else 32
    single = JP.init_state(n, [mem] * n, action_slots=slots)
    outs = _four_ways((jm, tm), single, batch, JP.schedule_batch,
                      JS.make_sharded_schedule(jm), TP.schedule_batch,
                      TS.make_sharded_schedule(tm))
    chosen = _np(outs[0][1])
    ok = chosen >= 0
    inv = chosen.clip(0).astype(np.int32)
    args = [np.array(c) for c in (batch.conc_slot, batch.need_mb,
                                  batch.max_conc)]
    jrel = JS.make_sharded_release(jm)(
        outs[1][0], jnp.asarray(inv), *map(jnp.asarray, args),
        jnp.asarray(ok))
    trel = TS.make_sharded_release(tm)(
        outs[3][0], torch.from_numpy(inv), *map(torch.from_numpy, args),
        torch.from_numpy(ok))
    _assert_same((JP.release_batch(outs[0][0], jnp.asarray(inv),
                                   *map(jnp.asarray, args),
                                   jnp.asarray(ok)),), (jrel,), (trel,))


# -- (b) the steps over one packed buffer ------------------------------------------
def _packed(rng, n, r, h, b, rows=9):
    """A packed buffer: releases of random invokers (conflated slots),
    health flips with padded duplicates, and a request batch."""
    rel = np.zeros((5, r), np.int32)
    rel[0] = rng.randint(0, n, r)
    rel[1] = rng.randint(0, 4, r)
    rel[2] = rng.choice([128, 256], r)
    rel[3] = rng.choice([1, 1, 4], r)
    rel[4] = rng.rand(r) > 0.3
    health = np.zeros((3, h), np.int32)
    k = h // 2
    health[0, :k] = rng.choice(n, k, replace=False)
    health[0, k:] = health[0, k - 1]
    health[1, :k] = rng.rand(k) > 0.3
    health[1, k:] = health[1, k - 1]
    health[2] = 1
    bt = _rand_batch(rng, n, b, slots=4)
    req = np.stack([np.asarray(c, np.int32) for c in bt]
                   + ([rng.randint(0, 3, b).astype(np.int32)]
                      if rows == 10 else []))
    return np.concatenate([rel.ravel(), health.ravel(), req.ravel()])


@pytest.mark.parametrize("kernel,b", [("auto", 8), ("auto", 64),
                                      ("scan", 32), ("repair", 16)])
def test_fused_and_release_steps_match_the_single_device(meshes, kernel, b):
    """The mesh's fused step, release-only fold and admit step over one
    packed buffer equal `ops/placement.py`'s single-device ones: the
    packed output and the books, step after step."""
    from openwhisk_tpu_torch.ops.throttle import init_buckets
    _jm, tm = meshes
    rng = np.random.RandomState(41 + b)
    n = 64
    single = _port_state(_dirty_state(rng, n, slots=4))
    sharded = TS.shard_state(single, tm)
    s_sched, s_rel, _ = TB._torch_pair(kernel)
    m_sched, m_rel, _ = TF.fleet_pair(tm, kernel)
    one = TP.make_fused_step_packed(s_rel, s_sched)
    mesh = TF.make_fleet_fused_step_packed(tm, m_rel, m_sched)
    rel_one = TP.make_release_packed(s_rel)
    rel_mesh = TF.make_fleet_release_packed(tm, m_rel)
    for step in range(3):
        buf = torch.from_numpy(_packed(rng, n, b, 8, b))
        single, o1 = one(single, buf, b, 8, b)
        sharded, o2 = mesh(sharded, buf, b, 8, b)
        assert torch.equal(o1, o2), step
        _assert_same((single,), (sharded,))
        rel = torch.from_numpy(_packed(rng, n, b, 8, b)[:5 * b].reshape(5, b))
        single = rel_one(single, rel)
        sharded = rel_mesh(sharded, rel)
        _assert_same((single,), (sharded,))
    admit_one = TP.make_fused_admit_step_packed(s_rel, s_sched)
    admit_mesh = TF.make_fleet_fused_admit_step_packed(tm, m_rel, m_sched)
    buckets = init_buckets(4, 2, device=CPU)
    buf = torch.from_numpy(_packed(rng, n, b, 8, b, rows=10))
    (single, bk1), o1 = admit_one((single, buckets), buf, np.float32(1.0),
                                  b, 8, b)
    (sharded, bk2), o2 = admit_mesh((sharded, buckets), buf,
                                    np.float32(1.0), b, 8, b)
    assert torch.equal(o1, o2)
    assert ((o1[:-1] >> 1) & 1).any(), "rows must throttle"
    assert all(torch.equal(x, y) for x, y in zip(bk1, bk2))
    _assert_same((single,), (sharded,))


@pytest.mark.parametrize("rate", [False, True], ids=["plain", "admit"])
def test_shadow_step_matches_jax_and_leaves_the_books(meshes, rate):
    """The mesh's shadow step (the penalized sharded repair on a copy of
    every shard) equals the JAX package's shadow step with its penalized
    repair, and the port's single-device shadow step, bit for bit; the
    live shards are untouched."""
    from openwhisk_tpu.ops import throttle as JT
    from openwhisk_tpu_torch.ops import throttle as TT
    _jm, tm = meshes
    rng = np.random.RandomState(43 + rate)
    n, b = 64, 32
    jst = _dirty_state(rng, n, slots=4)
    single = _port_state(jst)
    sharded = TS.shard_state(single, tm)
    before = books_of(sharded)
    pen = rng.randint(0, 2, n).astype(np.int32)
    buf = _packed(rng, n, b, 8, b, rows=10 if rate else 9)
    mk_j = (JP.make_shadow_admit_step_packed if rate
            else JP.make_shadow_step_packed)
    mk_t = (TP.make_shadow_admit_step_packed if rate
            else TP.make_shadow_step_packed)
    mk_m = (TF.make_fleet_shadow_admit_step_packed if rate
            else TF.make_fleet_shadow_step_packed)
    jfn = mk_j(JP.release_batch_vector, JP.schedule_batch_repair)
    tfn = mk_t(TP.release_batch_vector, TP.schedule_batch_repair)
    mfn = mk_m(tm, TF.make_fleet_release_vector(tm),
               TF.make_fleet_repair_schedule(tm, penalized=True))
    tpen = torch.from_numpy(pen)
    tbuf = torch.from_numpy(buf)
    if rate:
        now = np.float32(1.0)
        jb = JT.init_buckets(4, 2)
        tb = TT.init_buckets(4, 2, device=CPU)
        ref = jfn((jst, jb), jnp.asarray(buf), jnp.asarray(pen), now, b, 8, b)
        one = tfn((single, tb), tbuf, tpen, now, b, 8, b)
        got = mfn((sharded, tb), tbuf, tpen, now, b, 8, b,
                  scratch=TF.empty_sharded_books_like(sharded))
    else:
        ref = jfn(jst, jnp.asarray(buf), jnp.asarray(pen), b, 8, b)
        one = tfn(single, tbuf, tpen, b, 8, b)
        got = mfn(sharded, tbuf, tpen, b, 8, b)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    assert torch.equal(one, got)
    for x, y in zip(before, books_of(sharded)):
        np.testing.assert_array_equal(x, y)


# -- (c) the balancer ------------------------------------------------------------
def _mesh_package(side, fleet_mesh=True):
    """`tests/test_torch_balancer_front.py`'s package namespace with its
    balancer on an 8-shard fleet mesh (or, `fleet_mesh=False`, the
    single-device balancer)."""
    from test_torch_balancer_front import _jax_package, _port_package
    pkg = _jax_package() if side == "jax" else _port_package()
    make = pkg.make

    def make_mesh(provider, **kw):
        return make(provider, fleet_mesh=fleet_mesh, fleet_shards=N_SHARDS,
                    **kw)
    return types.SimpleNamespace(**{**vars(pkg), "make": make_mesh})


def _fleet_balancer(side, provider, **kw):
    """`tests/test_fleet_mesh.py`'s `_mk_balancer` for either package."""
    kw.setdefault("managed_fraction", 1.0)
    kw.setdefault("blackbox_fraction", 0.0)
    kw.setdefault("prewarm", False)
    kw.setdefault("initial_pad", 16)
    kw.setdefault("max_batch", 32)
    if side == "jax":
        from openwhisk_tpu.controller.loadbalancer import TpuBalancer
        from openwhisk_tpu.core.entity import ControllerInstanceId
        return TpuBalancer(provider, ControllerInstanceId("0"), kernel="xla",
                           calibrate_kernel="off", **kw)
    from openwhisk_tpu_torch.core.entity import ControllerInstanceId
    return TB.TpuBalancer(provider, ControllerInstanceId("0"), device=CPU,
                          **kw)


def _run(coro, timeout=90.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def test_fleet_mode_places_like_single_device_in_both_packages():
    """The same traffic through the JAX mesh balancer, the port's mesh
    balancer and the port's single-device balancer: identical placements
    and books."""
    async def go(side, fleet_mesh):
        bal = _fleet_balancer(side, entities(side).Provider(),
                              fleet_mesh=fleet_mesh, fleet_shards=N_SHARDS)
        if fleet_mesh:
            assert bal.kernel_resolved == "sharded"
            assert bal.n_shards == N_SHARDS and bal.fleet_axis == "fleet"
        else:
            assert bal.mesh is None and bal.n_shards == 1
        try:
            return await drive(side, bal)
        finally:
            await bal.close()

    ref = _run(go("jax", True))
    assert _run(go("port", True)) == ref
    assert _run(go("port", False)) == ref


@pytest.mark.parametrize("side", ["jax", "port"])
def test_env_knob_builds_the_mesh(side, monkeypatch):
    monkeypatch.setenv("CONFIG_whisk_loadBalancer_fleetMesh", "true")
    monkeypatch.setenv("CONFIG_whisk_loadBalancer_fleetShards",
                       str(N_SHARDS))
    bal = _fleet_balancer(side, entities(side).Provider())
    assert bal.n_shards == N_SHARDS and bal.fleet_axis == "fleet"
    assert bal._n_pad % N_SHARDS == 0
    asyncio.run(bal.close())


def test_growth_resharding_classifies_expected(monkeypatch):
    """Registrations past the pad re-pad and reshard mid-traffic: the
    profiler classifies every new signature as expected, with "reshard"
    among the reasons, and placement keeps working — as the JAX
    package's does."""
    monkeypatch.setenv("CONFIG_whisk_profiling_enabled", "true")

    async def go(side):
        E = entities(side).E
        bal = _fleet_balancer(side, entities(side).Provider(),
                              fleet_mesh=True, fleet_shards=N_SHARDS)
        d1, _ = await drive(side, bal, n_invokers=12, waves=1, per_wave=12)
        for i in range(12, 20):
            bal._status_change(E.InvokerInstanceId(i, user_memory=E.MB(2048)),
                               entities(side).HEALTHY)
        assert bal._n_pad == 32 and bal._n_pad % bal.n_shards == 0
        d2, books = await drive(side, bal, n_invokers=20, waves=1,
                                 per_wave=12, base=100)
        prof = bal.kernel_profile()
        await bal.close()
        return d1 + d2, books, prof

    ref = _run(go("jax"))
    got = _run(go("port"))
    assert got[:2] == ref[:2]
    prof = got[2]
    assert prof["compiles"]["unexpected"] == 0
    assert any(c["reason"] == "reshard" for c in prof["compiles"]["log"])
    assert prof["mesh"] == ref[2]["mesh"] == {"n_shards": N_SHARDS,
                                              "axis": "fleet"}


def test_occupancy_shards_block_and_gauges():
    """The occupancy plane aggregates per-shard books from the host cache:
    the shard rows sum to the fleet and equal the JAX package's; the
    supervision tick exports the shard count and per-shard ratios."""
    async def go(side):
        bal = _fleet_balancer(side, entities(side).Provider(),
                              fleet_mesh=True, fleet_shards=N_SHARDS)
        try:
            await drive(side, bal, waves=1)
            occ = bal.occupancy()
            bal._telemetry_tick()
            gauges = [bal.metrics.gauge_value(
                "loadbalancer_shard_occupancy_ratio", tags={"shard": str(s)})
                for s in range(N_SHARDS)]
            return (occ, bal.metrics.gauge_value("loadbalancer_fleet_shards"),
                    gauges, bal.OCCUPANCY_SYNCS_DEVICE)
        finally:
            await bal.close()

    occ, n_gauge, gauges, syncs = _run(go("port"))
    jocc, jn, jgauges, _ = _run(go("jax"))
    assert occ["mesh"] == jocc["mesh"] == {"n_shards": N_SHARDS,
                                           "axis": "fleet"}
    assert occ["shards"] == jocc["shards"] and len(occ["shards"]) == N_SHARDS
    assert sum(s["capacity_mb"] for s in occ["shards"]) == \
        occ["fleet"]["capacity_mb"]
    assert sum(s["used_mb"] for s in occ["shards"]) == \
        occ["fleet"]["used_mb"] > 0
    assert sum(s["invokers"] for s in occ["shards"]) == 12
    assert n_gauge == jn == N_SHARDS and gauges == jgauges
    assert None not in gauges and syncs is False


def test_snapshot_reshards_across_topologies():
    """Snapshots carry global books: a single-device snapshot restores
    onto the mesh and a mesh snapshot onto a single device, in both
    directions across the packages; `fleet_shards` is recorded."""
    async def go():
        single = _fleet_balancer("jax", entities("jax").Provider())
        await drive("jax", single, waves=1)
        snap1 = single.snapshot()
        books1 = books_of(single.state)
        await single.close()
        assert snap1["fleet_shards"] == 1

        meshy = _fleet_balancer("port", entities("port").Provider(),
                                fleet_mesh=True, fleet_shards=N_SHARDS)
        meshy.restore(snap1)
        for a, b in zip(books_of(meshy.state), books1):
            np.testing.assert_array_equal(a, b)
        await drive("port", meshy, waves=1, base=1000)
        snap2 = meshy.snapshot()
        books2 = books_of(meshy.state)
        await meshy.close()
        assert snap2["fleet_shards"] == N_SHARDS

        out = []
        for side in ("jax", "port"):
            back = _fleet_balancer(side, entities(side).Provider())
            back.restore(snap2)
            out.append(books_of(back.state))
            await back.close()
        jmesh = _fleet_balancer("jax", entities("jax").Provider(),
                                fleet_mesh=True, fleet_shards=N_SHARDS)
        jmesh.restore(snap2)
        out.append(books_of(jmesh.state))
        await jmesh.close()
        return books2, out

    books2, restored = _run(go())
    for got in restored:
        for a, b in zip(got, books2):
            np.testing.assert_array_equal(a, b)


def test_a_single_device_snapshot_with_a_small_pad_restores_onto_the_mesh():
    """The pad of a single-device snapshot the mesh cannot divide is
    rounded up, as the JAX package rounds it."""
    async def go(side):
        bal = _fleet_balancer(side, entities(side).Provider(),
                              initial_pad=4)
        await drive(side, bal, n_invokers=3, waves=1, per_wave=6)
        snap = bal.snapshot()
        await bal.close()
        assert snap["n_pad"] == 4
        meshy = _fleet_balancer(side, entities(side).Provider(),
                                fleet_mesh=True, fleet_shards=N_SHARDS)
        meshy.restore(snap)
        out = meshy._n_pad, books_of(meshy.state), snap
        await meshy.close()
        return out

    pad, books, snap = _run(go("port"))
    jpad, jbooks, _ = _run(go("jax"))
    assert pad == jpad == N_SHARDS
    for a, b in zip(books, jbooks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(books[0][:4], snap["free_mb"])


@pytest.mark.parametrize("rate", [None, 4], ids=["no_rate", "rate"])
@pytest.mark.parametrize("grow", [False, True], ids=["fixed", "grow"])
def test_front_scenario_on_the_mesh_matches_jax(rate, grow, monkeypatch):
    """The front's seeded scenario (pings, publish_many waves, a health
    flip through the FSM, acks, the trickle, growth, device rate
    admission) through the JAX mesh balancer, the port's mesh balancer
    and the port's single-device balancer: the same decision for every
    activation and the same books."""
    from test_torch_balancer_front import _scenario, run
    seed = 31 + (rate or 0) + 7 * grow
    pkgs = [_mesh_package("jax"), _mesh_package("port"),
            _mesh_package("port", fleet_mesh=False)]
    for pkg in pkgs:
        monkeypatch.setattr(pkg.E.ConcurrencyLimit, "MAX", 16)
    ref, port, single = (run(_scenario(p, rate, grow, seed), 120)
                         for p in pkgs)
    assert port["decisions"] == ref["decisions"] == single["decisions"]
    for k in ("throttled", "n", "slots", "active"):
        assert port[k] == ref[k] == single[k], k
    assert port["pad"] == ref["pad"]
    for k in ("free", "conc", "health"):
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
        n = single["pad"]
        np.testing.assert_array_equal(port[k][:n], single[k], err_msg=k)
        assert not port[k][n:].any()
    assert (port["throttled"] > 0) == (rate is not None)


# -- (d) the journal ------------------------------------------------------------
def _journal_mod(side):
    if side == "jax":
        from openwhisk_tpu.controller.loadbalancer import journal as J
    else:
        from openwhisk_tpu_torch.controller.loadbalancer import journal as J
    return J


async def _journal_some_traffic(side, bal, n_invokers=12, total=24):
    """`tests/test_journal.py`'s `TestMeshTopologyReplay` traffic."""
    x = entities(side)
    E = x.E

    async def fake_send(msg, invoker):
        return None

    bal.send_activation_to_invoker = fake_send
    for i in range(n_invokers):
        bal._status_change(E.InvokerInstanceId(i, user_memory=E.MB(2048)),
                           x.HEALTHY)
    ident = E.Identity.from_json({
        "subject": "guest", "namespace": {
            "name": "guest", "uuid": "23bc46b1-71f6-4ed5-8c54-816aa4f8c502"},
        "authkey": {"api_key": "23bc46b1-71f6-4ed5-8c54-816aa4f8c502:"
                               + "k" * 64},
        "rights": ["ACTIVATE"], "limits": {}})
    actions = []
    for i in range(4):
        a = E.ExecutableWhiskAction(
            E.EntityPath("guest"), E.EntityName(f"mt{i}"),
            E.CodeExec(kind="python:3", code="x"),
            limits=E.ActionLimits(E.TimeLimit(5000), E.MemoryLimit(
                E.MB([128, 256][i % 2]))))
        a.rev = E.DocRevision("1-b")
        actions.append(a)
    msgs = [x.Msg(x.Tx(f"t{k}", start_wallclock=1.0),
                  actions[k % 4].fully_qualified_name, "1-b", ident,
                  E.ActivationId(f"{k + 1:032x}"),
                  E.ControllerInstanceId("0"), False, {})
            for k in range(total)]
    await asyncio.gather(*[bal.publish(actions[k % 4], m)
                           for k, m in enumerate(msgs)])
    assert bal.journal.flush()


def _journaled_mesh_run(side, jdir):
    async def go():
        bal = _fleet_balancer(side, entities(side).Provider(),
                              fleet_mesh=True, fleet_shards=N_SHARDS)
        bal.attach_journal(_journal_mod(side).PlacementJournal(jdir))
        await _journal_some_traffic(side, bal)
        books, last = books_of(bal.state), bal._journal_seq
        await bal.close()
        bal.journal.close()
        return books, last
    return _run(go())


@pytest.fixture(scope="module")
def mesh_journals(tmp_path_factory):
    """Each package's 8-shard balancer journaling the same traffic:
    {side: (journal directory, live books, last seq)}."""
    out = {}
    for side in ("jax", "port"):
        jdir = str(tmp_path_factory.mktemp(f"mesh-{side}") / "wal")
        books, last = _journaled_mesh_run(side, jdir)
        out[side] = (jdir, books, last)
    return out


def _replay(side, jdir, **kw):
    """A fresh balancer of `side` (kw: its mesh) replays the journal in
    `jdir` from seq 0: (stats, books)."""
    async def go():
        bal = _fleet_balancer(side, entities(side).Provider(), **kw)
        j = _journal_mod(side).PlacementJournal(jdir)
        stats = bal.replay_journal(j.records(0))
        books = books_of(bal.state)
        await bal.close()
        j.close()
        return stats, books
    return _run(go())


def test_mesh_record_stamped_and_same_topology_replays_bit_exact(
        mesh_journals):
    jdir, live, last = mesh_journals["port"]
    recs = list(_journal_mod("port").PlacementJournal(jdir).records(0))
    assert recs[0]["t"] == "mesh"
    assert recs[0] == {"t": "mesh", "n_shards": N_SHARDS, "axis": "fleet",
                       "platform": "cpu", "seq": 1}
    assert all(r.get("S") == N_SHARDS for r in recs if r["t"] == "batch")
    stats, books = _replay("port", jdir, fleet_mesh=True,
                           fleet_shards=N_SHARDS)
    assert "skipped" not in stats and stats["batches"] >= 1
    assert stats["parity_mismatches"] == 0 and stats["last_seq"] == last
    for a, b in zip(books, live):
        np.testing.assert_array_equal(a, b)


def test_replay_on_different_device_count_cold_starts(mesh_journals):
    jdir, _live, last = mesh_journals["port"]
    stats, books = _replay("port", jdir)
    assert stats["skipped"] == "mesh_topology"
    assert stats["journal_shards"] == N_SHARDS
    assert stats["balancer_shards"] == 1
    assert stats["last_seq"] >= last
    free = books[0]
    assert int(free.sum()) == 0 and len(free) == 16


def test_single_device_tail_refused_on_mesh(tmp_path):
    """A single-device journal (no mesh records, no S) does not replay on
    a mesh balancer: its batch records imply one shard."""
    jdir = str(tmp_path / "wal")

    async def go():
        bal = _fleet_balancer("port", entities("port").Provider())
        bal.attach_journal(_journal_mod("port").PlacementJournal(jdir))
        await _journal_some_traffic("port", bal)
        await bal.close()
        bal.journal.close()
    _run(go())
    recs = list(_journal_mod("port").PlacementJournal(jdir).records(0))
    assert not any(r["t"] == "mesh" for r in recs)
    assert not any("S" in r for r in recs if r["t"] == "batch")
    stats, _books_ = _replay("port", jdir, fleet_mesh=True,
                             fleet_shards=N_SHARDS)
    assert stats["skipped"] == "mesh_topology"
    assert stats["journal_shards"] == 1
    assert stats["balancer_shards"] == N_SHARDS


def test_the_two_packages_write_byte_identical_mesh_journals(mesh_journals):
    (jdir_j, books_j, last_j), (jdir_p, books_p, last_p) = (
        mesh_journals["jax"], mesh_journals["port"])
    assert last_j == last_p
    names = sorted(os.listdir(jdir_j))
    assert names == sorted(os.listdir(jdir_p)) and names
    for name in names:
        with open(os.path.join(jdir_j, name), "rb") as a, \
                open(os.path.join(jdir_p, name), "rb") as b:
            assert a.read() == b.read(), name
    for a, b in zip(books_j, books_p):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer,replayer", [("jax", "port"),
                                             ("port", "jax")],
                         ids=["jax_journal_in_port", "port_journal_in_jax"])
def test_mesh_journals_replay_across_the_packages(mesh_journals, writer,
                                                  replayer):
    jdir, live, last = mesh_journals[writer]
    stats, books = _replay(replayer, jdir, fleet_mesh=True,
                           fleet_shards=N_SHARDS)
    assert "skipped" not in stats and stats["batches"] >= 1
    assert stats["parity_mismatches"] == 0 and stats["last_seq"] == last
    for a, b in zip(books, live):
        np.testing.assert_array_equal(a, b)


# -- (e) the quality plane's mesh shadow -------------------------------------------
@pytest.mark.parametrize("rate", [None, 4], ids=["no_rate", "rate"])
def test_mesh_shadow_and_scores_match_the_jax_plane(rate, monkeypatch):
    """The quality plane on a mesh balancer in both packages (a shadow
    every 2nd batch, stragglers injected into the anomaly scores): every
    kept shadow pass's decision vector, the decisions, the books and the
    plane's report equal the JAX plane's; the shadow runs the penalized
    sharded repair whatever pair production resolved."""
    from test_torch_balancer_front import _scenario, run
    from test_torch_quality import (QUALITY_ON, _inject, _quality_of,
                                    _same_report)
    for k, v in QUALITY_ON.items():
        monkeypatch.setenv(k, v)
    seed = 53 + (rate or 0)
    out = {}
    for side in ("jax", "port"):
        pkg = _mesh_package(side)
        monkeypatch.setattr(pkg.E.ConcurrencyLimit, "MAX", 16)
        kept = []

        def setup(bal, kept=kept):
            _inject(bal)
            real = bal._shadow_fn

            def shadow(*args, **kw):
                res = real(*args, **kw)
                kept.append(_np(res).copy())
                return res
            bal._shadow_fn = shadow

        res = run(_scenario(pkg, rate, False, seed, setup=setup,
                            inspect=_quality_of), 120)
        out[side] = (res, kept)
    (port, pk), (ref, jk) = out["port"], out["jax"]
    assert len(pk) == len(jk) > 0
    for a, b in zip(pk, jk):
        np.testing.assert_array_equal(a, b)
    assert port["decisions"] == ref["decisions"]
    for k in ("free", "conc", "health"):
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    (rep, raw), (jrep, jraw) = port["inspect"], ref["inspect"]
    for r in (rep, raw, jrep, jraw):
        r.pop("fleet_imbalance_cov")
        r.pop("last_batch", None)
    _same_report(rep, jrep)
    _same_report(raw, jraw)
    assert rep["shadow_batches"] > 0 and rep["divergent_rows"] > 0


# -- (f) the device rule ------------------------------------------------------------
class TestMeshTopologyHelpers:
    def test_mesh_topology_record(self, meshes):
        jm, tm = meshes
        assert TF.mesh_topology(tm) == {
            "n_shards": N_SHARDS, "axis": "fleet",
            "platform": jm.devices.flat[0].platform}
        assert TF.mesh_topology(None) == JF.mesh_topology(None) == {
            "n_shards": 1, "axis": None}

    def test_make_fleet_mesh_rejects_non_pow2(self):
        with pytest.raises(ValueError):
            TF.make_fleet_mesh(6, device=CPU)

    def test_make_fleet_mesh_default_pow2_floors(self):
        assert TF.mesh_shards(TF.make_fleet_mesh(None, device=CPU)) == 1
        assert TF.mesh_shards(TF.make_fleet_mesh(0, device=CPU)) == 1
        assert TF.mesh_shards(TF.make_fleet_mesh(4, device=CPU)) == 4


def test_cpu_shards_live_on_the_cpu_in_storage_of_their_own():
    """`device="cpu"`: every shard tensor on the CPU; each shard's conc
    is the [k, A] view of its own contiguous [A, k] storage, not a slice
    of the global book."""
    bal = _fleet_balancer("port", entities("port").Provider(),
                          fleet_mesh=True, fleet_shards=N_SHARDS)
    try:
        assert bal.device == torch.device(CPU)
        assert all(d == torch.device(CPU) for d in bal.mesh.devices)
        assert len(bal.state.shards) == N_SHARDS
        ptrs = set()
        for st in bal.state.shards:
            assert all(t.device.type == CPU for t in st)
            assert st.conc_free.T.is_contiguous()
            assert st.conc_free.shape == (16 // N_SHARDS, 4096)
            ptrs.add(st.conc_free.untyped_storage().data_ptr())
        assert len(ptrs) == N_SHARDS
    finally:
        asyncio.run(bal.close())


def test_no_device_means_the_card_and_nothing_falls_back():
    """`make_fleet_mesh` and the mesh balancer with no device run on the
    card(s); without one they raise instead of falling back to the
    CPU."""
    from openwhisk_tpu_torch.core.entity import ControllerInstanceId
    from openwhisk_tpu_torch.messaging import MemoryMessagingProvider
    if torch.cuda.is_available():
        mesh = TF.make_fleet_mesh(N_SHARDS)
        assert all(d.type == "cuda" for d in mesh.devices)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.make_fleet_mesh(N_SHARDS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.make_mesh(N_SHARDS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TB.TpuBalancer(MemoryMessagingProvider(), ControllerInstanceId("0"),
                       fleet_mesh=True, fleet_shards=N_SHARDS,
                       prewarm=False)


def test_shards_share_the_cards_in_order(monkeypatch):
    """Shard s goes on cuda:(s * count // S): with two cards, shards 0-3
    on the first and 4-7 on the second (device placement only; nothing
    is allocated)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = TF.make_fleet_mesh(N_SHARDS)
    assert [d.index for d in mesh.devices] == [0, 0, 0, 0, 1, 1, 1, 1]
    assert mesh.distinct == (torch.device("cuda", 0),
                             torch.device("cuda", 1))
    assert TF.mesh_topology(mesh)["platform"] == "gpu"
    assert TF.mesh_shards(TF.make_fleet_mesh(None)) == 2
