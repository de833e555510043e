"""The port's plain placement ops against the JAX package, bit for bit.

The same numpy-seeded books and batches go through the JAX reference
(`openwhisk_tpu.ops.placement`) and the port's plain torch version
(`openwhisk_tpu_torch.ops.placement`) on the CPU; decisions, forced flags,
repair round counts and books must be EXACTLY equal (integer arithmetic,
no tolerance).
"""
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from openwhisk_tpu.controller.loadbalancer.tpu_balancer import \
    _xla_pair  # noqa: E402
from openwhisk_tpu.ops import placement as J  # noqa: E402
from openwhisk_tpu_torch.controller.loadbalancer.tpu_balancer import \
    _torch_pair  # noqa: E402
from openwhisk_tpu_torch.ops import placement as T  # noqa: E402
from openwhisk_tpu_torch.ops import placement_cuda as K  # noqa: E402
from torch_placement_cases import (  # noqa: E402
    FAMILIES, SLOTS, random_batch, random_books)


def run_both(jax_fn, torch_fn, books, cols, penalty=None):
    """(jax outputs, torch outputs) as numpy: free, conc, chosen, forced
    [, rounds]."""
    free, conc, health = books
    js = J.PlacementState(jnp.asarray(free), jnp.asarray(conc),
                          jnp.asarray(health))
    jb = J.RequestBatch(*[jnp.asarray(c) for c in cols])
    jo = jax_fn(js, jb, None if penalty is None else jnp.asarray(penalty))
    ts = T.placement_state_from_numpy(free, conc, health, "cpu")
    tb = T.request_batch_from_numpy(*cols, device="cpu")
    to = torch_fn(ts, tb, None if penalty is None
                  else torch.from_numpy(penalty))
    j = [np.asarray(jo[0].free_mb), np.asarray(jo[0].conc_free)] + \
        [np.asarray(x) for x in jo[1:]]
    t = [to[0].free_mb.numpy(), to[0].conc_free.numpy()] + \
        [x.numpy() for x in to[1:]]
    return j, t


def assert_same(j, t):
    assert len(j) == len(t)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


SCHEDULES = {"scan": (J.schedule_batch, T.schedule_batch),
             "repair": (J.schedule_batch_repair, T.schedule_batch_repair)}


@pytest.mark.parametrize("kind", ["scan", "repair"])
@pytest.mark.parametrize("use_penalty", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_schedule_fuzz_matches_jax(kind, use_penalty, seed):
    """Random fleets and batches (mixed partitions, unhealthy rows, shared
    and out-of-range slots, container actions), chained over two steps."""
    rng = np.random.RandomState(seed)
    n = int(rng.choice([16, 64, 256]))
    b = int(rng.choice([8, 32, 64]))
    books = random_books(n, rng, mem=int(rng.choice([512, 1024])))
    pen = rng.randint(0, 3, n).astype(np.int32) if use_penalty else None
    jf, tf = SCHEDULES[kind]
    for _ in range(2):
        cols = random_batch(n, b, rng, oob_p=0.15)
        j, t = run_both(jf, tf, books, cols, pen)
        assert_same(j, t)
        books = (j[0], j[1], books[2])
    if kind == "repair":
        assert int(t[4]) >= 1


@pytest.mark.parametrize("kind", ["scan", "repair"])
@pytest.mark.parametrize("use_penalty", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_schedule_families_match_jax(kind, use_penalty, family):
    rng = np.random.RandomState(42)
    books, cols = FAMILIES[family](rng)
    n = books[0].shape[0]
    pen = rng.randint(0, 3, n).astype(np.int32) if use_penalty else None
    jf, tf = SCHEDULES[kind]
    j, t = run_both(jf, tf, books, cols, pen)
    assert_same(j, t)
    if family == "forced_overload":
        assert t[3].any()
    if family == "no_usable":
        assert (t[2] == -1).all()
        if kind == "repair":
            assert int(t[4]) == 1


@pytest.mark.parametrize("kind", ["scan", "repair"])
def test_64k_fleet_row_matches_jax(kind):
    """Partition sizes past ~46k overflow a naive int32 rank product: the
    split `_mulmod` must agree with the JAX one on a 65,536-invoker fleet."""
    rng = np.random.RandomState(3)
    n = 65536
    books = random_books(n, rng, mem=2048, slots=4, unhealthy_p=0.05)
    cols = random_batch(n, 8, rng, slots=4)
    cols[2] = np.asarray(rng.randint(n // 2, n, 8) % cols[1], np.int32)
    jf, tf = SCHEDULES[kind]
    j, t = run_both(jf, tf, books, cols)
    assert_same(j, t)


def test_mulmod_matches_jax_at_large_partitions():
    rng = np.random.RandomState(0)
    m = rng.randint(46_000, 1 << 17, 4096).astype(np.int32)
    a = rng.randint(-(1 << 17), 1 << 17, 4096).astype(np.int32)
    b = (rng.randint(0, 1 << 17, 4096) % m).astype(np.int32)
    want = np.asarray(J._mulmod(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(m)))
    got = T._mulmod(torch.from_numpy(a), torch.from_numpy(b),
                    torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(want, got)
    ref = (np.mod(a.astype(np.int64), m) * b) % m
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", range(4))
def test_flat_and_pairwise_prims_agree(seed):
    rng = np.random.RandomState(seed)
    b, size = 32, 8
    flat, pair = T.flat_prims(b, "cpu"), T.pairwise_prims(b, "cpu")
    flag = torch.from_numpy(rng.rand(b) < 0.5)
    key = torch.from_numpy(rng.randint(0, size, b).astype(np.int32))
    vals = torch.from_numpy(rng.randint(0, 100, b).astype(np.int32))
    for name in ("first_index_where", "any_same_key"):
        assert torch.equal(getattr(flat, name)(flag, key, size),
                           getattr(pair, name)(flag, key, size)), name
    assert torch.equal(flat.segment_exclusive_sum(vals, key),
                       pair.segment_exclusive_sum(vals, key))
    for name in ("exclusive_cumsum", "exclusive_cummax"):
        assert torch.equal(getattr(flat, name)(vals),
                           getattr(pair, name)(vals)), name
    assert int(flat.min_index_where(flag)) == int(pair.min_index_where(flag))


@pytest.mark.parametrize("seed", range(6))
def test_commit_masks_flat_raw_equals_pairwise_clamped(seed):
    """The rules over flat prims with raw (possibly out-of-range) slots
    equal the rules over pairwise prims with clamped slots plus `slot_ok`
    — the form the CUDA repair kernel evaluates."""
    rng = np.random.RandomState(seed)
    b, n, a = 32, 8, 4
    t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    placed = rng.rand(b) < 0.8
    use_conc = placed & (rng.rand(b) < 0.3)
    slot = rng.randint(0, a + 2, b).astype(np.int32)
    kw = dict(pending=t(rng.rand(b) < 0.8), placed=t(placed),
              forced=t(placed & (rng.rand(b) < 0.2)),
              sel=t(rng.randint(0, n, b).astype(np.int32)),
              take_mem=t(placed & ~use_conc), use_conc=t(use_conc),
              simple=t(rng.rand(b) < 0.6),
              need_mb=t(rng.choice([128, 256], b).astype(np.int32)),
              free_at_sel=t(rng.randint(0, 1024, b).astype(np.int32)),
              col_conc=t(rng.rand(b) < 0.3), n=n, a_slots=a)
    flat = T.repair_commit_masks(T.flat_prims(b, "cpu"), conc_slot=t(slot),
                                 **kw)
    pair = T.repair_commit_masks(
        T.pairwise_prims(b, "cpu"), conc_slot=t(np.clip(slot, 0, a - 1)),
        slot_ok=t(slot < a), **kw)
    for x, y in zip(flat, pair):
        assert torch.equal(x, y)


RELEASES = {"scan": (J.release_batch, T.release_batch),
            "vector": (J.release_batch_vector, T.release_batch_vector)}


def _release_both(kind, books, rel):
    free, conc, health = books
    jf, tf = RELEASES[kind]
    js = jf(J.PlacementState(jnp.asarray(free), jnp.asarray(conc),
                             jnp.asarray(health)),
            *[jnp.asarray(x) for x in rel])
    ts = tf(T.placement_state_from_numpy(free, conc, health, "cpu"),
            *[torch.from_numpy(np.asarray(x)) for x in rel])
    np.testing.assert_array_equal(np.asarray(js.free_mb), ts.free_mb.numpy())
    np.testing.assert_array_equal(np.asarray(js.conc_free),
                                  ts.conc_free.numpy())


@pytest.mark.parametrize("kind", ["scan", "vector"])
@pytest.mark.parametrize("seed", range(4))
def test_release_fuzz_matches_jax(kind, seed):
    rng = np.random.RandomState(seed)
    n = int(rng.choice([4, 16, 64]))
    r = int(rng.choice([8, 32, 64]))
    books = random_books(n, rng, conc_p=0.5)
    rel = (rng.randint(0, n, r).astype(np.int32),
           rng.randint(0, SLOTS, r).astype(np.int32),
           rng.choice([128, 256], r).astype(np.int32),
           rng.choice([1, 4, 4, 6], r).astype(np.int32),
           rng.rand(r) < 0.9)
    _release_both(kind, books, rel)


@pytest.mark.parametrize("kind", ["scan", "vector"])
def test_release_heterogeneous_group_replays_every_row(kind):
    """Two actions conflated on one slot of one invoker: the whole group
    replays row by row, in batch order."""
    conc = np.zeros((2, 4), np.int32)
    conc[0, 1] = 2
    books = (np.full(2, 4096, np.int32), conc, np.ones(2, bool))
    rel = (np.zeros(3, np.int32), np.ones(3, np.int32),
           np.array([256, 512, 256], np.int32), np.array([3, 4, 3], np.int32),
           np.ones(3, bool))
    _release_both(kind, books, rel)


def _packed_buf(rng, n, r, h, b):
    """A packed rel[5,R] ++ health[3,H] ++ req[9,B] buffer with real
    releases and health flips (padded health rows repeat the last flip)."""
    rel = np.zeros((5, r), np.int32)
    k = r // 2
    rel[0, :k] = rng.randint(0, n, k)
    rel[1, :k] = rng.randint(0, SLOTS, k)
    rel[2, :k] = rng.choice([128, 256], k)
    rel[3] = 1
    rel[3, :k] = rng.choice([1, 4], k)
    rel[4, :k] = 1
    health = np.zeros((3, h), np.int32)
    flips = rng.choice(n, 3, replace=False)
    health[0] = list(flips) + [flips[-1]] * (h - 3)
    health[1] = list(rng.randint(0, 2, 3)) + [0] * (h - 3)
    health[1, 3:] = health[1, 2]
    health[2] = 1
    req = np.stack([np.asarray(c, np.int32)
                    for c in random_batch(n, b, rng)])
    return np.concatenate([rel.ravel(), health.ravel(), req.ravel()])


@pytest.mark.parametrize("kernel", ["scan", "repair", "auto"])
def test_fused_packed_step_matches_jax(kernel):
    """Chained packed steps at two bucket widths (below and above the
    auto threshold): the port's `_torch_pair` against the JAX `_xla_pair`
    over the same buffers, decisions, rounds and books."""
    rng = np.random.RandomState(11)
    n = 64
    free, conc, health = random_books(n, rng, conc_p=0.5)
    js = J.PlacementState(jnp.asarray(free), jnp.asarray(conc),
                          jnp.asarray(health))
    ts = T.placement_state_from_numpy(free, conc, health, "cpu")
    jfn = J.make_fused_step_packed(*_xla_pair(kernel)[1::-1])
    tfn = T.make_fused_step_packed(*_torch_pair(kernel)[1::-1])
    for b in (16, 32, 16):
        buf = _packed_buf(rng, n, b, 8, b)
        js, jout = jfn(js, jnp.asarray(buf), b, 8, b)
        ts, tout = tfn(ts, torch.from_numpy(buf.copy()), b, 8, b)
        np.testing.assert_array_equal(np.asarray(jout), tout.numpy())
        for x, y in ((js.free_mb, ts.free_mb), (js.conc_free, ts.conc_free),
                     (js.health, ts.health)):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    j = J.unpack_step_output(np.asarray(jout))
    t = T.unpack_step_output(tout.numpy())
    for x, y in zip(j[:3], t[:3]):
        np.testing.assert_array_equal(x, y)
    assert j[3] == t[3]


def test_cuda_wrappers_take_plain_version_on_cpu_tensors():
    """On CPU tensors the kernel wrappers run the plain version (kernel
    layout in and out) and count no launch."""
    rng = np.random.RandomState(5)
    books = random_books(32, rng)
    cols = random_batch(32, 16, rng)
    K.reset_launch_counts()
    for kind, wrapper in (("scan", K.schedule_batch_cuda),
                          ("repair", K.schedule_batch_repair_cuda)):
        ts = T.placement_state_from_numpy(*books, device="cpu")
        out = wrapper(K.to_transposed(ts), T.request_batch_from_numpy(
            *cols, device="cpu"))
        ps = T.placement_state_from_numpy(*books, device="cpu")
        ref = SCHEDULES[kind][1](ps, T.request_batch_from_numpy(
            *cols, device="cpu"))
        assert torch.equal(out[0].conc_free.T, ref[0].conc_free)
        for x, y in zip(out[1:], ref[1:]):
            assert torch.equal(x, y)
    assert K.schedule_batch_cuda.launches == 0
    assert K.schedule_batch_repair_cuda.launches == 0


def test_repair_fit_predicate():
    assert K.fits_smem_repair(1) and K.fits_smem_repair(1024)
    assert not K.fits_smem_repair(0) and not K.fits_smem_repair(1025)


def test_port_imports_no_jax():
    """Importing every port module leaves `jax` and `openwhisk_tpu` out of
    sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import openwhisk_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax'\n"
        "             or k.startswith(('jax.', 'openwhisk_tpu.'))\n"
        "             or k == 'openwhisk_tpu')\n"
        "assert 'openwhisk_tpu_torch.controller.loadbalancer.tpu_balancer'"
        " in sys.modules\n"
        "print('BAD', bad)\n")
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
