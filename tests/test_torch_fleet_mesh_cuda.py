"""The fleet mesh on a card, against the single-device CUDA kernels.

Every test here needs a CUDA device and `nvcc` (the single-device kernels
build from openwhisk_tpu_torch/csrc at first use); without a card each
test skips with the reason printed. Run it on the card with

    python -m pytest --noconftest tests/test_torch_fleet_mesh_cuda.py -q

Every shard of an 8-shard mesh sits on the card. The sharded scan, the
sharded repair (plain and penalized) and the owner-masked release vector
equal the single-device CUDA kernels (and the plain release vector) bit
for bit — decisions, forced flags, rounds and books — and launch no
placement kernel. Both families' release folds launch the release kernel
once a shard, with no host sync, and fold like the single-device kernel. A mesh balancer on the card places like the
single-device card balancer, and its journal replays on the CPU mesh.
"""
import asyncio
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openwhisk_tpu_torch.controller.loadbalancer import \
    journal as JN  # noqa: E402
from openwhisk_tpu_torch.controller.loadbalancer import \
    tpu_balancer as TB  # noqa: E402
from openwhisk_tpu_torch.ops import placement as T  # noqa: E402
from openwhisk_tpu_torch.ops import placement_cuda as K  # noqa: E402
from openwhisk_tpu_torch.parallel import fleet_mesh as FM  # noqa: E402
from openwhisk_tpu_torch.parallel import sharded_state as SS  # noqa: E402
from torch_mesh_cases import drive, entities  # noqa: E402
from torch_placement_cases import random_batch, random_books  # noqa: E402

pytestmark = pytest.mark.cuda

S = 8


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")


def _clone(st):
    return T.PlacementState(st.free_mb.clone(), st.conc_free.T.clone().T,
                            st.health.clone())


def _equal(single, sharded):
    g = SS.gather_state(sharded)
    return all(torch.equal(x, y) for x, y in zip(single, g))


@pytest.mark.parametrize("b", [16, 256])
@pytest.mark.parametrize("kind", ["scan", "repair", "repair_penalized"])
def test_sharded_ops_equal_the_kernels(kind, b):
    rng = np.random.RandomState(b)
    n = 4096
    books = T.placement_state_from_numpy(*random_books(n, rng),
                                         device="cuda")
    batch = T.request_batch_from_numpy(*random_batch(n, b, rng),
                                       device="cuda")
    pen = (torch.from_numpy(rng.randint(0, 3, n).astype(np.int32)).cuda()
           if kind == "repair_penalized" else None)
    mesh = FM.make_fleet_mesh(S)
    single, sharded = _clone(books), SS.shard_state(books, mesh)
    kern = (K.schedule_batch_cuda if kind == "scan"
            else K.schedule_batch_repair_cuda)
    kout = kern(K.to_transposed(single), batch, pen)
    K.reset_launch_counts()
    if kind == "scan":
        mout = SS.make_sharded_schedule(mesh)(sharded, batch)
    elif pen is None:
        mout = FM.make_fleet_repair_schedule(mesh)(sharded, batch)
    else:
        mout = FM.make_fleet_repair_schedule(mesh, penalized=True)(
            sharded, batch, pen)
    torch.cuda.synchronize()
    assert K.schedule_batch_cuda.launches == 0
    assert K.schedule_batch_repair_cuda.launches == 0
    assert torch.equal(kout[1], mout[1]) and torch.equal(kout[2], mout[2])
    if kind != "scan":
        assert int(kout[3]) == int(mout[3])
    assert _equal(single, sharded)
    ok = (kout[1] >= 0) & (batch.conc_slot < books.conc_free.shape[1])
    rel = (kout[1].clamp_min(0),
           batch.conc_slot.clamp_max(books.conc_free.shape[1] - 1),
           batch.need_mb, batch.max_conc, ok)
    T.release_batch_vector(single, *rel)
    FM.make_fleet_release_vector(mesh)(sharded, *rel)
    assert _equal(single, sharded)


@pytest.mark.parametrize("r", [8, 256, 1500])
@pytest.mark.parametrize("family", ["scan", "repair"])
def test_mesh_release_folds_launch_the_kernel_once_a_shard(family, r):
    """Each family's mesh fold on card books: one release launch a shard,
    no host sync, books equal to the single-device kernel's on the same
    rows (cells crowded, some heterogeneous, a fifth invalid)."""
    rng = np.random.RandomState(r)
    n = 4096
    books = T.placement_state_from_numpy(*random_books(n, rng),
                                         device="cuda")
    a = books.conc_free.shape[1]
    cells = max(1, r // 3)
    pool = np.stack([rng.randint(0, n, cells), rng.randint(0, a, cells)])
    pick = rng.randint(0, cells, r)
    maxc = rng.choice([1, 2, 3, 4, 8], r)
    rows = [torch.from_numpy(c.astype(np.int32)).cuda() for c in (
        pool[0, pick], pool[1, pick], rng.choice([128, 256, 512], r), maxc)]
    rows.append(torch.from_numpy(rng.rand(r) > 0.2).cuda())
    mesh = FM.make_fleet_mesh(S)
    single, sharded = _clone(books), SS.shard_state(books, mesh)
    K.release_batch_cuda(single, *rows)
    fold = (SS.make_sharded_release(mesh) if family == "scan"
            else FM.make_fleet_release_vector(mesh))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fold(sharded, *rows)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert K.release_batch_cuda.launches == S
    assert _equal(single, sharded)


def test_mesh_balancer_on_the_card_places_like_the_single_device():
    async def go(jdir=None, **kw):
        x = entities("port")
        bal = TB.TpuBalancer(x.Provider(), x.E.ControllerInstanceId("0"),
                             managed_fraction=1.0, blackbox_fraction=0.0,
                             initial_pad=16, max_batch=32, **kw)
        bal._await_kernels()
        if jdir is not None:
            bal.attach_journal(JN.PlacementJournal(jdir))
        K.reset_launch_counts()
        try:
            placed, books = await drive("port", bal)
        finally:
            await bal.close()
        launches = (K.schedule_batch_cuda.launches
                    + K.schedule_batch_repair_cuda.launches)
        if bal.journal is not None:
            bal.journal.close()
        return placed, books, launches

    ref, ref_books, ref_launches = asyncio.run(go())
    with tempfile.TemporaryDirectory() as d:
        got, books, launches = asyncio.run(go(d, fleet_mesh=True,
                                              fleet_shards=S))

        async def replay():
            x = entities("port")
            cpu = TB.TpuBalancer(x.Provider(), x.E.ControllerInstanceId("1"),
                                 managed_fraction=1.0, blackbox_fraction=0.0,
                                 initial_pad=16, max_batch=32, device="cpu",
                                 fleet_mesh=True, fleet_shards=S)
            stats = cpu.replay_journal(JN.PlacementJournal(d).records(0))
            free = cpu.state.free_mb.tolist()
            await cpu.close()
            return stats, free

        stats, cpu_books = asyncio.run(replay())
    assert got == ref and books == ref_books
    assert ref_launches > 0 and launches == 0
    assert stats["parity_mismatches"] == 0 and "skipped" not in stats
    assert cpu_books == books
