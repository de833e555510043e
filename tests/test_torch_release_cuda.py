"""The port's release-fold kernel (csrc/release_fold.cu) against its plain
versions, on a card.

Every test here needs a CUDA device and `nvcc` (the kernel builds from
openwhisk_tpu_torch/csrc at first use); without a card each test skips
with the reason printed. Run it on the card with

    python -m pytest --noconftest tests/test_torch_release_cuda.py -q

Comparisons are bit-exact: free and conc after the fold.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openwhisk_tpu_torch.ops import placement as T  # noqa: E402
from openwhisk_tpu_torch.ops import placement_cuda as K  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")


def release_case(n, a, r, rng, cells=None):
    """Books and R release rows: concurrency rows crowd `cells` (inv, slot)
    cells, so groups of one cell form, some of them heterogeneous (two
    actions on one slot with other need or max_conc); a quarter are memory
    rows, a fifth invalid."""
    free = rng.randint(0, 4096, n).astype(np.int32)
    conc = rng.randint(0, 6, (n, a)).astype(np.int32)
    cells = cells or max(1, r // 3)
    pool = np.stack([rng.randint(0, n, cells), rng.randint(0, a, cells)])
    pick = rng.randint(0, cells, r)
    inv, slot = pool[0, pick].astype(np.int32), pool[1, pick].astype(np.int32)
    need = rng.choice([128, 256, 512], r).astype(np.int32)
    maxc = rng.choice([1, 2, 3, 4, 8], r).astype(np.int32)
    maxc[rng.rand(r) < 0.25] = 1
    valid = rng.rand(r) > 0.2
    return (free, conc), (inv, slot, need, maxc, valid)


def _fold(fn, books, rows):
    free, conc = (torch.from_numpy(x.copy()).cuda() for x in books)
    st = T.PlacementState(free, conc, torch.ones_like(free, dtype=torch.bool))
    cols = [torch.from_numpy(c).cuda() for c in rows]
    fn(st, *cols)
    torch.cuda.synchronize()
    return st.free_mb.cpu().numpy(), st.conc_free.cpu().numpy()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("r", [1, 8, 31, 32, 256, 1500])
def test_release_kernel_matches_both_plain_folds(r, seed):
    rng = np.random.RandomState(100 * r + seed)
    n, a = [(64, 8), (1000, 64), (16384, 4096), (300, 2)][seed]
    books, rows = release_case(n, a, r, rng)
    got = _fold(K.release_batch_cuda, books, rows)
    for plain in (T.release_batch, T.release_batch_vector):
        want = _fold(plain, books, rows)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_release_kernel_one_cell_replays_in_batch_order():
    """Every row on one cell, max_conc alternating 2 and 3: the wraps
    depend on the order, which the leader keeps."""
    r = 300
    books = (np.full(4, 1000, np.int32), np.zeros((4, 2), np.int32))
    rows = (np.full(r, 2, np.int32), np.ones(r, np.int32),
            np.arange(r, dtype=np.int32) % 7 + 1,
            np.where(np.arange(r) % 2, 3, 2).astype(np.int32),
            np.ones(r, bool))
    got = _fold(K.release_batch_cuda, books, rows)
    want = _fold(T.release_batch, books, rows)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_release_kernel_counts_one_launch_a_fold():
    rng = np.random.RandomState(3)
    books, rows = release_case(64, 8, 16, rng)
    K.reset_launch_counts()
    _fold(K.release_batch_cuda, books, rows)
    assert K.release_batch_cuda.launches == 1
    with K.uncounted():
        _fold(K.release_batch_cuda, books, rows)
    assert K.release_batch_cuda.launches == 1
    empty = tuple(c[:0] for c in rows)
    _fold(K.release_batch_cuda, books, empty)
    assert K.release_batch_cuda.launches == 1


def test_release_kernel_refuses_what_it_does_not_take():
    rng = np.random.RandomState(4)
    books, rows = release_case(64, 8, 8, rng)
    free, conc = (torch.from_numpy(x.copy()).cuda() for x in books)
    st = T.PlacementState(free, conc, torch.ones_like(free, dtype=torch.bool))
    cols = [torch.from_numpy(c).cuda() for c in rows]
    with pytest.raises(ValueError):
        K.release_batch_cuda(st, cols[0].long(), *cols[1:])
    with pytest.raises(ValueError):
        K.release_batch_cuda(st, *cols[:4], cols[4].int())
    with pytest.raises(ValueError):
        K.release_batch_cuda(st, *(c.cpu() for c in cols))


def _dropped(books, rows):
    """The rows as the plain folds can take them: a row outside the books
    (inv not in [0, N), or a concurrency row's slot not in [0, A)) made
    invalid, its indices clamped into range. The kernel drops such rows;
    the plain folds would index outside the books."""
    n, a = books[1].shape
    inv, slot, need, maxc, valid = rows
    out = ((inv < 0) | (inv >= n)
           | ((maxc > 1) & ((slot < 0) | (slot >= a))))
    return (np.clip(inv, 0, n - 1).astype(np.int32),
            np.clip(slot, 0, a - 1).astype(np.int32), need, maxc,
            valid & ~out)


def _one_cell(r, maxc):
    return (np.full(r, 3, np.int32), np.full(r, 1, np.int32),
            np.full(r, 256, np.int32), np.full(r, maxc, np.int32),
            np.ones(r, bool))


def _interleaved(r, maxc):
    """Four cells taken in turn; two of them heterogeneous (need or
    max_conc alternate on the cell), two homogeneous."""
    k = np.arange(r)
    cell = k % 4
    need = np.where((cell == 0) & (k // 4 % 2 == 1), 512, 256)
    mc = np.where((cell == 1) & (k // 4 % 2 == 1), maxc + 1, maxc)
    return ((cell % 2).astype(np.int32), (cell // 2).astype(np.int32),
            need.astype(np.int32), mc.astype(np.int32), np.ones(r, bool))


def _every_cell(r, maxc):
    k = np.arange(r)
    return ((k % 61).astype(np.int32), (k // 61).astype(np.int32),
            np.full(r, 128, np.int32), np.full(r, maxc, np.int32),
            np.ones(r, bool))


def _out_of_books(r, maxc):
    """Rows outside the books (inv < 0, inv >= N, slot < 0, slot >= A) and
    invalid rows among valid ones; memory rows with a slot out of range
    still return their memory."""
    rng = np.random.RandomState(r + maxc)
    inv = rng.randint(-3, 64, r).astype(np.int32)
    slot = rng.randint(-2, 34, r).astype(np.int32)
    mc = np.where(rng.rand(r) < 0.3, 1, maxc).astype(np.int32)
    return (inv, slot, rng.choice([128, 256], r).astype(np.int32), mc,
            rng.rand(r) > 0.3)


SHAPES = {"one_cell": _one_cell, "interleaved": _interleaved,
          "every_cell": _every_cell, "out_of_books": _out_of_books}


@pytest.mark.parametrize("maxc", [2, 16])
@pytest.mark.parametrize("r", [8, 256, 1024, 1500])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_release_kernel_segments_match_both_plain_folds(shape, r, maxc):
    """The sort's segments against both plain folds: one cell for all R
    rows (across the 1,024-row chunk at R = 1,500), four interleaved
    cells (two heterogeneous), every row on its own cell, and rows outside
    the books or invalid, at max_conc 2 and 16. Books start below and
    above max_conc and negative, so wraps clip at both ends."""
    n, a = 61, 32
    rng = np.random.RandomState(r * maxc)
    books = (rng.randint(0, 4096, n).astype(np.int32),
             rng.randint(-2, 2 * maxc, (n, a)).astype(np.int32))
    rows = SHAPES[shape](r, maxc)
    got = _fold(K.release_batch_cuda, books, rows)
    for plain in (T.release_batch, T.release_batch_vector):
        want = _fold(plain, books, _dropped(books, rows))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_release_kernel_transposed_books_and_the_launch_floor():
    """A mesh shard's books (conc the [k, A] view of a contiguous [A, k])
    fold like the standard layout; the empty launch counts nothing."""
    rng = np.random.RandomState(9)
    books, rows = release_case(512, 16, 300, rng)
    want = _fold(T.release_batch_vector, books, rows)
    free = torch.from_numpy(books[0].copy()).cuda()
    conc = torch.from_numpy(books[1].T.copy()).cuda().T
    st = T.PlacementState(free, conc, torch.ones_like(free, dtype=torch.bool))
    K.reset_launch_counts()
    K.release_batch_cuda(st, *(torch.from_numpy(c).cuda() for c in rows))
    K.empty_launch_cuda()
    torch.cuda.synchronize()
    assert K.release_batch_cuda.launches == 1
    np.testing.assert_array_equal(st.free_mb.cpu().numpy(), want[0])
    np.testing.assert_array_equal(st.conc_free.cpu().numpy(), want[1])
