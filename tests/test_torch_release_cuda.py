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
