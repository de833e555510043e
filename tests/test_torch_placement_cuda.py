"""The port's CUDA placement kernels against their plain versions, on a card.

Every test here needs a CUDA device and `nvcc` (the kernels build from
openwhisk_tpu_torch/csrc at first use); without a card the whole file is
skipped with the reason printed. Run it on the card with

    python -m pytest tests/test_torch_placement_cuda.py -q

Comparisons are bit-exact: chosen, forced, rounds, free and conc.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openwhisk_tpu_torch.controller.loadbalancer import \
    tpu_balancer as TB  # noqa: E402
from openwhisk_tpu_torch.ops import placement as T  # noqa: E402
from openwhisk_tpu_torch.ops import placement_cuda as K  # noqa: E402
from torch_placement_cases import (  # noqa: E402
    FAMILIES, container_case, random_batch, random_books)

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")


def _both(kind, books, cols, penalty):
    """(kernel result, plain result) on the card from the same inputs."""
    dev = "cuda"
    ks = T.placement_state_from_numpy(*books, device=dev)
    ps = T.placement_state_from_numpy(*books, device=dev)
    batch = T.request_batch_from_numpy(*cols, device=dev)
    pen = None if penalty is None else torch.from_numpy(penalty).to(dev)
    if kind == "scan":
        k = K.schedule_batch_cuda(K.to_transposed(ks), batch, pen)
        p = T.schedule_batch(ps, batch, pen)
    else:
        k = K.schedule_batch_repair_cuda(K.to_transposed(ks), batch, pen)
        p = T.schedule_batch_repair(ps, batch, pen)
    torch.cuda.synchronize()
    return (ks, k), (ps, p)


def _assert_exact(kr, pr):
    (ks, k), (ps, p) = kr, pr
    assert torch.equal(ks.free_mb, ps.free_mb)
    assert torch.equal(ks.conc_free, ps.conc_free)
    for x, y in zip(k[1:], p[1:]):
        assert torch.equal(x.reshape(-1), y.reshape(-1))


@pytest.mark.parametrize("kind", ["scan", "repair"])
@pytest.mark.parametrize("use_penalty", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_kernel_fuzz_matches_plain(kind, use_penalty, seed):
    rng = np.random.RandomState(seed)
    n = int(rng.choice([16, 256, 5000]))
    b = int(rng.choice([8, 32, 256]))
    books = random_books(n, rng)
    cols = random_batch(n, b, rng, oob_p=0.15)
    pen = rng.randint(0, 3, n).astype(np.int32) if use_penalty else None
    _assert_exact(*_both(kind, books, cols, pen))


@pytest.mark.parametrize("kind", ["scan", "repair"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_kernel_families_match_plain(kind, family):
    books, cols = FAMILIES[family](np.random.RandomState(42))
    _assert_exact(*_both(kind, books, cols, None))


def test_launch_counts_and_repair_batch_limit():
    rng = np.random.RandomState(0)
    books = random_books(64, rng)
    K.reset_launch_counts()
    _both("scan", books, random_batch(64, 8, rng), None)
    _both("repair", books, random_batch(64, 8, rng), None)
    assert K.schedule_batch_cuda.launches == 1
    assert K.schedule_batch_repair_cuda.launches == 1
    st = T.placement_state_from_numpy(*books, device="cuda")
    big = T.request_batch_from_numpy(*random_batch(64, 1025, rng),
                                     device="cuda")
    with pytest.raises(ValueError):
        K.schedule_batch_repair_cuda(K.to_transposed(st), big)


@pytest.mark.parametrize("use_penalty", [False, True])
@pytest.mark.parametrize("b", [32, 256, 1024])
def test_repair_container_traffic_matches_plain(b, use_penalty):
    """Container-opening rows on few slots: many rounds, each probing only
    the rows still pending."""
    rng = np.random.RandomState(b)
    books, cols = container_case(4999, b, rng)
    pen = rng.randint(0, 4, 4999).astype(np.int32) if use_penalty else None
    kr, pr = _both("repair", books, cols, pen)
    _assert_exact(kr, pr)
    assert int(kr[1][3]) > 2


def _set_window(cols, i, off, size, rng, maxc=None):
    """Row i of the nine batch columns gets the window [off, off + size)."""
    st = 1
    for cand in rng.permutation(np.arange(1, size + 1)):
        if np.gcd(int(cand), size) == 1:
            st = int(cand)
            break
    cols[0][i], cols[1][i] = off, size
    cols[2][i] = rng.randint(0, size)
    cols[3][i] = pow(st, -1, size) if size > 1 else 0
    cols[7][i] = rng.randint(0, size)
    cols[8][i] = True
    if maxc is not None:
        cols[6][i] = maxc


@pytest.mark.parametrize("use_penalty", [False, True])
@pytest.mark.parametrize("n", [1000, 4133])
def test_repair_window_edges_match_plain(n, use_penalty):
    """Fleets that are not a multiple of the kernel's 256-invoker work item,
    windows of width 1, at the fleet's end, and one with no healthy invoker
    whose forced choice (index 0) meets an earlier container-opener there."""
    rng = np.random.RandomState(n)
    books = random_books(n, rng, slots=16, unhealthy_p=0.1)
    cols = random_batch(n, 64, rng, maxc_choices=(1, 1, 4))
    _set_window(cols, 0, 0, 1, rng, maxc=4)     # opens a container on 0
    _set_window(cols, 1, n - 300, 300, rng)     # ends with the fleet
    _set_window(cols, 2, n - 1, 1, rng)         # the last invoker alone
    _set_window(cols, 3, n // 3, 77, rng)       # nothing healthy in it
    _set_window(cols, 4, rng.randint(1, n - 1), 1, rng)
    cols[3][5] = cols[1][5] + 7                 # a step past the window
    health = books[2].copy()
    health[0] = True
    health[n // 3:n // 3 + 77] = False
    books = (books[0], books[1], health)
    pen = rng.randint(0, 4, n).astype(np.int32) if use_penalty else None
    kr, pr = _both("repair", books, cols, pen)
    _assert_exact(kr, pr)
    assert int(kr[1][1][3]) == -1


def test_repair_partition_past_2_17_matches_plain():
    """Windows wider than 2^17 invokers: the kernel computes every rank
    with the split mulmod instead of stepping it."""
    rng = np.random.RandomState(17)
    n = (1 << 17) + 3000
    books = random_books(n, rng, mem=2048, slots=4, unhealthy_p=0.05)
    cols = random_batch(n, 8, rng, slots=4)
    cols[0][:4], cols[1][:4] = 0, n
    kr, pr = _both("repair", books, cols, None)
    _assert_exact(kr, pr)


def test_repair_launch_is_deterministic():
    """The same inputs twice: the atomics' order leaves no trace."""
    rng = np.random.RandomState(5)
    books, cols = container_case(4999, 1024, rng)
    (ks1, k1), _ = _both("repair", books, cols, None)
    (ks2, k2), _ = _both("repair", books, cols, None)
    assert torch.equal(ks1.free_mb, ks2.free_mb)
    assert torch.equal(ks1.conc_free, ks2.conc_free)
    for x, y in zip(k1[1:], k2[1:]):
        assert torch.equal(x, y)


def test_repair_runs_on_every_sm():
    rng = np.random.RandomState(1)
    books = random_books(512, rng)
    _both("repair", books, random_batch(512, 32, rng), None)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert K.schedule_batch_repair_cuda.grid["blocks"] >= sms


@pytest.mark.parametrize("use_penalty", [False, True])
@pytest.mark.parametrize("n", [64, 1000, 4133, 16384, 65536, 131072])
@pytest.mark.parametrize("b", [1, 8, 16, 31, 256])
def test_scan_fleets_match_plain(b, n, use_penalty):
    """The cluster scan at every fleet width it takes (1 to 8 invoker
    columns a thread) and batch widths across its prefetch ring."""
    rng = np.random.RandomState(b * 7 + n)
    books = random_books(n, rng, unhealthy_p=0.1)
    cols = random_batch(n, b, rng, maxc_choices=(1, 1, 4), oob_p=0.15)
    pen = rng.randint(0, 4, n).astype(np.int32) if use_penalty else None
    _assert_exact(*_both("scan", books, cols, pen))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_scan_families_at_256_match_plain(family):
    """Same-slot bursts, container openings and out-of-range slots over
    256 rows: each commit patches the values later rows prefetched."""
    books, cols = FAMILIES[family](np.random.RandomState(256), 256)
    _assert_exact(*_both("scan", books, cols, None))


@pytest.mark.parametrize("use_penalty", [False, True])
def test_scan_same_slot_runs_match_plain(use_penalty):
    """Runs of 2-11 container-opening rows on one slot and a 1-3 invoker
    window across a block edge, some slots past the slot axis."""
    rng = np.random.RandomState(11)
    n, a, b = 4096, 4, 256
    books = (np.full(n, 1024, np.int32), np.zeros((n, a), np.int32),
             np.ones(n, bool))
    cols = random_batch(n, b, rng, slots=a, maxc_choices=(4,))
    i = 0
    while i < b:
        run, width = int(rng.randint(2, 12)), int(rng.randint(1, 4))
        slot = int(rng.choice([0, 1, a - 1, a + 2]))
        for r in range(i, min(b, i + run)):
            _set_window(cols, r, 1023 - int(rng.randint(0, width)), width,
                        rng, maxc=4)
            cols[5][r] = slot
        i += run
    pen = rng.randint(0, 4, n).astype(np.int32) if use_penalty else None
    _assert_exact(*_both("scan", books, cols, pen))


@pytest.mark.parametrize("use_penalty", [False, True])
def test_scan_rows_outside_the_mulmod_contract_match_plain(use_penalty):
    """Rows whose home, rand or step_inv lie outside [0, size) take the
    kernel's divided keys, the others its Barrett keys: both exact."""
    rng = np.random.RandomState(21)
    n, b = 5000, 64
    books = random_books(n, rng, unhealthy_p=0.1)
    cols = random_batch(n, b, rng, maxc_choices=(1, 4), oob_p=0.1)
    size = cols[1]
    cols[3][0::4] = size[0::4] + 7           # a step past the window
    cols[2][1::4] = size[1::4] + 3           # home past the window
    cols[2][2::4] = -1 - cols[2][2::4]       # negative home
    cols[7][3::4] = -5                       # negative rand
    cols[7][0::8] = size[0::8] * 2 + 1       # rand past the window
    pen = rng.randint(0, 4, n).astype(np.int32) if use_penalty else None
    _assert_exact(*_both("scan", books, cols, pen))


def test_scan_launch_is_deterministic_and_reports_its_cluster():
    rng = np.random.RandomState(3)
    n = 65536
    books = random_books(n, rng)
    cols = random_batch(n, 256, rng, oob_p=0.1)
    (ks1, k1), _ = _both("scan", books, cols, None)
    (ks2, k2), _ = _both("scan", books, cols, None)
    assert torch.equal(ks1.free_mb, ks2.free_mb)
    assert torch.equal(ks1.conc_free, ks2.conc_free)
    for x, y in zip(k1[1:], k2[1:]):
        assert torch.equal(x, y)
    shape = K.schedule_batch_cuda.cluster
    blocks, per = shape["blocks"], shape["columns_per_thread"]
    assert blocks in (8, 16) and shape["threads"] == 1024
    # the fewest columns a thread (a power of two) that cover the fleet
    assert blocks * 1024 * per >= n > blocks * 1024 * per // 2
    assert shape["prefetch_depth"] >= 1


def test_scan_fleet_limit_raises():
    rng = np.random.RandomState(0)
    n = K.SCAN_MAX_N + 1
    assert K.fits_scan(K.SCAN_MAX_N) and not K.fits_scan(n)
    st = T.placement_state_from_numpy(*random_books(n, rng, slots=2),
                                      device="cuda")
    batch = T.request_batch_from_numpy(*random_batch(n, 4, rng, slots=2),
                                       device="cuda")
    launches = K.schedule_batch_cuda.launches
    with pytest.raises(ValueError, match="SCAN_MAX_N"):
        K.schedule_batch_cuda(K.to_transposed(st), batch)
    assert K.schedule_batch_cuda.launches == launches


def test_balancer_core_card_equals_cpu():
    """30 steps of mixed widths: the card (CUDA kernels) and the CPU
    (plain ops) place identically and end with the same books."""
    mem = [2048] * 300
    out = []
    for dev in ("cuda", "cpu"):
        core = TB.BalancerCore(mem, device=dev, max_batch=64,
                               action_slots=64)
        rng = np.random.RandomState(9)
        log = []
        for step in range(30):
            acts = rng.randint(0, 40, int(rng.randint(1, 65)))
            core.submit([core.build_row("ns", f"ns/a{a}", 128 * (1 + a % 4),
                                        1 + (a % 5 == 0) * 3, a % 7 == 0)
                         for a in acts])
            res = core.step()
            log.append((res.chosen.tolist(), res.forced.tolist(),
                        res.rounds))
            for k, inv in enumerate(res.chosen):
                if inv >= 0 and rng.rand() < 0.5:
                    core.complete(int(inv), int(res.rows[5, k]),
                                  int(res.rows[4, k]), int(res.rows[6, k]),
                                  res.slot_keys[k])
        out.append((log, core.books()))
    assert out[0][0] == out[1][0]
    for x, y in zip(out[0][1], out[1][1]):
        np.testing.assert_array_equal(x, y)
