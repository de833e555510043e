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
    FAMILIES, random_batch, random_books)

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
