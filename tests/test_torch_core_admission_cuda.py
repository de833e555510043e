"""`BalancerCore` with rate admission on a card: the admit step carries the
card's counted repair (its tail int32[4]: rounds, rows probed, resumed,
resume misses) and decides as the CPU core does on the same inputs, the
throttled rows' holes in the schedule's valid mask included.

Every test here needs a CUDA device and `nvcc`; without a card the file is
skipped with the reason printed. Run it on the card with

    python -m pytest --noconftest -q tests/test_torch_core_admission_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openwhisk_tpu_torch.controller.loadbalancer import \
    tpu_balancer as TB  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")


def _run(device, widths):
    """30 steps on the 64k cell's clock: 256-row steps over six namespaces
    of skewed traffic behind 600 invocations a minute, completions at
    random. (decisions, books, counters); `widths` gets the width of the
    step's output at each call of the packed step: every step on the CPU,
    the eager step and the capture of the one shape on the card, whose
    later steps replay the capture."""
    core = TB.BalancerCore([2048] * 3000, device=device, max_batch=256,
                           action_slots=64, rate_limit_per_minute=600)
    fn = core._packed_fn

    def packed(*args):
        carry, out = fn(*args)
        widths.append(out.shape[0] - args[5])
        return carry, out
    core._packed_fn = packed
    rng = np.random.RandomState(11)
    p = 0.6 ** np.arange(30)
    log = []
    for step in range(30):
        core.set_clock(step / 139.645)
        acts = rng.choice(30, 256, p=p / p.sum())
        core.submit([core.build_row(f"ns{a % 6}", f"ns{a % 6}/a{a}",
                                    128 * (1 + a % 3), 1, a % 11 == 0)
                     for a in acts])
        res = core.step()
        log.append((res.chosen.tolist(), res.forced.tolist(),
                    res.throttled.tolist(), res.rounds))
        for k, inv in enumerate(res.chosen):
            if inv >= 0 and rng.rand() < 0.4:
                core.complete(int(inv), int(res.rows[5, k]),
                              int(res.rows[4, k]), int(res.rows[6, k]),
                              res.slot_keys[k])
    return log, core.books(), dict(core.counters)


def test_admit_step_on_the_card_carries_the_counted_tail():
    card_widths, cpu_widths = [], []
    card, card_books, card_counts = _run("cuda", card_widths)
    cpu, cpu_books, cpu_counts = _run("cpu", cpu_widths)
    assert card == cpu
    for x, y in zip(card_books, cpu_books):
        np.testing.assert_array_equal(x, y)
    # B decisions, then the rounds and the repair kernel's three counts
    assert card_widths == [4] * 2 and cpu_widths == [1] * 30
    assert card_counts["graph_captures"] == 1
    assert card_counts["graph_replays"] == 29
    assert card_counts["repair_rows_probed"] > 0
    assert card_counts["throttled"] == cpu_counts["throttled"] > 0
    assert card_counts["placed"] == cpu_counts["placed"] > 0
    # throttled rows between admitted ones: holes in the valid mask
    holes = [t for _, _, t, _ in card
             if any(a and not b for a, b in zip(t, t[1:]))]
    assert holes
