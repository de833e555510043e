"""`BalancerCore` on a card replays one CUDA graph per step shape
(`BalancerCore._graphed_step`) and stays bit-exact with
`BalancerCore(device="cpu")`: every step's chosen, forced and throttled
flags and rounds, the books after each step, and the bucket tokens and
clock, with rate admission on and off.

The scenario (`torch_graph_cases.py`) runs batches of 8, 64 and 256 rows
(several shapes captured), releases, health flips on some steps only, a
clock that moves between steps, and a books swap mid-run, which captures
each shape again and never writes the books it left. Each step either
captures its shape (its first step on the live books) or replays it:
`graph_replays` rises by one each step after the capture, and
`graph_fallbacks` stays 0.

Every test here needs a CUDA device and `nvcc`; without a card the file is
skipped with the reason printed. Run it on the card with

    python -m pytest --noconftest -q tests/test_torch_core_graph_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from torch_graph_cases import (SWAP_AT, assert_same_run,  # noqa: E402
                               counter_steps, drive, expected_captures,
                               make_core, swap_books)

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")


@pytest.mark.parametrize("admit", [False, True])
def test_graphed_core_matches_the_cpu_core_step_for_step(admit):
    kept = {}

    def swap(core, step):
        if step == SWAP_AT:
            kept["old"] = swap_books(core)
            kept["copy"] = tuple(t.clone() for t in kept["old"])

    card = make_core("cuda", admit)
    got = drive(card, swap)
    assert_same_run(got, drive(make_core("cpu", admit)))
    assert not card._capture_errors
    captures = expected_captures(got)
    assert counter_steps(got, "graph_captures") == captures
    assert counter_steps(got, "graph_replays") == [1 - c for c in captures]
    assert got[-1][3]["graph_fallbacks"] == 0
    assert sum(captures) < len(captures)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(kept["old"], kept["copy"]))
    if admit:
        assert got[-1][3]["throttled"] > 0
    assert got[-1][3]["repair_rows_probed"] > 0
