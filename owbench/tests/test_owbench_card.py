"""On the card: a short run of each cell through the harness, correct.
Skips itself, with the reason, where there is no CUDA card."""
import json
import time

import pytest

from conftest import ROOT

DOC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in DOC["workloads"]])
def test_cell_runs_correct_on_the_card(card, workload):
    from owbench.lib.cell import run_cell
    out = run_cell(ROOT, workload, 2**31 + 123, 1.0, False,
                   t_start=time.monotonic())
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["metrics"]["placements_per_s"]["value"] > 0
