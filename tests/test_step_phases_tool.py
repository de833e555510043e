"""`tools/step_phases.py` times `BalancerCore.step`'s four phases on the
host clock: driven through a tiny owbench cell on the CPU, every window
step reports each phase once, the phases fit inside the call, and the
profiler's `span` is back in place afterwards."""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from openwhisk_tpu_torch.controller.loadbalancer import \
    tpu_balancer  # noqa: E402
from openwhisk_tpu_torch.ops import profiler  # noqa: E402
from owbench.tests.conftest import make_bench  # noqa: E402
from tools import step_phases  # noqa: E402


def test_tiny_cell_splits_each_step_into_its_four_phases(tmp_path):
    root, bench = make_bench(tmp_path)
    out = step_phases.measure("tiny.small", 2**31 + 91, 0.3, root=root,
                              device="cpu", bench=bench)
    assert out["correct"] and out["steps"] > 0
    assert out["placements_per_s"] > 0
    ph = out["phases_us"]
    assert set(ph) == set(step_phases.PHASES) | {"outside", "step"}
    assert all(ph[n]["median"] > 0 for n in step_phases.PHASES)
    inside = sum(ph[n]["mean"] for n in step_phases.PHASES)
    assert 0 < ph["outside"]["mean"] < ph["step"]["mean"]
    assert abs(inside + ph["outside"]["mean"] - ph["step"]["mean"]) \
        < 1e-6 * ph["step"]["mean"]
    assert tpu_balancer.span is profiler.span


def test_phase_clock_times_each_phase_of_each_call():
    clock = step_phases.PhaseClock()

    def step():
        for name in step_phases.PHASES:
            with clock.span(name):
                pass
        return "done"

    timed = clock.wrap(step)
    assert [timed(), timed()] == ["done", "done"]
    assert [sorted(s) for s in clock.steps] == [
        sorted(step_phases.PHASES + ("step",))] * 2
    assert all(s["step"] >= sum(s[n] for n in step_phases.PHASES)
               for s in clock.steps)
