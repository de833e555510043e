"""The check that decides `correct` on the CPU: a whole run of the harness
on a tiny cell (no card looked for), sound and with the timed path broken
underneath, and with the control in the program's place."""
import numpy as np
import pytest

from conftest import run_tiny
from owbench.reference.sharding import Reference


def test_a_sound_run_is_correct(tiny_bench):
    out = run_tiny(*tiny_bench)
    assert out["correct"] is True and out["failed"] == 0
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"placements_per_s", "setup_s"}
    assert out["run"]["kernels_built"] == []


def _unchanged_state(core):
    """A step that returns the books as it found them."""
    real = core._packed_fn

    def step(state, buf, r, h, b):
        kept = [t.clone() for t in state]
        state, out = real(state, buf, r, h, b)
        for t, k in zip(state, kept):
            t.copy_(k)
        return state, out
    core._packed_fn = step


def _half_batch(core):
    """A step that leaves out the second half of its rows."""
    real = core._packed_fn

    def step(state, buf, r, h, b):
        req = buf[5 * r + 3 * h:].view(9, b)
        req[8, b // 2:] = 0
        return real(state, buf, r, h, b)
    core._packed_fn = step


def _altered_answer(core):
    """A step whose seventh decision names the next invoker."""
    real = core.step

    def step():
        res = real()
        if len(res.chosen) > 6 and res.chosen[6] >= 0:
            res.chosen[6] = (res.chosen[6] + 1) % core.n
        return res
    core.step = step


def _altered_row(core):
    """A row builder whose fortieth row carries another forced rotation."""
    real = core.build_row
    count = [0]

    def build_row(*args):
        (row, key) = real(*args)
        count[0] += 1
        if count[0] == 40:
            row = row[:7] + ((row[7] + 1) % row[1],) + row[8:]
        return row, key
    core.build_row = build_row


def _control(core):
    """The reference with its sequential guarantee broken, in the
    program's place."""
    ctl = Reference(core.memory_mb, managed_fraction=core.managed_fraction,
                    blackbox_fraction=core.blackbox_fraction,
                    max_batch=core.max_batch, action_slots=core.action_slots,
                    sequential=False)
    for name in ("build_row", "submit", "complete", "set_health", "step",
                 "books"):
        setattr(core, name, getattr(ctl, name))


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _altered_answer, _altered_row, _control],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_run_is_not_correct(tiny_bench, fault):
    out = run_tiny(*tiny_bench, hook=fault)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
    if fault is _altered_row:
        assert out["checks"]["rows_differ"]["value"] > 0


def test_the_traced_run_checks_the_same(tiny_bench):
    out = run_tiny(*tiny_bench, trace=True, hook=_altered_answer)
    assert out["correct"] is False
    sound = run_tiny(*tiny_bench, trace=True)
    assert sound["correct"] is True
    assert np.isfinite(sound["metrics"]["repair_rounds"]["value"])
