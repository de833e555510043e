"""A configuration turns on an option of the core as new files only: its
`core` options go to both sides' constructors, its `reference` names a
module of its own under `owbench/reference/`, and `clock: "traffic"` hands
both sides the traffic's seconds before every step. A core's `throttled`
flags are held to the reference's like its placements, and the readers see
the window's deltas of the program's counters.

The port's core has no such option yet, so a stand-in (`BalancerCore` with
an option and a clock) is patched in; it and the configuration's reference
write what they were given into one log."""
import json
import sys
import types

import numpy as np
import pytest

from conftest import TINY_CONFIG, TINY_MIX, make_bench, run_tiny
from owbench.lib.manifest import load_module
from owbench.lib.traffic import Traffic

SEED = 2**31 + 1234

#: a configuration's own reference: the sharding reference with an option
#: it logs, and a clock it logs
TAGGED = '''"""The sharding reference with a logged option and clock."""
import owbench_options_log as log
from owbench.reference.sharding import Reference as Sharding


class Reference(Sharding):
    def __init__(self, memory_mb, *, tag, sequential=True, **kw):
        super().__init__(memory_mb, sequential=sequential, **kw)
        log.calls.append(("reference", "init", tag))

    def set_clock(self, now_s):
        super().set_clock(now_s)
        log.calls.append(("reference", "clock", now_s))
'''

#: a reference whose core holds back rows by a fixed rule: a held row
#: carries chosen -1 and `throttled`, and no completion frees what it took
THROTTLING = '''"""The sharding reference, holding back every ninth row."""
import types

import numpy as np
from owbench.reference.sharding import Reference as Sharding


def hold_back(res, step_no):
    held = (np.arange(len(res.chosen)) + step_no) % 9 == 0
    chosen = np.where(held, -1, res.chosen).astype(res.chosen.dtype)
    return types.SimpleNamespace(**dict(res._asdict(), chosen=chosen),
                                 throttled=held)


class Reference(Sharding):
    def __init__(self, memory_mb, **kw):
        super().__init__(memory_mb, **kw)
        self.steps = 0

    def step(self):
        res = hold_back(super().step(), self.steps)
        self.steps += 1
        return res
'''


@pytest.fixture
def log(monkeypatch):
    mod = types.ModuleType("owbench_options_log")
    mod.calls = []
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return mod


@pytest.fixture
def stand_in(monkeypatch, log):
    """`BalancerCore` with an option `tag` and a clock, both logged."""
    from openwhisk_tpu_torch.controller.loadbalancer import tpu_balancer

    class StandIn(tpu_balancer.BalancerCore):
        def __init__(self, fleet, *, tag, **kw):
            super().__init__(fleet, **kw)
            log.calls.append(("program", "init", tag))

        def set_clock(self, now_s):
            log.calls.append(("program", "clock", now_s))

    monkeypatch.setattr(tpu_balancer, "BalancerCore", StandIn)
    return StandIn


def _bench(tmp_path, name, source, **config):
    root, bench = make_bench(tmp_path, config=dict(TINY_CONFIG, **config))
    (bench / "reference" / f"{name}.py").write_text(source)
    return root, bench


def _calls(log, side, what):
    return [v for s, w, v in log.calls if (s, w) == (side, what)]


def test_both_sides_get_the_options_and_the_traffic_clock(tmp_path, log,
                                                          stand_in):
    root, bench = _bench(tmp_path, "tagged", TAGGED, core={"tag": "t7"},
                         reference="tagged", clock="traffic")
    out = run_tiny(root, bench, seed=SEED)
    assert out["correct"] is True
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert _calls(log, "program", "init") == ["t7"]
    assert _calls(log, "reference", "init") == ["t7"]
    program = _calls(log, "program", "clock")
    steps = out["run"]["setup_steps"] + out["run"]["window_steps"]
    assert program == _calls(log, "reference", "clock")
    per_s = Traffic(TINY_CONFIG, TINY_MIX, SEED).steps_per_s
    assert program == [k / per_s for k in range(steps)]


def test_without_a_clock_no_side_is_given_one(tmp_path, log, stand_in):
    root, bench = _bench(tmp_path, "tagged", TAGGED, core={"tag": "t8"},
                         reference="tagged")
    out = run_tiny(root, bench, seed=SEED)
    assert out["correct"] is True
    assert _calls(log, "reference", "init") == ["t8"]
    assert not _calls(log, "program", "clock")
    assert not _calls(log, "reference", "clock")


def test_an_unknown_clock_or_a_repeated_key_is_refused(tmp_path):
    root, bench = make_bench(tmp_path, config=dict(TINY_CONFIG,
                                                   clock="wall"))
    with pytest.raises(ValueError, match="clock"):
        run_tiny(root, bench)
    root, bench = make_bench(tmp_path / "b", config=dict(
        TINY_CONFIG, core={"max_batch": 8}))
    with pytest.raises(ValueError, match="core"):
        run_tiny(root, bench)


def _held_back(bench, alter=None):
    """A hook that holds back the program's rows by the throttling
    reference's rule, then hands each step's result to `alter`."""
    ref = load_module(bench / "reference" / "throttling.py", "hold_back")

    def hook(core):
        real, count = core.step, [0]

        def step():
            res = ref.hold_back(real(), count[0])
            if alter is not None:
                alter(count[0], res)
            count[0] += 1
            return res
        core.step = step
    return hook


def _throttling(tmp_path):
    return _bench(tmp_path, "throttling", THROTTLING, reference="throttling")


def test_throttled_rows_are_decided_and_compared(tmp_path):
    root, bench = _throttling(tmp_path)
    out = run_tiny(root, bench, seed=SEED, hook=_held_back(bench))
    assert out["correct"] is True
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert out["attempted"] > 0 and out["failed"] == 0


def test_a_core_that_holds_back_other_rows_is_not_correct(tmp_path):
    root, bench = _throttling(tmp_path)
    # the program places the rows the reference holds back
    out = run_tiny(root, bench, seed=SEED)
    assert out["correct"] is False
    assert out["checks"]["decisions_differ"]["value"] > 0


def test_a_throttled_flag_alone_that_differs_is_not_correct(tmp_path):
    """Step 12's held rows keep chosen -1 on both sides, but the program
    flags only the first of them: nothing but the flags differs."""
    root, bench = _throttling(tmp_path)
    unflagged = []

    def alter(step_no, res):
        if step_no == 12:
            held = np.flatnonzero(res.throttled)
            res.throttled[held[1:]] = False
            unflagged.append(len(held) - 1)

    out = run_tiny(root, bench, seed=SEED, hook=_held_back(bench, alter))
    assert unflagged and unflagged[0] > 0
    assert out["correct"] is False
    checks = {k: c["value"] for k, c in out["checks"].items()}
    assert checks == {"rows_differ": 0, "decisions_differ": unflagged[0],
                      "book_cells_differ": 0}


def test_readers_get_the_windows_counter_deltas(tmp_path):
    root, bench = make_bench(tmp_path)
    (bench / "metrics" / "steps_counted.py").write_text(
        "def read(run):\n    return run.counters.get('steps')\n")
    (bench / "metrics" / "placed_counted.py").write_text(
        "def read(run):\n    return run.counters.get('placed')\n")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    for name in ("steps_counted", "placed_counted"):
        doc["per_layer"].append({"name": name, "unit": "count",
                                 "better": "higher",
                                 "source": "program_counter",
                                 "layer": "core host",
                                 "moves": "placements_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    out = run_tiny(root, bench, trace=True, seed=SEED)
    assert out["correct"] is True
    m = out["metrics"]
    assert m["steps_counted"]["value"] == out["run"]["window_steps"]
    assert m["placed_counted"]["value"] == out["attempted"] - out["failed"]
