"""The configuration `ow64k-throttled`: the port's core with rate admission
(`core`: `rate_limit_per_minute`) on the traffic's clock, replayed by its
own reference (`reference/throttled.py`). A tiny copy runs `correct` with
throttled rows in it; a reference whose rate is one token a minute off is
not correct; the control (`sequential=False`) runs with the reference; the
admission's readers read nothing where their counter or range is absent."""
import json

import pytest

from conftest import ROOT, TINY_CONFIG, make_bench, run_tiny
from owbench import control
from owbench.lib.cell import Run
from owbench.lib.manifest import Manifest
from owbench.lib.trace import Trace

SEED = 2**31 + 4242
CONFIG = json.loads((ROOT / "owbench" / "configs" / "ow64k-throttled.json")
                    .read_text())
#: the tiny fleet's limit: its buckets drain within a few steps
TINY_THROTTLED = dict(TINY_CONFIG, core={"rate_limit_per_minute": 120},
                      reference="throttled", clock="traffic",
                      namespace_throttling=True)

OFF_BY_ONE = '''"""The throttled reference, one token a minute over."""
from owbench.reference.throttled import Reference as Throttled


class Reference(Throttled):
    def __init__(self, memory_mb, *, rate_limit_per_minute, **kw):
        super().__init__(memory_mb,
                         rate_limit_per_minute=rate_limit_per_minute + 1,
                         **kw)
'''


def test_the_configuration_turns_on_the_admission():
    assert CONFIG["core"] == {"rate_limit_per_minute": 12000}
    assert (CONFIG["reference"], CONFIG["clock"]) == ("throttled", "traffic")
    default = json.loads((ROOT / "owbench" / "configs" / "ow64k-default.json")
                         .read_text())
    same = set(default) - {"about", "assumed", "sources", "reduced",
                           "namespace_throttling"}
    assert {k: CONFIG[k] for k in same} == {k: default[k] for k in same}
    assert CONFIG["namespace_throttling"] is True


def test_a_tiny_throttled_cell_is_correct_with_throttled_rows(tmp_path):
    root, bench = make_bench(tmp_path, config=TINY_THROTTLED)
    out = run_tiny(root, bench, trace=True, seed=SEED, seconds=0.5)
    assert out["correct"] is True, out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values())
    share = out["metrics"]["throttled_share"]["value"]
    assert 0 < share < 100
    assert out["failed"] == 0 and out["attempted"] > 0
    # the CPU has no device events to read the admission's idle time from
    assert "admit_idle_us" not in out["metrics"]


def test_a_reference_one_token_a_minute_off_is_not_correct(tmp_path):
    root, bench = make_bench(tmp_path, config=dict(
        TINY_THROTTLED, reference="off_by_one"))
    (bench / "reference" / "off_by_one.py").write_text(OFF_BY_ONE)
    out = run_tiny(root, bench, seed=SEED, seconds=0.5)
    assert out["correct"] is False
    assert out["checks"]["decisions_differ"]["value"] > 0


def test_the_control_runs_with_the_throttled_reference(tmp_path):
    root, bench = make_bench(tmp_path, config=TINY_THROTTLED)
    cell = Manifest(root, bench).cell("tiny.small")
    got = control.readings(cell, SEED, 120)
    assert got["decisions_differ"] > 0 and got["book_cells_differ"] > 0


MANIFEST = Manifest(ROOT)


def _read(metric, trace=None, **fields):
    run = Run(MANIFEST, seconds=1.0, steps=2, decided=1024, placed=700)
    run.trace = trace
    for k, v in fields.items():
        setattr(run, k, v)
    return MANIFEST.reader(metric).read(run)


def _trace(admit: bool):
    """Two steps with a device; with `admit`, the admission's range inside
    each dispatch, 8 us of its 16 with the card idle."""
    ev = [("window", False, 0.0, 1000.0)]
    for t in (100.0, 500.0):
        ev += [("step", False, t, t + 300),
               ("core.dispatch", False, t + 30, t + 60),
               ("placement_repair_kernel", True, t + 40, t + 230)]
        if admit:
            ev += [("core.admit", False, t + 32, t + 48)]
    return Trace(ev)


@pytest.mark.parametrize("metric, fields", [
    ("throttled_share", {}),
    ("throttled_share", {"counters": {"placed": 700}}),
    ("throttled_share", {"counters": {"throttled": 3}, "decided": 0}),
    ("admit_idle_us", {}),
    ("admit_idle_us", {"trace": "no admission range"}),
])
def test_admission_readers_read_none_where_absent(metric, fields):
    if fields.get("trace"):
        fields = dict(fields, trace=_trace(admit=False))
    assert _read(metric, **fields) is None


def test_admission_readers_read_their_values():
    assert _read("throttled_share", counters={"throttled": 768}) == 75.0
    assert _read("throttled_share", counters={"throttled": 0}) == 0.0
    # 16 us a range, 8 of them with the card busy (the kernel from t + 40)
    assert _read("admit_idle_us", trace=_trace(admit=True)) == \
        pytest.approx(8.0)
