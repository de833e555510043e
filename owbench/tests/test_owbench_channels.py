"""The readers of the program's counters read nothing where the counters
are absent, and the tiny cell's result keeps the keys and values it had
before configurations could carry options, a reference and a clock."""
import pytest

from conftest import ROOT, run_tiny
from owbench.lib.cell import Run
from owbench.lib.manifest import Manifest

MANIFEST = Manifest(ROOT)


def _read(metric, **fields):
    run = Run(MANIFEST, seconds=1.0, steps=4, decided=1024, placed=1000)
    for k, v in fields.items():
        setattr(run, k, v)
    return MANIFEST.reader(metric).read(run)


@pytest.mark.parametrize("metric, counters", [
    ("forced_share", {}),
    ("forced_share", {"placed": 1000}),
    ("repair_resumed_share", {}),
    ("repair_resumed_share", {"repair_rows_resumed": 5}),
    # the CPU's repair counts nothing
    ("repair_resumed_share", {"repair_rows_probed": 0,
                              "repair_rows_resumed": 0}),
    ("release_backlog_rows", {}),
])
def test_counter_readers_read_none_without_their_counters(metric, counters):
    assert _read(metric, counters=counters) is None


def test_counter_readers_read_their_shares():
    assert _read("forced_share", counters={"forced": 256}) == 25.0
    assert _read("forced_share", counters={"forced": 0}) == 0.0
    assert _read("forced_share", counters={"forced": 3}, decided=0) is None
    assert _read("repair_resumed_share", counters={
        "repair_rows_probed": 400, "repair_rows_resumed": 394}) == 98.5
    assert _read("release_backlog_rows",
                 counters={"releases_left": 410}) == 102.5


RUN_KEYS = {"workload", "seed", "trace", "window_steps", "setup_steps",
            "kernels_built", "setup_s", "window_s", "reference_s",
            "release_backlog", "occupancy", "power_limit_w"}


def test_the_tiny_cells_result_keeps_its_keys_and_values(tiny_bench):
    out = run_tiny(*tiny_bench, seed=2**31 + 77)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "run", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"placements_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["device"] == {"platform": "cpu", "kind": "cpu", "count": 0,
                             "memory_peak_bytes": 0}
    assert set(out["run"]) == RUN_KEYS
    run = out["run"]
    assert (run["workload"], run["seed"], run["trace"]) == (
        "tiny.small", 2**31 + 77, 0)
    assert (run["setup_steps"], run["kernels_built"]) == (16, [])
    assert run["window_steps"] > 0 and out["attempted"] > 0
    assert out["checks"] == {k: {"value": 0, "limit": 0} for k in (
        "rows_differ", "decisions_differ", "book_cells_differ")}
