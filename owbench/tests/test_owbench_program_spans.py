"""The port opens ranges of its own inside `BalancerCore.step`
(`core.assembly`, `core.dispatch`, `core.readback`, `core.unpack`, with the
fused step's `release_fold` / `health_fold` / `schedule` inside the
dispatch). They change no other reading of the harness: every per-layer
reader but those of the program's own ranges and counters, and the
breakdown, read the same numbers from a trace that holds them, and their
mirrors on the device, as from one that does not. The readers of the
program's ranges and counters read nothing without them."""
import pytest
from conftest import ROOT

from owbench.lib.cell import Run
from owbench.lib.manifest import Manifest, read_metrics
from owbench.lib.trace import Trace

STEPS = (100.0, 500.0)
#: the readers of the program's own ranges and counters
PROGRAM_READERS = {"assembly_idle_us", "dispatch_idle_us", "readback_idle_us",
                   "unpack_idle_us", "release_backlog_rows",
                   "repair_resumed_share", "forced_share"}
WORK = {"schedule": {"probes": 400, "rotation_keys": 0, "rows": 16,
                     "probe_columns": 90, "rotation_columns": 0,
                     "permit_cells": 0, "cells_changed": 16},
        "release": {"rows": 8, "free_cells_read": 8, "conc_cells_read": 0,
                    "cells_changed": 8}}


def _events(program: bool):
    """Two steps of a window: the harness's ranges, the device's copies
    and kernels, and the mirrors of host ranges on the device; with
    `program`, the port's ranges inside each step and their mirrors."""
    ev = [("window", False, 0.0, 1000.0)]
    for t in STEPS:
        ev += [("row_build", False, t - 60, t - 10),
               ("step", False, t, t + 300),
               ("complete", False, t + 300, t + 320),
               ("step", True, t + 35, t + 240),
               ("Memcpy HtoD (Pageable -> Device)", True, t + 35, t + 38),
               ("release_fold_kernel", True, t + 40, t + 45),
               ("placement_repair_kernel", True, t + 60, t + 230),
               ("Memcpy DtoH (Device -> Pageable)", True, t + 236, t + 240)]
        if program:
            ev += [("core.assembly", False, t + 2, t + 30),
                   ("core.dispatch", False, t + 30, t + 58),
                   ("release_fold", False, t + 31, t + 36),
                   ("health_fold", False, t + 36, t + 50),
                   ("schedule", False, t + 50, t + 57),
                   ("core.readback", False, t + 58, t + 241),
                   ("core.unpack", False, t + 241, t + 298),
                   ("core.dispatch", True, t + 35, t + 230),
                   ("core.readback", True, t + 236, t + 240),
                   ("release_fold", True, t + 40, t + 45),
                   ("health_fold", True, t + 46, t + 59),
                   ("schedule", True, t + 60, t + 230)]
    return ev


def _run(manifest, program: bool) -> Run:
    run = Run(manifest, seconds=1e-3, steps=len(STEPS), placed=30,
              decided=32, rows_built=32, rounds=[3, 5], gc_pause_s=1e-5,
              work=[WORK] * len(STEPS))
    run.trace = Trace(_events(program))
    if program:
        run.counters = {"releases_left": 10, "repair_rows_probed": 200,
                        "repair_rows_resumed": 150, "forced": 4}
    return run


def test_every_reader_and_the_breakdown_ignore_the_programs_ranges():
    manifest = Manifest(ROOT)
    per_layer = manifest.doc["per_layer"]
    without, with_ = _run(manifest, False), _run(manifest, True)
    want = read_metrics(manifest, per_layer, without)
    assert sorted(want) == sorted(m["name"] for m in per_layer
                                  if m["name"] not in PROGRAM_READERS)
    got = read_metrics(manifest, per_layer, with_)
    assert {k: v for k, v in got.items() if k not in PROGRAM_READERS} == want
    assert set(got) - set(want) == PROGRAM_READERS
    assert with_.trace.breakdown() == without.trace.breakdown()
    assert (with_.trace.spans, with_.trace.device, with_.trace.merged) == (
        without.trace.spans, without.trace.device, without.trace.merged)
    # the fixture's own numbers: 182 device-busy us of each 300 us step
    assert want["fused_step_device_ms"]["value"] == pytest.approx(0.182)
    assert want["step_host_ms"]["value"] == pytest.approx(0.118)
    # each range less the copies and kernels inside it, a step; the
    # counters over the window's 2 steps and 32 rows
    values = {k: v["value"] for k, v in got.items() if k in PROGRAM_READERS}
    assert values == pytest.approx({
        "assembly_idle_us": 28.0, "dispatch_idle_us": 20.0,
        "readback_idle_us": 9.0, "unpack_idle_us": 57.0,
        "release_backlog_rows": 5.0, "repair_resumed_share": 75.0,
        "forced_share": 12.5})
