"""The port opens ranges of its own inside `BalancerCore.step`
(`core.assembly`, `core.dispatch`, `core.readback`, `core.unpack`, with the
fused step's `release_fold` / `health_fold` / `schedule` inside the
dispatch). They change no reading of the harness: every per-layer reader
and the breakdown read the same numbers from a trace that holds them, and
their mirrors on the device, as from one that does not."""
import pytest
from conftest import ROOT

from owbench.lib.cell import Run
from owbench.lib.manifest import Manifest, read_metrics
from owbench.lib.trace import Trace

STEPS = (100.0, 500.0)
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
    return run


def test_every_reader_and_the_breakdown_ignore_the_programs_ranges():
    manifest = Manifest(ROOT)
    per_layer = manifest.doc["per_layer"]
    without, with_ = _run(manifest, False), _run(manifest, True)
    want = read_metrics(manifest, per_layer, without)
    assert sorted(want) == sorted(m["name"] for m in per_layer)
    assert read_metrics(manifest, per_layer, with_) == want
    assert with_.trace.breakdown() == without.trace.breakdown()
    assert (with_.trace.spans, with_.trace.device, with_.trace.merged) == (
        without.trace.spans, without.trace.device, without.trace.merged)
    # the fixture's own numbers: 182 device-busy us of each 300 us step
    assert want["fused_step_device_ms"]["value"] == pytest.approx(0.182)
    assert want["step_host_ms"]["value"] == pytest.approx(0.118)
