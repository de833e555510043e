"""One run of one cell: set-up, the measured window, the reference's replay,
and the result line.

Set-up builds `BalancerCore` on the card from the configuration (its
fleet, its split, batch and slots, and the options under `core`), then
drives the traffic's fill and warm steps through the same loop as the
window: that loads (or builds) every kernel at the one shape the window
uses (full 256-row steps), and brings the fleet to its steady occupancy.
The run records which kernels nvcc built in it (`kernels_built`: a
checkout's first run builds them, and its `setup_s` holds the build). The
window then drives steps until `seconds` have passed. The readers get the
window's deltas of the program's counters (`core.counters`); with `trace`
the profiler records the window, and the per-layer readers take their
metrics from the trace too.

Once the window has closed and the peak memory is read, the program's
books are copied to the host and its state freed; the configuration's
reference (`owbench/reference/<reference>.py`, built with the same
options) then replays every step from the same inputs, on the same
traffic clock where the configuration asks for one, and the comparison
decides `correct`.
"""
from __future__ import annotations

import gc
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

from .check import LIMITS, compare_books, compare_steps, verdict
from .drive import Loop, StepInputs
from .manifest import Manifest, read_metrics
from .trace import WINDOW, Trace, profiler_events
from .traffic import Traffic


@dataclass
class Run:
    """What the metric readers read."""
    manifest: Manifest
    seconds: float = 0.0
    setup_s: float = 0.0
    steps: int = 0
    placed: int = 0
    decided: int = 0
    #: rows a core held back (`throttled`): decided, neither placed nor failed
    throttled: int = 0
    rows_built: int = 0
    rounds: List[int] = field(default_factory=list)
    gc_pause_s: float = 0.0
    #: the window's deltas of the program's counters (`core.counters`)
    counters: dict = field(default_factory=dict)
    trace: Optional[Trace] = None
    #: the reference's record of each window step's work (traced runs)
    work: List[dict] = field(default_factory=list)
    notes: dict = field(default_factory=dict)


class GcClock:
    """Seconds spent in CPython's collector while installed."""

    def __init__(self):
        self.total = 0.0
        self._t0 = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.total += time.perf_counter() - self._t0
            self._t0 = None


def _power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, *, t_start: float, device: str = "cuda",
             bench: Optional[Path] = None,
             hook: Optional[Callable] = None) -> dict:
    import torch
    from openwhisk_tpu_torch.controller.loadbalancer.tpu_balancer import (
        BalancerCore)
    from openwhisk_tpu_torch.ops import _build

    manifest = Manifest(root, bench)
    cell = manifest.cell(workload)
    cfg = cell.config
    on_card = torch.device(device).type == "cuda"
    fleet, kw = cell.fleet, cell.side_kwargs()
    Reference = cell.reference_class()
    # the process's build log before this run: a build is a new entry
    logs = dict(_build.build_logs)
    core = BalancerCore(fleet, device=device,
                        placement_kernel=cfg["placement_kernel"], **kw)
    if hook is not None:
        hook(core)
    traffic = Traffic(cfg, cell.mix, seed)
    clock = traffic.steps_per_s if cell.clock == "traffic" else None
    inputs = StepInputs(traffic)
    loop = Loop(core, inputs, traffic.table, clock)
    loop.run(traffic.setup_steps)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    built = sorted(k for k, v in _build.build_logs.items()
                   if logs.get(k) is not v)

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        loop.span = torch.profiler.record_function
        loop.run(1)  # the profiler's first step, outside the window
        sync()
    span = loop.span
    first, built0 = loop.step_no, loop.rows_built
    gc_clock = GcClock()
    # what set-up left on the heap (the traffic's record, the fill's
    # results, the completions in flight) is kept out of the collector's
    # later passes: a full pass over it would be the harness's cost
    gc.collect()
    gc.freeze()
    run = Run(manifest)
    run.setup_s = time.monotonic() - t_start
    c0 = dict(core.counters)
    gc.callbacks.append(gc_clock)
    try:
        t0 = time.perf_counter()
        with span(WINDOW):
            while True:
                loop.before_step()
                with span("step"):
                    res = core.step()
                loop.after_step(res)
                if time.perf_counter() - t0 >= seconds:
                    break
        t1 = time.perf_counter()
        run.counters = {k: v - c0.get(k, 0)
                        for k, v in core.counters.items()}
    finally:
        gc.callbacks.remove(gc_clock)
        gc.unfreeze()
    sync()
    if prof is not None:
        r0 = time.perf_counter()
        prof.stop()
        r1 = time.perf_counter()
        run.trace = Trace(profiler_events(prof, torch))
        del prof
        run.notes.update(trace_stop_s=r1 - r0,
                         trace_read_s=time.perf_counter() - r1)

    window = loop.results[first:]
    run.seconds = t1 - t0
    run.steps = len(window)
    run.decided = sum(len(r[0]) for r in window)
    run.placed = sum(int((r[0] >= 0).sum()) for r in window)
    run.throttled = sum(int(np.count_nonzero(r[4])) for r in window
                        if r[4] is not None)
    run.rows_built = loop.rows_built - built0
    run.rounds = [int(r[3]) for r in window]
    run.gc_pause_s = gc_clock.total
    if on_card:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cell.chips,
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 0,
               "memory_peak_bytes": 0}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_us(run.trace.t0, run.trace.t1) / 1e6
        dev["window_s"] = run.trace.window_us / 1e6
    power = _power_limit_w() if on_card else None

    # the program's outputs to the host, its state freed, then the replay
    program_books = core.books()
    program_steps = loop.results
    total_steps = loop.step_no
    del core, loop, res
    if on_card:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    ref = Reference(fleet, **kw)
    rloop = Loop(ref, inputs.replay(), traffic.table, clock)
    gc.disable()  # the replay makes no cycles; its heap only grows
    try:
        rloop.run(first)
        ref.keep_work = trace
        rloop.run(total_steps - first)
    finally:
        gc.enable()
    readings = compare_steps(program_steps, rloop.results)
    readings["book_cells_differ"] = compare_books(program_books, ref.books())
    reference_s = time.perf_counter() - r0
    run.work = ref.work

    metrics = read_metrics(manifest, cell.metrics(trace), run)
    free = ref.books()[0]
    out = {"correct": verdict(readings), "attempted": run.decided,
           "failed": run.decided - run.placed - run.throttled,
           "metrics": metrics, "device": dev}
    if run.trace is not None:
        out["breakdown"] = run.trace.breakdown()
    out["run"] = dict(
        workload=workload, seed=seed, trace=int(trace),
        window_steps=run.steps, setup_steps=traffic.setup_steps,
        kernels_built=built,
        setup_s=run.setup_s, window_s=run.seconds, reference_s=reference_s,
        release_backlog=ref.release_backlog,
        occupancy=1.0 - float(free.sum()) / float(sum(fleet)),
        power_limit_w=power, **run.notes)
    out["checks"] = {k: {"value": readings[k], "limit": LIMITS[k]}
                     for k in LIMITS}
    return out
