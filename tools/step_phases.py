"""Time `BalancerCore.step`'s four phases on the host clock, with no
profiler recording.

    python3 tools/step_phases.py --workload ow10k-conc.fanout --seed 7 \\
        [--seconds 10]

from the root of a checkout, on a CUDA card. It runs one owbench cell
(`owbench/lib/cell.py` `run_cell`, untraced) with the step's
`core.assembly` / `core.dispatch` / `core.readback` / `core.unpack` ranges
timed by `time.perf_counter` in place of `ops.profiler.span`, and prints
one JSON line: for each phase, for the rest of `step()` outside them
(`outside`) and for the whole call (`step`), the median and mean
microseconds over the window's steps; the cell's `placements_per_s` and
`correct`.

A profiler's ranges cost most where the step issues torch ops (the
dispatch), so a traced split leans toward the dispatch. This one has no
such lean, but it cannot tell the card's idle time from its busy time:
the readback holds the card's whole step.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("core.assembly", "core.dispatch", "core.readback", "core.unpack")


class _Timed:
    __slots__ = ("into", "name", "t0")

    def __init__(self, into: dict, name: str):
        self.into, self.name = into, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.into[self.name] = time.perf_counter() - self.t0


class PhaseClock:
    """Host seconds of each phase of each `step()` call."""

    def __init__(self):
        self.steps: list = []   # one {phase: seconds, "step": seconds} a call

    def span(self, name: str) -> _Timed:
        return _Timed(self.steps[-1], name)

    def wrap(self, step):
        def timed():
            now: dict = {}
            self.steps.append(now)
            t0 = time.perf_counter()
            res = step()
            now["step"] = time.perf_counter() - t0
            return res
        return timed


def measure(workload: str, seed: int, seconds: float, *, root: Path = ROOT,
            device: str = "cuda", bench=None) -> dict:
    from openwhisk_tpu_torch.controller.loadbalancer import tpu_balancer
    from owbench.lib.cell import run_cell

    clock = PhaseClock()

    def hook(core):
        core.step = clock.wrap(core.step)

    saved = tpu_balancer.span
    tpu_balancer.span = clock.span
    try:
        out = run_cell(root, workload, seed, seconds, False,
                       t_start=time.monotonic(), device=device, bench=bench,
                       hook=hook)
    finally:
        tpu_balancer.span = saved
    window = [s for s in clock.steps[len(clock.steps)
                                     - out["run"]["window_steps"]:]
              if PHASES[0] in s]   # the idle fold opens no phase

    def us(xs):
        return {"median": statistics.median(xs) * 1e6,
                "mean": statistics.fmean(xs) * 1e6}

    phases = {n: us([s[n] for s in window]) for n in PHASES}
    phases["outside"] = us([s["step"] - sum(s[n] for n in PHASES)
                            for s in window])
    phases["step"] = us([s["step"] for s in window])
    return {"workload": workload, "seed": seed, "steps": len(window),
            "phases_us": phases,
            "placements_per_s": out["metrics"]["placements_per_s"]["value"],
            "correct": out["correct"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    # the benchmark's kernel caches, so a checkout builds its kernels once
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "owbench" / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)
    print(json.dumps(measure(args.workload, args.seed, args.seconds)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
