"""The reduction of a `torch.profiler` trace of the measured window.

The harness wraps its calls into the port in named host ranges (`row_build`,
`flap`, `complete`, `step`) and the whole window in `window`. The port's
own ranges inside a step (those named `core.*`, and the fused step's
`release_fold` / `health_fold` / `schedule`) are `Trace.program`. The device
intervals are the profiler's CUDA events (kernels, copies, sets) inside the
window, without the annotations that mirror host ranges on the device.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

HOST_RANGES = ("row_build", "flap", "complete", "step")
WINDOW = "window"
#: the prefix of the program's own ranges (`Trace.program`), and the fused
#: step's ranges that it opens without the prefix
PROGRAM = "core."
PROGRAM_FOLDS = ("release_fold", "health_fold", "schedule")


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def profiler_events(prof, torch):
    """(name, on_device, start_us, end_us) of every event the stopped
    profiler recorded, read from its raw results (building its event tree
    takes a minute for a window of a few hundred thousand events)."""
    raw = prof.profiler.kineto_results.events()
    if not raw:
        return []
    base = min(e.start_ns() for e in raw)
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.device_type() == cuda, (e.start_ns() - base) / 1e3,
             (e.start_ns() - base + e.duration_ns()) / 1e3) for e in raw]


class Trace:
    """Host ranges and device intervals of the window, in microseconds."""

    def __init__(self, events):
        host, cpu_names, dev, program = [], set(), [], []
        for name, on_device, start, end in events:
            if on_device:
                dev.append((start, end, name))
            else:
                cpu_names.add(name)
                if name in HOST_RANGES or name == WINDOW:
                    host.append((start, end, name))
                elif name.startswith(PROGRAM) or name in PROGRAM_FOLDS:
                    program.append((start, end, name))
        windows = [(s, e) for s, e, n in host if n == WINDOW]
        if len(windows) != 1:
            raise RuntimeError(f"the trace holds {len(windows)} windows")
        self.t0, self.t1 = windows[0]
        self.spans: Dict[str, List[Tuple[float, float]]] = {
            n: sorted((s, e) for s, e, m in host
                      if m == n and self.t0 <= s < self.t1)
            for n in HOST_RANGES}
        self.device = sorted((s, e, n) for s, e, n in dev
                             if n not in cpu_names and self.t0 <= s < self.t1)
        #: the program's ranges in the window, by name
        self.program: Dict[str, List[Tuple[float, float]]] = {}
        for s, e, n in sorted(program):
            if self.t0 <= s < self.t1:
                self.program.setdefault(n, []).append((s, e))
        self.merged = merge([(s, min(e, self.t1)) for s, e, _ in self.device])
        self._starts = [s for s, _ in self.merged]

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def busy_us(self, lo: float, hi: float) -> float:
        """Device-busy time inside [lo, hi)."""
        i = max(bisect.bisect_right(self._starts, lo) - 1, 0)
        busy = 0.0
        for s, e in self.merged[i:]:
            if s >= hi:
                break
            busy += max(0.0, min(e, hi) - max(s, lo))
        return busy

    def kernel_us(self, name_part: str) -> List[float]:
        """Device time of each launch of the kernels whose name holds
        `name_part`, in launch order."""
        return [e - s for s, e, n in self.device if name_part in n]

    def _host_at(self, t: float) -> str:
        for name, spans in self.spans.items():
            i = bisect.bisect_right(spans, (t, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= t < spans[i][1]:
                return name
        return "harness"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the host range that was running, in seconds."""
        by_op: Dict[str, float] = {}
        for s, e, n in self.device:
            key = n.replace("(anonymous namespace)::", "").replace(
                "void ", "").split("(")[0][:80]
            by_op[key] = by_op.get(key, 0.0) + (e - s)
        gaps, end = [], self.t0
        for s, e in self.merged:
            if s > end:
                gaps.append((s - end, self._host_at((s + end) / 2)))
            end = max(end, e)
        if self.t1 > end:
            gaps.append((self.t1 - end, self._host_at((self.t1 + end) / 2)))
        gaps.sort(key=lambda g: -g[0])
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v / 1e6] for n, v in ops],
                "idle_gaps": [[n, g / 1e6] for g, n in gaps[:top]]}


def program_idle_us(run, name: str):
    """Device-idle microseconds a window step inside the program's ranges
    named `name`; None without a trace, a device or such ranges."""
    t = run.trace
    spans = t.program.get(name) if t is not None else None
    if not spans or not t.device or not run.steps:
        return None
    return sum((e - s) - t.busy_us(s, e) for s, e in spans) / run.steps
