"""A kernel's share of its roofline over the traced window."""
from __future__ import annotations

from .peaks import least_seconds


def share(run, kernel: str):
    """100 x (least time of the window's launches) / (their device time),
    or None where the trace lacks a launch of `kernel` for some step of
    the window. The least time of a launch is the larger of its operations
    over the int32 rate and its bytes over the HBM bandwidth, from
    `owbench/counts/<kernel>.py`; `run.notes` records which bound held in
    most launches."""
    if run.trace is None or not run.work:
        return None
    counts = run.manifest.counts(kernel)
    times = run.trace.kernel_us(counts.KERNEL)
    if len(times) != len(run.work) or sum(times) <= 0:
        return None
    least, bounds = 0.0, {"bytes": 0, "operations": 0}
    for step in run.work:
        t, bound = least_seconds(*counts.work(step))
        least += t
        bounds[bound] += 1
    run.notes[f"{kernel}_bound"] = max(bounds, key=bounds.get)
    return 100.0 * least / (sum(times) / 1e6)
