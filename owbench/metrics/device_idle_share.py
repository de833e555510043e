"""Percent of the traced window in which no operation ran on the card."""


def read(run):
    if (run.trace is None or not run.trace.device
            or run.trace.window_us <= 0):
        return None
    busy = run.trace.busy_us(run.trace.t0, run.trace.t1)
    return 100.0 * (1.0 - busy / run.trace.window_us)
