"""Milliseconds of CPython garbage collection a second of the window
(`gc.callbacks`)."""


def read(run):
    return run.gc_pause_s * 1e3 / run.seconds
