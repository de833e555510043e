"""Placements per second: every row placed in the window over the
window's wall time (host clock, ten seconds and more)."""


def read(run):
    return run.placed / run.seconds
