"""Seconds from the process's start to the window's: imports, loading (or
building) the kernels, the books, and the fill to steady occupancy."""


def read(run):
    return run.setup_s
