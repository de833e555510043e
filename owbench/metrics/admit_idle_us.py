"""Device-idle microseconds a step inside the program's `core.admit`
ranges (the host launching the rate admission's operations), over the
window's steps."""
from owbench.lib.trace import program_idle_us


def read(run):
    return program_idle_us(run, "core.admit")
