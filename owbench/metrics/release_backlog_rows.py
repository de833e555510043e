"""Releases left queued after each step's pack, a step: the program's
`releases_left` counter over the window's steps."""


def read(run):
    left = run.counters.get("releases_left")
    if left is None or not run.steps:
        return None
    return left / run.steps
