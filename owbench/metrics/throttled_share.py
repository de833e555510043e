"""Percent of the window's decided rows that the program's rate admission
held back (over their namespace's invocations a minute): the program's
`throttled` counter over the window's decided rows (None without the
counter or without rows)."""


def read(run):
    throttled = run.counters.get("throttled")
    if throttled is None or not run.decided:
        return None
    return 100.0 * throttled / run.decided
