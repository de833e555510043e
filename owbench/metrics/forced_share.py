"""Percent of the window's decided rows that were placed forced (no
invoker of the action's slice had room, so the first healthy invoker of
the row's rotation took it): the program's `forced` counter over the
window's decided rows (None without the counter or without rows)."""


def read(run):
    forced = run.counters.get("forced")
    if forced is None or not run.decided:
        return None
    return 100.0 * forced / run.decided
