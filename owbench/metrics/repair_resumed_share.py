"""Percent of the rows the repair kernel probed in its rounds that resumed
their walk from their last rank: the program's `repair_rows_resumed` over
`repair_rows_probed`, over the window (None without the counters, or
where the kernel probed no row, as on the CPU)."""


def read(run):
    probed = run.counters.get("repair_rows_probed")
    resumed = run.counters.get("repair_rows_resumed")
    if probed is None or resumed is None or probed <= 0:
        return None
    return 100.0 * resumed / probed
