"""Host microseconds a row spends in `BalancerCore.build_row` and `submit`:
the `row_build` ranges of the window over the rows built in it."""


def read(run):
    if run.trace is None or not run.rows_built:
        return None
    spans = run.trace.spans["row_build"]
    return sum(e - s for s, e in spans) / run.rows_built
