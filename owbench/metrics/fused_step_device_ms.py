"""Device milliseconds a step: the union of the device intervals inside
the `step` ranges (copies, the release kernel, the health fold's ops, the
schedule kernel, the output's ops), over the window's steps."""


def read(run):
    if run.trace is None or not run.trace.device or not run.steps:
        return None
    spans = run.trace.spans["step"]
    return sum(run.trace.busy_us(s, e) for s, e in spans) / len(spans) / 1e3
