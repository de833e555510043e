"""Host milliseconds a step spends in `BalancerCore.step` with the device
idle: each `step` range less the device-busy time inside it (packing,
copies issued, unpacking, the waits between launches)."""


def read(run):
    if run.trace is None or not run.steps:
        return None
    spans = run.trace.spans["step"]
    host = sum((e - s) - run.trace.busy_us(s, e) for s, e in spans)
    return host / len(spans) / 1e3
