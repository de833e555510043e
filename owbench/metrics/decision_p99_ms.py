"""99th percentile, over every step of the traced window, of the time
from the call to `step()` to its decisions on the host (the `step`
ranges): the wait of every activation of the micro-batch once its step
begins."""
import numpy as np


def read(run):
    if run.trace is None or not run.trace.spans["step"]:
        return None
    return float(np.percentile(
        [(e - s) / 1e3 for s, e in run.trace.spans["step"]], 99))
