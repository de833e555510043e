"""The echo-fleet anomaly run of `test_torch_anomaly_echo.py` at a size
given on the command line, through both packages on the CPU:

    JAX_PLATFORMS=cpu python tests/torch_anomaly_echo_sweep.py \\
        INVOKERS ACTIONS CONCURRENT INFLIGHT TRICKLE

Prints, for each package, the anomaly ticks run, the invokers flagged
after the run, the warm invokers (at least `min_samples` completions),
their median EWMA latency and the flagged invokers' EWMAs and robust z.
Latencies are wall-clock, so the counts vary from run to run.
"""
import asyncio
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]
import test_torch_anomaly_echo as T  # noqa: E402
from openwhisk_tpu.ops.anomaly import (S_ANOMALY_FLAG, S_EWMA_MS,  # noqa: E402
                                       S_STRAGGLER, S_TOTAL)


def main(argv):
    (T.ECHO_INVOKERS, T.ECHO_ACTIONS, T.ECHO_CONCURRENT, T.ECHO_INFLIGHT,
     T.ECHO_TRICKLE) = (int(x) for x in argv)
    for pkg in (T.JPKG, T.TPKG):
        pkg.core.entity.ConcurrencyLimit.MAX = 4
        ticks, (status, _), cfg = asyncio.run(T._run(pkg))
        last = ticks.scores[-1]
        flagged = np.nonzero(last[S_ANOMALY_FLAG])[0]
        warm = last[S_TOTAL] >= cfg.min_samples
        print(pkg.__name__, dict(
            status=status, ticks=len(ticks.scores), flagged=len(flagged),
            warm=int(warm.sum()),
            warm_median_ewma_ms=(round(float(np.median(
                last[S_EWMA_MS][warm])), 1) if warm.any() else None),
            flagged_ewma_ms=[round(float(last[S_EWMA_MS][i]), 1)
                             for i in flagged],
            flagged_z=[round(float(last[S_STRAGGLER][i]), 2)
                       for i in flagged]), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
