"""Device ops of the port: the placement step (`placement`, with the hand
CUDA kernels in `placement_cuda`), rate admission (`throttle`), the kernel
profiler and the device planes' folds (`telemetry`, `anomaly`,
`decision_quality`).

Exports the names the JAX package's `openwhisk_tpu.ops` does.
"""
from .placement import (PlacementState, RequestBatch, init_state,
                        release_batch, schedule_batch, set_health)
from .profiler import KernelProfiler, ProfilingConfig
from .throttle import TokenBucketState, admit_batch, init_buckets

__all__ = [n for n in dir() if not n.startswith("_")]
