"""Host utilities: copies of `openwhisk_tpu/utils/`'s modules of the same
names."""
from .transaction import TransactionId, LogMarkerToken
from .logging import Logging, MetricEmitter, PrintLogging
from .semaphores import ForcibleSemaphore, ResizableSemaphore, NestedSemaphore
from .ring_buffer import RingBuffer
from .scheduler import Scheduler
from .config import config_from_env, load_config

__all__ = [
    "TransactionId", "LogMarkerToken", "Logging", "PrintLogging", "MetricEmitter",
    "ForcibleSemaphore", "ResizableSemaphore", "NestedSemaphore",
    "RingBuffer", "Scheduler", "config_from_env", "load_config",
]
