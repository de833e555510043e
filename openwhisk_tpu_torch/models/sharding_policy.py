"""The row builder's share of the sharding placement policy.

A copy of what the balancer core needs from
`openwhisk_tpu/models/sharding_policy.py` (the home hash, the coprime probe
steps and the per-shard memory floor), kept here so the port never imports
the JAX package.
"""
from __future__ import annotations

import math
import zlib
from typing import List

MIN_SLOT_MB = 128  # MemoryLimit.MIN: every controller shard can host >=1 action


def generate_hash(namespace: str, action: str) -> int:
    """Stable 31-bit hash of (namespace, fully-qualified action name):
    CRC32, stable across processes."""
    return zlib.crc32(f"{namespace}/{action}".encode()) & 0x7FFFFFFF


def pairwise_coprimes(x: int) -> List[int]:
    """Greedy list of numbers <= x coprime to x and pairwise coprime
    (ref pairwiseCoprimeNumbersUntil): for x=10 -> [1, 3, 7]."""
    out: List[int] = []
    for cur in range(1, x + 1):
        if math.gcd(cur, x) == 1 and all(math.gcd(cur, p) == 1 for p in out):
            out.append(cur)
    return out or [1]
