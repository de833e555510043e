"""The sharding placement policy (CPU reference semantics).
A copy of `openwhisk_tpu/models/sharding_policy.py`.

Behavioral rebuild of the scheduling math of
core/controller/.../loadBalancer/ShardingContainerPoolBalancer.scala:
  - deterministic home invoker: hash(namespace, action) % n  (:266-268)
  - probe progression in steps coprime to the fleet size, so every invoker
    is visited exactly once (:50-81, pairwiseCoprimeNumbersUntil)
  - per-invoker capacity as a NestedSemaphore (memory MB x per-action
    concurrency) — acquire on probe, forced acquire on overload (:398-436)
  - managed vs blackbox fleet partitioning by configured fractions
    (:461-468,512-523)
  - horizontal sharding: each controller owns 1/clusterSize of every
    invoker's memory, floored at one action slot (getInvokerSlot :485-499)

This module is pure python/pure function + explicit state: the CPU
sharding balancer's scheduler, and the source of the home hash, the coprime
probe steps and the per-shard memory floor that the balancer core's row
builder uses.
"""
from __future__ import annotations

import math
import random
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..utils.semaphores import NestedSemaphore

MIN_SLOT_MB = 128  # MemoryLimit.MIN: every controller shard can host >=1 action


def generate_hash(namespace: str, action: str) -> int:
    """Stable 31-bit hash of (namespace, fully-qualified action name).

    The reference uses JVM String.hashCode xor; any stable uniform hash
    preserves the semantics (deterministic home per action). CRC32 is stable
    across Python processes and cheap to mirror on device.
    """
    return zlib.crc32(f"{namespace}/{action}".encode()) & 0x7FFFFFFF


def pairwise_coprimes(x: int) -> List[int]:
    """Greedy list of numbers <= x coprime to x and pairwise coprime
    (ref pairwiseCoprimeNumbersUntil): for x=10 -> [1, 3, 7]."""
    out: List[int] = []
    for cur in range(1, x + 1):
        if math.gcd(cur, x) == 1 and all(math.gcd(cur, p) == 1 for p in out):
            out.append(cur)
    return out or [1]


@dataclass
class InvokerSlotState:
    """One invoker as seen by one controller: its share of memory permits."""
    instance: int
    semaphore: NestedSemaphore
    usable: bool = True
    user_memory_mb: int = 2048


@dataclass
class ShardingPolicyState:
    """The balancer's scheduling state for one controller."""
    invokers: List[InvokerSlotState] = field(default_factory=list)
    cluster_size: int = 1
    managed_fraction: float = 0.9
    blackbox_fraction: float = 0.1
    step_sizes_managed: List[int] = field(default_factory=lambda: [1])
    step_sizes_blackbox: List[int] = field(default_factory=lambda: [1])

    # -- setup -------------------------------------------------------------
    @classmethod
    def build(cls, invoker_memories_mb: List[int], cluster_size: int = 1,
              managed_fraction: float = 0.9, blackbox_fraction: float = 0.1
              ) -> "ShardingPolicyState":
        s = cls(cluster_size=cluster_size, managed_fraction=managed_fraction,
                blackbox_fraction=blackbox_fraction)
        for i, mem in enumerate(invoker_memories_mb):
            s.invokers.append(InvokerSlotState(
                i, NestedSemaphore(s.invoker_slot_mb(mem)), True, mem))
        s._recompute_steps()
        return s

    def invoker_slot_mb(self, user_memory_mb: int) -> int:
        """getInvokerSlot (:485-499): this controller's share, floored at one
        minimal action slot (knowingly overcommitting when clusterSize >
        memory/minSlot)."""
        share = user_memory_mb // self.cluster_size
        return max(share, MIN_SLOT_MB)

    def _recompute_steps(self) -> None:
        n = len(self.invokers)
        self.step_sizes_managed = pairwise_coprimes(max(1, self.managed_count))
        self.step_sizes_blackbox = pairwise_coprimes(max(1, self.blackbox_count))

    # -- fleet partitioning (:461-468) --------------------------------------
    # numInvokers(fraction, n) = max(n * fraction, 1).toInt — computed
    # independently per class; the slices may overlap for small fleets,
    # exactly as in the reference.
    @property
    def blackbox_count(self) -> int:
        n = len(self.invokers)
        if n == 0:
            return 0
        return max(int(self.blackbox_fraction * n), 1)

    @property
    def managed_count(self) -> int:
        n = len(self.invokers)
        if n == 0:
            return 0
        return max(int(self.managed_fraction * n), 1)

    def partition(self, blackbox: bool) -> Tuple[int, int]:
        """(offset, size) of the fleet slice for this workload class:
        managed = first managed_count, blackbox = last blackbox_count."""
        n = len(self.invokers)
        if n == 0:
            return 0, 0
        if blackbox:
            return n - self.blackbox_count, self.blackbox_count
        return 0, self.managed_count

    # -- elasticity (:512-584) ----------------------------------------------
    def update_invokers(self, invoker_memories_mb: List[int],
                        usable: Optional[List[bool]] = None) -> None:
        """Grow in place / refresh capacities (shrink is by health only)."""
        for i, mem in enumerate(invoker_memories_mb):
            if i < len(self.invokers):
                inv = self.invokers[i]
                inv.user_memory_mb = mem
                if usable is not None:
                    inv.usable = usable[i]
            else:
                self.invokers.append(InvokerSlotState(
                    i, NestedSemaphore(self.invoker_slot_mb(mem)), True, mem))
                if usable is not None:
                    self.invokers[i].usable = usable[i]
        self._recompute_steps()

    def update_cluster(self, cluster_size: int) -> None:
        """Re-shard capacity when controllers join/leave (:561-584): rebuild
        semaphores at the new share (in-flight permits are intentionally
        reset, exactly as the reference swaps in fresh semaphores)."""
        if cluster_size != self.cluster_size:
            self.cluster_size = cluster_size
            for inv in self.invokers:
                inv.semaphore = NestedSemaphore(
                    self.invoker_slot_mb(inv.user_memory_mb))

    def set_health(self, instance: int, usable: bool) -> None:
        if 0 <= instance < len(self.invokers):
            self.invokers[instance].usable = usable


def schedule(state: ShardingPolicyState, namespace: str, action: str,
             memory_mb: int, max_concurrent: int = 1, blackbox: bool = False,
             rng: Optional[random.Random] = None,
             forced_rand: Optional[int] = None
             ) -> Tuple[Optional[int], bool]:
    """One placement decision (ref schedule :398-436 + publish :257-317).

    Returns (invoker_instance | None, forced): probes the home invoker and
    then steps through the partition in a coprime progression, acquiring the
    first free slot; on total overload, forces a random usable invoker; with
    no usable invokers at all, returns None.
    """
    offset, size = state.partition(blackbox)
    if size == 0:
        return None, False
    h = generate_hash(namespace, action)
    steps = state.step_sizes_blackbox if blackbox else state.step_sizes_managed
    home = h % size
    step = steps[h % len(steps)]
    action_key = f"{action}:{memory_mb}"  # per-(action,mem) concurrency pool

    idx = home
    for _ in range(size):
        inv = state.invokers[offset + idx]
        if inv.usable and inv.semaphore.try_acquire_concurrent(
                action_key, max_concurrent, memory_mb):
            return inv.instance, False
        idx = (idx + step) % size

    # overload: force a random usable invoker (:417-424). With `forced_rand`
    # the choice is a deterministic rotation — the same rule the device
    # kernel uses, so host-passed randomness keeps both paths in lockstep.
    if forced_rand is not None:
        best = None
        for i in range(size):
            inv = state.invokers[offset + i]
            if inv.usable:
                r = (i - forced_rand) % size
                if best is None or r < best[0]:
                    best = (r, inv)
        if best is None:
            return None, False
        chosen = best[1]
    else:
        usable = [state.invokers[offset + i] for i in range(size)
                  if state.invokers[offset + i].usable]
        if not usable:
            return None, False
        rng = rng or random
        chosen = usable[rng.randrange(len(usable))]
    chosen.semaphore.force_acquire_concurrent(action_key, max_concurrent, memory_mb)
    return chosen.instance, True


def release(state: ShardingPolicyState, invoker_instance: int, action: str,
            memory_mb: int, max_concurrent: int = 1) -> None:
    """Release the slot on completion ack (ref releaseInvoker)."""
    if 0 <= invoker_instance < len(state.invokers):
        state.invokers[invoker_instance].semaphore.release_concurrent(
            f"{action}:{memory_mb}", max_concurrent, memory_mb)
