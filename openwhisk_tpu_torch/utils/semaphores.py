"""Capacity-model semaphores.

Behavioral rebuild of the reference's semaphore family, which is the load
balancer's capacity model (SURVEY §2.3):
  - ForcibleSemaphore  (common/scala/.../common/ForcibleSemaphore.scala):
    non-blocking tryAcquire + forceAcquire that may over-commit (go negative).
  - ResizableSemaphore (common/scala/.../common/ResizableSemaphore.scala):
    permits that shrink by `reduction_size` whenever a full container's worth
    of concurrency slots becomes free again.
  - NestedSemaphore    (common/scala/.../common/NestedSemaphore.scala:29-116):
    two-level permits — outer memory permits, inner per-action concurrency
    permits. Acquiring a slot for an action with maxConcurrent C either takes
    a spare concurrency slot of an existing container (no memory) or takes
    memory for a new container and mints C-1 spare concurrency slots.

The reference uses lock-free CAS loops; here a per-object lock suffices — all
hot-path scheduling state in this framework is either asyncio-confined or
device-resident (functional JAX arrays, race-free by construction).
"""
from __future__ import annotations

import threading
from typing import Dict, Generic, Hashable, Tuple, TypeVar

T = TypeVar("T", bound=Hashable)


class ForcibleSemaphore:
    """Non-blocking semaphore that can be forced into over-commit."""

    def __init__(self, max_allowed: int):
        if max_allowed <= 0:
            raise ValueError("max_allowed must be > 0")
        self._lock = threading.Lock()
        self._free = max_allowed

    @property
    def available_permits(self) -> int:
        return self._free

    def try_acquire(self, acquires: int = 1) -> bool:
        if acquires <= 0:
            raise ValueError("acquires must be > 0")
        with self._lock:
            if self._free >= acquires:
                self._free -= acquires
                return True
            return False

    def force_acquire(self, acquires: int = 1) -> None:
        """Acquire even past zero — used for forced placement on overload
        (ref ShardingContainerPoolBalancer.scala:417-424)."""
        if acquires <= 0:
            raise ValueError("acquires must be > 0")
        with self._lock:
            self._free -= acquires

    def release(self, acquires: int = 1) -> None:
        if acquires <= 0:
            raise ValueError("acquires must be > 0")
        with self._lock:
            self._free += acquires


class ResizableSemaphore:
    """Semaphore whose pool shrinks by `reduction_size` when a full
    container's worth of permits is free again.

    release() returns (memory_releasable, empty): memory_releasable is True
    when a reduction happened (one container fully idle -> its memory permits
    can be returned to the outer semaphore); empty is True when no permits
    remain tracked for the action (entry can be dropped).
    """

    def __init__(self, initial_permits: int, reduction_size: int):
        self._lock = threading.Lock()
        self._free = initial_permits
        self._reduction = reduction_size

    @property
    def available_permits(self) -> int:
        return self._free

    def try_acquire(self, acquires: int = 1) -> bool:
        with self._lock:
            if self._free >= acquires:
                self._free -= acquires
                return True
            return False

    def release(self, acquires: int = 1, maybe_reduce: bool = False) -> Tuple[bool, bool]:
        with self._lock:
            self._free += acquires
            reduced = False
            if maybe_reduce and self._free >= self._reduction:
                self._free -= self._reduction
                reduced = True
            return reduced, self._free == 0


class NestedSemaphore(ForcibleSemaphore, Generic[T]):
    """Two-level (memory x per-action-concurrency) permits.

    Ref semantics (NestedSemaphore.scala:29-116):
      try_acquire_concurrent(action, C, mem):
        C == 1       -> plain memory try_acquire(mem)
        C  > 1       -> spare concurrency slot for `action` if present (free);
                        else memory for a new container + mint C-1 spares.
      force_acquire_concurrent: same but memory acquisition is forced.
      release_concurrent(action, C, mem):
        C == 1       -> release(mem)
        C  > 1       -> return one concurrency slot; when C slots are free
                        again, one container is idle -> release its memory.
    """

    def __init__(self, max_allowed: int):
        super().__init__(max_allowed)
        self._actions_lock = threading.Lock()
        self._action_slots: Dict[T, ResizableSemaphore] = {}

    def _slots_for(self, actionid: T, max_concurrent: int) -> ResizableSemaphore:
        with self._actions_lock:
            s = self._action_slots.get(actionid)
            if s is None:
                s = ResizableSemaphore(0, max_concurrent)
                self._action_slots[actionid] = s
            return s

    def concurrent_slots_available(self, actionid: T) -> int:
        with self._actions_lock:
            s = self._action_slots.get(actionid)
        return s.available_permits if s else 0

    def try_acquire_concurrent(self, actionid: T, max_concurrent: int,
                               memory_permits: int) -> bool:
        if max_concurrent == 1:
            return self.try_acquire(memory_permits)
        return self._try_or_force(actionid, max_concurrent, memory_permits, force=False)

    def force_acquire_concurrent(self, actionid: T, max_concurrent: int,
                                 memory_permits: int) -> None:
        if max_concurrent == 1:
            self.force_acquire(memory_permits)
        else:
            self._try_or_force(actionid, max_concurrent, memory_permits, force=True)

    def _try_or_force(self, actionid: T, max_concurrent: int, memory_permits: int,
                      force: bool) -> bool:
        slots = self._slots_for(actionid, max_concurrent)
        if slots.try_acquire(1):
            return True
        if force:
            self.force_acquire(memory_permits)
            slots.release(max_concurrent - 1, maybe_reduce=False)
            return True
        if self.try_acquire(memory_permits):
            slots.release(max_concurrent - 1, maybe_reduce=False)
            return True
        return False

    def release_concurrent(self, actionid: T, max_concurrent: int,
                           memory_permits: int) -> None:
        if max_concurrent == 1:
            self.release(memory_permits)
            return
        slots = self._slots_for(actionid, max_concurrent)
        memory_releasable, empty = slots.release(1, maybe_reduce=True)
        if memory_releasable:
            self.release(memory_permits)
        if empty:
            with self._actions_lock:
                s = self._action_slots.get(actionid)
                if s is slots and s.available_permits == 0:
                    del self._action_slots[actionid]
