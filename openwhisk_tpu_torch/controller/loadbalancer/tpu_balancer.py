"""The synchronous, device-facing core of the TPU balancer, in PyTorch.

The counterpart of the device half of
`openwhisk_tpu/controller/loadbalancer/tpu_balancer.py::TpuBalancer`: a
fixed invoker registry with its managed/blackbox partitions, the request
row arithmetic of `_build_row`, the concurrency-slot allocator, and one
step that packs releases, health flips and requests into ONE int32 host
buffer, copies it to the device once, runs ONE fused step and copies the
B+1 decision vector back once (`_dispatch_batch` / `_read_back`).

On the card (`device=None` or "cuda") the schedule always runs the CUDA
kernels (`_cuda_pair`); the release and health folds are plain torch ops on
the card. On the CPU (`device="cpu"`) everything is the plain torch
version (`_torch_pair`). The books are updated in place.
"""
from __future__ import annotations

import zlib
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ...models.sharding_policy import (MIN_SLOT_MB, generate_hash,
                                       pairwise_coprimes)
from ...ops.placement import (PlacementState, init_state,
                              make_fused_step_packed, make_release_packed,
                              release_batch, release_batch_vector,
                              resolve_device, schedule_batch,
                              schedule_batch_repair, set_health,
                              unpack_step_output)
from ...ops.placement_cuda import (schedule_batch_cuda,
                                   schedule_batch_repair_cuda,
                                   to_transposed)
from ...utils.ring_buffer import ColumnRing

#: batch-bucket width from which placement_kernel="auto" swaps the scan
#: schedule (and the row-by-row release fold) for the speculate-and-repair
#: schedule (and the vectorized release fold)
REPAIR_MIN_BATCH = 32

#: the fewest book rows: the fleet pads to a power of two, at least this
MIN_PAD = 64

#: request-row index of the concurrency slot
R_CONC_SLOT = 5


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _mod_inverse(step: int, m: int) -> int:
    return pow(step, -1, m) if m > 1 else 0


class _SlotAllocator:
    """Host-side collision-free action->concurrency-slot mapping; slots
    recycle when no in-flight activation references them. When every slot
    is taken, a key lands in `overflow` on a stable CRC32-hashed slot,
    refcounted so release stays balanced (the slot axis does not grow in
    this core)."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.slots: Dict[str, int] = {}
        self.refcount: Dict[str, int] = {}
        self.free: List[int] = list(range(n_slots - 1, -1, -1))
        #: key -> [slot, refcount], pinned at first overflowing acquire
        self.overflow: Dict[str, List[int]] = {}

    def _stable_slot(self, key: str) -> int:
        return zlib.crc32(key.encode()) % self.n_slots

    def acquire(self, key: str) -> int:
        of = self.overflow.get(key)
        if of is not None and not self.free and key not in self.slots:
            of[1] += 1  # still capped: pile on the pinned shared slot
            return of[0]
        if key not in self.slots:
            if not self.free:
                slot = self._stable_slot(key)
                self.overflow[key] = [slot, 1]
                return slot
            self.slots[key] = self.free.pop()
        self.refcount[key] = self.refcount.get(key, 0) + 1
        return self.slots[key]

    def release(self, key: str, slot: Optional[int] = None) -> None:
        """Balance the acquire that returned `slot` (None = best guess)."""
        ded = self.slots.get(key)
        of = self.overflow.get(key)
        use_dedicated = (ded is not None and self.refcount.get(key, 0) > 0
                         and (slot is None or slot == ded or of is None))
        if not use_dedicated and of is not None:
            of[1] -= 1
            if of[1] <= 0:
                self.overflow.pop(key)
            return
        n = self.refcount.get(key, 0) - 1
        if n <= 0:
            self.refcount.pop(key, None)
            s = self.slots.pop(key, None)
            if s is not None:
                self.free.append(s)
        else:
            self.refcount[key] = n


def _check_kernel(placement_kernel: str) -> None:
    if placement_kernel not in ("scan", "repair", "auto"):
        raise ValueError(f"placement_kernel must be scan|repair|auto, got "
                         f"{placement_kernel!r}")


def _torch_pair(placement_kernel: str):
    """(schedule_fn, release_fn, resolved_kernel) of plain torch ops: the
    counterpart of the JAX package's `_xla_pair`. "scan" and "repair" pin
    one pair; "auto" picks per bucket: scan below REPAIR_MIN_BATCH, repair
    at and above it, for the schedule and the release fold alike."""
    _check_kernel(placement_kernel)
    if placement_kernel == "repair":
        return schedule_batch_repair, release_batch_vector, "repair"
    if placement_kernel == "scan":
        return schedule_batch, release_batch, "scan"

    def auto_schedule(state, batch):
        if batch.valid.shape[0] >= REPAIR_MIN_BATCH:
            return schedule_batch_repair(state, batch)
        return schedule_batch(state, batch)

    def auto_release(state, inv, slot, need_mb, max_conc, valid):
        fn = (release_batch_vector if inv.shape[0] >= REPAIR_MIN_BATCH
              else release_batch)
        return fn(state, inv, slot, need_mb, max_conc, valid)

    return auto_schedule, auto_release, "repair"


def _cuda_pair(placement_kernel: str):
    """(schedule_fn, release_fn, resolved_kernel) with the schedule on the
    CUDA kernels: the counterpart of `_pallas_pair`, same scan|repair|auto
    meaning and the same per-bucket branch. The kernels take the [A, N]
    layout as a view of the same books; the release folds are plain torch
    ops on the card."""
    _check_kernel(placement_kernel)

    def sched_scan(st, batch):
        ts, chosen, forced = schedule_batch_cuda(to_transposed(st), batch)
        return to_transposed(ts), chosen, forced

    def sched_repair(st, batch):
        ts, chosen, forced, rounds = schedule_batch_repair_cuda(
            to_transposed(st), batch)
        return to_transposed(ts), chosen, forced, rounds

    if placement_kernel == "scan":
        return sched_scan, release_batch, "scan"
    if placement_kernel == "repair":
        return sched_repair, release_batch_vector, "repair"

    def auto_schedule(state, batch):
        if batch.valid.shape[0] >= REPAIR_MIN_BATCH:
            return sched_repair(state, batch)
        return sched_scan(state, batch)

    _, auto_release, _ = _torch_pair("auto")
    return auto_schedule, auto_release, "repair"


class StepResult(NamedTuple):
    chosen: np.ndarray      # int32[b]: invoker index, -1 = no invokers
    forced: np.ndarray      # bool[b]
    rounds: int             # repair rounds (0 for the scan)
    bucket: int             # padded batch width the step ran at
    rows: np.ndarray        # int32[9, b]: the request rows placed
    slot_keys: List[str]    # the rows' concurrency-slot keys


class BalancerCore:
    """The balancer's device-facing core over a fixed invoker registry.

    `invoker_memory_mb[i]` is invoker i's user memory; every invoker starts
    healthy. Rows come from `build_row`, queue with `submit`, and each
    `step()` places up to `max_batch` of them together with the queued
    releases (`complete`) and health flips (`set_health`)."""

    HEALTH_BATCH = 64

    def __init__(self, invoker_memory_mb: Sequence[int], *, device=None,
                 cluster_size: int = 1, managed_fraction: float = 0.9,
                 blackbox_fraction: float = 0.1, max_batch: int = 256,
                 action_slots: int = 4096, placement_kernel: str = "auto"):
        self.device = resolve_device(device)
        self.memory_mb = [int(m) for m in invoker_memory_mb]
        if not self.memory_mb:
            raise ValueError("BalancerCore needs at least one invoker")
        self.cluster_size = cluster_size
        self.managed_fraction = managed_fraction
        self.blackbox_fraction = blackbox_fraction
        self.max_batch = max_batch
        self.action_slots = action_slots
        self.n_pad = max(MIN_PAD, _next_pow2(len(self.memory_mb)))
        self._recompute_partitions()

        pair = _cuda_pair if self.device.type == "cuda" else _torch_pair
        sched, release, _ = pair(placement_kernel)
        self._packed_fn = make_fused_step_packed(release, sched)
        self._release_packed_fn = make_release_packed(release)
        self.state: PlacementState = init_state(
            len(self.memory_mb), [self._slot_mb(m) for m in self.memory_mb],
            n_pad=self.n_pad, action_slots=action_slots, device=self.device)

        self._healthy = [True] * len(self.memory_mb)
        self._slots = _SlotAllocator(action_slots)
        self._rand_counter = 0
        self._req_ring = ColumnRing(9, max_batch)
        self._queued: deque = deque()     # (slot_key, slot) per queued row
        self._rel_ring = ColumnRing(4, max_batch)
        self._releases: deque = deque()   # (slot_key, slot) per release
        self._health_updates: Dict[int, bool] = {}
        self.counters = {"steps": 0, "placed": 0, "forced": 0,
                         "unplaced": 0}

    # -- registry ----------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.memory_mb)

    def _slot_mb(self, user_memory_mb: int) -> int:
        return max(user_memory_mb // self.cluster_size, MIN_SLOT_MB)

    def _recompute_partitions(self) -> None:
        n = self.n
        self.managed_count = max(int(self.managed_fraction * n), 1)
        self.blackbox_count = max(int(self.blackbox_fraction * n), 1)
        self._steps_managed = pairwise_coprimes(max(1, self.managed_count))
        self._steps_blackbox = pairwise_coprimes(max(1, self.blackbox_count))

    # -- host queues -------------------------------------------------------
    def build_row(self, namespace: str, action_fqn: str, memory_mb: int,
                  max_conc: int, blackbox: bool):
        """One request row in packed-matrix order plus its slot key — the
        JAX balancer's `_build_row` arithmetic: the home hash, the probe
        step's inverse, the forced-rotation mix of `_rand_counter`, and a
        concurrency slot acquired for `f"{fqn}:{mem}"`."""
        n = self.n
        size = self.blackbox_count if blackbox else self.managed_count
        offset = (n - self.blackbox_count) if blackbox else 0
        h = generate_hash(namespace, action_fqn)
        steps = self._steps_blackbox if blackbox else self._steps_managed
        step_inv = _mod_inverse(steps[h % len(steps)], size)
        self._rand_counter += 1
        slot_key = f"{action_fqn}:{memory_mb}"
        req = (offset, size, h % size, step_inv, memory_mb,
               self._slots.acquire(slot_key), max_conc,
               (h ^ (self._rand_counter * 2654435761)) % max(size, 1), 1)
        return req, slot_key

    def submit(self, rows) -> None:
        """Queue rows from `build_row` for the next steps, in order."""
        for req, slot_key in rows:
            self._req_ring.push(req)
            self._queued.append((slot_key, req[R_CONC_SLOT]))

    def complete(self, inv: int, slot: int, mem: int, maxc: int,
                 slot_key: str) -> None:
        """Queue one completion: its capacity returns at the next step."""
        self._rel_ring.push((inv, slot, mem, maxc))
        self._releases.append((slot_key, slot))

    def set_health(self, idx: int, usable: bool) -> None:
        """Queue a health flip for the next step."""
        self._healthy[idx] = bool(usable)
        self._health_updates[idx] = bool(usable)

    # -- packing -----------------------------------------------------------
    @staticmethod
    def _bucket(n: int, cap: int) -> int:
        """Power-of-two batch buckets, at least 8, at most `cap`."""
        b = 8
        while b < n and b < cap:
            b *= 2
        return min(b, cap) if n <= cap else cap

    def _release_packed(self, pad_to: Optional[int] = None) -> np.ndarray:
        """Drain up to max_batch releases into ONE int32[5,R] array (padded
        rows: maxc=1, valid=0) and free their host slots."""
        cap = self.max_batch
        k = min(len(self._releases), cap)
        b = self._bucket(k, cap) if k else 8
        if pad_to is not None:
            b = max(b, pad_to)
        out = np.zeros((5, b), np.int32)
        out[3, k:] = 1
        if k:
            self._rel_ring.pop_into(out[:4], k)
            out[4, :k] = 1
        for _ in range(k):
            key, slot = self._releases.popleft()
            self._slots.release(key, slot)
        return out

    def _health_packed(self) -> np.ndarray:
        """Drain up to HEALTH_BATCH flips into ONE int32[3,H] array; padded
        rows repeat the last flip."""
        b = self.HEALTH_BATCH
        take = list(self._health_updates.items())[:b]
        for k, _ in take:
            del self._health_updates[k]
        out = np.zeros((3, b), np.int32)
        if take:
            pad = b - len(take)
            out[0] = [k for k, _ in take] + [take[-1][0]] * pad
            out[1] = [int(v) for _, v in take] + [int(take[-1][1])] * pad
            out[2] = 1
        return out

    # -- the step ----------------------------------------------------------
    def step(self) -> StepResult:
        """Place up to max_batch queued rows: one packed host buffer, one
        host->device copy, one fused step (release fold, health fold,
        schedule), one device->host copy of the B+1 decision vector. Rows
        that found no invoker give their slot back. With nothing queued
        the step only folds releases and health."""
        b = min(len(self._queued), self.max_batch)
        if b == 0:
            self._idle_fold()
            return StepResult(np.zeros(0, np.int32), np.zeros(0, bool), 0, 0,
                              np.zeros((9, 0), np.int32), [])
        n_rel = min(len(self._releases), self.max_batch)
        bp = max(self._bucket(b, self.max_batch),
                 self._bucket(n_rel, self.max_batch) if n_rel else 8)
        req_np = np.zeros((9, bp), np.int32)
        req_np[1, b:] = 1  # padded columns: size 1, max_conc 1, invalid
        req_np[6, b:] = 1
        self._req_ring.pop_into(req_np, b)
        rel_np = self._release_packed(pad_to=bp)
        health_np = self._health_packed()
        buf = np.concatenate([rel_np.ravel(), health_np.ravel(),
                              req_np.ravel()])
        self.state, out = self._packed_fn(
            self.state, torch.from_numpy(buf).to(self.device),
            rel_np.shape[1], health_np.shape[1], bp)
        chosen, forced, _, rounds = unpack_step_output(out.cpu().numpy())
        chosen, forced = chosen[:b], forced[:b]
        keys = [self._queued.popleft() for _ in range(b)]
        for (key, slot), inv in zip(keys, chosen):
            if inv < 0:  # no invokers: the slot is released
                self._slots.release(key, slot)
        self.counters["steps"] += 1
        self.counters["placed"] += int((chosen >= 0).sum())
        self.counters["forced"] += int(forced.sum())
        self.counters["unplaced"] += int((chosen < 0).sum())
        return StepResult(chosen, forced, rounds, bp, req_np[:, :b],
                          [k for k, _ in keys])

    def _idle_fold(self) -> None:
        if self._releases:
            self.state = self._release_packed_fn(
                self.state,
                torch.from_numpy(self._release_packed()).to(self.device))
        if self._health_updates:
            ups, self._health_updates = self._health_updates, {}
            self.state = set_health(self.state, list(ups.keys()),
                                    list(ups.values()))

    def books(self):
        """Host copies of the books: (free_mb int32[N], conc int32[A, N],
        health bool[N]), conc in the contiguous layout it is held in."""
        return tuple(t.cpu().numpy().copy() for t in (
            self.state.free_mb, self.state.conc_free.T, self.state.health))
