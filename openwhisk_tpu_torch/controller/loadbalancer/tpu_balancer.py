"""The TPU balancer, in PyTorch: placement decisions computed on the card.

The counterpart of `openwhisk_tpu/controller/loadbalancer/tpu_balancer.py`,
in two parts that share one device half:

  `BalancerCore` — the synchronous, device-facing core over a fixed invoker
      registry: `build_row` / `submit` / `complete` / `set_health` and one
      `step()` at a time.
  `TpuBalancer`  — the LoadBalancerProvider: `publish` / `publish_many`
      over a message bus, completion acks, invoker supervision, fleet and
      slot-axis growth, device rate admission, and a pipelined dispatch /
      readback loop:

        publish() ──> request ring ──┐ (adaptive window: flush at max_batch
                                     │  or after batch_window seconds)
        completion acks ──> releases ┤
        health transitions ─> flips  ┤
                                     ▼
            one device step: release fold ∘ health fold ∘ schedule
                                     │ (readback on a worker thread)
             assignments ──> ActivationMessage dispatch over the bus

The host planes ride the same loop as the JAX package's: dispatches go out
through the coalescing producer without a task a row (`_row_placed`'s
`send_nowait`), each step's input digest and decisions file into the
flight recorder, the device dispatch sits inside the host observatory's
GC bracket, and the trace store gets each batch's `device_dispatch` span.
So do the device planes: completion events fold into the telemetry
accumulator on the card on the dispatch cadence (at least
`TELEMETRY_FOLD_MIN` events a fold, the rest on the idle fold and the
supervision tick), the 1 Hz supervision tick runs the telemetry burn
rates, the anomaly step and the HBM watermarks, and the kernel profiler
wraps the step entry points and times each dispatch phase. With the
placement quality plane on (`CONFIG_whisk_placementQuality_enabled`,
off by default), every `shadow_every_n`-th batch first runs a
decision-only shadow pass (the penalized schedule of the production
family on a copy of the books, the anomaly plane's straggler flags as
the penalty), and every batch is scored on the post-commit books right
after the step; the score's summary row comes back with the step's
readback.

HA rides the same path as the JAX package's: an active/standby standby
refuses placement and journals nothing, an active stamps its fence epoch
on every dispatch and journal record; in partition mode (a ring
attached) a row of a partition this controller does not own is refused,
each pending row carries its `(partition, epoch)` into the batch
record's `parts`/`pe`, a batch's non-blocking tail past
`spillover_depth` forwards to a peer, and `absorb_partitions` replays a
previous owner's journal tail, filtered to the partitions claimed,
through the same kernels on top of the live books.

The device half: each step packs releases, health flips and requests into
ONE int32 host buffer, copies it to the device once, runs ONE fused step
and copies the B+1 decision vector back once. On the card (`device=None`
or "cuda") the schedule always runs the CUDA kernels (`_cuda_pair`); the
release and health folds are plain torch ops on the card. On the CPU
(`device="cpu"`) everything is the plain torch version (`_torch_pair`).
With a fleet mesh (`fleet_mesh`, `parallel/fleet_mesh.py`) the books are
S per-shard books, one process drives every shard, and the step is the
mesh's sharded torch ops (`fleet_pair`): placement, books, journal and
snapshot stay bit-exact with the single device. The books are updated
in place.

The path settings are the JAX package's `PlacementPathConfig`
(`CONFIG_whisk_loadBalancer_*`, constructor arguments first). With
`prewarm` on (the default) a balancer on the card builds and loads its
kernels off the event loop from its constructor (`placement_cuda.prewarm`,
one job a process) and then warms its step on dummy books there; the
constructor itself runs the 1 Hz tick's device programs once. A flush
waits for the job's future without blocking the loop, a journal replay or
an absorb waits for the same job, and a failed build fails every
dispatch. With it off the first dispatch builds them on the loop.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ...core.entity import ExecutableWhiskAction, InvokerInstanceId
from ...messaging.coalesce import export_coalesce_gauges
from ...messaging.message import ActivationMessage
from ...messaging.tcp import export_bus_gauges
from ...models.sharding_policy import (MIN_SLOT_MB, generate_hash,
                                       pairwise_coprimes)
from ...ops.anomaly import (S_EWMA_MS, S_STRAGGLER_FLAG, init_anomaly,
                            make_anomaly_step)
from ...ops.decision_quality import (S_DIVERGENT, S_IMBALANCE_COV,
                                     S_REGRET_SUM_MS, pad_quality_state)
from ...ops.placement import (PlacementState, RequestBatch,
                              empty_books_like, init_state,
                              make_fused_admit_step_packed,
                              make_fused_step_packed, make_release_packed,
                              make_shadow_admit_step_packed,
                              make_shadow_step_packed, release_batch,
                              release_batch_vector, resolve_device,
                              schedule_batch, schedule_batch_repair,
                              set_health, unpack_chosen, unpack_step_output)
from ...ops import placement_cuda
from ...ops.placement_cuda import (release_batch_cuda, schedule_batch_cuda,
                                   schedule_batch_repair_cuda,
                                   to_transposed)
from ...ops.profiler import pow2_statics
from ...ops.telemetry import init_telemetry, record_packed
from ...ops.throttle import init_buckets
from ...parallel.fleet_mesh import (
    empty_sharded_books_like, fleet_pair, make_fleet_fused_admit_step_packed,
    make_fleet_fused_step_packed, make_fleet_mesh, make_fleet_release_packed,
    make_fleet_repair_schedule, make_fleet_shadow_admit_step_packed,
    make_fleet_shadow_step_packed, mesh_topology)
from ...parallel.sharded_state import (ShardedState, gather_state,
                                       shard_state, sharded_set_free,
                                       sharded_set_health)
from ...utils.config import load_config
from ...utils.eventlog import GLOBAL_EVENT_LOG
from ...utils.hostprof import GLOBAL_HOST_OBSERVATORY
from ...utils.ring_buffer import ColumnRing
from ...utils.tracing import export_tracing_gauges, trace_id_of
from ...utils.waterfall import (STAGE_BATCH_ASSEMBLE, STAGE_DEVICE_DISPATCH,
                                STAGE_DEVICE_READBACK, STAGE_PUBLISH_ENQUEUE,
                                STAGE_SPILL_FORWARD)
from .base import (HEALTHY, CommonLoadBalancer, InvokerHealth,
                   LoadBalancerException, LoadBalancerThrottleException)
from .flight_recorder import BatchRecord, free_slot_histogram, occupancy_json
from .journal import decode_array, encode_array
from .supervision import InvokerPool

#: batch-bucket width from which placement_kernel="auto" swaps the scan
#: schedule (and the row-by-row release fold) for the speculate-and-repair
#: schedule (and the vectorized release fold)
REPAIR_MIN_BATCH = 32

#: the fewest book rows: the fleet pads to a power of two, at least this
MIN_PAD = 64

#: request-row index of the concurrency slot
R_CONC_SLOT = 5


@dataclass(frozen=True)
class PlacementPathConfig:
    """`CONFIG_whisk_loadBalancer_*` hot-path knobs (constructor arguments
    override the env), the JAX package's fields and defaults.

    The port honours six of them:
      placement_kernel: which batch algorithm schedules a micro-batch:
        "scan", "repair", or "auto" (the scan below REPAIR_MIN_BATCH rows,
        the repair from there), on the card's kernels or the CPU's plain
        versions alike.
      adaptive_window: under arrival pressure, trade a bounded
        accumulation delay (ADAPTIVE_WINDOW_MS) for bigger micro-batches;
        off = the eager/window policy alone.
      batch_publish: advertise the batch-shaped publish SPI to the front
        end (`publish_many`); off routes it through the serial path.
      prewarm: the early build. On the card, the constructor runs the
        1 Hz tick's device programs once and starts one worker-thread
        job that builds (nvcc) and loads every placement kernel, resolves
        its launcher (`placement_cuda.prewarm`) and warms the step on
        dummy books; a flush waits for it without blocking the event
        loop, and a journal replay or an absorb waits for the same job.
        A build that fails fails every dispatch. Off = the legacy build
        on demand: the first dispatch builds the kernels on the event
        loop. The JAX package's successor-bucket ladder (compiles of the
        next XLA shapes) has no counterpart: the port compiles no
        per-shape program, and a bucket's first step costs what a repeat
        costs within about 1 ms, the spread of the repeats (PERF.md §6).

      fleet_mesh: shard the invoker axis of the books over a ('fleet',)
        mesh of devices (parallel/fleet_mesh.py), one process driving
        every shard; placement stays bit-exact with the single device.
      fleet_shards: the mesh's shard count (a power of two; 0 = every
        visible device, rounded down to a power of two). Shards share a
        card when there are fewer cards than shards.

    The others name an XLA or Pallas choice and change nothing in the
    port; they are parsed so that one environment configures both
    packages. `kernel` picks XLA or Pallas: the port has one backend a
    device (the CUDA kernels on the card, the plain versions on the CPU,
    the sharded torch ops on a mesh), so neither it nor
    `calibrate_kernel` (the measured XLA/Pallas pick, per shard on a
    mesh) has anything to choose. `donate_state` and `ring_assembly` are
    what the port always does (the books are updated in place; rows are
    packed from column rings)."""
    placement_kernel: str = "auto"   # scan | repair | auto
    kernel: str = "auto"             # xla | pallas | auto
    donate_state: bool = True
    ring_assembly: bool = True
    prewarm: bool = True
    calibrate_kernel: str = "auto"   # auto | force | off
    adaptive_window: bool = True
    fleet_mesh: bool = False
    fleet_shards: int = 0
    batch_publish: bool = True


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _mod_inverse(step: int, m: int) -> int:
    return pow(step, -1, m) if m > 1 else 0


class _SlotAllocator:
    """Host-side collision-free action->concurrency-slot mapping; slots
    recycle when no in-flight activation references them.

    Saturation: the TpuBalancer grows the slot axis before this allocator
    runs dry (`_ensure_slot_capacity`; BalancerCore never grows it); only
    past the hard cap does a key land in `overflow` — a stable CRC32-hashed
    slot shared with whatever dedicated key owns it, refcounted so release
    stays balanced."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.slots: Dict[str, int] = {}
        self.refcount: Dict[str, int] = {}
        self.free: List[int] = list(range(n_slots - 1, -1, -1))
        #: key -> [slot, refcount]; the slot is pinned at first acquire so
        #: every in-flight activation of the key releases the slot it took,
        #: even if n_slots grows (which would move the CRC32 residue)
        self.overflow: Dict[str, List[int]] = {}

    def _stable_slot(self, key: str) -> int:
        return zlib.crc32(key.encode()) % self.n_slots

    @property
    def saturated(self) -> bool:
        return not self.free

    def needs_slot(self, key: str) -> bool:
        """Would acquiring `key` want a slot it doesn't own? (Overflowed
        keys count: their next acquire migrates to a dedicated slot if one
        is free.)"""
        return key not in self.slots

    def lookup(self, key: str) -> int:
        """Best-effort slot for `key` (fallback when a release arrives
        without its acquire-time slot)."""
        slot = self.slots.get(key)
        if slot is not None:
            return slot
        of = self.overflow.get(key)
        return of[0] if of is not None else self._stable_slot(key)

    def grow(self, new_n: int) -> None:
        """Extend the slot axis (the balancer grew the books to match).
        Existing assignments — pinned overflow slots included — stay put;
        only fresh capacity is added."""
        if new_n <= self.n_slots:
            raise ValueError(f"slot axis grows only: {self.n_slots} -> {new_n}")
        self.free = list(range(new_n - 1, self.n_slots - 1, -1)) + self.free
        self.n_slots = new_n

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


def _scan_valid(state, batch, penalty=None):
    """`schedule_batch` over the batch's valid rows alone, scattered back
    into the bucket (an invalid row places nothing: -1, not forced, the
    books untouched). The plain scan visits every row with a row's worth of
    small ops, so on the CPU balancer a bucket's padding cost its loop as
    much as a request. Bit-exact with `schedule_batch`."""
    b = batch.valid.shape[0]
    rows = torch.nonzero(batch.valid).flatten()
    if rows.numel() == b:
        return schedule_batch(state, batch, penalty)
    state, c, f = schedule_batch(
        state, RequestBatch(*(col[rows] for col in batch)), penalty)
    chosen = torch.full((b,), -1, dtype=torch.int32)
    forced = torch.zeros((b,), dtype=torch.bool)
    chosen[rows], forced[rows] = c, f
    return state, chosen, forced


def _release_valid(state, inv, slot, need_mb, max_conc, valid):
    """`release_batch` over the valid rows alone, in order (an invalid row
    folds nothing): the CPU balancer's fold, as `_scan_valid`."""
    rows = torch.nonzero(valid).flatten()
    if rows.numel() == valid.shape[0]:
        return release_batch(state, inv, slot, need_mb, max_conc, valid)
    return release_batch(state, inv[rows], slot[rows], need_mb[rows],
                         max_conc[rows], valid[rows])


def _torch_pair(placement_kernel: str):
    """(schedule_fn, release_fn, resolved_kernel) of plain torch ops: the
    counterpart of the JAX package's `_xla_pair`. "scan" and "repair" pin
    one pair; "auto" picks per bucket: scan below REPAIR_MIN_BATCH, repair
    at and above it, for the schedule and the release fold alike. The
    sequential loops skip a bucket's padding (`_scan_valid`)."""
    _check_kernel(placement_kernel)
    if placement_kernel == "repair":
        return schedule_batch_repair, release_batch_vector, "repair"
    if placement_kernel == "scan":
        return _scan_valid, _release_valid, "scan"

    def auto_schedule(state, batch):
        if batch.valid.shape[0] >= REPAIR_MIN_BATCH:
            return schedule_batch_repair(state, batch)
        return _scan_valid(state, batch)

    def auto_release(state, inv, slot, need_mb, max_conc, valid):
        fn = (release_batch_vector if inv.shape[0] >= REPAIR_MIN_BATCH
              else _release_valid)
        return fn(state, inv, slot, need_mb, max_conc, valid)

    return auto_schedule, auto_release, "repair"


def _sched_scan(st, batch, penalty=None):
    """The scan kernel on the books' [N, A] view (the kernel takes the
    [A, N] layout of the same tensors)."""
    ts, chosen, forced = schedule_batch_cuda(to_transposed(st), batch,
                                             penalty)
    return to_transposed(ts), chosen, forced


def _sched_repair(st, batch, penalty=None):
    """The repair kernel on the books' [N, A] view."""
    ts, chosen, forced, rounds = schedule_batch_repair_cuda(
        to_transposed(st), batch, penalty)
    return to_transposed(ts), chosen, forced, rounds


def _release_fold(st, inv, slot, need_mb, max_conc, valid):
    """The release kernel on the books' [N, A] view."""
    return release_batch_cuda(st, inv, slot, need_mb, max_conc, valid)


def _cuda_pair(placement_kernel: str):
    """(schedule_fn, release_fn, resolved_kernel) with the schedule on the
    CUDA kernels: the counterpart of `_pallas_pair`, same scan|repair|auto
    meaning and the same per-bucket branch. The release fold is one launch
    of the release kernel at every bucket (bit-exact with both plain folds):
    in torch ops it held the event loop for milliseconds a step, and at 32
    rows and more read the residue back on the host."""
    _check_kernel(placement_kernel)
    if placement_kernel == "scan":
        return _sched_scan, _release_fold, "scan"
    if placement_kernel == "repair":
        return _sched_repair, _release_fold, "repair"

    def auto_schedule(state, batch):
        if batch.valid.shape[0] >= REPAIR_MIN_BATCH:
            return _sched_repair(state, batch)
        return _sched_scan(state, batch)

    return auto_schedule, _release_fold, "repair"


def device_pair(device: torch.device, placement_kernel: str):
    """The (schedule, release, resolved) pair for the books' device: the
    CUDA kernels on the card, the plain torch versions on the CPU."""
    pair = _cuda_pair if device.type == "cuda" else _torch_pair
    return pair(placement_kernel)


def penalized_schedule(device: torch.device, resolved: str):
    """`schedule(state, batch, penalty)` for the quality plane's shadow
    pass: the penalized variant of the production family, as the JAX
    package picks it — the repair wherever the pair resolved "repair"
    (which "auto" does, so the shadow runs the repair at every bucket),
    else the scan. The CUDA kernel on the card, the plain version on the
    CPU."""
    if device.type != "cuda":
        return schedule_batch_repair if resolved == "repair" else \
            schedule_batch
    return _sched_repair if resolved == "repair" else _sched_scan


def _book_shapes(state) -> tuple:
    """Every tensor shape of single-device or sharded books."""
    shards = state.shards if isinstance(state, ShardedState) else (state,)
    return tuple(tuple(t.shape) for s in shards for t in s)


def _empty_books_like(state):
    return (empty_sharded_books_like(state)
            if isinstance(state, ShardedState) else empty_books_like(state))


def bucket(n: int, cap: int) -> int:
    """Power-of-two batch buckets, at least 8, at most `cap`."""
    b = 8
    while b < n and b < cap:
        b *= 2
    return min(b, cap) if n <= cap else cap


def pack_releases(ring: ColumnRing, queue: deque, slots: _SlotAllocator,
                  cap: int, pad_to: Optional[int] = None) -> np.ndarray:
    """Drain up to `cap` queued releases (int columns in `ring`, their
    (slot_key, slot) in `queue`) into ONE int32[5,R] array — padded rows:
    maxc=1, valid=0 — and free their host slots."""
    k = min(len(queue), cap)
    b = bucket(k, cap) if k else 8
    if pad_to is not None:
        b = max(b, pad_to)
    out = np.zeros((5, b), np.int32)
    out[3, k:] = 1
    if k:
        ring.pop_into(out[:4], k)
        out[4, :k] = 1
    for _ in range(k):
        key, slot = queue.popleft()
        slots.release(key, slot)
    return out


def pack_health(updates: Dict[int, bool], h: int) -> np.ndarray:
    """Drain up to `h` queued health flips into ONE int32[3,H] array;
    padded rows repeat the last flip (the fold allows duplicates with
    equal values)."""
    take = list(updates.items())[:h]
    for k, _ in take:
        del updates[k]
    out = np.zeros((3, h), np.int32)
    if take:
        pad = h - len(take)
        out[0] = [k for k, _ in take] + [take[-1][0]] * pad
        out[1] = [int(v) for _, v in take] + [int(take[-1][1])] * pad
        out[2] = 1
    return out


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

        sched, release, _ = device_pair(self.device, placement_kernel)
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
    _bucket = staticmethod(bucket)

    def _release_packed(self, pad_to: Optional[int] = None) -> np.ndarray:
        return pack_releases(self._rel_ring, self._releases, self._slots,
                             self.max_batch, pad_to)

    def _health_packed(self) -> np.ndarray:
        return pack_health(self._health_updates, self.HEALTH_BATCH)

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


class _Readback(NamedTuple):
    """A dispatched step's results on their way to the host: host tensors
    (pinned on the card, written by copies enqueued right after the step)
    and the event that marks them complete (None on the CPU)."""
    out: torch.Tensor          # int32[B + 1] packed decisions
    books: torch.Tensor        # int32[N] free_mb after the step
    event: Optional[object]    # torch.cuda.Event
    #: float32[N_SUMMARY] the quality scorer's row for the step, or None
    summary: Optional[torch.Tensor] = None


class TpuBalancer(CommonLoadBalancer):
    """The LoadBalancerProvider with placement on the card (the JAX
    package's `TpuBalancer`, the same constructor names for what it keeps).

    Invokers register by their first ping (the supervision pool's status
    changes grow the registry, the invoker axis and the books); `publish`
    and `publish_many` queue request rows that a flush policy dispatches as
    one fused device step each, with up to `pipeline_depth` steps in
    flight; completion acks queue releases that fold into the next step.

    `device` None means the CUDA card (and raises without one); "cpu" runs
    the plain torch versions. A step that fails leaves the books rebuilt at
    full capacity (forced timeouts self-heal the holds): nothing falls back
    to another device or kernel.

    `fleet_mesh` and `fleet_shards` (or `mesh=`, a `FleetMesh`) shard the
    books over a fleet mesh on the devices `device` names. The JAX
    package's per-shard calibration (its XLA/Pallas pick at the per-shard
    shape) is not ported: the port has one backend a device."""

    #: the bounded accumulation delay a loaded balancer trades for batch
    #: size, and the least batch a window must be expected to gather
    ADAPTIVE_WINDOW_MS = 8.0
    ADAPTIVE_MIN_BATCH = 4
    #: request-tuple field indices (row order of the packed matrix)
    R_NEED_MB, R_CONC_SLOT, R_MAX_CONC = 4, 5, 6
    #: namespace-bucket axis for device rate admission, and its tail
    #: sub-range shared by namespaces past the dedicated ones
    RATE_NS_BUCKETS = 1024
    RATE_NS_SHARED_BUCKETS = 64
    #: health flips drained per device step (leftovers roll over)
    HEALTH_BATCH = 64
    #: below this readback round trip the device counts as fast: eager
    #: dispatch of an idle balancer wins; above it, windowed batching
    RTT_FAST_MS = 5.0
    #: don't pay a telemetry-fold dispatch on the hot path for fewer than
    #: this many buffered completion events; the supervision tick and the
    #: scrape-time drain pick up the tail within a second
    TELEMETRY_FOLD_MIN = 64

    _bucket = staticmethod(bucket)

    def __init__(self, messaging_provider, controller_instance, logger=None,
                 cluster_size: int = 1, managed_fraction: float = 0.9,
                 blackbox_fraction: float = 0.1, batch_window: float = 0.002,
                 max_batch: int = 256, action_slots: int = 4096,
                 max_action_slots: int = 65536, initial_pad: int = 64,
                 pipeline_depth: int = 4,
                 rate_limit_per_minute: Optional[int] = None,
                 placement_kernel: Optional[str] = None,
                 adaptive_window: Optional[bool] = None,
                 batch_publish: Optional[bool] = None,
                 prewarm: Optional[bool] = None,
                 mesh=None, fleet_mesh: Optional[bool] = None,
                 fleet_shards: Optional[int] = None,
                 device=None, metrics=None, profiler=None, anomaly=None,
                 quality=None):
        path_cfg = load_config(PlacementPathConfig, env_path="load_balancer")
        #: fleet-mesh mode (CONFIG_whisk_loadBalancer_fleetMesh): build the
        #: ('fleet',) mesh here unless the caller handed one in (the legacy
        #: mesh= constructor path keeps working; its axis name is adopted
        #: whatever it is). Default OFF = the single-device path, bit-exact.
        self.fleet_mesh = (fleet_mesh if fleet_mesh is not None
                           else path_cfg.fleet_mesh)
        if mesh is None and self.fleet_mesh:
            shards_cfg = (fleet_shards if fleet_shards is not None
                          else path_cfg.fleet_shards)
            mesh = make_fleet_mesh(shards_cfg or None, device=device)
        self.mesh = mesh
        #: mesh axis name and shard count (1 without a mesh) — the admin/
        #: occupancy planes and the journal's topology records read these
        self.fleet_axis = mesh.axis if mesh is not None else None
        self.n_shards = mesh.n_shards if mesh is not None else 1
        #: the books' device; on a mesh the lead device (shard 0's), where
        #: the packed buffer lands and the step's outputs come back
        self.device = mesh.lead if mesh is not None else resolve_device(device)
        #: what runs the schedule: "cuda" (the kernels on the card),
        #: "torch" (the plain versions on the CPU) or "sharded" (the mesh's
        #: torch ops, which launch no hand-written kernel)
        self.kernel_resolved = ("sharded" if mesh is not None else
                                "cuda" if self.device.type == "cuda"
                                else "torch")
        if placement_kernel is None:
            placement_kernel = path_cfg.placement_kernel
        _check_kernel(placement_kernel)
        super().__init__(messaging_provider, controller_instance, logger,
                         metrics=metrics, profiler=profiler, anomaly=anomaly,
                         quality=quality)
        # the profiler's HBM watermarks and capture traces read this
        # balancer's device
        self.profiler.device = self.device
        self._cluster_size = cluster_size
        self.managed_fraction = managed_fraction
        self.blackbox_fraction = blackbox_fraction
        self.batch_window = batch_window
        self.max_batch = max_batch
        self.action_slots = action_slots
        self.max_action_slots = max(max_action_slots, action_slots)
        self.placement_kernel = placement_kernel
        self.adaptive_window = (adaptive_window if adaptive_window is not None
                                else path_cfg.adaptive_window)
        self.batch_publish = (batch_publish if batch_publish is not None
                              else path_cfg.batch_publish)
        self.prewarm = prewarm if prewarm is not None else path_cfg.prewarm
        #: the early build's job (prewarm on the card, started at the end
        #: of the constructor): a future that is done once every kernel is
        #: built and loaded and the step warmed, off the event loop; None =
        #: nothing to wait for (the CPU, or prewarm off)
        self._kernels_job: Optional[concurrent.futures.Future] = None
        self._kernels_waiter = False
        self.rate_limit_per_minute = rate_limit_per_minute
        self.pipeline_depth = max(1, pipeline_depth)
        self._n_pad = max(initial_pad, self.n_shards)
        if mesh is not None:
            # power-of-two pad so the invoker axis always divides evenly
            # over the (power-of-two) shard count; single-device pads keep
            # the caller's exact value (bit-exact legacy behavior)
            self._n_pad = _next_pow2(self._n_pad)

        #: memos of pure functions on the publish path: (ns, fqn) -> home
        #: hash and (step, size) -> modular inverse, cleared at 64k
        self._hash_cache: Dict[tuple, int] = {}
        self._modinv_cache: Dict[tuple, int] = {}
        #: publish-inter-arrival EWMA (ms), the adaptive window's signal;
        #: starts sparse so a fresh balancer is eager
        self._gap_ewma_ms = 1000.0
        self._last_gap_ms = 1e9
        self._last_pub_t = time.monotonic()
        self._ns_slots: Dict[str, int] = {}
        self._t0_mono = time.monotonic()

        self._registry: List[InvokerInstanceId] = []
        self._healthy: List[bool] = []
        self._slots = _SlotAllocator(action_slots)
        self._rand_counter = 0
        #: partitions follow the registry lazily (`_refresh_partitions`)
        self._partitions_stale = True
        self._coprimes: Dict[int, List[int]] = {}

        #: the schedule and release pair of the books' device (on a mesh,
        #: the full placementKernel knob: scan keeps the sharded scan,
        #: repair the per-shard speculate-and-repair with the
        #: global-occupancy exchange, auto the per-bucket hybrid): the live
        #: steps below and the journal replay's steps are built from it
        if mesh is not None:
            (self._sched_fn, self._release_fn,
             self.placement_kernel_resolved) = fleet_pair(
                mesh, placement_kernel, repair_min_batch=REPAIR_MIN_BATCH)
        else:
            (self._sched_fn, self._release_fn,
             self.placement_kernel_resolved) = device_pair(self.device,
                                                           placement_kernel)
        sched, release = self._sched_fn, self._release_fn
        # the profiler interposes on every device entry point: first-seen
        # signatures classify by first-call / expect-window / pow2-bucketed
        # statics (the only shapes _bucket may produce) — anything else is
        # shape churn and trips the recompile watchdog
        self._release_packed_fn = self.profiler.wrap(
            "release_packed", self._make_release_packed(release),
            expected=lambda st, rel: _next_pow2(rel.shape[1]) == rel.shape[1])
        self._bucket_state = None
        if rate_limit_per_minute is not None:
            self._packed_fn = self.profiler.wrap(
                "fused_admit_step",
                self._make_step(release, sched, admit=True),
                expected=pow2_statics)
            # soft state: a rolling rate window, kept across book rebuilds
            self._bucket_state = init_buckets(
                self.RATE_NS_BUCKETS, rate_limit_per_minute,
                device=self.device)
        else:
            self._packed_fn = self.profiler.wrap(
                "fused_step", self._make_step(release, sched),
                expected=pow2_statics)

        #: host copy of free_mb from the last readback or state install;
        #: occupancy() serves from it. Installs are sequence-guarded:
        #: readbacks finish out of order under the pipeline.
        self._books_cache: Optional[np.ndarray] = None
        self._books_seq = 0
        self._books_cache_seq = 0
        #: the books: one PlacementState, or on a mesh a ShardedState (S
        #: per-shard books, each on its device)
        self.state = None
        #: write-ahead placement journal (loadbalancer/journal.py): None =
        #: journaling off. Every committed change to the books appends one
        #: record; a restored controller replays the tail on top of the
        #: snapshot (replay_journal).
        self.journal = None
        self._journal_seq = 0
        #: True while replay_journal re-applies records, so the re-applied
        #: changes don't journal themselves again
        self._journal_mute = False
        #: a fleet-mesh writer stamps ONE `mesh` topology record ahead of
        #: its first append (per process / per promotion), so a replayer
        #: on a different device count cold-starts with a logged reason
        #: instead of silently mis-sharding
        self._journal_mesh_stamped = False
        #: cross-partition spillover (active/active only; spillover.py):
        #: with a sink attached, publish_many diverts its non-blocking
        #: overflow past `spillover_depth` pending rows to the
        #: least-loaded peer instead of deepening the local queue
        self.spillover_sink = None
        self.spillover_depth = 256
        self.spilled_rows = 0
        #: placement-quality plane inputs, host-refreshed on the 1 Hz
        #: supervision tick from the anomaly plane's harvested scores:
        #: padded per-invoker cost (latency EWMA) and capacity vectors for
        #: the scorer, and the straggler-flag penalty for the shadow
        #: kernel (uploaded to the device only when they change)
        self._quality_ewma_np = np.zeros(self._n_pad, np.float32)
        self._quality_caps_np = np.zeros(self._n_pad, np.int32)
        self._quality_ewma = None
        self._quality_caps = None
        self._shadow_penalty_np = np.zeros(self._n_pad, np.int32)
        self._shadow_penalty = None
        self._quality_batches = 0
        #: the shadow pass's one copy of the books, shaped like the live
        #: books (`_install_state` re-makes it when they grow)
        self._shadow_scratch: Optional[PlacementState] = None
        self._build_shadow_fn()
        self._init_device_state()

        # request queue: (req, placement future, slot key, enqueue time,
        # activation id, action, trace id) per row — the trailing fields
        # feed the flight recorder; in partition mode one more, the row's
        # (partition, epoch) — its int columns mirrored in a ring;
        # releases: (slot key, slot) per row, columns in a ring
        self._pending: List[tuple] = []
        self._req_ring = ColumnRing(10, max_batch * 4)
        self._releases: deque = deque()
        self._rel_ring = ColumnRing(4, max_batch * 4)
        self._health_updates: Dict[int, bool] = {}
        self._flush_task: Optional[asyncio.Task] = None
        self._step_lock = asyncio.Lock()
        self._inflight_steps = 0
        self._capacity_free = asyncio.Event()
        self._readbacks: set = set()
        #: send tasks of batched publishes (raw producer: one per row)
        self._publish_finishers: set = set()
        self._closing = False
        #: EWMA of the readback round trip: picks the eager-vs-window
        #: policy. Starts above the fast threshold: unknown counts as slow.
        self._rtt_ewma_ms = 2 * self.RTT_FAST_MS
        #: dispatch -> readback ms of recent steps
        self.step_ms: deque = deque(maxlen=65536)

        # a per-controller group: every controller sees every ping
        self.supervision = InvokerPool(
            messaging_provider, on_status_change=self._status_change,
            logger=logger, group=f"health-{controller_instance.as_string}",
            on_tick=self._telemetry_tick)
        # advisory unhealthy hints from the anomaly plane land on the
        # supervision pool (pushed only when hintUnhealthy is configured)
        self.anomaly.hint_sink = self.supervision.set_unhealthy_hints
        # completion telemetry accumulates ON DEVICE for this balancer: the
        # buffered event rows fold into the accumulator as one scatter-add
        # per dispatch cycle (_dispatch_batch / idle _device_step)
        if self.telemetry.enabled:
            self.telemetry.use_device(self._n_pad, self.device)
        if self.prewarm and self.device.type == "cuda":
            # the tick's programs here, before the loop runs anything of
            # this balancer: warmed on a worker thread they contend with
            # the loop's first tick inside the CUDA runtime (measured: the
            # tick stalled longer)
            self._warm_planes()
            self._kernels_job = self._start_early_build()

    # -- device state ------------------------------------------------------
    def _slot_mb(self, user_memory_mb: int) -> int:
        return max(user_memory_mb // self._cluster_size, MIN_SLOT_MB)

    def _init_device_state(self) -> None:
        """Books at full capacity for the registry (restart semantics)."""
        n = len(self._registry)
        slot_mb = [self._slot_mb(i.user_memory.to_mb) for i in self._registry]
        st = init_state(n or 1, slot_mb or [0], n_pad=self._n_pad,
                        action_slots=self.action_slots, device=self.device)
        health = torch.zeros_like(st.health)
        if self._healthy:
            health[:len(self._healthy)] = torch.tensor(self._healthy)
        self._install_state(PlacementState(st.free_mb, st.conc_free, health))
        # placement-quality plane: the accumulator and the scorer keyed to
        # the current invoker pad (a rebuild restarts the accumulated
        # quality counts, like the JAX package's). The scorer reads the
        # live [N, A] view of the books.
        if self.quality.enabled:
            self.quality.use_device(self._n_pad, device=self.device)
            self._refresh_quality_signals()

    def _install_state(self, state: PlacementState) -> None:
        """Adopt new-shape books: shard them onto the mesh (if any). On a
        mesh this IS a reshard event, flagged to the profiler, so the
        signature census stays quiet through cluster grow/resize."""
        if self.mesh is not None:
            self.profiler.expect("reshard")
            state = shard_state(state, self.mesh, axis=self.fleet_axis)
        self.state = state
        self._set_books_now()
        scratch = self._shadow_scratch
        if self._shadow_fn is not None and (
                scratch is None
                or _book_shapes(scratch) != _book_shapes(state)):
            self._shadow_scratch = None  # free the old copy first
            self._shadow_scratch = _empty_books_like(state)

    # -- the books' layout: one device, or the shards of a mesh -------------
    def _make_step(self, release, sched, admit: bool = False):
        """The fused packed step (with device rate admission when `admit`)
        for the books' layout."""
        if self.mesh is None:
            make = (make_fused_admit_step_packed if admit
                    else make_fused_step_packed)
            return make(release, sched)
        make = (make_fleet_fused_admit_step_packed if admit
                else make_fleet_fused_step_packed)
        return make(self.mesh, release, sched)

    def _make_release_packed(self, release):
        if self.mesh is None:
            return make_release_packed(release)
        return make_fleet_release_packed(self.mesh, release)

    def _global_books(self) -> PlacementState:
        """The books as one PlacementState on the books' device: the live
        books on one device, a gathered copy of every shard on a mesh (a
        write into it is lost)."""
        if self.mesh is None:
            return self.state
        return gather_state(self.state, self.device)

    def _books_copy(self) -> PlacementState:
        """A copy of the global books, enqueued on the stream now."""
        if self.mesh is not None:
            return self._global_books()  # the gather is the copy
        st = self.state
        return PlacementState(st.free_mb.clone(), st.conc_free.T.clone().T,
                              st.health.clone())

    def _set_health(self, idx, usable) -> None:
        """Health flags in place, on the owner shards on a mesh."""
        if self.mesh is None:
            self.state = set_health(self.state, idx, usable)
        else:
            self.state = sharded_set_health(self.state, idx, usable)

    def _set_free(self, rows: List[int]) -> None:
        """New registry rows' free memory at full capacity (on the owner
        shards on a mesh: a write into a gathered copy would be lost)."""
        vals = torch.tensor([self._slot_mb(self._registry[i].user_memory.to_mb)
                             for i in rows], dtype=torch.int32)
        if self.mesh is None:
            self.state.free_mb[torch.tensor(rows)] = vals.to(self.device)
        else:
            sharded_set_free(self.state, rows, vals)

    def _build_shadow_fn(self) -> None:
        """The decision-only shadow twin of the production step (quality
        plane): the penalized variant of the production family over the
        same packed buffer and release/health folds, on a copy of the
        books, so divergence measures the penalty, not a kernel change;
        production stays bit-exact with the plane on."""
        self._shadow_fn = None
        if not (self.quality.enabled and self.quality.shadow_every_n > 0):
            return
        rate_on = self.rate_limit_per_minute is not None
        if self.mesh is not None:
            # every schedule pair is bit-exact with every other, so the
            # mesh shadow always runs the penalized sharded repair kernel
            # regardless of which pair fleet_pair resolved for production
            sched = make_fleet_repair_schedule(self.mesh, penalized=True)
            make = (make_fleet_shadow_admit_step_packed if rate_on
                    else make_fleet_shadow_step_packed)
            self._shadow_fn = make(self.mesh, self._release_fn, sched)
            return
        sched = penalized_schedule(self.device,
                                   self.placement_kernel_resolved)
        make = (make_shadow_admit_step_packed if rate_on
                else make_shadow_step_packed)
        self._shadow_fn = make(self._release_fn, sched)

    def _refresh_quality_signals(self) -> None:
        """Host-side refresh of the quality plane's input vectors (the
        1 Hz supervision tick, book rebuilds and growth): the anomaly
        plane's latency EWMAs become the scorer's cost vector, its
        straggler flags the shadow penalty, the registry's capacities the
        imbalance's denominator. Each vector is uploaded to the device
        only when it changes."""
        n = self._n_pad
        self._refresh_partitions()
        caps = np.zeros(n, np.int32)
        m = min(n, len(self._caps_mb))
        caps[:m] = np.minimum(self._caps_mb[:m], 2 ** 31 - 1)
        ewma = np.zeros(n, np.float32)
        pen = np.zeros(n, np.int32)
        sc = self.anomaly._scores
        if sc is not None:
            k = min(n, sc.shape[1])
            ewma[:k] = sc[S_EWMA_MS, :k]
            pen[:k] = sc[S_STRAGGLER_FLAG, :k].astype(np.int32)
        if (self._quality_caps is None
                or not np.array_equal(caps, self._quality_caps_np)):
            self._quality_caps_np = caps
            self._quality_caps = self._to_device(caps)
        if (self._quality_ewma is None
                or not np.array_equal(ewma, self._quality_ewma_np)):
            self._quality_ewma_np = ewma
            self._quality_ewma = self._to_device(ewma)
        if (self._shadow_penalty is None
                or not np.array_equal(pen, self._shadow_penalty_np)):
            self._shadow_penalty_np = pen
            self._shadow_penalty = self._to_device(pen)

    def _next_books_seq(self) -> int:
        self._books_seq += 1
        return self._books_seq

    def _install_books(self, books_np, seq: int) -> None:
        """Install host books into occupancy()'s cache unless a NEWER
        step's books already landed. Called on the event loop."""
        if seq >= self._books_cache_seq:
            self._books_cache_seq = seq
            self._books_cache = books_np

    def _set_books_now(self) -> None:
        """Synchronous cache install for authoritative state changes
        (init, registration, growth): supersedes in-flight readbacks."""
        self._install_books(self.state.free_mb.to("cpu", copy=True).numpy(),
                            self._next_books_seq())

    def _books_ref(self) -> torch.Tensor:
        """The post-step books vector as its own tensor, enqueued on the
        stream before the next step mutates the live books in place (on a
        mesh the gather onto the lead device is that copy)."""
        if self.mesh is not None:
            return self.state.free_mb
        return self.state.free_mb.clone()

    def _recover_failed_step(self) -> None:
        """A device call failed part-way: its in-place updates may have
        half-written the books. Rebuild them at full capacity over the
        registry — restart semantics; in-flight holds self-heal through
        forced timeouts. The bucket state is never written in place, so it
        stands."""
        if self.logger:
            self.logger.error(None, "device step failed; rebuilding the "
                                    "device books", "TpuBalancer")
        self._init_device_state()
        if self._journal_live():
            # books were rebuilt at full capacity: replay must do the same
            self._journal_append({"t": "reinit"})

    def _set_inflight(self, delta: int) -> None:
        self._inflight_steps += delta

    def _grow_padding(self, new_pad: int) -> None:
        """Re-pad the books to `new_pad` invoker rows on the device,
        PRESERVING the live books (in-flight holds survive fleet growth;
        only update_cluster resets them, which is reference behavior). The
        copies are stream-ordered after every dispatched step."""
        st = self._global_books()
        n_old = st.free_mb.shape[0]
        self.profiler.expect("reshard" if self.mesh is not None
                             else "fleet_growth")
        free = torch.zeros((new_pad,), dtype=st.free_mb.dtype,
                           device=self.device)
        free[:n_old] = st.free_mb
        conc = torch.zeros((self.action_slots, new_pad),
                           dtype=st.free_mb.dtype, device=self.device)
        conc[:, :n_old] = st.conc_free.T
        health = torch.zeros((new_pad,), dtype=torch.bool,
                             device=self.device)
        health[:n_old] = st.health
        self._n_pad = new_pad
        self._install_state(PlacementState(free, conc.T, health))
        if self.quality.enabled:
            # the accumulator's per-invoker rows and the scorer's and the
            # shadow's vectors follow the books' pad (the JAX package keeps
            # the pad they were made at, and drops attribution past it)
            if self.quality._qstate is not None:
                self.quality._qstate = pad_quality_state(
                    self.quality._qstate, new_pad)
            self._refresh_quality_signals()
        if self._journal_live():
            self._journal_append({"t": "grow", "n_pad": new_pad})

    def _grow_slots(self, new_slots: int) -> None:
        """Widen the books' action axis on the device, preserving every
        live permit."""
        self.profiler.expect("slot_growth")
        st = self._global_books()
        conc = torch.zeros((new_slots, self._n_pad), dtype=st.free_mb.dtype,
                           device=self.device)
        conc[:self.action_slots] = st.conc_free.T
        self.action_slots = new_slots
        self._slots.grow(new_slots)
        self._install_state(PlacementState(st.free_mb, conc.T, st.health))
        self.counters["action_slot_growth"] += 1
        if self._journal_live():
            self._journal_append({"t": "slots", "action_slots": new_slots})

    def _ensure_slot_capacity(self, slot_key: str) -> None:
        """Grow the concurrency-slot axis before the allocator runs dry;
        past the hard cap the allocator's stable-hash overflow takes over,
        counted so conflated concurrency pools are never silent."""
        if not (self._slots.saturated and self._slots.needs_slot(slot_key)):
            return
        if self.action_slots < self.max_action_slots:
            self._grow_slots(min(self.action_slots * 2,
                                 self.max_action_slots))
        else:
            self.counters["action_slot_overflow"] += 1
            if self.logger and slot_key not in self._slots.overflow:
                self.logger.warn(
                    None, f"action concurrency slots saturated at the hard "
                    f"cap ({self.action_slots}); '{slot_key}' shares a "
                    "hashed slot (conflated concurrency pool)")

    # -- fleet bookkeeping -------------------------------------------------
    def _status_change(self, instance: InvokerInstanceId, status: str) -> None:
        idx = instance.instance
        new_rows = []
        while idx >= len(self._registry):
            new_rows.append(len(self._registry))
            self._registry.append(instance)
            self._healthy.append(False)
        self._registry[idx] = instance
        self._healthy[idx] = status == HEALTHY
        if new_rows:
            if len(self._registry) > self._n_pad:
                self._grow_padding(_next_pow2(len(self._registry)))
            # initialize ONLY the new rows (full capacity, health folds in
            # with the flip below); existing rows keep their holds
            self._set_free(new_rows)
            self._set_books_now()
            if self._journal_live():
                self._journal_append({
                    "t": "reg",
                    "reg": [self._registry[i].to_json() for i in new_rows],
                    "healthy": [bool(self._healthy[i]) for i in new_rows]})
        self._health_updates[idx] = self._healthy[idx]
        self._partitions_stale = True

    def _refresh_partitions(self) -> None:
        """Recompute the managed/blackbox partitions, their coprime probe
        steps and the capacity vector from the registry — the JAX package
        does this on every status change; here on first use after one (the
        same values: a pure function of the registry), so registering a
        fleet of n invokers costs O(n), not O(n^2)."""
        if not self._partitions_stale:
            return
        self._partitions_stale = False
        n = len(self._registry)
        self.managed_count = max(int(self.managed_fraction * n), 1) if n else 0
        self.blackbox_count = max(int(self.blackbox_fraction * n), 1) if n else 0
        self._steps_managed = self._coprimes_of(max(1, self.managed_count))
        self._steps_blackbox = self._coprimes_of(max(1, self.blackbox_count))
        self._caps_mb = np.asarray(
            [self._slot_mb(i.user_memory.to_mb) for i in self._registry],
            np.int64)

    def _coprimes_of(self, x: int) -> List[int]:
        steps = self._coprimes.get(x)
        if steps is None:
            steps = self._coprimes[x] = pairwise_coprimes(x)
        return steps

    def _telemetry_tick(self) -> None:
        # the supervision watchdog also drains completion events that
        # arrived while no placement traffic was flowing (idle fleets must
        # still converge their device counts)
        self._telemetry_fold(True)
        self.telemetry.tick(self.metrics)
        # anomaly detection rides the same tick: the device step enqueues
        # now and its scores harvest NEXT tick (no device sync on the
        # event loop, same rule as the burn-rate math)
        self.anomaly.tick(self.metrics)
        # the quality plane rides the same cadence: refresh its cost/
        # penalty vectors from the scores the anomaly tick harvested, then
        # its gauges (host aggregates only — no device sync)
        if self.quality.enabled:
            self._refresh_quality_signals()
            self.quality.tick(self.metrics)
        # HBM watermark gauges ride the same 1 Hz tick (guarded no-op on
        # the CPU)
        self.profiler.refresh_memory(self.metrics)
        export_tracing_gauges(self.metrics)
        # bus-client health rides the same cadence: coalescing batch sizes
        # and TCP-bus consumer reconnects (messaging/{coalesce,tcp}.py)
        export_coalesce_gauges(self.metrics)
        export_bus_gauges(self.metrics)
        # journal durability lag / size / fsync tail ride the same 1 Hz
        # cadence
        if self.journal is not None:
            self.journal.export_gauges(self.metrics)
        # fleet-mesh visibility: shard count + per-shard occupancy from
        # the cached books (host-side only)
        if self.mesh is not None:
            self._refresh_partitions()
            self._export_shard_gauges()

    def update_cluster(self, cluster_size: int) -> None:
        """Controller joined/left: re-shard every invoker's memory (ref
        updateCluster :561-584); the books restart at full capacity."""
        if cluster_size != self._cluster_size:
            self._cluster_size = cluster_size
            self.profiler.expect("reshard" if self.mesh is not None
                                 else "cluster_resize")
            self._init_device_state()
            self._partitions_stale = True
            if self._journal_live():
                self._journal_append({"t": "cluster", "size": cluster_size})

    @property
    def cluster_size(self) -> int:
        return self._cluster_size

    # -- placement journal (loadbalancer/journal.py) -----------------------
    def attach_journal(self, journal) -> None:
        """Adopt a PlacementJournal. Appends start from the max of the
        balancer's own seq and what the log already holds, so a restarted
        active never reuses a sequence number. Also registers the
        journal's durability lag as an alert signal: the built-in
        `journal_stall` rule (anomaly.py) fires when the lag stays above
        its threshold for its window — an fsync device stall — and
        /admin/ready surfaces the firing state."""
        self.journal = journal
        if journal is not None:
            self._journal_seq = max(self._journal_seq, journal.last_seq())
            self.anomaly.extra_signals["journal_lag_batches"] = (
                lambda: float(self.journal.lag_batches)
                if self.journal is not None else None)

    def _journal_live(self) -> bool:
        return (self.journal is not None and not self._journal_mute
                and not self.ha_standby)

    def _journal_append(self, rec: dict) -> int:
        """Stamp the next seq (and fencing epoch) onto `rec` and append.
        Returns the seq (0 when journaling is off). Called on the event
        loop in the SAME synchronous block as the change to the books it
        records, so journal order == the order of changes to the books and
        a snapshot's `journal_seq` is exactly consistent with its books."""
        if not self._journal_live():
            return 0
        if (self.mesh is not None and not self._journal_mesh_stamped
                and rec.get("t") != "mesh"):
            # topology header: ONE `mesh` record ahead of this writer's
            # first append (rides alongside `reg`/`cluster`), so replay
            # can refuse a different device count with a logged reason
            self._journal_mesh_stamped = True
            self._journal_append({"t": "mesh", **mesh_topology(self.mesh)})
        self._journal_seq += 1
        rec["seq"] = self._journal_seq
        if self.fence_epoch is not None:
            rec["epoch"] = self.fence_epoch
        try:
            self.journal.append(rec)
        except Exception as e:  # noqa: BLE001 — journaling degrades, the
            # placement path never dies for the flight data recorder
            if self.logger:
                self.logger.warn(None, f"journal append failed: {e!r}; "
                                       "detaching journal", "TpuBalancer")
            self.journal = None
        return rec.get("seq", 0)

    def replay_journal(self, records, logger=None,
                       from_seq: Optional[int] = None,
                       parts_filter=None, foreign: bool = False) -> dict:
        """Deterministically re-execute a journal tail on top of the
        current (snapshot-restored) books. Batch records re-run the SAME
        schedule and release functions the live balancer used (the CUDA
        kernels on the card, their plain versions on the CPU) over the
        recorded packed input buffers — placement is bit-deterministic
        across them, so the re-derived books equal the writer's and the
        re-derived decisions equal the journaled readback
        (`parity_mismatches` counts divergence, e.g. a kernel-knob change
        across the restart). Structural records (registration, growth,
        cluster) re-apply their host-side change.

        Batches journaled at dispatch but crashed before readback replay
        with their full request set (conservative over-hold: those
        placements were computed on the dead device; self-heal via forced
        timeouts reclaims them, exactly the checkpoint posture).

        Topology: a batch record carrying a shard count (`S`, 1 when
        absent) other than this balancer's COLD-STARTS the books with a logged reason
        instead of mis-sharding the replay (`skipped: "mesh_topology"`).

        `parts_filter` restricts the replay to batch records whose `parts`
        intersect the given partition set (and their acks); structural
        records are skipped under a filter. `foreign=True` marks the tail
        as another controller's journal: its seqs live in that journal's
        numbering, so this balancer's own `_journal_seq` never moves, and
        a topology mismatch skips the replay (logged) instead of
        cold-starting the live books. Records carrying a `pe`
        (per-partition epoch) map are dropped PER PARTITION when every
        overlapping partition was superseded at-or-before their seq."""
        stats: dict = {}
        for _ in self.replay_stepper(records, logger=logger,
                                     from_seq=from_seq,
                                     parts_filter=parts_filter,
                                     foreign=foreign, stats=stats):
            pass
        return stats

    def replay_stepper(self, records, logger=None,
                       from_seq: Optional[int] = None,
                       parts_filter=None, foreign: bool = False,
                       stats: Optional[dict] = None):
        """The replay engine behind `replay_journal`, exposed as a
        generator for the time-travel debugger (timetravel.py): yields one
        step dict `{seq, t, rec, detail}` per APPLIED record (acks and
        stale/filtered records are handled internally), so a consumer can
        stop at seq K, break on an activation id, or inspect the
        re-derived books between any two steps. `stats` is a
        caller-supplied dict mutated in place (replayed/batches/
        parity_mismatches/last_seq...) — shared with `replay_journal`, and
        still correct when the consumer abandons the generator early:
        finalization (journal un-mute, host-books refresh, last_seq) runs
        in the generator's `finally`, i.e. also on `close()`."""
        self._await_kernels()
        log = logger or self.logger
        if stats is None:
            stats = {}
        if from_seq is not None and not foreign:
            self._journal_seq = int(from_seq)
        stats.update({"replayed": 0, "batches": 0, "parity_mismatches": 0,
                      "from_seq": (int(from_seq) if from_seq is not None
                                   else self._journal_seq)})
        self.profiler.expect("snapshot_restore")
        recs = [r for r in records]
        # stale-epoch filter: a demoted active's already-popped write batch
        # can still land in its own old segment AFTER the new epoch began —
        # any record whose epoch is superseded at-or-before its seq was
        # never part of the promoted active's state and must not replay
        first_seq: Dict[int, int] = {}
        #: per-partition variant of the same bound: (pid, epoch) -> first
        #: seq observed carrying it (records with a `pe` map)
        pfirst_seq: Dict[tuple, int] = {}
        for r in recs:
            e, s = int(r.get("epoch", 0)), int(r.get("seq", 0))
            first_seq[e] = min(first_seq.get(e, s), s)
            for pid_s, pe in (r.get("pe") or {}).items():
                key = (int(pid_s), int(pe))
                pfirst_seq[key] = min(pfirst_seq.get(key, s), s)
        bounds = sorted(first_seq.items())
        pbounds: Dict[int, list] = {}
        for (pid, e), s in sorted(pfirst_seq.items()):
            pbounds.setdefault(pid, []).append((e, s))

        def _fresh_for(pid: int, e: int, s: int) -> bool:
            return not any(e2 > e and s2 <= s
                           for e2, s2 in pbounds.get(pid, ()))

        def _fresh(r: dict) -> bool:
            e, s = int(r.get("epoch", 0)), int(r.get("seq", 0))
            if any(e2 > e and s2 <= s for e2, s2 in bounds):
                return False
            pe = r.get("pe")
            if not pe:
                return True
            # fresh while ANY overlapping partition is fresh — a batch
            # mixing a stale and a live partition still owes the live
            # partition its holds (the stale rows are epsilon over-hold,
            # self-healed by forced timeouts like every replay over-hold)
            pids = ((int(p) for p in pe)
                    if parts_filter is None
                    else (int(p) for p in pe if int(p) in parts_filter))
            return any(_fresh_for(p, int(pe[str(p)]), s) for p in pids)

        if parts_filter is not None:
            parts_filter = set(int(p) for p in parts_filter)
            kept = []
            kept_seqs = set()
            for r in recs:
                t = r.get("t")
                if t == "batch":
                    if parts_filter & set(int(p) for p in
                                          r.get("parts") or ()):
                        kept.append(r)
                        kept_seqs.add(int(r.get("seq", 0)))
                elif t == "ack":
                    # an ack applies through its dispatch-time batch
                    # record: absorbed iff that batch was
                    if int(r.get("for", 0)) in kept_seqs:
                        kept.append(r)
                # everything else (reg/grow/slots/cluster/reinit/fold/
                # mesh): the previous owner's own topology and idle
                # bookkeeping — never part of a partition handoff
            stats["filtered_out"] = len(recs) - len(kept)
            recs = kept
        n_all = len(recs)
        recs = [r for r in recs if _fresh(r)]
        stats["stale_epoch_dropped"] = n_all - len(recs)
        # acks key their dispatch-time batch record by `for` (the ack's own
        # seq only orders it in the log)
        acks = {int(r["for"]): r for r in recs
                if r.get("t") == "ack" and "for" in r}
        # the live pair, outside the profiler's wrap: replay steps are not
        # live placement traffic
        replay_step = self._make_step(self._release_fn, self._sched_fn)
        replay_release = self._make_release_packed(self._release_fn)
        # foreign tails run on a LOCAL cursor in the dead owner's seq
        # space; our own journal numbering is untouched
        cursor = (int(from_seq or 0) if foreign else self._journal_seq)
        self._journal_mute = True
        cold = False
        try:
            for rec in recs:
                t = rec.get("t")
                seq = int(rec.get("seq", 0))
                if t == "ack":
                    # already applied through its batch record; still claim
                    # the seq so the promoted active never reuses it
                    cursor = max(cursor, seq)
                    if not foreign:
                        self._journal_seq = cursor
                    continue
                if seq <= cursor:
                    continue
                if t in ("batch", "mesh"):
                    got = int(rec.get("S" if t == "batch" else "n_shards",
                                      1))
                    if got != self.n_shards:
                        if foreign:
                            # NEVER cold-start a live survivor's books
                            # over an absorbed tail: skip it and say so;
                            # the un-replayed holds self-heal
                            if log:
                                log.warn(None, "absorbed journal tail was "
                                               f"written at {got} fleet "
                                               f"shard(s), this balancer "
                                               f"runs {self.n_shards}; "
                                               "skipping the absorb "
                                               "replay", "TpuBalancer")
                            stats["skipped"] = "mesh_topology"
                            break
                        cold = True
                        self._topology_coldstart(stats, recs, got, log)
                        return
                detail = None
                if t == "mesh":
                    pass  # topology verified above; nothing to re-apply
                elif t == "batch":
                    detail = self._replay_batch(rec, acks.get(seq),
                                                replay_step, stats)
                elif t == "fold":
                    self._replay_fold(rec, replay_release)
                elif t == "reg":
                    self._replay_reg(rec)
                elif t == "grow":
                    if int(rec["n_pad"]) > self._n_pad:
                        self._grow_padding(int(rec["n_pad"]))
                elif t == "slots":
                    if int(rec["action_slots"]) > self.action_slots:
                        self._grow_slots(int(rec["action_slots"]))
                elif t == "cluster":
                    self.update_cluster(int(rec["size"]))
                elif t == "reinit":
                    self._init_device_state()
                elif log:
                    log.warn(None, f"journal record type {t!r} unknown "
                                   "(newer writer?); skipped", "TpuBalancer")
                stats["replayed"] += 1
                cursor = max(cursor, seq)
                if not foreign:
                    self._journal_seq = cursor
                yield {"seq": seq, "t": t, "rec": rec, "detail": detail}
        finally:
            self._journal_mute = False
            if not cold:
                self._set_books_now()
                stats["last_seq"] = cursor
                if stats["parity_mismatches"] and log:
                    log.warn(None, f"journal replay re-derived "
                                   f"{stats['parity_mismatches']} decisions "
                                   "differently than the recorded readback "
                                   "(kernel knobs changed across the "
                                   "restart?)", "TpuBalancer")

    def absorb_partitions(self, pids, journal, snap_doc=None,
                          logger=None) -> dict:
        """Partition handoff, absorb side: replay the PREVIOUS owner's
        journal tail — filtered to exactly the partitions this controller
        just claimed — through the same kernels, on top of the live books
        (on the card, the scan and repair kernels). The dead (or
        rebalanced-away) owner's post-snapshot in-flight holds for these
        partitions land on the new owner's books conservatively
        (un-acked rows self-heal via forced timeouts), per-partition stale
        epochs drop, and the previous owner's structural records never
        touch our topology. The absorbed tail's seqs stay in the previous
        owner's numbering (`foreign`), so our own journal order is
        untouched. The epoch bump that fences the previous owner happened
        at claim time (set_partition_leadership) — this replay is
        books-accuracy, the fence is the zero-double-execution guarantee.

        Every failure path degrades to skipped-absorb with the fence
        still in place; never an abort."""
        log = logger or self.logger
        pids = set(int(p) for p in pids)
        for pid in pids:
            self.partition_replay[pid] = "replaying"
        from_seq = int((snap_doc or {}).get("journal_seq", 0))
        GLOBAL_EVENT_LOG.record("absorb_start",
                                instance=self.controller.instance,
                                parts=sorted(pids), from_seq=from_seq)
        stats = {"absorbed_partitions": sorted(pids), "replayed": 0}
        try:
            stats = self.replay_journal(journal.records(from_seq),
                                        logger=log, from_seq=from_seq,
                                        parts_filter=pids, foreign=True)
            stats["absorbed_partitions"] = sorted(pids)
        except Exception as e:  # noqa: BLE001 — degrade, never abort: the
            # claim's epoch bump already fences the previous owner
            stats["skipped"] = f"absorb_error: {e!r}"
            if log:
                log.warn(None, f"partition absorb replay failed ({e!r}); "
                               "continuing with the fence only",
                         "TpuBalancer")
        finally:
            for pid in pids:
                self.partition_replay[pid] = "ready"
        GLOBAL_EVENT_LOG.record("absorb_end",
                                instance=self.controller.instance,
                                parts=sorted(pids),
                                replayed=int(stats.get("replayed", 0)),
                                skipped=stats.get("skipped"))
        self.counters["partitions_absorbed"] += len(pids)
        return stats

    def _topology_coldstart(self, stats: dict, recs: list, got: int,
                            log) -> dict:
        """A journal tail written at a different fleet topology cannot be
        replayed here (the packed records are deterministic only through
        the SAME sharded kernels): cold-start — fresh full-capacity books
        over the restored registry; leaked in-flight holds self-heal via
        forced timeouts, exactly the pruned-tail posture — with a logged
        reason. Every seq in the tail is still claimed so a promoted
        active never reuses one."""
        if log:
            log.warn(None, f"placement journal tail was written at {got} "
                           f"fleet shard(s) but this balancer runs "
                           f"{self.n_shards}; cold-starting instead of "
                           f"mis-sharding the replay", "TpuBalancer")
        stats["skipped"] = "mesh_topology"
        stats["journal_shards"] = got
        stats["balancer_shards"] = self.n_shards
        self._journal_seq = max(
            [self._journal_seq] + [int(r.get("seq", 0)) for r in recs])
        self._init_device_state()
        stats["last_seq"] = self._journal_seq
        return stats

    def _replay_batch(self, rec: dict, ack: Optional[dict], replay_step,
                      stats: dict) -> dict:
        R, H, B = int(rec["R"]), int(rec["H"]), int(rec["B"])
        rows, b = int(rec["rows"]), int(rec["b"])
        buf = decode_array(rec["buf"])
        rel = buf[:5 * R]
        health = buf[5 * R:5 * R + 3 * H]
        req = buf[5 * R + 3 * H:].reshape(rows, B)[:9].copy()
        if ack is not None:
            out_rec = np.asarray(ack["out"], np.int64)
            throttled = ((out_rec >> 1) & 1).astype(bool)
            # device rate admission already rejected these at commit time:
            # replay with their valid bit cleared so the re-derived books
            # hold exactly what the committed step held
            req[8, :len(throttled)] &= ~throttled
        buf9 = np.concatenate([rel, health, req.ravel()]).astype(np.int32)
        self.state, out = replay_step(self.state, self._to_device(buf9),
                                      R, H, B)
        stats["batches"] += 1
        #: per-batch evidence for the time-travel debugger (timetravel.py):
        #: replay_journal ignores it
        detail: dict = {"b": b, "aids": rec.get("aids") or [],
                        "acked": ack is not None, "mismatches": 0}
        if ack is not None:
            # the one host read of a replayed batch: only acked batches
            # have recorded decisions to hold the derived ones against
            derived = out.cpu().numpy()[:b].astype(np.int64)
            recorded = np.asarray(ack["out"], np.int64)[:b]
            thr = ((recorded >> 1) & 1).astype(bool)
            mism = int(np.count_nonzero(derived[~thr] != recorded[~thr]))
            stats["parity_mismatches"] += mism
            detail.update({"derived": derived, "recorded": recorded,
                           "throttled": thr, "mismatches": mism})
        return detail

    def _replay_fold(self, rec: dict, replay_release) -> None:
        if "rel" in rec:
            rel = decode_array(rec["rel"]).reshape(5, -1).copy()
            self.state = replay_release(self.state, self._to_device(rel))
        health = rec.get("health")
        if health:
            self._set_health([int(i) for i, _ in health],
                             [bool(v) for _, v in health])

    def _replay_reg(self, rec: dict) -> None:
        new_rows = []
        for j, healthy in zip(rec["reg"], rec["healthy"]):
            inv = InvokerInstanceId.from_json(j)
            idx = inv.instance
            while idx >= len(self._registry):
                new_rows.append(len(self._registry))
                self._registry.append(inv)
                self._healthy.append(False)
            self._registry[idx] = inv
            self._healthy[idx] = bool(healthy)
        if new_rows:
            if len(self._registry) > self._n_pad:
                self._grow_padding(_next_pow2(len(self._registry)))
            self._set_free(new_rows)
        self._partitions_stale = True

    # -- checkpoint / resume -----------------------------------------------
    def snapshot_parts(self) -> dict:
        """Event-loop-side capture for a snapshot: device-side clones of
        the books plus copies of the host books. The steps write the books
        IN PLACE, so the clones are enqueued here, on the stream behind
        every step dispatched so far and ahead of any later one (the
        pattern of `_books_ref`); the device->host transfer then runs on a
        worker thread (checkpoint.BalancerSnapshotter) reading only the
        clones, without racing the loop's later steps or mixing books
        from different steps. On a mesh the clones are one gather of
        every shard: the snapshot's books are global."""
        return {
            "state": self._books_copy(),
            "journal_seq": self._journal_seq,
            "n_pad": self._n_pad,
            "fleet_shards": self.n_shards,
            "cluster_size": self._cluster_size,
            "action_slots": self.action_slots,
            "registry": [inv.to_json() for inv in self._registry],
            "healthy": list(self._healthy),
            "slots": dict(self._slots.slots),
            "slot_refcount": dict(self._slots.refcount),
            "slot_overflow": {k: list(v)
                              for k, v in self._slots.overflow.items()},
        }

    def snapshot(self, parts: Optional[dict] = None) -> dict:
        """Host-side snapshot of the capacity books + registry, the JAX
        package's document key for key. Thread-safe given `parts` from
        snapshot_parts(). `conc_nonzero` lists [invoker, slot, value] in
        row-major (invoker, slot) order; the non-zero cells are found on
        the books' device, so only they cross to the host, never the
        whole [N, A] book."""
        parts = dict(parts) if parts is not None else self.snapshot_parts()
        state = parts.pop("state")
        conc = state.conc_free
        nz = torch.nonzero(conc)
        cells = torch.cat([nz, conc[nz[:, 0], nz[:, 1]].long()[:, None]], 1)
        parts["free_mb"] = state.free_mb.cpu().tolist()
        parts["conc_nonzero"] = cells.cpu().tolist()
        return parts

    def restore(self, snap: dict) -> None:
        self.profiler.expect("snapshot_restore")
        # the snapshot's books are GLOBAL (topology-independent): restoring
        # them onto a different shard count is a deterministic reshard —
        # _install_state re-places every row on this balancer's own mesh.
        # Said out loud because the JOURNAL tail is not topology-portable
        # (replay_journal cold-starts on a mismatch).
        snap_shards = int(snap.get("fleet_shards", 1))
        if snap_shards != self.n_shards and self.logger:
            self.logger.info(
                None, f"snapshot was taken at {snap_shards} fleet "
                f"shard(s); resharding deterministically onto "
                f"{self.n_shards}", "TpuBalancer")
        # the snapshot's books already hold every journaled change up to
        # this seq: replay_journal resumes from here (older snapshots carry
        # no seq — a full-history journal replays from 0)
        self._journal_seq = int(snap.get("journal_seq", 0))
        self._n_pad = int(snap["n_pad"])
        if self.mesh is not None and self._n_pad % self.n_shards:
            # a single-device snapshot may carry a pad the mesh cannot
            # divide: round up (extra rows are unhealthy zero-capacity
            # padding, exactly like growth padding)
            self._n_pad = _next_pow2(max(self._n_pad, self.n_shards))
        self._cluster_size = int(snap["cluster_size"])
        # older snapshots predate the growable slot axis
        self.action_slots = int(snap.get("action_slots", self.action_slots))
        self._registry = [InvokerInstanceId.from_json(j)
                          for j in snap["registry"]]
        self._healthy = [bool(h) for h in snap["healthy"]]
        free = np.asarray(snap["free_mb"], np.int32)
        if len(free) < self._n_pad:  # pad rounded up above
            free = np.concatenate(
                [free, np.zeros((self._n_pad - len(free),), np.int32)])
        # conc is held as the [N, A] view of [A, N] storage (init_state)
        conc = np.zeros((self.action_slots, self._n_pad), np.int32)
        cells = np.asarray(snap.get("conc_nonzero", []),
                           np.int64).reshape(-1, 3)
        conc[cells[:, 1], cells[:, 0]] = cells[:, 2]
        health = np.zeros((self._n_pad,), bool)
        health[: len(self._healthy)] = self._healthy
        dev = self.device
        self._install_state(PlacementState(
            torch.from_numpy(free).to(dev), torch.from_numpy(conc).to(dev).T,
            torch.from_numpy(health).to(dev)))
        self._slots.n_slots = self.action_slots
        self._slots.slots = dict(snap.get("slots", {}))
        self._slots.refcount = dict(snap.get("slot_refcount", {}))
        self._slots.overflow = {k: [int(v[0]), int(v[1])]
                                for k, v in snap.get("slot_overflow", {}).items()}
        used = set(self._slots.slots.values())
        self._slots.free = [s for s in range(self.action_slots - 1, -1, -1)
                            if s not in used]
        self._partitions_stale = True

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        self.start_ack_feed()
        self.supervision.start()

    async def close(self) -> None:
        self._closing = True  # no new flush tasks from here on
        await self.supervision.stop()
        if self._flush_task:
            self._flush_task.cancel()
        # let in-flight readbacks resolve their publishers first
        if self._readbacks:
            await asyncio.gather(*list(self._readbacks),
                                 return_exceptions=True)
        # fail queued publishers instead of leaving them awaiting forever
        pending, self._pending = self._pending, []
        self._req_ring.clear()
        for req, fut, slot_key, _t, aid, *_ in pending:
            self._slots.release(slot_key, req[self.R_CONC_SLOT])
            self.waterfall.discard(aid)
            if not fut.done():
                fut.set_exception(LoadBalancerException("load balancer shut down"))
        # batched-publish sends drain AFTER the queued rows fail and BEFORE
        # the producer closes, so every caller-facing future resolves
        if self._publish_finishers:
            await asyncio.gather(*list(self._publish_finishers),
                                 return_exceptions=True)
        # releases that will never reach a device step: free host slots
        while self._releases:
            self._slots.release(*self._releases.popleft())
        self._rel_ring.clear()
        await super().close()

    # -- publish -----------------------------------------------------------
    def _standby_error(self) -> Optional[LoadBalancerException]:
        """The pre-placement refusals shared by publish/publish_many."""
        if self.ha_standby:
            # HA failover mode: placement is fenced to the active leader —
            # refusing BEFORE any state change makes the 503 safe for the
            # edge to retry on the active upstream
            return LoadBalancerException(
                "standby controller: placement is fenced to the active "
                "leader")
        if len(self._registry) == 0 or not any(self._healthy):
            return LoadBalancerException(
                "No invokers available to schedule the activation.")
        return None

    def _ns_slot(self, ns_id: str) -> int:
        slot = self._ns_slots.get(ns_id)
        if slot is None:
            dedicated = self.RATE_NS_BUCKETS - self.RATE_NS_SHARED_BUCKETS
            if len(self._ns_slots) < dedicated:
                slot = len(self._ns_slots)
                self._ns_slots[ns_id] = slot
            else:
                # dedicated range full: hash into the SHARED tail
                # sub-range, never onto a dedicated tenant's bucket
                slot = dedicated + (zlib.crc32(ns_id.encode())
                                    % self.RATE_NS_SHARED_BUCKETS)
        return slot

    def _build_row(self, action: ExecutableWhiskAction,
                   msg: ActivationMessage) -> tuple:
        """One request row in packed-matrix order (10 fields: the 9 of the
        schedule plus the rate-admission namespace slot) with its slot key
        and action name, shared by the serial and batched paths;
        everything stateful (_rand_counter, the slot allocator, slot-axis
        growth) mutates in exactly the serial order."""
        self._refresh_partitions()
        n = len(self._registry)
        blackbox = action.exec_metadata().is_blackbox
        size = self.blackbox_count if blackbox else self.managed_count
        offset = (n - self.blackbox_count) if blackbox else 0
        fqn_str = str(action.fully_qualified_name)
        hkey = (str(msg.user.namespace.name), fqn_str)
        h = self._hash_cache.get(hkey)
        if h is None:
            if len(self._hash_cache) >= 65536:
                self._hash_cache.clear()
            h = self._hash_cache[hkey] = generate_hash(*hkey)
        steps = self._steps_blackbox if blackbox else self._steps_managed
        step = steps[h % len(steps)]
        ikey = (step, size)
        step_inv = self._modinv_cache.get(ikey)
        if step_inv is None:
            if len(self._modinv_cache) >= 65536:
                self._modinv_cache.clear()
            step_inv = self._modinv_cache[ikey] = _mod_inverse(step, size)
        self._rand_counter += 1
        mem = action.limits.memory.megabytes
        maxc = action.limits.concurrency.max_concurrent
        slot_key = f"{fqn_str}:{mem}"
        self._ensure_slot_capacity(slot_key)
        ns_slot = (self._ns_slot(msg.user.namespace.uuid.asString)
                   if self.rate_limit_per_minute is not None else 0)
        req = (offset, size, h % size, step_inv, mem,
               self._slots.acquire(slot_key), maxc,
               (h ^ (self._rand_counter * 2654435761)) % max(size, 1), 1,
               ns_slot)
        return req, slot_key, fqn_str

    def _eager(self) -> bool:
        """Dispatch an idle balancer's queue now: nothing in flight, a fast
        device, and no arrival pressure asking for a window."""
        return (self._inflight_steps == 0
                and self._rtt_ewma_ms < self.RTT_FAST_MS
                and self._coalesce_window_s() == 0.0)

    async def publish(self, action: ExecutableWhiskAction,
                      msg: ActivationMessage) -> asyncio.Future:
        err = self._standby_error()
        if err is not None:
            raise err
        pid = None
        if self.partition_ring is not None:
            pid = self.partition_of_msg(msg)
            err = self._partition_refusal(msg, pid)
            if err is not None:
                raise err
        req, slot_key, fqn_str = self._build_row(action, msg)
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        # trailing fields feed the flight recorder: enqueue time (queue-age
        # digest), the activation/action ids for the decision row, and the
        # trace id (exemplar plumbing on OpenMetrics scrapes)
        aid_str = msg.activation_id.asString
        t_now = time.monotonic()
        self._note_arrival(t_now)
        entry = (req, fut, slot_key, t_now,
                 aid_str, fqn_str,
                 trace_id_of(msg.trace_context))
        if pid is not None:
            # active/active: the row's (partition, epoch) rides the entry
            # so the dispatch-time journal record carries per-partition
            # ids + the epoch each row was admitted under (a spilled row
            # keeps its origin's stamp when that is ahead of ours)
            entry = entry + ((pid, self._row_epoch(msg, pid)),)
        # waterfall: the activation is now IN the balancer's queue — the
        # delta from here to batch_assemble is pure queueing/window wait
        self.waterfall.stamp(aid_str, STAGE_PUBLISH_ENQUEUE)
        self._req_ring.push(req)
        self._pending.append(entry)
        # inline fast path: with free pipeline capacity, dispatch NOW when
        # the batch is full or the idle device is fast (the dispatch body
        # has no awaits); otherwise arm the flush window
        if not ((len(self._pending) >= self.max_batch or self._eager())
                and self._try_flush_now()):
            self._arm_flush(urgent=len(self._pending) >= self.max_batch)
        try:
            inv_idx, forced = await fut
        except asyncio.CancelledError:
            # cancelled between set_result and resumption: the placement is
            # lost to this caller but its capacity is not
            if fut.done() and not fut.cancelled() and fut.exception() is None:
                self._abandon_placement(int(fut.result()[0]), req, slot_key)
            # abandoned = never acked = never finished: drop the stage
            # vector, like every other abandonment path
            self.waterfall.discard(aid_str)
            raise
        invoker, promise = self._map_placement(inv_idx, forced, req,
                                               slot_key, msg, action)
        await self.send_activation_to_invoker(msg, invoker)
        return promise

    def _map_placement(self, inv_idx: int, forced, req: tuple,
                       slot_key: str, msg, action):
        """The post-placement outcome mapping shared by `publish` and the
        batched `_row_placed`: failure codes release the held slot and
        raise the serial texts; success sets up the activation entry and
        returns (invoker, completion promise)."""
        if inv_idx < 0:
            self.waterfall.discard(msg.activation_id.asString)
        if inv_idx == -2:
            # device token bucket rejected it: no capacity was consumed
            self._slots.release(slot_key, req[self.R_CONC_SLOT])
            self.counters["device_throttled"] += 1
            raise LoadBalancerThrottleException(
                "Too many requests in the last minute (device rate "
                "admission).")
        if inv_idx < 0:
            self._slots.release(slot_key, req[self.R_CONC_SLOT])
            raise LoadBalancerException(
                "No invokers available to schedule the activation.")
        if forced:
            self.counters["forced_placements"] += 1
        invoker = self._registry[inv_idx]
        promise = self.setup_activation(msg, action, invoker)
        entry = self.activation_slots.get(msg.activation_id.asString)
        if entry is not None:
            entry.conc_slot = req[self.R_CONC_SLOT]
        return invoker, promise

    def publish_many(self, pairs) -> List[asyncio.Future]:
        """The batch-shaped publish SPI: one call schedules a whole
        admission batch — one clock read and arrival-EWMA pass, one block
        write into the request ring, one shared flush decision (full
        buckets dispatch inline) — with per-row continuations as
        done-callbacks (`_row_placed`). Each returned future resolves to
        the completion promise (what `publish` returns) or raises
        `publish`'s exact exceptions. `batch_publish=False`: the serial
        per-pair default."""
        if not self.batch_publish:
            return super().publish_many(pairs)
        loop = asyncio.get_event_loop()
        outs: List[asyncio.Future] = [loop.create_future() for _ in pairs]
        err = self._standby_error()
        if err is not None:
            # a fresh exception per row, as N publish calls raise N
            for out in outs:
                out.set_exception(type(err)(*err.args))
            return outs
        built: List[tuple] = []
        ring = self.partition_ring
        # cross-partition spillover (active/active): with a peered sink
        # and the pending queue past the depth gate, this batch's
        # NON-BLOCKING tail forwards to the least-loaded peer instead of
        # deepening the local queue (the forwarded rows are fenced with
        # this owner's partition epoch, so the peer's journal replays
        # them exactly; blocking rows stay local — their client waits on
        # THIS controller's completion promise)
        overflow = 0
        if (ring is not None and self.spillover_sink is not None
                and self.spillover_sink.has_peer()):
            overflow = max(0, len(self._pending) + len(pairs)
                           - self.spillover_depth)
        spill_rows: List[tuple] = []
        for (action, msg), out in zip(pairs, outs):
            pid = None
            if ring is not None:
                pid = self.partition_of_msg(msg)
                err = self._partition_refusal(msg, pid)
                if err is not None:
                    out.set_exception(err)
                    continue
                if overflow > 0 and not msg.blocking \
                        and pid in self.owned_partitions:
                    spill_rows.append((action, msg, out, pid))
                    overflow -= 1
                    continue
            try:
                req, slot_key, fqn_str = self._build_row(action, msg)
            except Exception as e:  # noqa: BLE001 — per-row isolation,
                # like N independent publish calls
                out.set_exception(e)
                continue
            built.append((req, loop.create_future(), slot_key, msg, action,
                          out, fqn_str, pid))
        if spill_rows:
            self._spill_forward(spill_rows)
        if not built:
            return outs
        # the serial path notes an arrival only after a successful row
        # build, so the shared clock read counts built rows
        t_now = time.monotonic()
        self._note_arrivals(t_now, len(built))
        self._req_ring.push_block(
            np.asarray([b[0] for b in built], np.int32).T)
        for req, fut, slot_key, msg, _action, _out, fqn_str, pid in built:
            entry = (req, fut, slot_key, t_now, msg.activation_id.asString,
                     fqn_str, trace_id_of(msg.trace_context))
            self._pending.append(
                entry if pid is None
                else entry + ((pid, self._row_epoch(msg, pid)),))
        self.waterfall.stamp_many([b[3].activation_id.asString for b in built],
                                  STAGE_PUBLISH_ENQUEUE)
        # ONE shared flush decision: drain full buckets inline, then apply
        # the serial eager/window rule once
        while (len(self._pending) >= self.max_batch
               and self._try_flush_now()):
            pass
        if self._pending and not (self._eager() and self._try_flush_now()):
            self._arm_flush(urgent=len(self._pending) >= self.max_batch)
        for req, fut, slot_key, msg, action, out, _fqn, _pid in built:
            # a caller that goes away cancels its row: the readback fan-out
            # reads that as an abandoned publisher and returns the capacity
            out.add_done_callback(
                lambda o, f=fut: (f.cancel() if (o.cancelled()
                                                 and not f.done())
                                  else None))
            fut.add_done_callback(
                lambda f, r=req, sk=slot_key, m=msg, ac=action, o=out:
                self._row_placed(f, r, sk, m, ac, o))
        return outs

    def _row_epoch(self, msg, pid: int) -> int:
        """The fence epoch a row is admitted under: our view of its
        partition's epoch, or the origin's stamp when that is ahead (a
        spilled row whose claim announcement we have not folded yet)."""
        ep = self.partition_epochs.get(pid, 0)
        if msg.fence_part == pid and msg.fence_epoch is not None:
            ep = max(ep, int(msg.fence_epoch))
        return ep

    def _spill_forward(self, rows: List[tuple]) -> None:
        """Forward an overflow sub-batch to the spillover sink
        (spillover.py). Each row is fence-stamped with ITS partition's
        current epoch BEFORE it leaves — the stamp is both the invoker
        fence and the peer-side admission credential — and the waterfall
        stamps the extra hop, then folds the origin-side partial vector
        (the peer's books own the rest of the row's life). The caller's
        future resolves to a completed placeholder promise: spillover
        only takes non-blocking rows, whose promise is never awaited."""
        wf = self.waterfall
        loop = asyncio.get_event_loop()
        pairs = []
        for action, msg, _out, pid in rows:
            msg.fence_part = pid
            msg.fence_epoch = self.partition_epochs.get(pid, 0)
            pairs.append((action, msg))
        try:
            sent = self.spillover_sink.forward(pairs)
        except Exception as e:  # noqa: BLE001 — a failing forward fails
            # its rows like a refused publish, never the whole batch —
            # and is never counted as a forward (no stamp, no counter)
            for _action, _msg, out, _pid in rows:
                if not out.done():
                    out.set_exception(LoadBalancerException(
                        f"spillover forward failed: {e}"))
            return
        # handed to the sink: NOW count the forwards and fold the
        # origin-side waterfall (an async send that later fails shows up
        # in loadbalancer_spillover_send_failed, like a lost produce)
        for _action, msg, _out, _pid in rows:
            aid = msg.activation_id.asString
            wf.stamp(aid, STAGE_SPILL_FORWARD)
            row = wf.finish(aid)
            # the origin half's tail verdict runs HERE — the spill hop is
            # this process's terminal stage (no completion ack ever comes
            # back to these books), so waiting for one would leak the
            # pending spans forever. The kept half (the origin's spans and
            # the hop span joined to the partial stage vector) is what
            # /admin/trace/{id} merges with the peer's half.
            if self.trace_store.enabled:
                tid = (row or {}).get("trace_id") or trace_id_of(
                    getattr(msg, "trace_context", None))
                self.trace_store.complete(aid, tid, row=row)
        self.spilled_rows += len(rows)
        self.counters["spillover_forwarded"] += len(rows)
        for (_action, _msg, out, _pid), row_sent in zip(rows, sent):
            placeholder: asyncio.Future = loop.create_future()
            placeholder.set_result(None)

            def _resolve(sf: asyncio.Future, o=out, p=placeholder) -> None:
                exc = None if sf.cancelled() else sf.exception()
                if exc is not None:
                    self.counters["spillover_send_failed"] += 1
                if o.done():
                    return
                if sf.cancelled():
                    o.cancel()
                elif exc is not None:
                    o.set_exception(exc)
                else:
                    o.set_result(p)

            row_sent.add_done_callback(_resolve)

    def _row_placed(self, fut: asyncio.Future, req: tuple, slot_key: str,
                    msg, action, out: asyncio.Future) -> None:
        """One batched row's continuation (a done-callback on its placement
        future): the serial publish's post-placement body, then the
        dispatch send handed to the bus coalescer WITHOUT awaiting (its
        flush future resolves `out`, so send failures still surface exactly
        like the serial path's raised send errors). All rows of a readback
        wave run their callbacks in one sweep, so their sends coalesce into
        the same bus frames the serial path's fan-out produced."""
        try:
            if fut.cancelled():
                return  # abandoned: the fan-out returned the capacity
            exc = fut.exception()
            if exc is not None:
                # dispatch failure: the failing step already released the
                # row's slot
                if not out.done():
                    out.set_exception(exc)
                return
            inv_idx, forced = fut.result()
            if out.cancelled():
                # caller went away between the fan-out and this callback
                self._abandon_placement(int(inv_idx), req, slot_key)
                return
            invoker, promise = self._map_placement(inv_idx, forced, req,
                                                   slot_key, msg, action)
            send_nowait = getattr(self.producer, "send_nowait", None)
            if send_nowait is not None:
                # fence stamping + published counter shared with the
                # serial send (prepare_dispatch), so the two paths
                # cannot drift. Note this task-free submit is the one
                # dispatch that does NOT flow through the
                # send_activation_to_invoker hook — minting a coroutine
                # per row to honor it would be the exact per-activation
                # floor this path removes.
                topic = self.prepare_dispatch(msg, invoker)
                sendf = send_nowait(topic, msg)

                def _sent(sf: asyncio.Future) -> None:
                    # retrieve the flush outcome UNCONDITIONALLY (before
                    # any early-return): a caller gone by cancellation
                    # must not leave an unretrieved flush exception
                    # spamming the loop's GC-time logger
                    send_exc = (None if sf.cancelled()
                                else sf.exception())
                    if out.done():
                        return
                    if sf.cancelled():
                        # the coalescer's drainer was cancelled with the
                        # dispatch still queued (loop teardown): serial
                        # parity is the awaited send RAISING
                        # CancelledError to the caller — never success
                        # for an unsent dispatch
                        out.cancel()
                        return
                    if send_exc is not None:
                        # serial parity: the entry stays; the forced
                        # timeout self-heals the held capacity
                        out.set_exception(send_exc)
                    else:
                        out.set_result(promise)

                sendf.add_done_callback(_sent)
            else:
                # raw (non-coalescing) producer: no task-free submit —
                # one send task per row, the serial cost (this is the
                # coalescing-off configuration, not the hot path). The
                # task awaits send_activation_to_invoker (which runs
                # prepare_dispatch itself), so the documented dispatch
                # hook keeps covering this path for subclasses/tests.
                task = asyncio.get_event_loop().create_task(
                    self._send_then_resolve(invoker, msg, out, promise))
                self._publish_finishers.add(task)
                task.add_done_callback(self._publish_finishers.discard)
        except Exception as e:  # noqa: BLE001 — a raising done-callback
            # would strand the caller: fail the row instead
            if not out.done():
                out.set_exception(e)

    async def _send_then_resolve(self, invoker, msg, out: asyncio.Future,
                                 promise) -> None:
        try:
            await self.send_activation_to_invoker(msg, invoker)
        except Exception as e:  # noqa: BLE001 — the serial publish raises it
            if not out.done():
                out.set_exception(e)
            return
        if not out.done():
            out.set_result(promise)

    def _abandon_placement(self, inv_idx: int, req: tuple,
                           slot_key: str) -> None:
        """A publisher went away after its request was (or will never be)
        placed: route the reserved capacity through the release queue,
        which frees the host slot at drain time."""
        if inv_idx >= 0:
            self._queue_release(inv_idx, req[self.R_CONC_SLOT],
                                req[self.R_NEED_MB], req[self.R_MAX_CONC],
                                slot_key)
            self._arm_flush()
        else:
            self._slots.release(slot_key, req[self.R_CONC_SLOT])

    def _queue_release(self, inv: int, slot: int, mem: int, maxc: int,
                       key: str) -> None:
        """Buffer one capacity release for the next device step."""
        self._rel_ring.push((inv, slot, mem, maxc))
        self._releases.append((key, slot))

    # -- completion hooks --------------------------------------------------
    def release_invoker(self, invoker: InvokerInstanceId, entry) -> None:
        action_name = entry.action_key.rsplit("@", 1)[0]
        key = f"{action_name}:{entry.memory_mb}"
        slot = (entry.conc_slot if entry.conc_slot is not None
                else self._slots.lookup(key))
        self._queue_release(invoker.instance, slot, entry.memory_mb,
                            entry.max_concurrent, key)
        self._arm_flush()

    def on_invocation_finished(self, invoker, is_system_error, forced) -> None:
        self.supervision.on_invocation_finished(invoker, is_system_error, forced)

    async def invoker_health(self) -> List[InvokerHealth]:
        return self.supervision.health()

    def kernel_profile(self) -> dict:
        """The profiling-plane payload, labeled with the kernels actually
        running ("cuda" on the card, "torch" for the plain versions on the
        CPU, "sharded" on a mesh) — host-side reads only, no device sync
        (the allocator statistics are host counters)."""
        out = self.profiler.profile_json(kernel=self.kernel_resolved)
        out["placement_kernel"] = self.placement_kernel_resolved
        out["kernel_chosen_by"] = "static"
        if self.mesh is not None:
            out["mesh"] = {"n_shards": self.n_shards,
                           "axis": self.fleet_axis}
        return out

    #: occupancy() serves from the last readback's CACHED books — no
    #: device sync, so the admin endpoint runs inline on the event loop
    OCCUPANCY_SYNCS_DEVICE = False

    def occupancy(self) -> dict:
        """Per-invoker memory in use from the last readback's cached books
        (refreshed on every readback and state install): no device sync on
        the caller's path; under a full pipeline it lags the dispatched
        state by up to `pipeline_depth` unread steps."""
        self._refresh_partitions()
        free = self._books_cache
        caps = self._caps_mb
        rows = []
        for i, inv in enumerate(self._registry):
            cap = int(caps[i])
            f = int(free[i]) if i < len(free) else cap
            rows.append((inv.as_string, self._healthy[i], cap, f, cap - f))
        out = occupancy_json(self.placement_kernel_resolved, rows)
        if self.mesh is not None:
            # per-shard books aggregated from the SAME cached vector —
            # still zero device syncs on the API path
            out["mesh"] = {"n_shards": self.n_shards,
                           "axis": self.fleet_axis}
            out["shards"] = self._shard_occupancy(free, caps)
        return out

    def _shard_occupancy(self, free, caps) -> List[dict]:
        """Per-shard occupancy rows from host-cached books. Shard s owns
        invoker rows [s*k, (s+1)*k) with k = n_pad / n_shards (the
        sharded books' block layout); padding rows carry zero capacity and
        zero free, so they drop out of the sums."""
        rows_per = max(1, self._n_pad // max(1, self.n_shards))
        n_reg = len(caps)
        out = []
        for s in range(self.n_shards):
            lo, hi = s * rows_per, (s + 1) * rows_per
            reg_hi = min(hi, n_reg)
            cap = int(caps[lo:reg_hi].sum()) if lo < n_reg else 0
            f = int(free[lo:min(hi, len(free))].sum()) \
                if lo < len(free) else cap
            used = cap - f
            out.append({"shard": s,
                        "invokers": max(0, reg_hi - lo),
                        "capacity_mb": cap, "used_mb": used,
                        "occupancy": (round(used / cap, 4) if cap
                                      else 0.0)})
        return out

    def _export_shard_gauges(self) -> None:
        """`loadbalancer_fleet_shards` + per-shard occupancy ratios from
        the cached books — host numpy only, never a device sync (rides
        the 1 Hz supervision tick)."""
        self.metrics.gauge("loadbalancer_fleet_shards", self.n_shards)
        free = self._books_cache
        if free is None:
            return
        for row in self._shard_occupancy(free, self._caps_mb):
            self.metrics.gauge("loadbalancer_shard_occupancy_ratio",
                               row["occupancy"],
                               tags={"shard": str(row["shard"])})

    @property
    def rtt_policy(self) -> str:
        """The dispatch policy the readback RTT selects: "eager" (fast
        device: an idle balancer dispatches each arrival at once) or
        "window" (arrivals wait out batch_window)."""
        return "eager" if self._rtt_ewma_ms < self.RTT_FAST_MS else "window"

    # -- the flush policy --------------------------------------------------
    def _note_arrival(self, now: float) -> None:
        """Track the publish inter-arrival EWMA: the adaptive window's
        pressure signal."""
        gap_ms = (now - self._last_pub_t) * 1e3
        self._last_pub_t = now
        self._last_gap_ms = gap_ms
        self._gap_ewma_ms = min(0.9 * self._gap_ewma_ms + 0.1 * gap_ms,
                                1000.0)

    def _note_arrivals(self, now: float, n: int) -> None:
        """n arrivals at ONE clock read: the first blends the real gap, the
        rest blend zero gaps — a 0.9^(n-1) decay in closed form. At n=1
        this IS `_note_arrival`."""
        self._note_arrival(now)
        if n > 1:
            self._gap_ewma_ms *= 0.9 ** (n - 1)
            self._last_gap_ms = 0.0

    def _coalesce_window_s(self) -> float:
        """> 0 when arrival pressure says windowed batching beats eager
        dispatch: the EWMA predicts at least ADAPTIVE_MIN_BATCH arrivals in
        one window, and the last gap confirms traffic is still flowing."""
        if (self.adaptive_window
                and self._gap_ewma_ms * self.ADAPTIVE_MIN_BATCH
                <= self.ADAPTIVE_WINDOW_MS
                and self._last_gap_ms <= self.ADAPTIVE_WINDOW_MS):
            return self.ADAPTIVE_WINDOW_MS / 1e3
        return 0.0

    def _arm_flush(self, urgent: bool = False) -> None:
        if self._closing:
            return  # close() drains queued releases host-side itself
        window = self._coalesce_window_s()
        # idle fast path: with no step in flight there is nothing to batch
        # WITH, unless arrival pressure asks for a window
        if self._inflight_steps == 0 and self._pending and window == 0.0:
            urgent = True
        if self._flush_task is None or self._flush_task.done():
            self._flush_task = asyncio.get_event_loop().create_task(
                self._flush_later(0 if urgent
                                  else (window or self.batch_window)))

    async def _flush_later(self, delay: float) -> None:
        # loop INSIDE the task until drained: re-arming from here would be
        # a no-op (this task is not done yet) and strand leftover work
        while True:
            if delay:
                await asyncio.sleep(delay)
            if self._defer_until_built():
                return  # the early build's completion re-arms the flush
            async with self._step_lock:
                await self._device_step()
            if not (self._pending or self._releases or self._health_updates):
                return
            delay = self._coalesce_window_s() or self.batch_window

    def _try_flush_now(self) -> bool:
        """Synchronous dispatch when the pipeline has capacity and no flush
        task is mid-step (the dispatch body has no awaits)."""
        if (self._pending and not self._step_lock.locked()
                and self._inflight_steps < self.pipeline_depth
                and not self._closing and not self._defer_until_built()):
            self._set_inflight(1)
            self._dispatch_batch()
            return True
        return False

    # -- the early build ---------------------------------------------------
    def _defer_until_built(self) -> bool:
        """True while rows wait and the early build is still running: the
        flush is deferred, and re-armed on the loop when the job's future
        completes. A dispatch never enters the build from the loop (it
        would block on the build's lock, which the worker holds)."""
        job = self._kernels_job
        if job is None or job.done() or not self._pending:
            return False
        if not self._kernels_waiter:
            self._kernels_waiter = True
            loop = asyncio.get_event_loop()
            job.add_done_callback(
                lambda _f: loop.call_soon_threadsafe(self._kernels_built))
        return True

    def _start_early_build(self) -> concurrent.futures.Future:
        """The early build on a daemon worker thread: the process's kernel
        build and load (`placement_cuda.prewarm`, shared by every balancer
        of the process), then this balancer's warm steps. A mesh launches
        no CUDA placement kernel, but its release folds launch the release
        kernel once a shard, so it waits for the same build and then warms
        its sharded step."""
        build = placement_cuda.prewarm()
        job: concurrent.futures.Future = concurrent.futures.Future()
        job.set_running_or_notify_cancel()

        def run():
            try:
                build.result()
                self._warm_steps()
            except BaseException as e:  # noqa: BLE001 — to the waiters
                job.set_exception(e)
            else:
                job.set_result(None)

        threading.Thread(target=run, name="balancer-early-build",
                         daemon=True).start()
        return job

    def _warm_steps(self) -> None:
        """The JAX package's warm step (`_warm_fns`), here on the worker
        thread: the packed step (and the shadow step, with the quality
        plane on) once at each family's bucket, the scan's and the
        repair's, on all-zero dummy books of the live shape, with the
        readback's pinned copy. Valid masks are 0, so nothing places or
        releases. It warms what a process's first step pays on the loop
        otherwise: the kernels' runtime and launch set-up, the modules of
        the step's torch ops, the pinned staging memory. Its launches do
        not count. On a mesh the dummies are sharded like the live books
        and the sharded step is warmed."""
        rate_on = self.rate_limit_per_minute is not None
        rows = 10 if rate_on else 9
        h = self.HEALTH_BATCH
        with placement_cuda.uncounted():
            for bp in sorted({self._bucket(1, self.max_batch),
                              self._bucket(REPAIR_MIN_BATCH,
                                           self.max_batch)}):
                req = np.zeros((rows, bp), np.int32)
                req[1] = req[6] = 1  # padded columns: size 1, max_conc 1
                buf = np.concatenate([np.zeros(5 * bp + 3 * h, np.int32),
                                      req.ravel()])
                # the books' shape read once: the loop grows the live
                # books while this runs, and the dummies and the penalty
                # must agree with each other
                n_pad, slots = self._n_pad, self.action_slots
                dummy = init_state(1, [0], n_pad=n_pad, action_slots=slots,
                                   device=self.device)
                if self.mesh is not None:
                    dummy = shard_state(dummy, self.mesh)
                dbuf = self._to_device(buf)
                st, now = dummy, ()
                if rate_on:  # the admit variant: bucket state and a clock
                    st = (dummy, init_buckets(self.RATE_NS_BUCKETS,
                                              self.rate_limit_per_minute,
                                              device=self.device))
                    now = (np.float32(0.0),)
                if self._shadow_fn is not None:
                    self._shadow_fn(st, dbuf,
                                    torch.zeros((n_pad,), dtype=torch.int32,
                                                device=self.device), *now,
                                    bp, h, bp,
                                    scratch=_empty_books_like(dummy))
                _, out = self._packed_fn(st, dbuf, *now, bp, h, bp)
                self._warm_readback(out)

    def _warm_planes(self) -> None:
        """The 1 Hz tick's device programs once on dummy state, from the
        constructor: the telemetry fold and the anomaly step, with the
        scores' pinned copy (a process's first tick pays their modules on
        the loop otherwise, about half a second on the card). The planes
        are observability: a failure here is logged, as theirs are, and
        fails no placement."""
        acc = getattr(self.telemetry, "accumulator", None)
        if not (self.telemetry.enabled
                and getattr(acc, "kernel", "") == "device"):
            return
        try:
            tstate = record_packed(
                init_telemetry(acc.n_invokers, acc.n_namespaces,
                               acc.n_buckets, device=self.device),
                self._to_device(np.zeros((5, 8), np.int32)), acc.bounds)
            if self.anomaly.enabled:
                _, scores = make_anomaly_step(*self.anomaly._cfg_args())(
                    init_anomaly(acc.n_invokers, acc.n_buckets,
                                 device=self.device),
                    tstate.inv_buckets, tstate.inv_lat_ms,
                    tstate.inv_outcomes)
                self._warm_readback(scores)
        except Exception as e:  # noqa: BLE001 — observability only
            if self.logger:
                self.logger.warn(None, f"plane warm-up failed: {e!r}",
                                 "TpuBalancer")

    def _warm_readback(self, out: torch.Tensor) -> None:
        """A warm step's result copied to pinned host memory and waited
        for (on the card), as a readback is."""
        if self.device.type == "cuda":
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()

    def _kernels_built(self) -> None:
        self._kernels_waiter = False
        if self._pending:
            self._arm_flush(urgent=True)

    def _await_kernels(self) -> None:
        """Wait for the early build (a journal replay, an absorb) and
        raise its failure: a dispatch whose kernels failed to build fails,
        and so does every dispatch after it."""
        if self._kernels_job is not None:
            self._kernels_job.result()

    def _release_packed(self, pad_to: Optional[int] = None) -> np.ndarray:
        return pack_releases(self._rel_ring, self._releases, self._slots,
                             self.max_batch, pad_to)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A fresh host array on the books' device: through pinned memory
        with an asynchronous copy on the card (a pageable copy would wait
        for every step in flight)."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _start_readback(self, out: Optional[torch.Tensor],
                        summary: Optional[torch.Tensor] = None) -> _Readback:
        """Enqueue the copies of a step's decision vector (None for a fold
        without one), of the books it left and of its quality summary row
        (None with the plane off), right behind the step."""
        books = self._books_ref()
        if self.device.type != "cuda":
            return _Readback(out, books, None, summary)
        dev = (out, books, summary)
        hosts = [None if t is None else
                 torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for t in dev]
        for h, t in zip(hosts, dev):
            if h is not None:
                h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _Readback(hosts[0], hosts[1], event, hosts[2])

    @staticmethod
    def _wait(rb: _Readback) -> None:
        """Worker-thread side: wait for this readback's copies and nothing
        broader."""
        if rb.event is not None:
            rb.event.synchronize()

    def _read_back(self, rb: _Readback):
        """Device->host seam (runs on a worker thread; tests inject
        failures here): (chosen, forced, throttled, rounds) and the books."""
        self._wait(rb)
        return unpack_step_output(rb.out.numpy()), rb.books.numpy()

    async def _device_step(self) -> None:
        if not self._pending:
            # nothing to schedule: fold releases and health
            folded = bool(self._releases)
            try:
                rel_np = ups = None
                if self._releases:
                    rel_np = self._release_packed()
                    self.state = self._release_packed_fn(
                        self.state, self._to_device(rel_np))
                if self._health_updates:
                    ups, self._health_updates = self._health_updates, {}
                    self._set_health(list(ups.keys()), list(ups.values()))
                if (rel_np is not None or ups) and self._journal_live():
                    fold = {"t": "fold"}
                    if rel_np is not None:
                        fold["rel"] = encode_array(rel_np)
                    if ups:
                        fold["health"] = [[int(k), bool(v)]
                                          for k, v in ups.items()]
                    self._journal_append(fold)
            except Exception as e:  # noqa: BLE001 — a failed in-place fold
                # may have half-written the books; the popped releases are
                # moot once they are rebuilt at full capacity
                self._recover_failed_step()
                if self.logger:
                    self.logger.error(None, f"idle fold failed: {e!r}",
                                      "TpuBalancer")
                return
            if folded:
                self._refresh_books_async()
            self._telemetry_fold(self.telemetry.pending > 0)
            return
        # bound dispatched-but-unread steps BEFORE popping the batch: a
        # cancellation while waiting here (close() cancels the flush task)
        # must leave the queue intact for close() to fail
        while self._inflight_steps >= self.pipeline_depth:
            self._capacity_free.clear()
            await self._capacity_free.wait()
        self._set_inflight(1)
        self._dispatch_batch()

    def _dispatch_batch(self) -> None:
        batch, self._pending = (self._pending[:self.max_batch],
                                self._pending[self.max_batch:])
        t0 = time.monotonic()
        b = len(batch)
        # ONE shared power-of-two bucket for the release AND request axes
        n_rel = min(len(self._releases), self.max_batch)
        bp = max(self._bucket(b, self.max_batch),
                 self._bucket(n_rel, self.max_batch) if n_rel else 8)
        rate_on = self.rate_limit_per_minute is not None
        req_np = np.zeros((10 if rate_on else 9, bp), np.int32)
        req_np[1, b:] = 1  # padded columns: size 1, max_conc 1, invalid
        req_np[6, b:] = 1
        # the columns were written at publish time; without rate admission
        # the ring's ns_slot row is dropped
        self._req_ring.pop_into(req_np, b)
        # flight-recorder input digest, captured host-side before the step
        # (batch is FIFO: batch[0] carries the oldest enqueue time)
        rec = None
        if self.flight_recorder.enabled:
            rec = BatchRecord(digest={
                "kernel": self.placement_kernel_resolved,
                "healthy_invokers": sum(self._healthy),
                "queue_depth": b + len(self._pending),
                "oldest_age_ms": round((t0 - batch[0][3]) * 1e3, 3),
            })
            if self.mesh is not None:
                rec.digest["shards"] = self.n_shards
            tid = next((e[6] for e in batch if e[6]), None)
            if tid is not None:
                # the record carries a trace: the phase histogram's bucket
                # line gets an exemplar pointing at it (OpenMetrics only)
                rec.digest["trace_id"] = tid
        # waterfall: assemble/dispatch/readback are BATCH events — one
        # shared timestamp per edge for every activation in the batch (the
        # aid list is built once, only when the plane is live)
        wf = self.waterfall
        wf_aids = [e[4] for e in batch] if wf.enabled else None
        rel_np = self._release_packed(pad_to=bp)
        health_np = pack_health(self._health_updates, self.HEALTH_BATCH)
        buf = np.concatenate([rel_np.ravel(), health_np.ravel(),
                              req_np.ravel()])
        t_assembled = time.monotonic()
        r, h = rel_np.shape[1], health_np.shape[1]
        # one clock for both admissions: the shadow's rate-admission fold
        # (a pure function of buckets/now) reproduces production's
        # admitted set exactly
        now32 = (np.float32(time.monotonic() - self._t0_mono)
                 if rate_on else None)
        # host-observatory bracket: a GC pause landing inside this window
        # stalls the device dispatch — counting it here turns a mysterious
        # dispatch-stage outlier in the waterfall into an attributed cause
        GLOBAL_HOST_OBSERVATORY.begin_dispatch()
        try:
            self._await_kernels()  # done here: the flush waited for it
            dbuf = self._to_device(buf)
            shadow_out = self._shadow_pass(dbuf, now32, r, h, bp)
            if rate_on:
                (self.state, self._bucket_state), out = self._packed_fn(
                    (self.state, self._bucket_state), dbuf, now32, r, h, bp)
            else:
                self.state, out = self._packed_fn(self.state, dbuf, r, h, bp)
            q_summary = self._quality_step(
                dbuf[5 * r + 3 * h:].view(-1, bp)[:9], out, shadow_out)
            rb = self._start_readback(out, q_summary)
        except Exception as e:  # noqa: BLE001 — a failed dispatch must not
            # leak the permit or the host conc slots, or strand publishers
            self._set_inflight(-1)
            self._capacity_free.set()
            self._recover_failed_step()
            for req, fut, slot_key, _t, aid, *_ in batch:
                self._slots.release(slot_key, req[self.R_CONC_SLOT])
                wf.discard(aid)
                if not fut.done():
                    fut.set_exception(
                        LoadBalancerException(f"device dispatch failed: {e}"))
            if self.logger:
                self.logger.error(None, f"device dispatch failed: {e!r}",
                                  "TpuBalancer")
            return
        finally:
            GLOBAL_HOST_OBSERVATORY.end_dispatch()
        # write-ahead journal: the step above is enqueued, so the record
        # lands at exactly this point in the order of changes to the books
        # (the readback appends a matching `ack` with the decisions)
        jseq = 0
        if self._journal_live():
            jrec = {
                "t": "batch", "R": r, "H": h, "B": bp,
                "rows": int(req_np.shape[0]), "b": b,
                "buf": encode_array(buf), "aids": [e[4] for e in batch]}
            if self.partition_ring is not None:
                # active/active: the record carries its rows' ring
                # partitions plus the epoch each was admitted under, so
                # a handoff replays EXACTLY the partitions the new owner
                # absorbed and drops per-partition stale epochs
                # (replay_journal parts_filter). Off-mode records carry
                # neither key — the wire format is unchanged.
                pe: Dict[str, int] = {}
                for e in batch:
                    if len(e) > 7:
                        p, ep = e[7]
                        pe[str(p)] = max(pe.get(str(p), 0), int(ep))
                jrec["parts"] = sorted(int(p) for p in pe)
                jrec["pe"] = pe
            if self.mesh is not None:
                # shard count travels on EVERY batch record (the one-shot
                # `mesh` header can be pruned away with its snapshot):
                # replay refuses a topology mismatch per batch
                jrec["S"] = self.n_shards
            jseq = self._journal_append(jrec)
        # completion telemetry rides the SAME dispatch cycle: at most one
        # extra scatter-add per batch over event rows already packed
        # host-side — asynchronous like the step itself, no readback
        # (counts stay on the device until a scrape). Small tails are left
        # for the 1 Hz supervision tick / scrape-time drain instead of
        # paying a launch for a near-empty fold on every micro-batch.
        self._telemetry_fold(
            self.telemetry.pending >= self.TELEMETRY_FOLD_MIN)
        # phase breakdown: assembly is host numpy packing, dispatch the
        # enqueue (transfers + launches)
        t_dispatched = time.monotonic()
        if wf_aids is not None:
            wf.stamp_many(wf_aids, STAGE_BATCH_ASSEMBLE,
                          int(t_assembled * 1e9))
            wf.stamp_many(wf_aids, STAGE_DEVICE_DISPATCH,
                          int(t_dispatched * 1e9))
        self.profiler.observe_phase("assembly", (t_assembled - t0) * 1e3)
        self.profiler.observe_phase("dispatch",
                                    (t_dispatched - t_assembled) * 1e3)
        if rec is not None:
            rec.timings["assembly_ms"] = round((t_assembled - t0) * 1e3, 3)
            rec.timings["dispatch_ms"] = round(
                (t_dispatched - t_assembled) * 1e3, 3)
        self.counters["steps"] += 1
        task = asyncio.get_event_loop().create_task(
            self._readback_step(batch, b, out, rb, t0, req_np,
                                self._next_books_seq(), rec, jseq))
        self._readbacks.add(task)
        task.add_done_callback(self._readbacks.discard)

    def _shadow_pass(self, dbuf, now32, r: int, h: int, bp: int):
        """The quality plane's shadow counterfactual, every
        `shadow_every_n`-th batch: a decision-only pass over the SAME
        packed buffer on the shadow copy of the books, enqueued BEFORE the
        production step so the copy reads the pre-step books. Returns its
        decision vector, or None. A failure is logged and swallowed: the
        shadow is observability and never takes placement down."""
        if self._shadow_fn is None:
            return None
        self._quality_batches += 1
        k = self.quality.shadow_every_n
        if k <= 0 or self._quality_batches % k:
            return None
        try:
            if now32 is not None:
                return self._shadow_fn(
                    (self.state, self._bucket_state), dbuf,
                    self._shadow_penalty, now32, r, h, bp,
                    scratch=self._shadow_scratch)
            return self._shadow_fn(self.state, dbuf, self._shadow_penalty,
                                   r, h, bp, scratch=self._shadow_scratch)
        except Exception as e:  # noqa: BLE001 — observability only
            if self.logger:
                self.logger.warn(None, f"shadow step failed: {e!r}",
                                 "TpuBalancer")
            return None

    def _quality_step(self, req, out, shadow_out):
        """Quality scoring (every batch while the plane is on): one
        read-only pass over the POST-commit books, the decision vector
        and the anomaly EWMAs, enqueued right behind the step; its summary
        row comes back with the step's readback. Failures are logged and
        swallowed, as the shadow's are. On a mesh the scorer reads the
        global books gathered onto the lead device: one copy of every
        shard a batch."""
        if not self.quality.enabled:
            return None
        try:
            st = self._global_books()
            return self.quality.device_step(
                st.free_mb, st.conc_free, st.health,
                self._quality_ewma, self._quality_caps, req, out, shadow_out)
        except Exception as e:  # noqa: BLE001 — observability only
            if self.logger:
                self.logger.warn(None, f"quality step failed: {e!r}",
                                 "TpuBalancer")
            return None

    def _telemetry_fold(self, due: bool) -> None:
        """Fold the buffered completion events into the device accumulator
        when `due`; a telemetry failure never takes the placement path
        down with it (it is counted and logged)."""
        if not due:
            return
        try:
            self.telemetry.device_fold()
        except Exception as e:  # noqa: BLE001
            self.counters["telemetry_fold_failures"] += 1
            if self.logger:
                self.logger.warn(None, f"telemetry fold failed: {e!r}",
                                 "TpuBalancer")

    def _refresh_books_async(self) -> None:
        """Refresh occupancy()'s cached books after a fold that has no
        readback of its own, off the event loop."""
        rb = self._start_readback(None)
        seq = self._next_books_seq()

        async def _pull():
            await asyncio.to_thread(self._wait, rb)
            self._install_books(rb.books.numpy(), seq)

        task = asyncio.get_event_loop().create_task(_pull())
        self._readbacks.add(task)
        task.add_done_callback(self._readbacks.discard)

    async def _readback_step(self, batch, b, out, rb: _Readback, t0,
                             req_np, books_seq: int, rec=None,
                             journal_seq: int = 0) -> None:
        def _read():
            t_r0 = time.monotonic()
            arrs, books_np = self._read_back(rb)
            t_r1 = time.monotonic()
            rb_ms = (t_r1 - t_r0) * 1e3
            self.profiler.observe_phase("readback", rb_ms)
            # benign cross-thread write: a float EWMA steering a heuristic
            self._rtt_ewma_ms = 0.8 * self._rtt_ewma_ms + 0.2 * rb_ms
            # the digest's fleet view from the POST-step books this
            # readback already copied: no device read of its own
            if rec is not None:
                caps = self._caps_mb
                n_reg = min(len(caps), len(books_np))
                cap_total = int(caps[:n_reg].sum())
                used = cap_total - int(books_np[:n_reg].sum())
                rec.digest["free_slot_hist"] = free_slot_histogram(
                    books_np[:n_reg], MIN_SLOT_MB)
                rec.digest["occupancy"] = (
                    round(used / cap_total, 4) if cap_total else 0.0)
                rec.timings["readback_ms"] = round(rb_ms, 3)
            # quality summary: the scorer's row came back with this
            # readback's copies
            if rb.summary is not None:
                try:
                    s = rb.summary.numpy()
                    self.quality.note_summary(s)
                    if rec is not None:
                        rec.digest["quality"] = {
                            "regret_ms": round(float(s[S_REGRET_SUM_MS]), 3),
                            "imbalance_cov": round(
                                float(s[S_IMBALANCE_COV]), 4),
                            "divergent": int(s[S_DIVERGENT]),
                        }
                except Exception as e:  # noqa: BLE001 — a failed score
                    # readout must not fail the batch readback
                    if self.logger:
                        self.logger.warn(
                            None, f"quality summary failed: {e!r}",
                            "TpuBalancer")
            return arrs, t_r1, books_np

        try:
            (chosen_np, forced_np, throttled_np, rounds), t_done, books_np = \
                await asyncio.to_thread(_read)
            self._install_books(books_np, books_seq)
            if journal_seq and self._journal_live():
                # the committed decision vector, keyed to the dispatch-time
                # batch record: replay asserts parity against it, and the
                # throttled bits tell replay which requests the device rate
                # admission rejected (they consumed no capacity)
                enc = (((chosen_np[:b].astype(np.int64) + 1) << 2)
                       | (throttled_np[:b].astype(np.int64) << 1)
                       | forced_np[:b].astype(np.int64))
                self._journal_append({"t": "ack", "for": journal_seq,
                                      "out": [int(v) for v in enc]})
        except Exception as e:  # noqa: BLE001 — the DISPATCH succeeded, so
            # the books hold this batch's placements with no publisher left
            # to release them: reverse them ON DEVICE from `out` (no
            # readback needed; the release fold inverts the schedule's)
            compensated = True
            try:
                chosen = unpack_chosen(out[:-1])[0]
                req = torch.from_numpy(req_np[[5, 4, 6, 8]]).to(self.device)
                rel = torch.stack([chosen.clamp_min(0), req[0], req[1],
                                   req[2], req[3] * (chosen >= 0).int()])
                self.state = self._release_packed_fn(self.state, rel)
                if journal_seq and self._journal_live():
                    # the dispatch-time batch record stands; journal its
                    # reversal on the device so replay undoes it
                    # identically (the host copy syncs, but this is
                    # already an error path)
                    self._journal_append({"t": "fold",
                                          "rel": encode_array(
                                              rel.cpu().numpy())})
            except Exception:  # noqa: BLE001 — device genuinely dead: keep
                # the host refcounts PINNED so the slot indices cannot pass
                # to another action with phantom concurrency
                compensated = False
                self._recover_failed_step()
            for req, fut, slot_key, _t, aid, *_ in batch:
                if compensated:
                    self._slots.release(slot_key, req[self.R_CONC_SLOT])
                self.waterfall.discard(aid)
                if not fut.done():
                    fut.set_exception(
                        LoadBalancerException(f"device step failed: {e}"))
            self._set_inflight(-1)
            self._capacity_free.set()
            if self.logger:
                self.logger.error(None, f"device readback failed: {e!r} "
                                  f"(compensated={compensated})",
                                  "TpuBalancer")
            return
        self._set_inflight(-1)
        self._capacity_free.set()
        wf = self.waterfall
        if wf.enabled:
            wf.stamp_many([e[4] for e in batch], STAGE_DEVICE_READBACK,
                          int(t_done * 1e9))
        dt_ms = (t_done - t0) * 1e3
        self.step_ms.append(dt_ms)
        self.counters["scheduled"] += b
        if rounds > 0:
            self.counters["repair_steps"] += 1
            self.counters["repair_rounds"] += rounds
            if rec is not None:
                rec.digest["repair_rounds"] = rounds
        t_f0 = time.monotonic()
        for (req, fut, slot_key, *_), inv_idx, f, thr in zip(
                batch, chosen_np, forced_np, throttled_np):
            if fut.cancelled():
                # abandoned publisher: nobody will ever ack this activation
                # (a throttled row carries chosen -1: nothing was reserved)
                self._abandon_placement(int(inv_idx), req, slot_key)
            elif not fut.done():
                fut.set_result((-2 if thr else int(inv_idx), bool(f)))
        fanout_ms = (time.monotonic() - t_f0) * 1e3
        prof = self.profiler
        prof.observe_phase("fanout", fanout_ms)
        prof.observe_phase("total", dt_ms,
                           trace_id=(rec.digest.get("trace_id")
                                     if rec is not None else None))
        if rec is not None:
            # tail sampling: with a threshold armed, full per-decision rows
            # are filed only for slow batches (a live capture window takes
            # everything); skipped batches still refresh the gauges
            self._record_batch(rec, batch, chosen_np, forced_np, throttled_np,
                               fanout_ms, file=prof.admit_batch(dt_ms))
            # after the record files: the device span's batch_seq tag is
            # the assigned ring seq (the join key /admin/trace ships)
            self._trace_batch_hooks(rec, batch, forced_np, dt_ms, b)
            if prof.capture_armed:
                row = rec.to_json()
                row["total_ms"] = round(dt_ms, 3)
                prof.capture_step(row)
        elif prof.capture_armed:
            # flight recorder off: the capture window still gets timings
            prof.capture_step({"ts": time.time(), "batch_size": b,
                               "total_ms": round(dt_ms, 3)})

    def _trace_batch_hooks(self, rec, batch, forced_np, dt_ms: float,
                           b: int) -> None:
        """Trace-observatory riders for one placed micro-batch,
        all from stamps already taken (rec.ts, dt_ms — no new clock
        reads): the per-batch `device_dispatch` span under the digest's
        trace id (the flight-recorder link the assembled tree joins on),
        the `divergent` mark when the shadow counterfactual disagreed,
        the `exemplar` force-keep (the phase histogram just pinned this
        trace id onto a bucket line — every rendered exemplar must
        resolve), and the `forced` mark per force-placed row."""
        from ...utils.tracestore import GLOBAL_TRACE_STORE, synthetic_span
        store = GLOBAL_TRACE_STORE
        if not store.active:
            return
        tid = rec.digest.get("trace_id")
        if tid:
            store.emit(synthetic_span(
                tid, "device_dispatch", rec.ts, rec.ts + dt_ms / 1e3,
                tags={"proc": f"controller{self.controller.name}",
                      "batch_seq": str(rec.seq),
                      "kernel": str(rec.digest.get("kernel")),
                      "batch_size": str(b)}))
            if self.profiler.enabled:
                store.force(tid, "exemplar")
            q = rec.digest.get("quality")
            if q and q.get("divergent"):
                store.mark(tid, "divergent")
        for e, f in zip(batch, forced_np):
            if f and e[6]:
                store.mark(e[6], "forced")

    def _record_batch(self, rec, batch, chosen_np, forced_np, throttled_np,
                      fanout_ms: float, file: bool = True) -> None:
        """Finish and file the flight-recorder record for one micro-batch,
        and refresh the introspection gauges. `file=False` (tail-sampled
        fast batch) refreshes the gauges without ringing the record."""
        rec.timings["fanout_ms"] = round(fanout_ms, 3)
        fr = self.flight_recorder
        if file:
            n_reg = len(self._registry)
            decisions = rec.decisions
            for (req, fut, slot_key, t_enq, aid, act, _tid, *_), ci, f, thr \
                    in zip(batch, chosen_np, forced_np, throttled_np):
                ci = int(ci)
                name = (self._registry[ci].as_string
                        if 0 <= ci < n_reg else None)
                decisions.append((aid, act, ci, name, bool(f), bool(thr),
                                  req[self.R_NEED_MB]))
            fr.record(rec)
        m = self.metrics
        d = rec.digest
        m.gauge("loadbalancer_placement_queue_depth", d["queue_depth"])
        m.gauge("loadbalancer_placement_batch_age_ms", d["oldest_age_ms"])
        m.gauge("loadbalancer_healthy_invokers", d["healthy_invokers"])
        m.gauge("loadbalancer_fleet_occupancy_ratio", d.get("occupancy", 0.0))
        m.gauge("loadbalancer_flight_recorder_dropped", fr.dropped)


class TpuBalancerProvider:
    @staticmethod
    def instance(**kwargs) -> TpuBalancer:
        return TpuBalancer(**kwargs)
