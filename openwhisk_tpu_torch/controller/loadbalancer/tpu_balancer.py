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

The device half: each step packs releases, health flips and requests into
ONE int32 host buffer, copies it to the device once, runs ONE fused step
and copies the B+1 decision vector back once. On the card (`device=None`
or "cuda") the schedule always runs the CUDA kernels (`_cuda_pair`); the
release and health folds are plain torch ops on the card. On the CPU
(`device="cpu"`) everything is the plain torch version (`_torch_pair`).
The books are updated in place.
"""
from __future__ import annotations

import asyncio
import time
import zlib
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ...core.entity import ExecutableWhiskAction, InvokerInstanceId
from ...messaging.message import ActivationMessage
from ...models.sharding_policy import (MIN_SLOT_MB, generate_hash,
                                       pairwise_coprimes)
from ...ops.placement import (PlacementState, init_state,
                              make_fused_admit_step_packed,
                              make_fused_step_packed, make_release_packed,
                              release_batch, release_batch_vector,
                              resolve_device, schedule_batch,
                              schedule_batch_repair, set_health,
                              unpack_chosen, unpack_step_output)
from ...ops.placement_cuda import (schedule_batch_cuda,
                                   schedule_batch_repair_cuda,
                                   to_transposed)
from ...ops.throttle import init_buckets
from ...utils.ring_buffer import ColumnRing
from .base import (HEALTHY, CommonLoadBalancer, InvokerHealth,
                   LoadBalancerException, LoadBalancerThrottleException,
                   occupancy_json)
from .supervision import InvokerPool

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


def device_pair(device: torch.device, placement_kernel: str):
    """The (schedule, release, resolved) pair for the books' device: the
    CUDA kernels on the card, the plain torch versions on the CPU."""
    pair = _cuda_pair if device.type == "cuda" else _torch_pair
    return pair(placement_kernel)


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
    to another device or kernel."""

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

    _bucket = staticmethod(bucket)

    def __init__(self, messaging_provider, controller_instance, logger=None,
                 cluster_size: int = 1, managed_fraction: float = 0.9,
                 blackbox_fraction: float = 0.1, batch_window: float = 0.002,
                 max_batch: int = 256, action_slots: int = 4096,
                 max_action_slots: int = 65536, initial_pad: int = 64,
                 pipeline_depth: int = 4,
                 rate_limit_per_minute: Optional[int] = None,
                 placement_kernel: str = "auto",
                 adaptive_window: bool = True, batch_publish: bool = True,
                 device=None):
        self.device = resolve_device(device)
        super().__init__(messaging_provider, controller_instance, logger)
        self._cluster_size = cluster_size
        self.managed_fraction = managed_fraction
        self.blackbox_fraction = blackbox_fraction
        self.batch_window = batch_window
        self.max_batch = max_batch
        self.action_slots = action_slots
        self.max_action_slots = max(max_action_slots, action_slots)
        self.placement_kernel = placement_kernel
        self.adaptive_window = adaptive_window
        self.batch_publish = batch_publish
        self.rate_limit_per_minute = rate_limit_per_minute
        self.pipeline_depth = max(1, pipeline_depth)
        self._n_pad = initial_pad

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

        sched, release, self.placement_kernel_resolved = device_pair(
            self.device, placement_kernel)
        self._release_packed_fn = make_release_packed(release)
        self._bucket_state = None
        if rate_limit_per_minute is not None:
            self._packed_fn = make_fused_admit_step_packed(release, sched)
            # soft state: a rolling rate window, kept across book rebuilds
            self._bucket_state = init_buckets(
                self.RATE_NS_BUCKETS, rate_limit_per_minute,
                device=self.device)
        else:
            self._packed_fn = make_fused_step_packed(release, sched)

        #: host copy of free_mb from the last readback or state install;
        #: occupancy() serves from it. Installs are sequence-guarded:
        #: readbacks finish out of order under the pipeline.
        self._books_cache: Optional[np.ndarray] = None
        self._books_seq = 0
        self._books_cache_seq = 0
        self.state: Optional[PlacementState] = None
        self._init_device_state()

        # request queue: (req, placement future, slot key) per row, its int
        # columns mirrored in a ring; releases: (slot key, slot) per row,
        # columns in a ring
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
            logger=logger, group=f"health-{controller_instance.as_string}")

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

    def _install_state(self, state: PlacementState) -> None:
        self.state = state
        self._set_books_now()

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
        stream before the next step mutates the live books in place."""
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

    def _set_inflight(self, delta: int) -> None:
        self._inflight_steps += delta

    def _grow_padding(self, new_pad: int) -> None:
        """Re-pad the books to `new_pad` invoker rows on the device,
        PRESERVING the live books (in-flight holds survive fleet growth;
        only update_cluster resets them, which is reference behavior). The
        copies are stream-ordered after every dispatched step."""
        st = self.state
        n_old = st.free_mb.shape[0]
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

    def _grow_slots(self, new_slots: int) -> None:
        """Widen the books' action axis on the device, preserving every
        live permit."""
        st = self.state
        conc = torch.zeros((new_slots, self._n_pad), dtype=st.free_mb.dtype,
                           device=self.device)
        conc[:self.action_slots] = st.conc_free.T
        self.action_slots = new_slots
        self._slots.grow(new_slots)
        self._install_state(PlacementState(st.free_mb, conc.T, st.health))
        self.counters["action_slot_growth"] += 1

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
            self.state.free_mb[torch.tensor(new_rows)] = torch.tensor(
                [self._slot_mb(self._registry[i].user_memory.to_mb)
                 for i in new_rows], dtype=torch.int32).to(self.device)
            self._set_books_now()
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

    def update_cluster(self, cluster_size: int) -> None:
        """Controller joined/left: re-shard every invoker's memory (ref
        updateCluster :561-584); the books restart at full capacity."""
        if cluster_size != self._cluster_size:
            self._cluster_size = cluster_size
            self._init_device_state()
            self._partitions_stale = True

    @property
    def cluster_size(self) -> int:
        return self._cluster_size

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
        for req, fut, slot_key in pending:
            self._slots.release(slot_key, req[self.R_CONC_SLOT])
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
        schedule plus the rate-admission namespace slot), shared by the
        serial and batched paths; everything stateful (_rand_counter, the
        slot allocator, slot-axis growth) mutates in exactly the serial
        order."""
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
        return req, slot_key

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
        req, slot_key = self._build_row(action, msg)
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._note_arrival(time.monotonic())
        self._req_ring.push(req)
        self._pending.append((req, fut, slot_key))
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
        for (action, msg), out in zip(pairs, outs):
            try:
                req, slot_key = self._build_row(action, msg)
            except Exception as e:  # noqa: BLE001 — per-row isolation,
                # like N independent publish calls
                out.set_exception(e)
                continue
            built.append((req, loop.create_future(), slot_key, msg, action,
                          out))
        if not built:
            return outs
        # the serial path notes an arrival only after a successful row
        # build, so the shared clock read counts built rows
        self._note_arrivals(time.monotonic(), len(built))
        self._req_ring.push_block(
            np.asarray([b[0] for b in built], np.int32).T)
        self._pending.extend(b[:3] for b in built)
        # ONE shared flush decision: drain full buckets inline, then apply
        # the serial eager/window rule once
        while (len(self._pending) >= self.max_batch
               and self._try_flush_now()):
            pass
        if self._pending and not (self._eager() and self._try_flush_now()):
            self._arm_flush(urgent=len(self._pending) >= self.max_batch)
        for req, fut, slot_key, msg, action, out in built:
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

    def _row_placed(self, fut: asyncio.Future, req: tuple, slot_key: str,
                    msg, action, out: asyncio.Future) -> None:
        """One batched row's continuation (a done-callback on its placement
        future): the serial publish's post-placement body, then the send
        on a task of its own (the raw producer has no task-free submit)
        whose outcome resolves `out`."""
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
        return occupancy_json(self.placement_kernel_resolved, rows)

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
                and not self._closing):
            self._set_inflight(1)
            self._dispatch_batch()
            return True
        return False

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

    def _start_readback(self, out: Optional[torch.Tensor]) -> _Readback:
        """Enqueue the copies of a step's decision vector (None for a fold
        without one) and of the books it left, right behind the step."""
        books = self._books_ref()
        if self.device.type != "cuda":
            return _Readback(out, books, None)
        hosts = [None if t is None else
                 torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for t in (out, books)]
        for h, t in zip(hosts, (out, books)):
            if h is not None:
                h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _Readback(hosts[0], hosts[1], event)

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
                if self._releases:
                    self.state = self._release_packed_fn(
                        self.state, self._to_device(self._release_packed()))
                if self._health_updates:
                    ups, self._health_updates = self._health_updates, {}
                    self.state = set_health(self.state, list(ups.keys()),
                                            list(ups.values()))
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
        rel_np = self._release_packed(pad_to=bp)
        health_np = pack_health(self._health_updates, self.HEALTH_BATCH)
        buf = np.concatenate([rel_np.ravel(), health_np.ravel(),
                              req_np.ravel()])
        r, h = rel_np.shape[1], health_np.shape[1]
        try:
            dbuf = self._to_device(buf)
            if rate_on:
                now32 = np.float32(time.monotonic() - self._t0_mono)
                (self.state, self._bucket_state), out = self._packed_fn(
                    (self.state, self._bucket_state), dbuf, now32, r, h, bp)
            else:
                self.state, out = self._packed_fn(self.state, dbuf, r, h, bp)
            rb = self._start_readback(out)
        except Exception as e:  # noqa: BLE001 — a failed dispatch must not
            # leak the permit or the host conc slots, or strand publishers
            self._set_inflight(-1)
            self._capacity_free.set()
            self._recover_failed_step()
            for req, fut, slot_key in batch:
                self._slots.release(slot_key, req[self.R_CONC_SLOT])
                if not fut.done():
                    fut.set_exception(
                        LoadBalancerException(f"device dispatch failed: {e}"))
            if self.logger:
                self.logger.error(None, f"device dispatch failed: {e!r}",
                                  "TpuBalancer")
            return
        self.counters["steps"] += 1
        task = asyncio.get_event_loop().create_task(
            self._readback_step(batch, b, out, rb, t0, req_np,
                                self._next_books_seq()))
        self._readbacks.add(task)
        task.add_done_callback(self._readbacks.discard)

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
                             req_np, books_seq: int) -> None:
        def _read():
            t_r0 = time.monotonic()
            arrs, books_np = self._read_back(rb)
            t_r1 = time.monotonic()
            # benign cross-thread write: a float EWMA steering a heuristic
            self._rtt_ewma_ms = (0.8 * self._rtt_ewma_ms
                                 + 0.2 * (t_r1 - t_r0) * 1e3)
            return arrs, t_r1, books_np

        try:
            (chosen_np, forced_np, throttled_np, rounds), t_done, books_np = \
                await asyncio.to_thread(_read)
            self._install_books(books_np, books_seq)
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
            except Exception:  # noqa: BLE001 — device genuinely dead: keep
                # the host refcounts PINNED so the slot indices cannot pass
                # to another action with phantom concurrency
                compensated = False
                self._recover_failed_step()
            for req, fut, slot_key in batch:
                if compensated:
                    self._slots.release(slot_key, req[self.R_CONC_SLOT])
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
        self.step_ms.append((t_done - t0) * 1e3)
        self.counters["scheduled"] += b
        if rounds > 0:
            self.counters["repair_steps"] += 1
            self.counters["repair_rounds"] += rounds
        for (req, fut, slot_key), inv_idx, f, thr in zip(
                batch, chosen_np, forced_np, throttled_np):
            if fut.cancelled():
                # abandoned publisher: nobody will ever ack this activation
                # (a throttled row carries chosen -1: nothing was reserved)
                self._abandon_placement(int(inv_idx), req, slot_key)
            elif not fut.done():
                fut.set_result((-2 if thr else int(inv_idx), bool(f)))


class TpuBalancerProvider:
    @staticmethod
    def instance(**kwargs) -> TpuBalancer:
        return TpuBalancer(**kwargs)
