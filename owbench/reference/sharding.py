"""Plain NumPy reference of the balancer core's placement semantics.

It follows OpenWhisk's `ShardingContainerPoolBalancer` (core/controller/
.../loadBalancer/ShardingContainerPoolBalancer.scala) as the port's
`BalancerCore` serves it, and it imports nothing of the port:

- the fleet splits into a managed slice (the first
  `int(managed_fraction * n)` invokers, at least one) and a blackbox slice
  (the last `int(blackbox_fraction * n)`, at least one);
- an action's home is `crc32("<namespace>/<fqn>") & 0x7fffffff` modulo its
  slice, and its probe walks the slice in a step taken from the numbers up
  to the slice size that are coprime to it and to each other
  (`pairwiseCoprimeNumbersUntil`), chosen by the same hash;
- an invoker takes an activation when it is healthy and has a free
  concurrency permit of the action's `<fqn>:<memory>` pool or the
  action's memory (`NestedSemaphore.tryAcquireConcurrent`): a permit
  first, else a new container's memory and its `max_conc - 1` spare
  permits;
- when no invoker of the slice can take it, the first healthy invoker at
  or after a per-row random rotation takes it anyway (forced);
- a completion returns one permit, and a whole container's worth of
  permits returns its memory (`releaseConcurrent`); an action with
  `max_conc` 1 returns its memory at once.

The balancer core's host bookkeeping is part of what a row carries, so it
is modelled too: a concurrency pool gets a slot of the concurrency table
from a free list (lowest first, a freed slot reused first) while any
activation of it is in flight; a step folds at most `max_batch` queued
completions (oldest first) and `HEALTH_BATCH` queued health flips (the
oldest invoker's flip first, a later flip of the same invoker replacing
its value), and then places up to `max_batch` queued rows in order, each
seeing the books as every earlier row left them.

`sequential=False` breaks that last guarantee: every row of a step sees
the books as they stood when the step began (the control that a check of
the placements has to fail).

`set_clock(now_s)` keeps the traffic's clock (`now_s`), which a
configuration with `clock: "traffic"` sets before every step; this
placement policy reads no time. A configuration's own reference
(`owbench/reference/<name>.py`, a subclass of this `Reference` as a rule)
takes the configuration's `core` options as keywords.
"""
from __future__ import annotations

import zlib
from collections import deque
from typing import Dict, List, NamedTuple

import numpy as np

#: health flips one step folds
HEALTH_BATCH = 64
#: a concurrency pool's memory floor for one controller (MemoryLimit.MIN)
MIN_SLOT_MB = 128
#: probes tried one at a time before the rest of the walk is vectorised
SCALAR_PROBES = 6
#: a walk that stopped closer to home than this restarts from home
DEEP_WALK = 32
#: a walk restarts from home when more invokers than this gained room since
#: the pool's last walk (reading them would cost more than the walk)
HINT_LOG_LIMIT = 4096


def launch_width(rows: int, cap: int) -> int:
    """The padded width a step's kernels run at: the power of two from 8
    up that holds the rows, at most `cap`."""
    b = 8
    while b < rows and b < cap:
        b *= 2
    return min(b, cap)


def home_hash(namespace: str, fqn: str) -> int:
    return zlib.crc32(f"{namespace}/{fqn}".encode()) & 0x7FFFFFFF


def coprime_steps(x: int) -> List[int]:
    """`pairwiseCoprimeNumbersUntil(x)`: the greedy ascending list of
    numbers up to x coprime to x and to each other. A composite coprime to
    x shares its least prime factor with an earlier entry, so the list is
    1 and the primes up to x that do not divide x."""
    if x <= 1:
        return [1]
    sieve = np.ones(x + 1, bool)
    sieve[:2] = False
    for p in range(2, int(x ** 0.5) + 1):
        if sieve[p]:
            sieve[p * p::p] = False
    primes = np.nonzero(sieve)[0]
    return [1] + [int(p) for p in primes if x % p]


class Result(NamedTuple):
    chosen: np.ndarray       # int32[b]; -1: no healthy invoker in the slice
    forced: np.ndarray       # bool[b]
    rows: np.ndarray         # int32[9, b]
    slot_keys: List[str]


class Reference:
    """The books and queues of one controller over a fixed fleet."""

    def __init__(self, memory_mb, *, managed_fraction: float,
                 blackbox_fraction: float, max_batch: int,
                 action_slots: int, cluster_size: int = 1,
                 sequential: bool = True):
        self.n = n = len(memory_mb)
        self.max_batch = max_batch
        self.sequential = sequential
        self.free = np.array([max(int(m) // cluster_size, MIN_SLOT_MB)
                              for m in memory_mb], np.int64)
        self.health = np.ones(n, bool)
        # the same two books as Python lists, for the walk's scalar probes
        self._free = self.free.tolist()
        self._health = [True] * n
        self.conc = np.zeros((action_slots, n), np.int64)
        self.managed = max(int(managed_fraction * n), 1)
        self.blackbox = max(int(blackbox_fraction * n), 1)
        self._steps = {False: coprime_steps(self.managed),
                       True: coprime_steps(self.blackbox)}
        self._counter = 0
        #: (namespace, fqn, blackbox) -> what its rows' probe needs
        self._geometry: Dict[tuple, tuple] = {}
        self._free_slots = list(range(action_slots - 1, -1, -1))
        self._slot_of: Dict[str, int] = {}
        self._refs: Dict[str, int] = {}
        self._queued: deque = deque()
        self._releases: deque = deque()
        self._flips: Dict[int, bool] = {}
        #: invokers that gained room or health, in order, and their count
        self._rose = np.zeros(1 << 16, np.int64)
        self._n_rose = 0
        #: pool key -> [position its last walk stopped at, _n_rose then, slot]
        self._walks: Dict[str, list] = {}
        #: what each step's kernels had to do (`work`), kept when asked
        self.keep_work = False
        self.work: List[dict] = []
        #: (probes, rotation keys) of the last row placed: the positions of
        #: its walk up to the first that could take it, and of the forced
        #: rotation up to the first healthy invoker
        self._cost = (0, 0)
        #: the traffic's seconds, as the last `set_clock` gave them
        self.now_s = 0.0

    # -- the concurrency slots ------------------------------------------
    def _acquire(self, key: str) -> int:
        slot = self._slot_of.get(key)
        if slot is None:
            if not self._free_slots:
                raise RuntimeError("the reference models no slot overflow: "
                                   "more concurrent pools than slots")
            slot = self._slot_of[key] = self._free_slots.pop()
        self._refs[key] = self._refs.get(key, 0) + 1
        return slot

    def _release_slot(self, key: str) -> None:
        left = self._refs[key] - 1
        if left:
            self._refs[key] = left
        else:
            del self._refs[key]
            self._free_slots.append(self._slot_of.pop(key))

    # -- the balancer core's calls --------------------------------------
    def build_row(self, namespace: str, fqn: str, memory_mb: int,
                  max_conc: int, blackbox: bool):
        geo = self._geometry.get((namespace, fqn, blackbox))
        if geo is None:
            size = self.blackbox if blackbox else self.managed
            offset = self.n - self.blackbox if blackbox else 0
            h = home_hash(namespace, fqn)
            steps = self._steps[blackbox]
            step = steps[h % len(steps)]
            step_inv = pow(step, -1, size) if size > 1 else 0
            geo = self._geometry[namespace, fqn, blackbox] = (
                offset, size, h % size, step_inv, step, h)
        offset, size, home, step_inv, step, h = geo
        self._counter += 1
        key = f"{fqn}:{memory_mb}"
        rand = (h ^ (self._counter * 2654435761)) % size
        row = (offset, size, home, step_inv, memory_mb,
               self._acquire(key), max_conc, rand, 1)
        return row, key, step

    def submit(self, rows) -> None:
        self._queued.extend(rows)

    def complete(self, inv: int, slot: int, mem: int, maxc: int,
                 key: str) -> None:
        self._releases.append((inv, slot, mem, maxc, key))

    def set_health(self, idx: int, usable: bool) -> None:
        self._flips[idx] = bool(usable)

    def set_clock(self, now_s: float) -> None:
        self.now_s = float(now_s)

    def step(self) -> Result:
        b = min(len(self._queued), self.max_batch)
        k = min(len(self._releases), self.max_batch)
        width = max(launch_width(b, self.max_batch),
                    launch_width(k, self.max_batch) if k else 8)
        work = {"width": width} if self.keep_work else None
        self._fold_releases(work)
        for idx in list(self._flips)[:HEALTH_BATCH]:
            up = self.health[idx] = self._health[idx] = self._flips.pop(idx)
            if up:
                self._gained(idx)
        batch = [self._queued.popleft() for _ in range(b)]
        chosen = np.full(b, -1, np.int32)
        forced = np.zeros(b, bool)
        rows = np.array([r for r, _, _ in batch], np.int32).T.reshape(9, b)
        touched = ({}, {}) if work is not None else None
        stops = []
        updates = []
        for i, (row, key, step) in enumerate(batch):
            offset, size, home, step_inv, need, slot, maxc, rand, _ = row
            sel, f = self._probe(key, offset, size, home, step, step_inv,
                                 need, slot, rand)
            if work is not None:
                stops.append((offset, size, home, step, slot, maxc, rand,
                              *self._cost))
            if sel < 0:
                self._release_slot(key)
                continue
            chosen[i], forced[i] = sel, f
            upd = (sel, slot, need, maxc, self.conc[slot, sel] > 0)
            if self.sequential:
                self._take(upd, touched)
            else:
                updates.append(upd)
        for upd in updates:
            self._take(upd, touched)
        if work is not None:
            work["schedule"] = self._schedule_work(stops, *touched)
            self.work.append(work)
        return Result(chosen, forced, rows, [k for _, k, _ in batch])

    # -- the books -------------------------------------------------------
    def _probe(self, key, offset, size, home, step, step_inv, need, slot,
               rand):
        """(invoker, forced) for one row against the books as they stand;
        (-1, False) when the slice has no healthy invoker.

        A deep walk resumes where the pool's last walk stopped: every
        position before it was full then, and a placement only takes room.
        So before it only an invoker that has gained room or health since
        can take the row. Such an invoker's position in this walk is its
        rank, (local - home) * step_inv mod size, and the walk starts at
        the lowest of them; after a walk that found nothing, at the lowest
        of those that can take the row now (the others are full)."""
        start, walk = 0, self._walks.get(key)
        conc = self.conc[slot]
        if walk is not None and walk[2] == slot and walk[0] >= DEEP_WALK:
            start, seen = walk[0], walk[1]
            if self._n_rose - seen > HINT_LOG_LIMIT:
                start = 0
            elif self._n_rose > seen:
                loc = self._rose[seen:self._n_rose] - offset
                loc = loc[(loc >= 0) & (loc < size)]
                ranks = (loc - home) * step_inv % size
                if start == size and len(ranks):
                    js = offset + loc
                    ranks = ranks[self.health[js] & (
                        (conc[js] > 0) | (self.free[js] >= need))]
                if len(ranks):
                    start = min(start, int(ranks.min()))
        sel, k = self._walk(start, offset, size, home, step, need, conc)
        self._walks[key] = [k, self._n_rose, slot]
        if sel >= 0:
            self._cost = (k + 1, 0)
            return sel, False
        sel, hit = self._rotate(offset, size, rand)
        self._cost = (size, hit + 1 if sel >= 0 else size)
        return sel, sel >= 0

    def _rotate(self, offset, size, rand):
        """(invoker, position) of the first healthy invoker of the forced
        rotation rand, rand + 1, ... over the slice; (-1, size) when none
        is healthy."""
        health, j = self._health, rand
        for t in range(min(size, SCALAR_PROBES)):
            if health[offset + j]:
                return offset + j, t
            j = j + 1 if j + 1 < size else 0
        js = offset + (rand + np.arange(size, dtype=np.int64)) % size
        ok = self.health[js]
        hit = int(ok.argmax())
        return (int(js[hit]), hit) if ok[hit] else (-1, size)

    def _walk(self, k, offset, size, home, step, need, conc):
        """(invoker, position) of the first invoker from position k of the
        walk home, home + step, ... that can take the row; (-1, size) when
        none can."""
        free, health = self._free, self._health
        idx = (home + k * step) % size
        for k in range(k, min(size, k + SCALAR_PROBES)):
            j = offset + idx
            if health[j] and (free[j] >= need or conc[j] > 0):
                return j, k
            idx += step
            if idx >= size:
                idx -= size
        else:
            k += 1
        chunk = 64
        while k < size:
            k1 = min(size, k + chunk)
            js = offset + (home + np.arange(k, k1, dtype=np.int64) * step
                           ) % size
            ok = self.health[js] & ((conc[js] > 0) | (self.free[js] >= need))
            hit = int(ok.argmax())
            if ok[hit]:
                return int(js[hit]), k + hit
            k, chunk = k1, chunk * 8
        return -1, size

    def _gained(self, inv: int) -> None:
        """Note that invoker `inv` gained room or health."""
        if self._n_rose == len(self._rose):
            self._rose = np.concatenate([self._rose,
                                         np.zeros_like(self._rose)])
        self._rose[self._n_rose] = inv
        self._n_rose += 1

    def _take(self, upd, touched) -> None:
        sel, slot, need, maxc, use_permit = upd
        if touched is not None:
            touched[0].setdefault(sel, self._free[sel])
            touched[1].setdefault((slot, sel), int(self.conc[slot, sel]))
        if use_permit:
            self.conc[slot, sel] -= 1
        else:
            self.free[sel] -= need
            self._free[sel] -= need
            if maxc > 1:  # a new container's spare permits: room for its pool
                self.conc[slot, sel] += maxc - 1
                self._gained(sel)

    def _fold_releases(self, work) -> None:
        k = min(len(self._releases), self.max_batch)
        touched_free: Dict[int, int] = {}
        touched_conc: Dict[tuple, int] = {}
        conc_rows = 0
        for _ in range(k):
            inv, slot, mem, maxc, key = self._releases.popleft()
            self._release_slot(key)
            self._gained(inv)
            touched_free.setdefault(inv, self._free[inv])
            if maxc <= 1:
                self.free[inv] += mem
                self._free[inv] += mem
                continue
            conc_rows += 1
            touched_conc.setdefault((slot, inv), int(self.conc[slot, inv]))
            if self.conc[slot, inv] + 1 >= maxc:
                self.free[inv] += mem
                self._free[inv] += mem
                self.conc[slot, inv] += 1 - maxc
            else:
                self.conc[slot, inv] += 1
        if work is not None:
            work["release"] = dict(
                rows=k, conc_rows=conc_rows,
                free_cells_read=len(touched_free),
                conc_cells_read=len(touched_conc),
                cells_changed=self._changed(touched_free, touched_conc),
                backlog=len(self._releases))

    def _changed(self, touched_free, touched_conc) -> int:
        return (sum(int(self.free[i]) != v for i, v in touched_free.items())
                + sum(int(self.conc[c]) != v
                      for c, v in touched_conc.items()))

    def _schedule_work(self, stops, touched_free, touched_conc) -> dict:
        """What the exact sequential schedule reads and writes for these
        rows: each row probes its walk up to the first invoker that can
        take it, and a forced row its rotation up to the first healthy
        invoker. Every input cell is read once: free memory and health over
        the union of the probed invokers, health alone over the rest of the
        rotations, and the permits of a slot over the union of its rows'
        probes where the row's action has permits (max_conc above 1)."""
        walks: Dict[tuple, int] = {}
        permit_walks: Dict[tuple, int] = {}
        probed = np.zeros(self.n, bool)
        rotated = np.zeros(self.n, bool)
        probes = rotation_keys = 0
        for offset, size, home, step, slot, maxc, rand, k, rot in stops:
            probes += k
            rotation_keys += rot
            walk = (offset, size, home, step)
            walks[walk] = max(walks.get(walk, 0), k)
            if maxc > 1:
                pw = (slot, *walk)
                permit_walks[pw] = max(permit_walks.get(pw, 0), k)
            if rot:
                rotated[offset + (rand + np.arange(rot)) % size] = True
        for (offset, size, home, step), k in walks.items():
            probed[offset + (home + np.arange(k, dtype=np.int64) * step)
                   % size] = True
        permit_cells = 0
        per_slot: Dict[int, list] = {}
        for (slot, offset, size, home, step), k in permit_walks.items():
            per_slot.setdefault(slot, []).append(
                offset + (home + np.arange(k, dtype=np.int64) * step) % size)
        for cols in per_slot.values():
            permit_cells += len(np.unique(np.concatenate(cols)))
        return dict(rows=len(stops), probes=probes,
                    rotation_keys=rotation_keys,
                    probe_columns=int(probed.sum()),
                    rotation_columns=int((rotated & ~probed).sum()),
                    permit_cells=permit_cells,
                    cells_changed=self._changed(touched_free, touched_conc))

    def books(self):
        """(free int64[n], conc int64[A, n], health bool[n])."""
        return self.free, self.conc, self.health

    @property
    def release_backlog(self) -> int:
        return len(self._releases)

    @property
    def queued(self) -> int:
        return len(self._queued)
