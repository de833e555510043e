"""Batched invoker placement as plain PyTorch.

The counterpart of `openwhisk_tpu/ops/placement.py`: the same probe-rank
placement (rank(i) = (i - home) * step^{-1} mod size, lowest eligible rank
wins, lowest index breaks ties), the same forced placement under overload,
the same NestedSemaphore capacity updates, and the same two batch
algorithms:

  `schedule_batch`        — the reference scan, a Python loop over B rows.
  `schedule_batch_repair` — speculate-and-repair: every pending row probes
                            the current books, the conflict rules
                            (`repair_commit_masks`) commit the provably
                            order-independent set, and the loop re-runs the
                            rest. Bit-exact with the scan, rounds included.

These plain functions are what the port runs on the CPU, and what the
CUDA kernels in `placement_cuda.py` are held against on the card.

State (`PlacementState`):
  free_mb   int32[N]     free memory permits per invoker
  conc_free int32[N, A]  spare concurrency permits per (invoker, slot): the
                         JAX package's layout, held as the `.T` view of a
                         contiguous [A, N] tensor so that one slot's row is
                         contiguous for the kernels (`init_state`)
  health    bool[N]      usable mask

Every function here updates the state's tensors IN PLACE where the JAX
package returned new (or donated) buffers, and returns the same
`PlacementState` object; a caller that needs the pre-call books clones
them first.

Out-of-range concurrency slots (`conc_slot >= A`) read the clamped column
and DROP their write, as the JAX scatter does. Slots are non-negative: the
slot allocator hands out [0, A).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

I32 = torch.int32


def resolve_device(device=None) -> torch.device:
    """The port's device rule: `None` means the CUDA card, and raises when
    there is none; the CPU runs only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _mulmod(a, b, m):
    """(a % m) * b % m without int32 overflow, for 0 <= b < m <= 2**17.

    Splitting b = hi*512 + lo keeps every intermediate under 2**26, exactly
    as the JAX package does. `torch.remainder` is the floor modulo
    (`jnp.mod`): non-negative for m > 0, where `fmod` would not be."""
    a = torch.remainder(a, m)
    hi = torch.div(b, 512, rounding_mode="floor")
    lo = b - hi * 512
    t = torch.remainder(a * hi, m)
    t = torch.remainder(t * 512, m)
    return torch.remainder(t + a * lo, m)


class PlacementState(NamedTuple):
    free_mb: torch.Tensor    # int32[N]
    conc_free: torch.Tensor  # int32[N, A] (view of contiguous [A, N])
    health: torch.Tensor     # bool[N]


class RequestBatch(NamedTuple):
    offset: torch.Tensor     # int32[B] partition start
    size: torch.Tensor       # int32[B] partition length
    home: torch.Tensor       # int32[B] hash % size
    step_inv: torch.Tensor   # int32[B] inverse of step mod size
    need_mb: torch.Tensor    # int32[B]
    conc_slot: torch.Tensor  # int32[B]
    max_conc: torch.Tensor   # int32[B]
    rand: torch.Tensor       # int32[B] randomness for forced placement
    valid: torch.Tensor      # bool[B]


def init_state(n_invokers: int, slot_mb, n_pad: int = 0,
               action_slots: int = 512, device=None) -> PlacementState:
    """Build the books on `device` (None = the card); `slot_mb` is a scalar
    or a per-invoker list. Padding rows are unhealthy with zero capacity.
    The concurrency books are allocated as a contiguous [A, N] tensor and
    held as its [N, A] view."""
    dev = resolve_device(device)
    n_pad = n_pad or n_invokers
    if n_pad < n_invokers:
        raise ValueError(f"n_pad {n_pad} < n_invokers {n_invokers}")
    free = torch.zeros((n_pad,), dtype=I32, device=dev)
    free[:n_invokers] = torch.as_tensor(slot_mb, dtype=I32).expand(
        n_invokers).to(dev)
    health = torch.zeros((n_pad,), dtype=torch.bool, device=dev)
    health[:n_invokers] = True
    conc = torch.zeros((action_slots, n_pad), dtype=I32, device=dev)
    return PlacementState(free, conc.T, health)


def placement_state_from_numpy(free_mb, conc_free, health,
                               device=None) -> PlacementState:
    """Carry books across from numpy (e.g. the JAX package's
    `PlacementState` as `np.asarray` arrays, conc in its [N, A] layout)
    into the port's state on `device` (None = the card)."""
    dev = resolve_device(device)
    conc_an = np.ascontiguousarray(np.asarray(conc_free, np.int32).T)
    return PlacementState(
        torch.from_numpy(np.array(free_mb, np.int32)).to(dev),
        torch.from_numpy(conc_an).to(dev).T,
        torch.from_numpy(np.array(health, bool)).to(dev))


def request_batch_from_numpy(offset, size, home, step_inv, need_mb,
                             conc_slot, max_conc, rand, valid,
                             device=None) -> RequestBatch:
    """A `RequestBatch` on `device` from nine host columns."""
    dev = resolve_device(device)
    cols = [torch.from_numpy(np.array(x, np.int32)).to(dev)
            for x in (offset, size, home, step_inv, need_mb, conc_slot,
                      max_conc, rand)]
    return RequestBatch(*cols, torch.from_numpy(
        np.array(valid, bool)).to(dev))


def set_health(state: PlacementState, idx, usable) -> PlacementState:
    """Set health flags in place (unique indices)."""
    dev = state.health.device
    state.health[torch.as_tensor(idx, dtype=torch.long, device=dev)] = \
        torch.as_tensor(usable, dtype=torch.bool, device=dev)
    return state


def _slot_read_write(slot, a: int):
    """(clamped slot for reads, in-range mask for writes)."""
    return slot.clamp(0, a - 1), (slot >= 0) & (slot < a)


def _schedule_one(state: PlacementState, req, penalty=None):
    """One activation (the scan body), on 1-element tensors: vectorized
    probe over N, forced fallback, capacity update in place.

    `penalty` (optional int32[N], small non-negative levels) demotes an
    invoker by one full lap of the probe ring per level (`rank + penalty *
    size`); the sentinel then grows from n + 2 to 2^30. `penalty=None`
    runs exactly the penalty-free computation."""
    offset, size, home, step_inv, need, slot, max_conc, rand, valid = req
    n = state.free_mb.shape[0]
    a = state.conc_free.shape[1]
    dev = state.free_mb.device
    big = n + 2

    idx = torch.arange(n, dtype=I32, device=dev)
    local = idx - offset
    in_part = (local >= 0) & (local < size)
    size_safe = size.clamp_min(1)
    rank = _mulmod(local - home, step_inv, size_safe)
    if penalty is not None:
        big = 1 << 30
        rank = rank + penalty * size_safe

    slot_r, slot_ok = _slot_read_write(slot, a)
    # a slot's column is a row of the [A, N] tensor the books are held in
    conc_col = state.conc_free.T.index_select(0, slot_r.long())[0]
    has_conc = conc_col > 0
    has_mem = state.free_mb >= need
    eligible = in_part & state.health & (has_conc | has_mem)
    key = torch.where(eligible, rank, big)
    choice = torch.argmin(key).reshape(1)
    found = key[choice] < big

    # overload: force a usable invoker chosen by a random rotation
    usable = in_part & state.health
    fkey = torch.where(usable, torch.remainder(local - rand, size_safe), big)
    fchoice = torch.argmin(fkey).reshape(1)
    have_usable = fkey[fchoice] < big

    sel = torch.where(found, choice, fchoice)
    placed = valid & (found | have_usable)
    forced = valid & ~found & have_usable

    # capacity update (NestedSemaphore.tryAcquireConcurrent semantics)
    use_conc = placed & (conc_col[sel] > 0)
    take_mem = placed & ~use_conc
    state.free_mb.index_add_(0, sel, torch.where(take_mem, -need, 0))
    conc_delta = torch.where(
        use_conc, -1, torch.where(take_mem & (max_conc > 1), max_conc - 1, 0))
    state.conc_free.index_put_(
        (sel, slot_r.long()), torch.where(slot_ok, conc_delta, 0),
        accumulate=True)
    return torch.where(placed, sel.to(I32), -1), forced


def schedule_batch(state: PlacementState, batch: RequestBatch, penalty=None
                   ) -> Tuple[PlacementState, torch.Tensor, torch.Tensor]:
    """Place a micro-batch sequentially, one vectorized probe per request,
    updating the books in place. Returns (state, chosen int32[B], forced
    bool[B]); chosen is -1 where no invoker is usable."""
    b = batch.valid.shape[0]
    chosen, forced = [], []
    for i in range(b):
        req = tuple(col[i:i + 1] for col in batch)
        c, f = _schedule_one(state, req, penalty)
        chosen.append(c)
        forced.append(f)
    if b == 0:
        dev = state.free_mb.device
        return (state, torch.zeros((0,), dtype=I32, device=dev),
                torch.zeros((0,), dtype=torch.bool, device=dev))
    return state, torch.cat(chosen), torch.cat(forced)


class RepairPrims(NamedTuple):
    """Index primitives the repair conflict rules are written against.

    The rules (`repair_commit_masks`) exist once; only these order-
    sensitive reductions have two implementations, which must agree bit
    for bit:

      `flat_prims`     — scatter/sort formulations over int32[B] vectors:
                         what `schedule_batch_repair` uses.
      `pairwise_prims` — [B, B] mask + reduction formulations: the form the
                         CUDA repair kernel evaluates, one thread per row
                         looping over the earlier rows.

      bidx                    request's own batch index
      first_index_where(f, k, size)
                              per request i: does any FLAGGED request j < i
                              share my key?
      any_same_key(f, k, size)
                              per request i: does ANY flagged request (self
                              included) share my key?
      segment_exclusive_sum(v, k)
                              per request i: sum of v[j] over j < i with
                              k[j] == k[i]
      exclusive_cumsum(v)     per request i: sum of v[j] over j < i
      exclusive_cummax(v)     per request i: max of v[j] over j < i (0 when
                              empty; callers pass non-negative values)
      min_index_where(f)      smallest flagged batch index (B when none)
    """
    bidx: torch.Tensor
    first_index_where: Callable
    any_same_key: Callable
    segment_exclusive_sum: Callable
    exclusive_cumsum: Callable
    exclusive_cummax: Callable
    min_index_where: Callable


def flat_prims(b: int, device) -> RepairPrims:
    """Scatter/sort prims over flat int32[B] vectors. Keys out of
    [0, size) are DROPPED by the scatters and CLAMPED by the gathers, as
    the JAX scatter/gather pair does."""
    bidx = torch.arange(b, dtype=I32, device=device)
    sentinel = b

    def _scatter_key(key, size):
        # an out-of-range key lands in a spare cell that nobody reads
        return torch.where((key >= 0) & (key < size), key, size).long()

    def _gather_key(key, size):
        return key.clamp(0, size - 1).long()

    def first_index_where(flag, key, size):
        firsts = torch.full((size + 1,), sentinel, dtype=I32, device=device)
        firsts.scatter_reduce_(0, _scatter_key(key, size),
                               torch.where(flag, bidx, sentinel), "amin")
        return firsts[_gather_key(key, size)] < bidx

    def any_same_key(flag, key, size):
        seen = torch.zeros((size + 1,), dtype=I32, device=device)
        seen.scatter_reduce_(0, _scatter_key(key, size), flag.to(I32),
                             "amax")
        return seen[_gather_key(key, size)] > 0

    def segment_exclusive_sum(values, key):
        # stable sort by key keeps batch order inside each segment; a
        # cummax of the segment-start prefix turns the global cumsum into
        # per-segment exclusive sums
        order = torch.argsort(key, stable=True)
        v_s = values[order]
        k_s = key[order]
        c = torch.cumsum(v_s, 0, dtype=I32)
        seg_start = torch.cat([torch.ones((1,), dtype=torch.bool,
                                          device=device),
                               k_s[1:] != k_s[:-1]])
        base = torch.cummax(torch.where(seg_start, c - v_s, 0), 0).values
        out = torch.zeros_like(c)
        out[order] = c - v_s - base
        return out

    def exclusive_cumsum(values):
        return torch.cumsum(values, 0, dtype=I32) - values

    def exclusive_cummax(values):
        m = torch.cummax(values, 0).values
        return torch.cat([torch.zeros((1,), dtype=m.dtype, device=device),
                          m[:-1]])

    def min_index_where(flag):
        return torch.where(flag, bidx, sentinel).min()

    return RepairPrims(bidx, first_index_where, any_same_key,
                       segment_exclusive_sum, exclusive_cumsum,
                       exclusive_cummax, min_index_where)


def pairwise_prims(b: int, device) -> RepairPrims:
    """Sort/scatter-free prims: each is a [B, B] mask (self on axis 0,
    other request on axis 1) plus a reduction over the other requests.
    Keys are compared as given: a caller with out-of-range slots clamps
    them and passes `slot_ok` to `repair_commit_masks`."""
    bidx = torch.arange(b, dtype=I32, device=device)
    before = bidx[None, :] < bidx[:, None]  # other strictly earlier

    def _same(key):
        return key[None, :] == key[:, None]

    def first_index_where(flag, key, size):
        return (flag[None, :] & _same(key) & before).any(1)

    def any_same_key(flag, key, size):
        return (flag[None, :] & _same(key)).any(1)

    def segment_exclusive_sum(values, key):
        return torch.where(_same(key) & before, values[None, :], 0).sum(
            1, dtype=I32)

    def exclusive_cumsum(values):
        return torch.where(before, values[None, :], 0).sum(1, dtype=I32)

    def exclusive_cummax(values):
        return torch.where(before, values[None, :], 0).max(1).values

    def min_index_where(flag):
        return torch.where(flag, bidx, b).min()

    return RepairPrims(bidx, first_index_where, any_same_key,
                       segment_exclusive_sum, exclusive_cumsum,
                       exclusive_cummax, min_index_where)


def repair_commit_masks(prims: RepairPrims, *, pending, placed, forced, sel,
                        take_mem, use_conc, simple, need_mb, conc_slot,
                        free_at_sel, col_conc, n: int, a_slots: int,
                        slot_ok=None):
    """THE speculate-and-repair conflict rules, one copy for every backend
    of the port (the CUDA repair kernel evaluates the same rules in their
    pairwise form). Returns `(safe, commit)`: the rows whose outcome is
    settled this round and the subset that writes capacity.

      * `hard_conflict`: an earlier pending non-cascade writer shares my
        chosen invoker, or an earlier container-opener shares my conc
        column;
      * `mem_conflict`: I take memory (non-forced) at an invoker whose
        free space, after the committed cascade prefix's demand, no longer
        covers my need;
      * everything before the first conflict commits, plus valid-but-
        unplaceable rows and the provably order-independent commits
        (`ooo`): past the first conflict, i may commit while earlier rows
        stay unresolved iff every such straggler is a pure-memory request,
        a pessimistic budget at sel_i covers all of them plus i, and i's
        conc write (if any) touches no column a straggler probes.

    `slot_ok` (None with raw slots and `flat_prims`) marks rows whose slot
    was in range before the caller clamped it, so the slot-keyed writer
    flags drop exactly as the flat scatters drop an out-of-range key."""
    def _w(flag):
        return flag if slot_ok is None else flag & slot_ok

    writer = pending & placed
    # memory-cascade writers: touch only free_mb[sel], no conc cell
    cascade = writer & take_mem & simple
    hard = writer & ~cascade
    grow = writer & take_mem & ~simple

    hard_conflict = (prims.first_index_where(hard, sel, n)
                     | prims.first_index_where(_w(grow), conc_slot, a_slots))
    prior_mem = prims.segment_exclusive_sum(
        torch.where(cascade, need_mb, 0), sel).to(I32)
    mem_conflict = (take_mem & ~forced
                    & (free_at_sel - prior_mem < need_mb))
    conflict = pending & (hard_conflict | mem_conflict)
    first_bad = prims.min_index_where(conflict)

    # out-of-order commits past the first conflict
    straggler = pending & placed & (prims.bidx >= first_bad)
    grow_potential = prims.any_same_key(_w(pending & ~simple), conc_slot,
                                        a_slots)
    pure = simple & ~col_conc & ~grow_potential
    bad_w = straggler & ~pure
    impure_before = prims.exclusive_cumsum(bad_w.to(I32)) > 0
    s_demand = torch.where(straggler, need_mb, 0)
    demand_before = prims.exclusive_cumsum(s_demand).to(I32)
    # reserve the largest earlier-straggler need on top of their total
    # demand, so no straggler's re-probe sees i's commit flip has_mem
    max_need_before = prims.exclusive_cummax(s_demand).to(I32)
    budget_ok = (~take_mem |
                 (free_at_sel - prior_mem - demand_before
                  - max_need_before >= need_mb))
    conc_write = use_conc | (take_mem & ~simple)
    slot_probed_before = prims.first_index_where(_w(straggler), conc_slot,
                                                 a_slots)
    ooo = (pending & placed & ~forced & ~hard_conflict & ~impure_before
           & budget_ok & ~(conc_write & slot_probed_before))

    safe = pending & ((prims.bidx < first_bad) | ~placed | ooo)
    return safe, safe & placed


def _probe_geometry(n: int, batch: RequestBatch, penalty=None):
    """The state-independent part of the batch probe, hoisted out of the
    repair loop: [B, N] partition mask and probe ranks, and the forced
    rotation key. The penalized sentinel grows to 2^30."""
    dev = batch.offset.device
    big = n + 2
    idx = torch.arange(n, dtype=I32, device=dev)
    local = idx[None, :] - batch.offset[:, None]          # [B, N]
    size_col = batch.size[:, None]
    in_part = (local >= 0) & (local < size_col)
    size_safe = size_col.clamp_min(1)
    rank = _mulmod(local - batch.home[:, None], batch.step_inv[:, None],
                   size_safe)
    if penalty is not None:
        big = 1 << 30
        rank = rank + penalty[None, :] * size_safe
    fkey_rot = torch.remainder(local - batch.rand[:, None], size_safe)
    return big, in_part, rank, fkey_rot


class Speculation(NamedTuple):
    """One repair round's probe of every row against the current books:
    what `repair_commit_masks` judges, plus `found` (an eligible invoker
    exists; where none does, `sel` is the forced choice)."""
    found: torch.Tensor        # bool[B]
    sel: torch.Tensor          # int32[B]
    placed: torch.Tensor       # bool[B]
    forced: torch.Tensor       # bool[B]
    use_conc: torch.Tensor     # bool[B]
    take_mem: torch.Tensor     # bool[B]
    col_conc: torch.Tensor     # bool[B]
    free_at_sel: torch.Tensor  # int32[B]


def forced_choice(usable, fkey_rot, big):
    """The loop-invariant forced choice: the lowest rotation key over the
    usable invokers, lowest index on ties -> (fchoice int64[B], have_usable
    bool[B]). A row with nothing usable gets index 0 (argmin of a row of
    sentinels)."""
    fkey = torch.where(usable, fkey_rot, big)
    fchoice = torch.argmin(fkey, 1)
    return fchoice, fkey.gather(1, fchoice[:, None])[:, 0] < big


def repair_speculate(state: PlacementState, batch: RequestBatch, usable,
                     rank, big, fchoice, have_usable, slot_rl) -> Speculation:
    """Probe every row of the batch against the current books (one round
    of `schedule_batch_repair`); `slot_rl` is the clamped slot as int64."""
    free = state.free_mb
    conc_bn = state.conc_free.T.index_select(0, slot_rl)   # [B, N]
    has_conc = conc_bn > 0
    eligible = usable & (has_conc | (free[None, :] >= batch.need_mb[:, None]))
    key = torch.where(eligible, rank, big)
    choice = torch.argmin(key, 1)
    found = key.gather(1, choice[:, None])[:, 0] < big
    sel = torch.where(found, choice, fchoice)
    placed = batch.valid & (found | have_usable)
    use_conc = placed & (conc_bn.gather(1, sel[:, None])[:, 0] > 0)
    return Speculation(
        found=found, sel=sel.to(I32), placed=placed,
        forced=batch.valid & ~found & have_usable, use_conc=use_conc,
        take_mem=placed & ~use_conc, col_conc=(usable & has_conc).any(1),
        free_at_sel=free[sel])


def schedule_batch_repair(state: PlacementState, batch: RequestBatch,
                          penalty=None, on_round=None):
    """Speculate-and-repair: bit-exact `schedule_batch` semantics with the
    B-length dependency chain collapsed to the conflict count. Each round
    probes every row against the current books, commits the set that
    `repair_commit_masks` proves order-independent, and re-runs the rest;
    the loop ends when nothing is pending or after B + 1 rounds.
    `on_round`, if given, is called with the pending mask bool[B] at the
    start of every round (the work a round needs is its pending rows).

    Updates the books in place. Returns (state, chosen int32[B], forced
    bool[B], rounds int32 scalar tensor)."""
    b = batch.valid.shape[0]
    dev = state.free_mb.device
    prims = flat_prims(b, dev)
    n = state.free_mb.shape[0]
    a_slots = state.conc_free.shape[1]
    free, conc = state.free_mb, state.conc_free

    # loop-invariant geometry: ranks, partitions and the whole forced path
    big, in_part, rank, fkey_rot = _probe_geometry(n, batch, penalty)
    usable = in_part & state.health[None, :]
    fchoice, have_usable = forced_choice(usable, fkey_rot, big)
    simple = batch.max_conc <= 1
    slot_r, slot_ok = _slot_read_write(batch.conc_slot, a_slots)
    slot_rl = slot_r.long()

    pending = batch.valid.clone()
    chosen = torch.full((b,), -1, dtype=I32, device=dev)
    forced_acc = torch.zeros((b,), dtype=torch.bool, device=dev)
    rounds = 0
    while rounds <= b and bool(pending.any()):
        if on_round is not None:
            on_round(pending)
        sp = repair_speculate(state, batch, usable, rank, big, fchoice,
                              have_usable, slot_rl)
        safe, commit = repair_commit_masks(
            prims, pending=pending, placed=sp.placed, forced=sp.forced,
            sel=sp.sel, take_mem=sp.take_mem, use_conc=sp.use_conc,
            simple=simple, need_mb=batch.need_mb, conc_slot=batch.conc_slot,
            free_at_sel=sp.free_at_sel, col_conc=sp.col_conc,
            n=n, a_slots=a_slots)
        sel = sp.sel.long()
        free.index_add_(0, sel, torch.where(commit & sp.take_mem,
                                            -batch.need_mb, 0))
        conc_delta = torch.where(
            commit & sp.use_conc, -1,
            torch.where(commit & sp.take_mem & ~simple, batch.max_conc - 1,
                        0))
        conc.index_put_((sel, slot_rl), torch.where(slot_ok, conc_delta, 0),
                        accumulate=True)
        chosen = torch.where(safe, torch.where(sp.placed, sp.sel, -1),
                             chosen)
        forced_acc = forced_acc | (safe & sp.forced)
        pending = pending & ~safe
        rounds += 1
    return (state, chosen, forced_acc,
            torch.tensor(rounds, dtype=I32, device=dev))


def release_batch(state: PlacementState, inv, slot, need_mb, max_conc,
                  valid) -> PlacementState:
    """Fold a batch of completion releases into the books in place, one
    row at a time (ref releaseInvoker / NestedSemaphore.releaseConcurrent)."""
    free, conc = state.free_mb, state.conc_free
    for r in range(inv.shape[0]):
        iv = inv[r:r + 1].long()
        sl = slot[r:r + 1].long()
        need, mc, ok = need_mb[r:r + 1], max_conc[r:r + 1], valid[r:r + 1]
        simple = ok & (mc <= 1)
        conc_val = conc[iv, sl] + 1
        reduced = ok & (mc > 1) & (conc_val >= mc)
        # concurrency release: +1 permit; a full container's worth free ->
        # reduce by max_conc and return the container's memory
        conc_delta = torch.where(ok & (mc > 1),
                                 torch.where(reduced, 1 - mc, 1), 0)
        free.index_add_(0, iv, torch.where(simple | reduced, need, 0))
        conc.index_put_((iv, sl), conc_delta, accumulate=True)
    return state


def release_batch_vector(state: PlacementState, inv, slot, need_mb,
                         max_conc, valid) -> PlacementState:
    """Bit-exact `release_batch` with the R-length loop vectorized away.

    Simple rows (`max_conc <= 1`) add memory in one scatter-add.
    Concurrency rows group by (invoker, slot) through two stable argsorts;
    a homogeneous group of k releases from cell value c0 wraps exactly
    r = clip(floor((c0 + k) / max_conc), 0, k) times, so the whole group is
    two scatter-adds. Heterogeneous groups (two actions conflated on one
    hashed slot) replay every row in batch order; there are none in steady
    state. Updates the books in place."""
    r_len = inv.shape[0]
    dev = inv.device
    free, conc = state.free_mb, state.conc_free
    simple = valid & (max_conc <= 1)

    conc_row = valid & (max_conc > 1)
    # lexicographic (inv, slot) sort via two stable passes; non-conc rows
    # key to a (-1, -1) sentinel segment that contributes nothing
    ki = torch.where(conc_row, inv, -1)
    ks = torch.where(conc_row, slot, -1)
    o1 = torch.argsort(ks, stable=True)
    o = o1[torch.argsort(ki[o1], stable=True)]
    ki_s, ks_s = ki[o], ks[o]
    start = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                       (ki_s[1:] != ki_s[:-1]) | (ks_s[1:] != ks_s[:-1])])
    gid = (torch.cumsum(start.to(I32), 0, dtype=I32) - 1).long()
    conc_s, need_s, maxc_s = conc_row[o], need_mb[o], max_conc[o]
    zeros = torch.zeros((r_len,), dtype=I32, device=dev)
    k_g = zeros.clone().index_add_(0, gid, conc_s.to(I32))
    # the group leader (lowest batch index: stable sorts preserve batch
    # order within a key) defines the group's expected need/max_conc
    fneed = zeros.clone().index_add_(0, gid, torch.where(start, need_s, 0))
    fmaxc = zeros.clone().index_add_(0, gid, torch.where(start, maxc_s, 0))
    het_row = conc_s & ((need_s != fneed[gid]) | (maxc_s != fmaxc[gid]))
    het_g = zeros.clone().scatter_reduce_(0, gid, het_row.to(I32),
                                          "amax") > 0

    inv_s, slot_s = inv[o].long(), slot[o].long()
    apply_leader = start & conc_s & ~het_g[gid]
    c0 = conc[inv_s, slot_s]
    k = k_g[gid]
    mx = maxc_s.clamp_min(1)  # sentinel rows: avoid div by <= 0
    wraps = torch.minimum(
        torch.div(c0 + k, mx, rounding_mode="floor").clamp_min(0), k)
    free.index_add_(0, inv.long(), torch.where(simple, need_mb, 0))
    free.index_add_(0, inv_s, torch.where(apply_leader, need_s * wraps, 0))
    conc.index_put_((inv_s, slot_s),
                    torch.where(apply_leader, k - mx * wraps, 0),
                    accumulate=True)

    # heterogeneous residue: every conc row of a conflated group replays in
    # batch order (the host reads the mask: normally all False)
    het_b = torch.zeros((r_len,), dtype=torch.bool, device=dev)
    het_b[o] = conc_s & het_g[gid]
    for i in torch.nonzero(het_b).flatten().tolist():
        iv, sl = inv[i:i + 1].long(), slot[i:i + 1].long()
        nd, mc = need_mb[i:i + 1], max_conc[i:i + 1]
        reduced = conc[iv, sl] + 1 >= mc
        free.index_add_(0, iv, torch.where(reduced, nd, 0))
        conc.index_put_((iv, sl), torch.where(reduced, 1 - mc, 1),
                        accumulate=True)
    return state


def fold_health(state: PlacementState, idx, val, mask) -> PlacementState:
    """Masked health fold in place: only masked-in rows write, so a padded
    row never races a real flip. Duplicate masked-in indices must carry
    equal values (the packer repeats the last flip); out-of-range indices
    are dropped like the JAX scatter drops them."""
    n = state.health.shape[0]
    ok = mask & (idx >= 0) & (idx < n)
    upd = torch.full((n + 1,), -1, dtype=I32, device=idx.device)
    upd.scatter_reduce_(0, torch.where(ok, idx, n).long(),
                        torch.where(ok, val.to(I32), -1), "amax")
    upd = upd[:n]
    state.health.copy_(torch.where(upd >= 0, upd > 0, state.health))
    return state


def make_fused_step(release_fn=None, schedule_fn=None):
    """The balancer's whole step as one function: fold releases -> fold
    health flips -> schedule the micro-batch, all in place.

    Returns (state, chosen, forced, rounds): schedules without a repair
    loop report rounds == 0. Each phase is a named `torch.profiler` range
    (release_fold, health_fold, schedule), so a profile splits the step."""
    release_fn = release_fn or release_batch
    schedule_fn = schedule_fn or schedule_batch
    span = torch.profiler.record_function

    def fused(state: PlacementState, rel_inv, rel_slot, rel_mem, rel_maxc,
              rel_valid, health_idx, health_val, health_valid,
              batch: RequestBatch):
        with span("release_fold"):
            state = release_fn(state, rel_inv, rel_slot, rel_mem, rel_maxc,
                               rel_valid)
        with span("health_fold"):
            state = fold_health(state, health_idx, health_val, health_valid)
        with span("schedule"):
            out = schedule_fn(state, batch)
        rounds = (out[3] if len(out) > 3 else
                  torch.zeros((), dtype=I32, device=state.free_mb.device))
        return out[0], out[1], out[2], rounds

    return fused


def make_release_packed(release_fn=None):
    """Release-only fold over the packed int32[5,R] matrix (inv, slot, mem,
    maxc, valid), in place: the idle-drain counterpart of
    `make_fused_step_packed`."""
    release_fn = release_fn or release_batch

    def packed(state: PlacementState, rel):
        return release_fn(state, rel[0], rel[1], rel[2], rel[3],
                          rel[4].bool())

    return packed


def make_fused_step_packed(release_fn=None, schedule_fn=None):
    """The fused step over ONE packed int32 buffer, with ONE int32 vector
    out, in the JAX package's layout:

      buf int32[5R + 3H + 9B]:
        rel    [5,R]: inv, slot, mem, maxc, valid
        health [3,H]: idx, val, mask
        req    [9,B]: offset, size, home, step_inv, need_mb, conc_slot,
                      max_conc, rand, valid
      out int32[B + 1]: B elements of ((chosen+1)<<2) | forced, then the
                        repair-round count (0 for the scan).

    The books are updated in place (where the JAX package donated them)."""
    fused = make_fused_step(release_fn, schedule_fn)

    def packed(state: PlacementState, buf, R: int, H: int, B: int):
        rel = buf[:5 * R].view(5, R)
        health = buf[5 * R:5 * R + 3 * H].view(3, H)
        req = buf[5 * R + 3 * H:].view(9, B)
        batch = RequestBatch(req[0], req[1], req[2], req[3], req[4], req[5],
                             req[6], req[7], req[8].bool())
        state, chosen, forced, rounds = fused(
            state, rel[0], rel[1], rel[2], rel[3], rel[4].bool(),
            health[0], health[1].bool(), health[2].bool(), batch)
        out = ((chosen + 1) << 2) | forced.to(I32)
        return state, torch.cat([out, rounds.reshape(1).to(I32)])

    return packed


def make_fused_admit_step_packed(release_fn=None, schedule_fn=None):
    """`make_fused_step_packed` with device token-bucket admission
    (ops/throttle.py) before the schedule: the step folds releases and
    health, ADMITS the batch against per-namespace buckets, then schedules
    only the admitted requests. Over-rate requests come back with bit 1 of
    their packed decision set (chosen -1) and never consume capacity.

      carry (state, buckets); buf int32[5R + 3H + 10B]: req grows a 10th
      row, ns_slot (the balancer's namespace -> bucket index); `now` is
      the balancer's small-magnitude clock in seconds.
      out int32[B + 1]: ((chosen+1)<<2) | throttled<<1 | forced, then the
      repair-round count.

    The books are updated in place; the bucket state comes back new."""
    from .throttle import admit_batch

    fused = make_fused_step(release_fn, schedule_fn)

    def packed(carry, buf, now, R: int, H: int, B: int):
        state, buckets = carry
        rel = buf[:5 * R].view(5, R)
        health = buf[5 * R:5 * R + 3 * H].view(3, H)
        req = buf[5 * R + 3 * H:].view(10, B)
        valid = req[8].bool()
        buckets, admitted = admit_batch(buckets, now, req[9], valid)
        throttled = valid & ~admitted
        batch = RequestBatch(req[0], req[1], req[2], req[3], req[4], req[5],
                             req[6], req[7], admitted)
        state, chosen, forced, rounds = fused(
            state, rel[0], rel[1], rel[2], rel[3], rel[4].bool(),
            health[0], health[1].bool(), health[2].bool(), batch)
        out = (((chosen + 1) << 2) | (throttled.to(I32) << 1)
               | forced.to(I32))
        return (state, buckets), torch.cat([out, rounds.reshape(1).to(I32)])

    return packed


def unpack_chosen(out):
    """Decode the packed step output's per-request slice (numpy or torch)
    -> (chosen int32, forced bool, throttled bool). Slice off the trailing
    repair-round element first, or use `unpack_step_output`."""
    return (out >> 2) - 1, (out & 1) != 0, ((out >> 1) & 1) != 0


def unpack_step_output(out):
    """Decode a full packed step output vector (B+1 elements):
    -> (chosen, forced, throttled, repair_rounds int)."""
    chosen, forced, throttled = unpack_chosen(out[:-1])
    return chosen, forced, throttled, int(out[-1])
