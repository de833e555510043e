"""Sharded placement: the invoker axis split over a fleet mesh of devices.

The counterpart of `openwhisk_tpu/parallel/sharded_state.py`, as a
single-controller mesh: one process drives every shard, as the JAX
package's `shard_map` does, and the collectives are explicit exchanges
onto the lead device (shard 0's):

  * `FleetMesh`     — the axis name and the S devices, in shard order.
  * `ShardedState`  — the books as S per-shard `PlacementState`s. Shard s
                      owns invoker rows [s*k, (s+1)*k), k = N / S (the
                      block layout of the JAX package's NamedSharding).
                      Each shard's conc book is its own contiguous [A, k]
                      storage held as the [k, A] view, as `init_state`
                      holds the whole book: a block of rows of the global
                      [N, A] view is not contiguous in storage, so a shard
                      never aliases or slices the global book.
  * an all_gather   — S per-shard vectors stacked on the lead device;
  * a psum          — S owner-masked per-shard vectors summed there.

The scan schedule: for each request, every shard reduces its local slice
to (best probe-rank, its global index) and the forced-placement fallback
candidate; ONE [S, 2] exchange elects the global winner by lexicographic
(key, global index) minimum; only the owner shard applies the capacity
update. This keeps the exact sequential semantics of the single-device
scan at any shard count.

`shard_state` and `gather_state` move books between the global layout
and the mesh; the `sharded_set_*` writes go to the owner shards (a write
into a gathered copy would be lost).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops.placement import (I32, PlacementState, _mulmod,
                             _slot_read_write, release_batch, resolve_device)


class Replicas(dict):
    """One value a device of a mesh (tensors, or tuples of tensors),
    keyed by `torch.device`: a host buffer crosses to each distinct
    device once, and every shard on a device reads the same copy."""


def _to(x, dev: torch.device):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    vals = [_to(e, dev) for e in x]
    return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)


class FleetMesh:
    """A single-controller device mesh: the axis name and S devices in
    shard order (several shards may share a device). The first device is
    the lead: exchanges land there, and so do the step's outputs."""

    def __init__(self, devices: Sequence, axis: str = "inv"):
        if not devices:
            raise ValueError("a fleet mesh needs at least one device")
        self.devices: Tuple[torch.device, ...] = tuple(
            torch.device(d) for d in devices)
        self.axis = axis
        self.distinct: Tuple[torch.device, ...] = tuple(
            dict.fromkeys(self.devices))

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def replicate(self, x) -> Replicas:
        """`x` on every distinct device of the mesh (the lead's entry is
        `x` itself when it lives there); `Replicas` pass through."""
        if isinstance(x, Replicas):
            return x
        return Replicas((d, _to(x, d)) for d in self.distinct)


class ShardedState(NamedTuple):
    """The books as per-shard `PlacementState`s, shard s owning rows
    [s*k, (s+1)*k). `free_mb`, `conc_free` and `health` read the GLOBAL
    books, gathered onto the lead device: fresh copies for readers (a
    write into them is lost; write through the `sharded_set_*` helpers or
    the sharded steps)."""
    shards: Tuple[PlacementState, ...]

    @property
    def rows_per_shard(self) -> int:
        return self.shards[0].free_mb.shape[0]

    @property
    def lead(self) -> torch.device:
        return self.shards[0].free_mb.device

    @property
    def free_mb(self) -> torch.Tensor:
        return torch.cat([s.free_mb.to(self.lead) for s in self.shards])

    @property
    def conc_free(self) -> torch.Tensor:
        return torch.cat([s.conc_free.T.to(self.lead) for s in self.shards],
                         1).T

    @property
    def health(self) -> torch.Tensor:
        return torch.cat([s.health.to(self.lead) for s in self.shards])


def make_mesh(n_devices: Optional[int] = None, axis: str = "inv",
              device=None) -> FleetMesh:
    """A mesh of `n_devices` shards (None: one a visible device). `device`
    follows the port's device rule: None means the card(s) and raises
    without one; "cpu" puts every shard on the CPU, as the tests ask.
    On the cards shard s goes on cuda:(s * count // S), so shards share a
    card when there are fewer cards than shards; a CUDA device with an
    index pins every shard to it. Nothing falls back to the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        want = n_devices or count
        return FleetMesh([torch.device("cuda", s * count // want)
                          for s in range(want)], axis)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index)
    return FleetMesh([dev] * (n_devices or 1), axis)


def shard_state(state: PlacementState, mesh: FleetMesh,
                axis: Optional[str] = None) -> ShardedState:
    """Split global books over the mesh, each shard in storage of its own
    on its device. `axis` names the mesh's axis, as the JAX package's
    signature does; the mesh has one."""
    if axis is not None and axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    n = state.free_mb.shape[0]
    s_count = mesh.n_shards
    if n % s_count:
        raise ValueError(f"invoker padding {n} must divide evenly over "
                         f"{s_count} shards")
    k = n // s_count
    a = state.conc_free.shape[1]
    conc_an = state.conc_free.T  # the [A, N] storage of the [N, A] view
    shards = []
    for s, dev in enumerate(mesh.devices):
        lo, hi = s * k, (s + 1) * k
        free = torch.empty((k,), dtype=I32, device=dev)
        free.copy_(state.free_mb[lo:hi])
        conc = torch.empty((a, k), dtype=I32, device=dev)
        conc.copy_(conc_an[:, lo:hi])
        health = torch.empty((k,), dtype=torch.bool, device=dev)
        health.copy_(state.health[lo:hi])
        shards.append(PlacementState(free, conc.T, health))
    return ShardedState(tuple(shards))


def gather_state(sharded: ShardedState, device=None) -> PlacementState:
    """The global books rebuilt on `device` (None: the lead device), conc
    as the [N, A] view of contiguous [A, N] storage. Fresh tensors."""
    dev = torch.device(device) if device is not None else sharded.lead
    sh = sharded.shards
    return PlacementState(
        torch.cat([s.free_mb.to(dev) for s in sh]),
        torch.cat([s.conc_free.T.to(dev) for s in sh], 1).T,
        torch.cat([s.health.to(dev) for s in sh]))


def _rows_by_shard(sharded: ShardedState, idx, values):
    """Host indices and values split by owner shard: (shard, local rows,
    values) for each shard that owns any, grouped on the host (a write
    of a few rows is a registration's or a health flip's)."""
    k = sharded.rows_per_shard
    groups: Dict[int, Tuple[List[int], list]] = {}
    for i, v in zip(torch.as_tensor(idx).reshape(-1).tolist(),
                    torch.as_tensor(values).reshape(-1).tolist()):
        rows, vals = groups.setdefault(i // k, ([], []))
        rows.append(i - (i // k) * k)
        vals.append(v)
    for s, (rows, vals) in sorted(groups.items()):
        yield sharded.shards[s], rows, vals


def sharded_set_health(sharded: ShardedState, idx, usable) -> ShardedState:
    """`set_health` on the owner shards (unique indices)."""
    for st, rows, vals in _rows_by_shard(sharded, idx, usable):
        dev = st.health.device
        st.health[torch.tensor(rows, device=dev)] = torch.tensor(
            vals, dtype=torch.bool, device=dev)
    return sharded


def sharded_set_free(sharded: ShardedState, idx, free_mb) -> ShardedState:
    """free_mb[idx] = free_mb on the owner shards (unique indices)."""
    for st, rows, vals in _rows_by_shard(sharded, idx, free_mb):
        dev = st.free_mb.device
        st.free_mb[torch.tensor(rows, device=dev)] = torch.tensor(
            vals, dtype=I32, device=dev)
    return sharded


def owner_rows(sel_d, off: int, k: int):
    """Global indices on a shard's device -> (local index clamped into the
    shard, int64; mask of the rows this shard owns)."""
    mine = (sel_d >= off) & (sel_d < off + k)
    return (sel_d - off).clamp(0, k - 1).long(), mine


def elect(mesh: FleetMesh, parts: List[torch.Tensor], big: int):
    """The all_gather election: per-shard (key, global index) pairs [.., 2]
    stacked on the lead device -> the lexicographic (key, index) minimum,
    which is the first index of the minimum over the concatenated axis
    (what a single-device argmin returns). -> (key, index)."""
    allv = torch.stack([p.to(mesh.lead) for p in parts])   # [S, .., 2]
    kmin = allv[..., 0].amin(0)
    idx = torch.where(allv[..., 0] == kmin, allv[..., 1], big).amin(0)
    return kmin, idx


def local_argmin(key, off: int):
    """A shard's [.., k] keys -> its [.., 2] (min key, global index) pairs
    (the lowest local index on ties)."""
    a = torch.argmin(key, -1, keepdim=True)
    return torch.stack([key.gather(-1, a)[..., 0],
                        off + a[..., 0].to(I32)], -1)


def make_sharded_schedule(mesh: FleetMesh):
    """The sharded scan: `fn(state, batch) -> (state, chosen int32[B],
    forced bool[B])` with the books updated in place and the decisions on
    the lead device. Bit-exact with `schedule_batch`.

    The probe geometry and the forced candidate do not depend on the
    books (health is fixed inside a batch), so each shard computes them
    for all B requests up front, and the forced candidates are elected
    once; each request then probes the current books on every shard, one
    [S, 2] exchange elects the winner, and the owner shard commits."""

    def schedule(state: ShardedState, batch):
        reps = mesh.replicate(batch)
        lead = reps[mesh.lead]
        b = lead.valid.shape[0]
        k = state.rows_per_shard
        n_total = k * mesh.n_shards
        a_slots = state.shards[0].conc_free.shape[1]
        big = n_total + 2
        geo = []
        for s, st in enumerate(state.shards):
            dev = st.free_mb.device
            bt = reps[dev]
            off = s * k
            gidx = off + torch.arange(k, dtype=I32, device=dev)
            local = gidx[None, :] - bt.offset[:, None]
            size_col = bt.size[:, None]
            in_part = (local >= 0) & (local < size_col)
            size_safe = size_col.clamp_min(1)
            rank = _mulmod(local - bt.home[:, None], bt.step_inv[:, None],
                           size_safe)
            usable = in_part & st.health[None, :]
            fkey = torch.where(usable, torch.remainder(
                local - bt.rand[:, None], size_safe), big)
            slot_r, slot_ok = _slot_read_write(bt.conc_slot, a_slots)
            geo.append((st, bt, off, rank, usable, local_argmin(fkey, off),
                        slot_r.long(), slot_ok))
        fmin, fbest = elect(mesh, [g[5] for g in geo], big)
        have_usable = fmin < big
        chosen, forced = [], []
        for i in range(b):
            parts, cols = [], []
            for st, bt, off, rank, usable, _f, slot_rl, _ok in geo:
                # a copy of the slot's column as this request finds it
                col = st.conc_free.T.index_select(0, slot_rl[i:i + 1])[0]
                cols.append(col)
                eligible = usable[i] & ((col > 0)
                                        | (st.free_mb >= bt.need_mb[i:i + 1]))
                parts.append(local_argmin(torch.where(eligible, rank[i],
                                                      big), off))
            kmin, best = elect(mesh, parts, big)
            found = kmin < big
            sel = torch.where(found, best, fbest[i])
            placed = lead.valid[i] & (found | have_usable[i])
            forced.append((lead.valid[i] & ~found & have_usable[i])
                          .reshape(1))
            chosen.append(torch.where(placed, sel, -1).reshape(1))
            # owner-masked update: zero adds off the owner shard
            for (st, bt, off, _r, _u, _f, slot_rl, slot_ok), col in zip(
                    geo, cols):
                # 1-element tensors throughout: a 0-dim tensor index is
                # read on the host
                dev = st.free_mb.device
                lsel, mine = owner_rows(sel.reshape(1).to(dev), off, k)
                mine = mine & placed.to(dev)
                use_conc = mine & (col.index_select(0, lsel) > 0)
                take_mem = mine & ~use_conc
                need, maxc = bt.need_mb[i:i + 1], bt.max_conc[i:i + 1]
                st.free_mb.index_add_(0, lsel, torch.where(take_mem, -need,
                                                           0))
                delta = torch.where(use_conc, -1, torch.where(
                    take_mem & (maxc > 1), maxc - 1, 0))
                st.conc_free.index_put_(
                    (lsel, slot_rl[i:i + 1]),
                    torch.where(slot_ok[i:i + 1], delta, 0),
                    accumulate=True)
        if b == 0:
            return (state, torch.zeros((0,), dtype=I32, device=mesh.lead),
                    torch.zeros((0,), dtype=torch.bool, device=mesh.lead))
        return state, torch.cat(chosen).to(I32), torch.cat(forced)

    return schedule


def _owned_release_args(mesh: FleetMesh, state: ShardedState, inv, slot,
                        need_mb, max_conc, valid):
    """Per shard: (its books, local invoker rows, slot, need, max_conc,
    valid & owned) on its device — the rows it does not own masked
    invalid."""
    args = [mesh.replicate(x) for x in (inv, slot, need_mb, max_conc, valid)]
    k = state.rows_per_shard
    for s, st in enumerate(state.shards):
        dev = st.free_mb.device
        inv_d, slot_d, need_d, maxc_d, valid_d = (x[dev] for x in args)
        linv, mine = owner_rows(inv_d, s * k, k)
        yield st, linv.to(I32), slot_d, need_d, maxc_d, valid_d & mine


def make_sharded_release(mesh: FleetMesh):
    """The sharded row-by-row release fold (`release_batch` on every
    shard over the rows it owns): owner-masked, no exchange."""

    def release(state: ShardedState, inv, slot, need_mb, max_conc, valid):
        for args in _owned_release_args(mesh, state, inv, slot, need_mb,
                                        max_conc, valid):
            release_batch(*args)
        return state

    return release


__all__ = ["FleetMesh", "Replicas", "ShardedState", "make_mesh",
           "shard_state", "gather_state", "sharded_set_health",
           "sharded_set_free", "make_sharded_schedule",
           "make_sharded_release"]
