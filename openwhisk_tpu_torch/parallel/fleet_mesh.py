"""The production fleet mesh: speculate-and-repair over a ('fleet',) axis.

The counterpart of `openwhisk_tpu/parallel/fleet_mesh.py` on the port's
single-controller mesh (`sharded_state.FleetMesh`):

  * `make_fleet_mesh`  — the ('fleet',) mesh, a power-of-two shard count so
                         power-of-two invoker pads always divide.
  * `make_fleet_repair_schedule`
                       — speculate-and-repair with each shard probing its
                         LOCAL [B, k] slice. Each round: one [S, B, 2]
                         exchange elects the global winners, and one
                         exchange of three owner-masked [B] vectors sums
                         the winning cells' occupancy (free_mb, the conc
                         permit, any consumable permit on the column) on
                         the lead device — the "global-occupancy
                         exchange". The conflict rules are THE shared
                         `repair_commit_masks`, run once over those [B]
                         vectors on the lead device; the commit masks go
                         back to every shard, which applies only the rows
                         it owns. Decisions, books AND round counts equal
                         the single-device repair's.
  * `make_fleet_release_vector`
                       — the release fold on every shard over the rows it
                         owns: on a card one launch of the release kernel
                         a shard (no host read), on the CPU
                         `release_batch_vector`. A (invoker, slot) group
                         lives on one shard, so the single-device
                         exactness argument carries over. No exchange.
  * `fleet_pair`       — the (schedule, release, resolved) selector, with
                         the placement-kernel knob's meaning: scan | repair
                         | auto (the scan below `repair_min_batch` rows,
                         the repair from there).
  * the fused, release-only and shadow steps over one packed buffer, as
    `ops/placement.py` builds them for one device: the buffer crosses to
    the lead device once and once more to each other device of the mesh;
    the health fold is owner-masked; admission's token buckets stay on the
    lead device; the one packed int32[B+1] output lands there.

Every op here is a plain torch op but the release folds, which on a card
launch the release kernel once a shard (`sharded_state.owned_release`), as
the single-device step does: the mesh runs no placement kernel, as the JAX
package's mesh runs no Pallas.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.placement import (I32, PlacementState, RequestBatch, _mulmod,
                             _slot_read_write, flat_prims, fold_health,
                             release_batch_vector, repair_commit_masks,
                             resolve_device, shadow_books)
from ..ops.profiler import span
from .sharded_state import (FleetMesh, Replicas, ShardedState, elect,
                            local_argmin, make_mesh, make_sharded_release,
                            make_sharded_schedule, owned_release,
                            owner_rows, shard_state)

#: the production mesh axis name (sharded_state's prototype used "inv")
FLEET_AXIS = "fleet"


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def make_fleet_mesh(n_shards: Optional[int] = None, axis: str = FLEET_AXIS,
                    device=None) -> FleetMesh:
    """Mesh over the ('fleet',) axis. `n_shards` None or 0 takes every
    visible device of `device`'s kind (the cards for None, one for the
    CPU), rounded DOWN to a power of two: the balancer pads the invoker
    axis to powers of two, and `shard_state` needs the pad to divide
    evenly. Any other count must be a power of two. `device` as
    `make_mesh`: None = the card(s), raising without one; no fallback."""
    dev = resolve_device(device)
    if not n_shards:  # None OR 0 both mean "all devices, pow2-floored"
        avail = (torch.cuda.device_count()
                 if dev.type == "cuda" and dev.index is None else 1)
        want = _pow2_floor(max(1, avail))
    elif _pow2_floor(n_shards) != n_shards:
        raise ValueError(f"fleet shard count must be a power of two "
                         f"(pow2 invoker pads must divide evenly), "
                         f"got {n_shards}")
    else:
        want = n_shards
    return make_mesh(want, axis=axis, device=dev)


def mesh_axis(mesh: FleetMesh) -> str:
    return mesh.axis


def mesh_shards(mesh: FleetMesh) -> int:
    return mesh.n_shards


def mesh_topology(mesh: Optional[FleetMesh]) -> dict:
    """The topology record stamped into the journal / snapshot / admin
    planes (a replayer on a different topology must cold-start, not
    silently mis-shard). `platform` uses JAX's names ("gpu" for CUDA), so
    the record means the same in both packages."""
    if mesh is None:
        return {"n_shards": 1, "axis": None}
    return {"n_shards": mesh_shards(mesh), "axis": mesh_axis(mesh),
            "platform": "gpu" if mesh.lead.type == "cuda" else "cpu"}


def make_fleet_repair_schedule(mesh: FleetMesh, penalized: bool = False):
    """The speculate-and-repair schedule over the fleet mesh: bit-exact
    `schedule_batch_repair` semantics (state, chosen, forced, rounds) with
    the [B, N] probe split to [B, k] a shard, the books updated in place
    and the decisions on the lead device.

    Per round:
      * speculation — each shard computes its slice of exactly the arrays
        the single-device repair computes, over the same loop-invariant
        geometry; the exchange elects the lexicographic (key, global
        index) minimum, the single device's first index of the minimum.
        The forced candidate is elected once, outside the loop.
      * occupancy exchange — free_mb[sel] and the permit at (sel, slot)
        live on one owner shard: the sum of the owner-masked reads (zeros
        elsewhere) is the single-device gather. `col_conc` sums the
        shards' any-permit flags.
      * conflict rules — `repair_commit_masks` over those [B] vectors, once
        on the lead device; `pending` is what the single device's is, so
        the round counts match. The loop reads `pending.any()` on the host
        once a round, as the plain repair does.
      * commit — owner-masked adds (zero elsewhere); an out-of-range
        slot's write is dropped, not clamped.

    `penalized=True` builds the counterfactual variant: the fn takes a
    third argument, a global int32[N] penalty (rank + penalty * size, the
    sentinel raised to 2^30), as the single-device families do."""

    def schedule(state: ShardedState, batch, penalty=None):
        reps = mesh.replicate(batch)
        lead = reps[mesh.lead]
        b = lead.valid.shape[0]
        prims = flat_prims(b, mesh.lead)
        k = state.rows_per_shard
        n_total = k * mesh.n_shards
        a_slots = state.shards[0].conc_free.shape[1]
        big = n_total + 2 if penalty is None else 1 << 30

        # loop-invariant LOCAL geometry: each shard's slice of the [B, N]
        # rank/partition math (ops.placement._probe_geometry)
        geo = []
        for s, st in enumerate(state.shards):
            dev = st.free_mb.device
            bt = reps[dev]
            off = s * k
            gidx = off + torch.arange(k, dtype=I32, device=dev)
            local = gidx[None, :] - bt.offset[:, None]         # [B, k]
            size_col = bt.size[:, None]
            in_part = (local >= 0) & (local < size_col)
            size_safe = size_col.clamp_min(1)
            rank = _mulmod(local - bt.home[:, None], bt.step_inv[:, None],
                           size_safe)
            if penalty is not None:
                rank = rank + penalty[off:off + k].to(dev)[None, :] \
                    * size_safe
            usable = in_part & st.health[None, :]
            fkey = torch.where(usable, torch.remainder(
                local - bt.rand[:, None], size_safe), big)
            slot_r, slot_ok = _slot_read_write(bt.conc_slot, a_slots)
            geo.append((st, bt, off, rank, usable, local_argmin(fkey, off),
                        slot_r.long(), slot_ok, bt.max_conc <= 1))
        # the forced path is loop-invariant (capacity-blind, health fixed
        # inside a batch): elect the global forced candidate once
        fmin, fbest = elect(mesh, [g[5] for g in geo], big)
        have_usable = fmin < big
        simple = lead.max_conc <= 1

        pending = lead.valid.clone()
        chosen = torch.full((b,), -1, dtype=I32, device=mesh.lead)
        forced_acc = torch.zeros((b,), dtype=torch.bool, device=mesh.lead)
        rounds = 0
        while rounds <= b and bool(pending.any()):
            probes = []
            for st, bt, off, rank, usable, _f, slot_rl, _ok, _s in geo:
                conc_bn = st.conc_free.T.index_select(0, slot_rl)  # [B, k]
                has_conc = conc_bn > 0
                eligible = usable & (has_conc | (st.free_mb[None, :]
                                                 >= bt.need_mb[:, None]))
                probes.append((conc_bn, has_conc, local_argmin(
                    torch.where(eligible, rank, big), off)))
            kmin, choice = elect(mesh, [p[2] for p in probes], big)
            found = kmin < big
            sel = torch.where(found, choice, fbest)
            placed = lead.valid & (found | have_usable)
            forced = lead.valid & ~found & have_usable

            # global-occupancy exchange: the winning cell's books live on
            # one owner shard — sum the owner-masked reads
            parts, owners = [], []
            for (st, _bt, off, _r, usable, _f, _sl, _ok, _s), \
                    (conc_bn, has_conc, _p) in zip(geo, probes):
                lsel, mine = owner_rows(sel.to(st.free_mb.device), off, k)
                owners.append((lsel, mine))
                parts.append(torch.stack([
                    torch.where(mine, conc_bn.gather(1, lsel[:, None])[:, 0],
                                0),
                    torch.where(mine, st.free_mb[lsel], 0),
                    (usable & has_conc).any(1).to(I32)]).to(mesh.lead))
            occ = torch.stack(parts).sum(0, dtype=I32)        # [3, B]
            use_conc = placed & (occ[0] > 0)
            take_mem = placed & ~use_conc

            # THE shared conflict rules over the [B] vectors, once
            safe, commit = repair_commit_masks(
                prims, pending=pending, placed=placed, forced=forced,
                sel=sel, take_mem=take_mem, use_conc=use_conc,
                simple=simple, need_mb=lead.need_mb,
                conc_slot=lead.conc_slot, free_at_sel=occ[1],
                col_conc=occ[2] > 0, n=n_total, a_slots=a_slots)

            # owner-masked commit (zero adds elsewhere are no-ops)
            masks = mesh.replicate(torch.stack([commit & take_mem,
                                                commit & use_conc]))
            for (st, bt, _o, _r, _u, _f, slot_rl, slot_ok, simple_d), \
                    (lsel, mine) in zip(geo, owners):
                m = masks[st.free_mb.device]
                mem_w, conc_w = m[0] & mine, m[1] & mine
                st.free_mb.index_add_(0, lsel, torch.where(
                    mem_w, -bt.need_mb, 0))
                delta = torch.where(conc_w, -1, torch.where(
                    mem_w & ~simple_d, bt.max_conc - 1, 0))
                st.conc_free.index_put_(
                    (lsel, slot_rl), torch.where(slot_ok, delta, 0),
                    accumulate=True)
            chosen = torch.where(safe, torch.where(placed, sel, -1), chosen)
            forced_acc = forced_acc | (safe & forced)
            pending = pending & ~safe
            rounds += 1
        return (state, chosen, forced_acc,
                torch.tensor(rounds, dtype=I32, device=mesh.lead))

    if penalized:
        return lambda state, batch, penalty: schedule(state, batch, penalty)
    return lambda state, batch: schedule(state, batch)


def make_fleet_release_vector(mesh: FleetMesh):
    """The owner-masked release fold of the repair family: on CPU books
    `release_batch_vector` on every shard, with the rows it does not own
    masked invalid; on a card one launch of the release kernel a shard
    (`sharded_state.owned_release`). A group's rows share one invoker,
    hence one shard, so the batch order inside a group — the only order
    that matters — is kept. No exchange."""
    return owned_release(mesh, release_batch_vector)


def _on_lead(mesh: FleetMesh, x):
    return x[mesh.lead] if isinstance(x, Replicas) else x


def fleet_pair(mesh: FleetMesh, placement_kernel: str,
               repair_min_batch: int = 32):
    """(schedule_fn, release_fn, resolved_kernel) for the fleet mesh, with
    the placement-kernel knob's single-device meaning: "repair" pins the
    sharded speculate-and-repair pair, "scan" the sharded scan pair,
    "auto" picks per batch width (scan below `repair_min_batch`, repair
    at and above it). Every pair is bit-exact with every other and with
    the single-device functions, so the knob moves only cost."""
    sched_scan = make_sharded_schedule(mesh)
    rel_scan = make_sharded_release(mesh)
    if placement_kernel == "scan":
        return sched_scan, rel_scan, "scan"
    sched_repair = make_fleet_repair_schedule(mesh)
    rel_repair = make_fleet_release_vector(mesh)
    if placement_kernel == "repair":
        return sched_repair, rel_repair, "repair"
    if placement_kernel != "auto":
        raise ValueError(f"placement_kernel must be scan|repair|auto, got "
                         f"{placement_kernel!r}")
    threshold = repair_min_batch

    def auto_schedule(state, batch):
        width = _on_lead(mesh, batch).valid.shape[0]
        fn = sched_repair if width >= threshold else sched_scan
        return fn(state, batch)

    def auto_release(state, inv, slot, need_mb, max_conc, valid):
        width = _on_lead(mesh, inv).shape[0]
        fn = rel_repair if width >= threshold else rel_scan
        return fn(state, inv, slot, need_mb, max_conc, valid)

    auto_schedule._placement_hybrid = True
    auto_release._placement_hybrid = True
    return auto_schedule, auto_release, "repair"


# -- the step over one packed buffer, on the mesh ---------------------------

def _rows(bufs: Replicas, lo: int, n_rows: int, width: int):
    """The [n_rows, width] block at bufs[d][lo:] as one `Replicas` a row."""
    cols = [Replicas() for _ in range(n_rows)]
    for d, buf in bufs.items():
        block = buf[lo:lo + n_rows * width].view(n_rows, width)
        for j in range(n_rows):
            cols[j][d] = block[j]
    return cols


def _bools(col: Replicas) -> Replicas:
    return Replicas((d, t.bool()) for d, t in col.items())


def _unpack(mesh: FleetMesh, buf, R: int, H: int, B: int, req_rows: int):
    """The packed buffer's releases (5 columns), health flips (3) and
    request rows (`req_rows`) as per-device views of one copy a device."""
    bufs = mesh.replicate(buf)
    rel = _rows(bufs, 0, 5, R)
    health = _rows(bufs, 5 * R, 3, H)
    req = _rows(bufs, 5 * R + 3 * H, req_rows, B)
    rel[4], health[1], health[2] = (_bools(rel[4]), _bools(health[1]),
                                    _bools(health[2]))
    return rel, health, req


def _batch(req, valid: Replicas) -> Replicas:
    return Replicas((d, RequestBatch(*(c[d] for c in req[:8]), v))
                    for d, v in valid.items())


def make_fleet_fold_health(mesh: FleetMesh):
    """The owner-masked health fold: `fold_health` on every shard over the
    flips it owns (the masked `scatter_reduce` rule for duplicates)."""

    def fold(state: ShardedState, idx, val, mask) -> ShardedState:
        args = [mesh.replicate(x) for x in (idx, val, mask)]
        k = state.rows_per_shard
        for s, st in enumerate(state.shards):
            dev = st.free_mb.device
            idx_d, val_d, mask_d = (x[dev] for x in args)
            # a flip another shard owns lands outside [0, k) here, and
            # fold_health drops indices outside the books: the owner mask
            fold_health(st, idx_d - s * k, val_d, mask_d)
        return state

    return fold


def _fused(mesh: FleetMesh, release_fn, schedule_fn):
    fold = make_fleet_fold_health(mesh)

    def fused(state, rel, health, batch):
        with span("release_fold"):
            state = release_fn(state, *rel)
        with span("health_fold"):
            state = fold(state, *health)
        with span("schedule"):
            out = schedule_fn(state, batch)
        rounds = (out[3] if len(out) > 3 else
                  torch.zeros((), dtype=I32, device=mesh.lead))
        return out[0], out[1], out[2], rounds

    return fused


def make_fleet_fused_step_packed(mesh: FleetMesh, release_fn, schedule_fn):
    """`make_fused_step_packed` on the mesh: the same buffer layout
    (int32[5R + 3H + 9B]) and the same int32[B + 1] output, on the lead
    device; the books are updated in place on their shards."""
    fused = _fused(mesh, release_fn, schedule_fn)

    def packed(state: ShardedState, buf, R: int, H: int, B: int):
        rel, health, req = _unpack(mesh, buf, R, H, B, 9)
        state, chosen, forced, rounds = fused(state, rel, health,
                                              _batch(req, _bools(req[8])))
        out = ((chosen + 1) << 2) | forced.to(I32)
        return state, torch.cat([out, rounds.reshape(1).to(I32)])

    return packed


def make_fleet_fused_admit_step_packed(mesh: FleetMesh, release_fn,
                                       schedule_fn):
    """`make_fused_admit_step_packed` on the mesh: the token buckets stay
    on the lead device, where the admission runs; the admitted mask
    crosses to the other devices once."""
    from ..ops.throttle import admit_batch

    fused = _fused(mesh, release_fn, schedule_fn)

    def packed(carry, buf, now, R: int, H: int, B: int):
        state, buckets = carry
        rel, health, req = _unpack(mesh, buf, R, H, B, 10)
        valid = req[8][mesh.lead].bool()
        buckets, admitted = admit_batch(buckets, now, req[9][mesh.lead],
                                        valid)
        throttled = valid & ~admitted
        state, chosen, forced, rounds = fused(
            state, rel, health, _batch(req, mesh.replicate(admitted)))
        out = (((chosen + 1) << 2) | (throttled.to(I32) << 1)
               | forced.to(I32))
        return (state, buckets), torch.cat([out, rounds.reshape(1).to(I32)])

    return packed


def make_fleet_release_packed(mesh: FleetMesh, release_fn):
    """The release-only fold over the packed int32[5, R] matrix on the
    mesh (the idle-drain counterpart of the fused step)."""

    def packed(state: ShardedState, rel):
        cols = _rows(mesh.replicate(rel.reshape(-1)), 0, 5, rel.shape[1])
        return release_fn(state, *cols[:4], _bools(cols[4]))

    return packed


def empty_sharded_books_like(state: ShardedState) -> ShardedState:
    """Uninitialized books of `state`'s shards, each on its device, conc
    held as the `.T` view of its own contiguous [A, k]."""
    return ShardedState(tuple(PlacementState(
        torch.empty_like(s.free_mb), torch.empty_like(s.conc_free.T).T,
        torch.empty_like(s.health)) for s in state.shards))


def fleet_shadow_books(live: ShardedState,
                       scratch: Optional[ShardedState] = None
                       ) -> ShardedState:
    """`shadow_books` shard by shard: every shard of `live` copied into
    the matching shard of `scratch` (allocated when None)."""
    if scratch is None:
        scratch = empty_sharded_books_like(live)
    elif len(scratch.shards) != len(live.shards):
        raise ValueError(f"fleet_shadow_books: {len(scratch.shards)} "
                         f"scratch shards for {len(live.shards)} live ones")
    for s, t in zip(scratch.shards, live.shards):
        shadow_books(t, s)
    return scratch


def make_fleet_shadow_step_packed(mesh: FleetMesh, release_fn, schedule_fn):
    """`make_shadow_step_packed` on the mesh: the decision-only pass over
    the same packed buffer on a copy of every shard, `schedule_fn(state,
    batch, penalty)` with the global int32[N] penalty; returns the
    B-element decision vector on the lead device."""
    fold = make_fleet_fold_health(mesh)

    def shadow(state: ShardedState, buf, penalty, R: int, H: int, B: int,
               scratch: Optional[ShardedState] = None):
        rel, health, req = _unpack(mesh, buf, R, H, B, 9)
        st = fleet_shadow_books(state, scratch)
        st = release_fn(st, *rel)
        st = fold(st, *health)
        out = schedule_fn(st, _batch(req, _bools(req[8])), penalty)
        return ((out[1] + 1) << 2) | out[2].to(I32)

    return shadow


def make_fleet_shadow_admit_step_packed(mesh: FleetMesh, release_fn,
                                        schedule_fn):
    """`make_shadow_admit_step_packed` on the mesh: the admission re-runs
    on the lead device against the production step's buckets and `now`
    (its new buckets are dropped); bit 1 carries throttled."""
    from ..ops.throttle import admit_batch

    fold = make_fleet_fold_health(mesh)

    def shadow(carry, buf, penalty, now, R: int, H: int, B: int,
               scratch: Optional[ShardedState] = None):
        state, buckets = carry
        rel, health, req = _unpack(mesh, buf, R, H, B, 10)
        valid = req[8][mesh.lead].bool()
        _, admitted = admit_batch(buckets, now, req[9][mesh.lead], valid)
        throttled = valid & ~admitted
        st = fleet_shadow_books(state, scratch)
        st = release_fn(st, *rel)
        st = fold(st, *health)
        out = schedule_fn(st, _batch(req, mesh.replicate(admitted)), penalty)
        return (((out[1] + 1) << 2) | (throttled.to(I32) << 1)
                | out[2].to(I32))

    return shadow


__all__ = ["FLEET_AXIS", "make_fleet_mesh", "mesh_axis", "mesh_shards",
           "mesh_topology", "make_fleet_repair_schedule",
           "make_fleet_release_vector", "fleet_pair", "shard_state",
           "make_mesh", "make_fleet_fold_health",
           "make_fleet_fused_step_packed",
           "make_fleet_fused_admit_step_packed",
           "make_fleet_release_packed", "empty_sharded_books_like",
           "fleet_shadow_books", "make_fleet_shadow_step_packed",
           "make_fleet_shadow_admit_step_packed"]
