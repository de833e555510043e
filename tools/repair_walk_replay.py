"""Replay an owbench cell's steps on the CPU and measure how far each
pending row's probe moves from one repair round to the next.

    python3 tools/repair_walk_replay.py --workload ow64k-default.fanout \\
        --seed 7 [--steps 6] [--chunk 256]

from the root of a checkout; no card is needed. The NumPy reference
(`owbench/reference/sharding.py`) drives the cell's set-up and then
`--steps` window steps. For each window step the books as the step's
schedule starts (releases and health folded) and the step's rows are
taken, and the speculate-and-repair rounds are emulated on them: every
round probes each pending row's whole window in rank order and commits
the set that `ops/placement.py` `repair_commit_masks` settles, as
`schedule_batch_repair` and the card's repair kernel do. The emulated
decisions are checked against the reference's.

Between two rounds a pending row resumes (the repair kernel probes it from
its last rank) unless a commit of the round before wrote a nonzero permit
delta into its read slot's column or raised an invoker's free memory.
Printed as one JSON line: the mean pending rows a round, rounds a step,
the share of pending rows that resume, the distribution of a resumed row's
rank move, and for K = 1, 2, 4, 8 the share of resumed probes whose next
fit lies within their first K * `--chunk` ranks (the first pass).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
FIRST_PASS_CHUNKS = (1, 2, 4, 8)


class Snapshotting:
    """Mixin for the reference: the books as each step's first row is
    probed (after the step's release and health folds): free memory,
    health and the permit rows of the slots the step's rows read."""

    def step(self):
        b = min(len(self._queued), self.max_batch)
        self._slots_read = {int(self._queued[k][0][5]) for k in range(b)}
        self._snap = None
        return super().step()

    def _probe(self, *args, **kw):
        if self._snap is None:
            self._snap = (self.free.copy(), self.health.copy(),
                          {s: self.conc[s].copy() for s in self._slots_read})
        return super()._probe(*args, **kw)


def emulate(free, health, conc_rows, rows, a_slots, torch, T):
    """The repair rounds of one step: returns (chosen, records, resets):
    per round, {row: (found, rank)} over its pending rows (rank = the
    window's size where nothing fits), and (the slots whose permit column
    the round's commits changed, whether a commit raised free memory)."""
    off, size, home, sinv, need, slot, maxc, rand, valid = rows
    b = rows.shape[1]
    free = free.astype(np.int64).copy()
    conc = {s: c.astype(np.int64).copy() for s, c in conc_rows.items()}
    geo = {}

    def walk(i):
        key = (int(off[i]), int(size[i]), int(home[i]), int(sinv[i]))
        g = geo.get(key)
        if g is None:
            o, m, h, si = key
            st = pow(si, -1, m) if m > 1 else 0
            g = geo[key] = o + (h + np.arange(m, dtype=np.int64) * st) % m
        return g

    pending = valid.astype(bool).copy()
    chosen = np.full(b, -1, np.int64)
    fsel, have = np.zeros(b, np.int64), np.zeros(b, bool)
    for i in np.nonzero(pending)[0]:
        m = int(size[i])
        idx = np.arange(off[i], off[i] + m)
        fk = np.where(health[idx], (idx - off[i] - rand[i]) % m, m + 1)
        fsel[i], have[i] = idx[fk.argmin()], fk.min() <= m
    prims = T.flat_prims(b, "cpu")
    t = torch.from_numpy
    records, resets = [], []
    rounds = 0
    while rounds <= b and pending.any():
        found = np.zeros(b, bool)
        sel = np.zeros(b, np.int64)
        col_conc = np.zeros(b, bool)
        rec = {}
        for i in np.nonzero(pending)[0]:
            seq = walk(i)
            c = conc[int(slot[i])][seq]
            ok = health[seq] & ((c > 0) | (free[seq] >= need[i]))
            r = int(ok.argmax())
            found[i] = bool(ok[r])
            sel[i] = seq[r] if found[i] else fsel[i]
            col_conc[i] = bool((health[seq] & (c > 0)).any())
            rec[int(i)] = (bool(found[i]), r if found[i] else int(size[i]))
        placed = valid.astype(bool) & (found | have)
        use_conc = placed & np.array(
            [conc[int(slot[i])][sel[i]] > 0 for i in range(b)])
        take_mem = placed & ~use_conc
        simple = maxc <= 1
        safe, commit = T.repair_commit_masks(
            prims, pending=t(pending), placed=t(placed),
            forced=t(valid.astype(bool) & ~found & have),
            sel=t(sel.astype(np.int32)), take_mem=t(take_mem),
            use_conc=t(use_conc), simple=t(simple),
            need_mb=t(need.astype(np.int32)),
            conc_slot=t(slot.astype(np.int32)),
            free_at_sel=t(free[sel].astype(np.int32)),
            col_conc=t(col_conc), n=len(free), a_slots=a_slots)
        safe, commit = safe.numpy(), commit.numpy()
        slots_hit, raised = set(), False
        for j in np.nonzero(commit)[0]:
            s = int(slot[j])
            if take_mem[j]:
                free[sel[j]] -= need[j]
                raised |= need[j] < 0
            delta = -1 if use_conc[j] else (
                maxc[j] - 1 if take_mem[j] and maxc[j] > 1 else 0)
            if delta:
                conc[s][sel[j]] += delta
                slots_hit.add(s)
        chosen[safe] = np.where(placed[safe], sel[safe], -1)
        pending &= ~safe
        records.append(rec)
        resets.append((slots_hit, raised))
        rounds += 1
    return chosen, records, resets


def replay(workload: str, seed: int, steps: int, chunk: int) -> dict:
    sys.path.insert(0, str(ROOT))
    import torch
    from openwhisk_tpu_torch.ops import placement as T
    from owbench.lib.drive import Loop, StepInputs
    from owbench.lib.manifest import Manifest
    from owbench.lib.traffic import Traffic
    from owbench.reference.sharding import Reference

    torch.set_num_threads(1)
    cell = Manifest(ROOT).cell(workload)
    cfg = cell.config
    fleet = [cfg["invoker_memory_mb"]] * cfg["invokers"]
    kw = dict(cluster_size=cfg["cluster_size"],
              managed_fraction=cfg["managed_fraction"],
              blackbox_fraction=cfg["blackbox_fraction"],
              max_batch=cfg["max_batch"], action_slots=cfg["action_slots"])

    class Ref(Snapshotting, Reference):
        pass

    ref = Ref(fleet, **kw)
    traffic = Traffic(cfg, cell.mix, seed)
    loop = Loop(ref, StepInputs(traffic), traffic.table)
    loop.run(traffic.setup_steps)
    pend, moves, rounds_seen = [], [], []
    resumed = listed = mismatched = 0
    first_pass = {k: 0 for k in FIRST_PASS_CHUNKS}
    for _ in range(steps):
        loop.before_step()
        res = ref.step()
        loop.after_step(res)
        free, health, conc_rows = ref._snap
        rows = res.rows.astype(np.int64)
        chosen, records, resets = emulate(free, health, conc_rows, rows,
                                          cfg["action_slots"], torch, T)
        mismatched += int((chosen != res.chosen).sum())
        rounds_seen.append(len(records))
        for r, rec in enumerate(records):
            pend.append(len(rec))
            listed += len(rec)
            if r == 0:
                continue
            prev, (hit_slots, raised) = records[r - 1], resets[r - 1]
            for i, (found, rank) in rec.items():
                if raised or int(rows[5, i]) in hit_slots:
                    continue
                resumed += 1
                was_found, bound = prev[i]
                m = int(rows[1, i])
                if rank < bound:
                    raise AssertionError(
                        f"row {i} moved back from rank {bound} to {rank}")
                if not was_found:
                    for k in first_pass:
                        first_pass[k] += 1
                    continue
                move = rank - bound  # a row that now fits nowhere: m - bound
                moves.append(move)
                for k in first_pass:
                    # the first pass: ranks bound + [0, reach)
                    reach = k * chunk
                    first_pass[k] += (move < reach
                                      or (not found and m - bound <= reach))
    mv = np.array(moves) if moves else np.zeros(1)
    return {
        "workload": workload, "seed": seed, "steps": steps,
        "decisions_differ": mismatched,
        "rounds_per_step": float(np.mean(rounds_seen)),
        "pending_rows_per_round": float(np.mean(pend)),
        "rows_probed": listed, "rows_resumed": resumed,
        "resumed_share": resumed / max(listed, 1),
        "move_quantiles": {q: float(np.quantile(mv, q / 100))
                           for q in (50, 90, 95, 99, 100)},
        "move_zero_share": float((mv == 0).mean()),
        "first_pass_hit_share": {
            f"K={k}": first_pass[k] / max(resumed, 1) for k in first_pass},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--chunk", type=int, default=256)
    args = ap.parse_args(argv)
    t0 = time.monotonic()
    out = replay(args.workload, args.seed, args.steps, args.chunk)
    out["seconds"] = time.monotonic() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
