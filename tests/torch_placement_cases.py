"""Seeded numpy inputs shared by the port's placement tests: books and
request batches of the JAX suite's fuzz families (no jax, no torch)."""
import math

import numpy as np

SLOTS = 16


def random_batch(n, b, rng, mem_choices=(128, 256, 512), slots=SLOTS,
                 maxc_choices=(1, 1, 4), valid_p=0.95, oob_p=0.0):
    """Nine numpy columns: random partition windows, coprime steps, shared
    conc slots (some past the slot axis with `oob_p`), container actions,
    invalid rows — the JAX suite's `_random_batch` families."""
    off = rng.randint(0, max(1, n // 2), b)
    size = np.maximum(1, rng.randint(1, n + 1, b) - off)
    size = np.minimum(size, n - off)
    home = rng.randint(0, 1 << 16, b) % size
    step_inv = np.zeros(b, np.int64)
    for i in range(b):
        s = int(size[i])
        st = rng.randint(1, s + 1)
        while math.gcd(int(st), s) != 1:
            st = rng.randint(1, s + 1)
        step_inv[i] = pow(int(st), -1, s) if s > 1 else 0
    need = rng.choice(mem_choices, b)
    slot = rng.randint(0, slots, b)
    slot = np.where(rng.rand(b) < oob_p, slots + rng.randint(0, 4, b), slot)
    maxc = rng.choice(maxc_choices, b)
    rand = rng.randint(0, 1 << 20, b) % np.maximum(size, 1)
    valid = rng.rand(b) < valid_p
    cols = [np.asarray(x, np.int32) for x in
            (off, size, home, step_inv, need, slot, maxc, rand)]
    return cols + [np.asarray(valid, bool)]


def random_books(n, rng, mem=1024, slots=SLOTS, unhealthy_p=0.2,
                 conc_p=0.3):
    free = np.full(n, mem, np.int32)
    health = ~(rng.rand(n) < unhealthy_p)
    if not health.any():
        health[rng.randint(0, n)] = True
    conc = np.where(rng.rand(n, slots) < conc_p,
                    rng.randint(1, 4, (n, slots)), 0).astype(np.int32)
    return free, conc, health


def _burst_cols(n, b, need, slot, maxc, home=None):
    full = lambda x: np.full(b, x, np.int32)  # noqa: E731
    home = np.arange(b, dtype=np.int32) % n if home is None else full(home)
    return [full(0), full(n), home, full(1), full(need), full(slot),
            full(maxc), np.arange(b, dtype=np.int32) % n, np.ones(b, bool)]


FAMILIES = {
    # each family takes a seeded rng and, optionally, the batch width b
    # memory pressure forces random-rotation placement (over-commit)
    "forced_overload": lambda rng, b=64: (
        (np.full(4, 256, np.int32), np.zeros((4, 8), np.int32),
         np.ones(4, bool)),
        random_batch(4, b, rng, mem_choices=(256, 512), slots=8)),
    # nothing usable: every row unplaced, books untouched
    "no_usable": lambda rng, b=16: (
        (np.full(8, 1024, np.int32), np.zeros((8, 8), np.int32),
         np.zeros(8, bool)),
        random_batch(8, b, rng, slots=8)),
    # one simple action bursting onto a tiny partition (memory cascade)
    "cascade": lambda rng, b=32: (
        (np.full(2, 1024, np.int32), np.zeros((2, 4), np.int32),
         np.ones(2, bool)),
        _burst_cols(2, b, 128, 1, 1, home=0)),
    # max_conc > 1 placements open permits that flip later choices
    "container_open": lambda rng, b=16: (
        (np.full(4, 256, np.int32), np.zeros((4, 4), np.int32),
         np.ones(4, bool)),
        _burst_cols(4, b, 256, 2, 4)),
    # slots past the slot axis: the read clamps, the write drops
    "oob_slot": lambda rng, b=32: (
        random_books(16, rng, slots=4, conc_p=0.5),
        random_batch(16, b, rng, slots=4, maxc_choices=(1, 4),
                     oob_p=0.5)),
}


def container_case(n, b, rng, slots=8):
    """Container actions (max_conc 2-16 for seven rows in ten) on a few
    shared slots over a fleet of n: the conflict rules hold most rows
    back, so the repair runs many rounds."""
    books = random_books(n, rng, mem=2048, slots=slots, conc_p=0.3)
    cols = random_batch(n, b, rng, slots=slots,
                        maxc_choices=(1, 1, 1, 2, 4, 4, 8, 8, 16, 16))
    return books, cols


def _window_row(cols, i, off, size, rng):
    """Row i of the nine batch columns gets the window [off, off + size),
    with a home, a coprime step and a rand inside it."""
    cols[0][i], cols[1][i] = off, size
    cols[2][i] = rng.randint(0, size)
    st = int(rng.randint(1, size + 1))
    while math.gcd(st, size) != 1:
        st = int(rng.randint(1, size + 1))
    cols[3][i] = pow(st, -1, size) if size > 1 else 0
    cols[7][i] = rng.randint(0, size)
    cols[8][i] = True


def wide_case(n, use_penalty, b=36):
    """A fleet padded past 2^17 (the scan kernel's wide instance) with
    partitions within 2^17 placed anywhere in it: windows across the
    register, shared-memory and streamed tiers' edges, the managed
    partition of a 140,000-invoker fleet (126,000), a dead window (row 6),
    the last invoker alone, rows whose ranks all tie (step_inv 0: the
    lowest index wins), rows that only a forced rotation places (rows
    10-12) and out-of-range slots. Returns (books, cols, penalty)."""
    rng = np.random.RandomState(n % 9973 + use_penalty)
    free, conc, health = random_books(n, rng, slots=4, unhealthy_p=0.1,
                                      conc_p=0.05)
    cols = random_batch(1 << 17, b, rng, slots=4, maxc_choices=(1, 1, 4),
                        oob_p=0.15)
    cols[0] += rng.randint(0, n - (1 << 17) + 1, b).astype(cols[0].dtype)
    edges = [2 * 16384, 16 * 8192, 16 * 16384, 55 * 16384, n - 16]
    for r, e in enumerate(edges):
        _window_row(cols, r, min(e - 9, n - 20), 20, rng)
    _window_row(cols, 5, 0, 126000, rng)
    _window_row(cols, 6, n // 3, 5, rng)
    _window_row(cols, 7, n - 1, 1, rng)
    for r in (8, 9):
        _window_row(cols, r, int(rng.randint(0, n - 4096)), 4096, rng)
        cols[3][r] = 0
    conc = conc.copy()
    for r in (10, 11, 12):
        _window_row(cols, r, int(rng.randint(0, n - 8)), 8, rng)
        cols[4][r] = 1 << 24
        conc[cols[0][r]:cols[0][r] + 8] = 0
    health = health.copy()
    health[[0, n - 1]] = True
    health[n // 3:n // 3 + 5] = False
    pen = rng.randint(0, 4, n).astype(np.int32) if use_penalty else None
    return (free, conc, health), cols, pen


def rule_case(n, a, free, cells, rows):
    """Books of n healthy invokers (`free` MB each, permit cells
    {(inv, slot): count}) and nine batch columns of `rows` (need, slot,
    max_conc, home, rand), each over the whole fleet with step 1."""
    conc = np.zeros((n, a), np.int32)
    for (inv, slot), v in cells.items():
        conc[inv, slot] = v
    books = (np.full(n, free, np.int32), conc, np.ones(n, bool))
    b = len(rows)
    need, slot, maxc, home, rand = (np.array(c, np.int32)
                                    for c in zip(*rows))
    z = np.zeros(b, np.int32)
    return books, [z, z + n, home, z + 1, need, slot, maxc, rand,
                   np.ones(b, bool)]


#: (n, a, free, cells, rows) where row 0's round-0 commit changes the
#: permit column row 1 reads, so the repair kernel must not resume row 1
RESUME_RULE_CASES = {
    # row 0 fits nowhere and is forced onto invoker 2, opening a container
    # there: row 1 (same slot) then fits invoker 2 through its permits
    "forced_container_open": (4, 4, 100, {}, [(256, 1, 4, 0, 2),
                                              (256, 1, 4, 0, 3)]),
    # row 0 opens a container on slot 3; row 1's slot 7 is past the slot
    # axis and reads slot 3 (clamped)
    "clamped_slot": (4, 4, 256, {}, [(256, 3, 4, 0, 0),
                                     (1024, 7, 1, 1, 2)]),
    # row 0 uses invoker 2's one permit: row 1 (same slot) then finds no
    # permit in its window any more
    "permit_use": (4, 2, 0, {(2, 0): 1}, [(256, 0, 4, 0, 0),
                                          (256, 0, 4, 0, 1)]),
}


def long_walk_case(gap=1500, rows=64, n=8192, size=6000, seed=3):
    """One hot action's `rows` rows (128 MB, max_conc 1) walking a window
    of `size` where only every `gap`-th rank from rank 10 on has room, for
    one row each: after round 0 each resumed probe's next fit lies `gap`
    ranks on, beyond its first pass. Returns (books, cols, idx of rank)."""
    rng = np.random.RandomState(seed)
    home = int(rng.randint(0, size))
    step = 7
    while math.gcd(step, size) != 1:
        step += 1
    at_rank = (home + np.arange(size) * step) % size
    free = np.zeros(n, np.int32)
    free[size:] = 4096
    free[at_rank[10::gap]] = 128
    conc = np.zeros((n, 4), np.int32)
    cols = [np.full(rows, x, np.int32) for x in
            (0, size, home, pow(step, -1, size), 128, 1, 1)]
    cols.append(rng.randint(0, size, rows).astype(np.int32))
    cols.append(np.ones(rows, bool))
    return (free, conc, np.ones(n, bool)), cols, at_rank
