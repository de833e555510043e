"""The card's scan kernel, decomposed as it runs, checked bit for bit.

`csrc/placement_scan.cu` spreads each request's probe over one cluster of
C blocks x 1,024 threads: thread t owns the invoker columns t + k * C * 1,024
for the whole launch and keeps their free memory, health and penalty in
registers; each thread prefetches its columns' conc values D requests
ahead, and the owner of a commit patches the values it already holds for
later requests on the same (clamped) slot; the packed (key, index) minima
merge per warp, per block and across the cluster; free is written back at
the end. `emulate_scan` below is that decomposition in numpy, and every
test holds it against the JAX package's `schedule_batch`: chosen, forced,
free and conc.

Inputs: the families of torch_placement_cases, fleets of 64 to 65,536
invokers with windows that straddle block edges, one-column and dead
windows, same-slot runs longer than the prefetch depth, and out-of-range
slots, with and without the penalty, at C in {1, 8, 16} and D in {1, 4}.
"""
import math
from functools import lru_cache

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from openwhisk_tpu.ops import placement as J  # noqa: E402
from torch_placement_cases import (  # noqa: E402
    FAMILIES, random_batch, random_books)

THREADS = 1024
CLUSTERS = (1, 8, 16)
DEPTHS = (1, 4)
NO_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)


def _mulmod(a, b, m):
    """The JAX package's split (a % m) * b % m, b = hi * 512 + lo."""
    a = np.mod(a, m)
    hi = b // 512
    lo = b - hi * 512
    t = np.mod(a * hi, m)
    t = np.mod(t * 512, m)
    return np.mod(t + a * lo, m)


def _pack(key, idx):
    """(key << 32 | idx) as uint64, the key offset so that unsigned order
    is signed int32 order."""
    k = (key.astype(np.int64).astype(np.int32).view(np.uint32)
         ^ np.uint32(0x80000000)).astype(np.uint64)
    return (k << np.uint64(32)) | idx.astype(np.uint64)


def _key_of(p):
    return int(np.uint32((int(p) >> 32) ^ 0x80000000).view(np.int32))


def _window(off, size, n):
    lo = min(max(int(off), 0), n)
    return lo, min(max(int(off) + int(size), lo), n)


def _cluster_min(per_thread, clusters):
    """Per-thread minima merged as the kernel merges them: each warp's
    shuffles, each block's atomicMin, then every warp's min over the
    blocks' partials."""
    warps = per_thread.reshape(clusters * THREADS // 32, 32).min(axis=1)
    blocks = warps.reshape(clusters, THREADS // 32).min(axis=1)
    return blocks.min()


def emulate_scan(books, cols, penalty, clusters, depth, seed=0):
    """The kernel's decomposition of the scan in numpy. books = (free
    int32[N], conc int32[N, A], health bool[N]); returns (free, conc [N, A],
    chosen, forced)."""
    free, conc_na, health = books
    n, a = conc_na.shape
    conc = np.ascontiguousarray(conc_na.T).astype(np.int64)  # device [A, N]
    off, size, home, step_inv, need, slot_raw, maxc, rnd, valid = [
        np.asarray(c).astype(np.int64) for c in cols]
    b = valid.shape[0]
    nthreads = clusters * THREADS
    kk = -(-n // nthreads)
    col = np.arange(kk * nthreads).reshape(kk, nthreads)  # column of (k, t)
    live = col < n
    at = np.where(live, col, 0)
    # the owners' registers, for the whole launch
    fr = np.where(live, free[at], 0).astype(np.int64)
    hl = live & np.asarray(health)[at]
    pen = (None if penalty is None
           else np.where(live, np.asarray(penalty)[at], 0).astype(np.int64))
    dirty = np.zeros_like(live)
    big = (1 << 30) if penalty is not None else n + 2
    rng = np.random.RandomState(seed)
    ring = [None] * depth

    def fetch(j):
        # anything a request cannot use is poison: it must never be read
        vals = rng.randint(-5, 1 << 20, col.shape).astype(np.int64)
        if valid[j]:
            lo, hi = _window(off[j], size[j], n)
            s = min(max(int(slot_raw[j]), 0), a - 1)
            mask = hl & (col >= lo) & (col < hi)
            vals[mask] = conc[s, col[mask]]
        ring[j % depth] = vals

    for j in range(min(depth, b)):
        fetch(j)
    chosen = np.full(b, -1, np.int32)
    forced = np.zeros(b, bool)
    for i in range(b):
        buf = ring[i % depth]
        slot_ok = 0 <= slot_raw[i] < a
        slot = min(max(int(slot_raw[i]), 0), a - 1)
        lo, hi = _window(off[i], size[i], n)
        found = have_usable = False
        sel = 0
        if valid[i] and lo < hi:
            m = max(int(size[i]), 1)
            usable = hl & (col >= lo) & (col < hi)
            local = col - off[i]
            fkey = np.mod(local - rnd[i], m)
            eligible = usable & ((buf > 0) | (fr >= need[i]))
            key = _mulmod(local - home[i], step_inv[i], m)
            if pen is not None:
                key = (key + pen * m).astype(np.int32)
            best = np.where(eligible, _pack(key, col), NO_KEY).min(axis=0)
            fbest = np.where(usable, _pack(fkey, col), NO_KEY).min(axis=0)
            rb = _cluster_min(best, clusters)
            rf = _cluster_min(fbest, clusters)
            found = _key_of(rb) < big
            have_usable = _key_of(rf) < big
            sel = int(rb if found else rf) & 0xFFFFFFFF
        placed = found or have_usable
        if placed:
            k, t = divmod(sel, nthreads)  # the owner of sel
            cell = int(buf[k, t])
            use_conc = cell > 0
            if not use_conc:
                fr[k, t] -= need[i]
                dirty[k, t] = True
            delta = -1 if use_conc else (int(maxc[i]) - 1 if maxc[i] > 1
                                         else 0)
            if slot_ok and delta:
                conc[slot, sel] = cell + delta
                for e in range(1, depth):
                    j = i + e
                    if j < b and min(max(int(slot_raw[j]), 0), a - 1) == slot:
                        ring[j % depth][k, t] += delta
        chosen[i] = sel if placed else -1
        forced[i] = (not found) and have_usable
        if i + depth < b:
            fetch(i + depth)
    out_free = np.array(free, np.int64)
    out_free[col[dirty]] = fr[dirty]
    return (out_free.astype(np.int32), conc.T.astype(np.int32), chosen,
            forced)


def _jax_scan(books, cols, penalty):
    free, conc, health = books
    st = J.PlacementState(jnp.asarray(free), jnp.asarray(conc),
                          jnp.asarray(health))
    jb = J.RequestBatch(*[jnp.asarray(c) for c in cols])
    out, chosen, forced = J.schedule_batch(
        st, jb, None if penalty is None else jnp.asarray(penalty))
    return (np.asarray(out.free_mb), np.asarray(out.conc_free),
            np.asarray(chosen), np.asarray(forced))


def _check(books, cols, penalty, clusters, depth, want=None):
    want = _jax_scan(books, cols, penalty) if want is None else want
    got = emulate_scan(books, cols, penalty, clusters, depth)
    for name, w, g in zip(("free", "conc", "chosen", "forced"), want, got):
        np.testing.assert_array_equal(g, w, name)
    return got


# ------------------------------------------------------------- families
@lru_cache(maxsize=None)
def _family(family, use_penalty):
    rng = np.random.RandomState(42)
    books, cols = FAMILIES[family](rng)
    n = books[0].shape[0]
    pen = rng.randint(0, 3, n).astype(np.int32) if use_penalty else None
    return books, cols, pen, _jax_scan(books, cols, pen)


@pytest.mark.parametrize("use_penalty", [False, True])
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("clusters", CLUSTERS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_families_match_jax(family, clusters, depth, use_penalty):
    books, cols, pen, want = _family(family, use_penalty)
    got = _check(books, cols, pen, clusters, depth, want)
    if family == "no_usable":
        assert (got[2] == -1).all() and not got[3].any()


# ---------------------------------------------------- fleets and windows
def _coprime_inv(size, rng):
    st = int(rng.randint(1, size + 1))
    while math.gcd(st, size) != 1:
        st = int(rng.randint(1, size + 1))
    return pow(st, -1, size) if size > 1 else 0


def _set_window(cols, i, off, size, rng):
    """Row i of the nine batch columns gets the window [off, off + size)."""
    cols[0][i], cols[1][i] = off, size
    cols[2][i] = rng.randint(0, size)
    cols[3][i] = _coprime_inv(size, rng)
    cols[7][i] = rng.randint(0, size)
    cols[8][i] = True


#: edges of blocks (1,024 columns) and of the cluster's thread ranges
#: (8,192 and 16,384 columns at C = 8 and 16) that windows straddle
EDGES = (1024, 2048, 8192, 16384, 32768)


@lru_cache(maxsize=None)
def _fleet(n, use_penalty):
    rng = np.random.RandomState(n)
    books = random_books(n, rng, unhealthy_p=0.1)
    cols = random_batch(n, 40, rng, oob_p=0.15)
    row = 0
    for edge in EDGES:
        if edge + 9 <= n:
            _set_window(cols, row, edge - 7, 16, rng)
            _set_window(cols, row + 1, edge - 1, 2, rng)
            row += 2
    _set_window(cols, row, n - 1, 1, rng)          # the last invoker alone
    _set_window(cols, row + 1, 0, 1, rng)          # the first alone
    _set_window(cols, row + 2, n // 3, 5, rng)     # nothing healthy in it
    health = books[2].copy()
    health[[0, n - 1]] = True
    health[n // 3:n // 3 + 5] = False
    books = (books[0], books[1], health)
    pen = rng.randint(0, 4, n).astype(np.int32) if use_penalty else None
    return books, cols, pen, row + 2, _jax_scan(books, cols, pen)


@pytest.mark.parametrize("use_penalty", [False, True])
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("clusters", CLUSTERS)
@pytest.mark.parametrize("n", [64, 1000, 4133, 16384, 65536])
def test_fleets_and_windows_match_jax(n, clusters, depth, use_penalty):
    books, cols, pen, dead_row, want = _fleet(n, use_penalty)
    got = _check(books, cols, pen, clusters, depth, want)
    assert got[2][dead_row] == -1 and not got[3][dead_row]


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("clusters", CLUSTERS)
def test_dead_windows_leave_books_untouched(clusters, depth):
    """No row has a usable invoker: every row gets -1, nothing is forced,
    and the books come back as they went in."""
    rng = np.random.RandomState(clusters * 10 + depth)
    n = 3000
    books = random_books(n, rng, unhealthy_p=0.0)
    cols = random_batch(n, 24, rng)
    health = books[2].copy()
    for i in range(24):
        lo, hi = _window(cols[0][i], cols[1][i], n)
        health[lo:hi] = False
    books = (books[0], books[1], health)
    got = _check(books, cols, None, clusters, depth)
    assert (got[2] == -1).all() and not got[3].any()
    np.testing.assert_array_equal(got[0], books[0])
    np.testing.assert_array_equal(got[1], books[1])


# ------------------------------------------- same-slot runs and bad slots
def _burst_batch(n, b, run, rng):
    """Runs of `run` same-slot container-opening rows (max_conc 4) on
    windows of 1-3 invokers across a block edge, alternating between two
    slots, so each commit changes what the next rows of its run read."""
    cols = random_batch(n, b, rng, slots=4, maxc_choices=(4,))
    for start in range(0, b, run):
        width = int(rng.randint(1, 4))
        off = 1023 - int(rng.randint(0, width))
        slot = (start // run) % 2
        for i in range(start, min(b, start + run)):
            _set_window(cols, i, off, width, rng)
            cols[5][i] = slot
            cols[4][i] = 512
    return cols


@lru_cache(maxsize=None)
def _bursts(run, use_penalty):
    rng = np.random.RandomState(run)
    n = 2048
    free, conc, health = random_books(n, rng, slots=4, conc_p=0.0)
    free = np.full(n, 1024, np.int32)  # two openings fill an invoker
    books = (free, conc, np.ones(n, bool))
    cols = _burst_batch(n, 48, run, rng)
    pen = rng.randint(0, 3, n).astype(np.int32) if use_penalty else None
    return books, cols, pen, _jax_scan(books, cols, pen)


@pytest.mark.parametrize("use_penalty", [False, True])
@pytest.mark.parametrize("run", [3, 6, 11])
@pytest.mark.parametrize("clusters", [1, 16])
@pytest.mark.parametrize("depth", DEPTHS)
def test_same_slot_runs_longer_than_depth(depth, clusters, run,
                                          use_penalty):
    books, cols, pen, want = _bursts(run, use_penalty)
    got = _check(books, cols, pen, clusters, depth, want)
    # the runs did open containers and take their permits
    assert (got[1] != books[1]).any()
    assert (got[2] >= 0).all()


@lru_cache(maxsize=None)
def _oob(use_penalty):
    """Rows on one invoker whose slot is past the slot axis (read clamped
    to the last row, write dropped), then rows on that last row in range,
    then past it again."""
    rng = np.random.RandomState(7)
    n, a = 1500, 4
    free = np.full(n, 4096, np.int32)
    conc = np.zeros((n, a), np.int32)
    conc[1024, a - 1] = 1
    books = (free, conc, np.ones(n, bool))
    cols = random_batch(n, 12, rng, slots=a, maxc_choices=(3,))
    for i in range(12):
        _set_window(cols, i, 1024, 1, rng)
    cols[5][:] = [a + 1, a - 1, a + 3, a - 1, a - 1, a + 1, a - 1, a + 2,
                  a - 1, a - 1, a - 1, a]
    pen = rng.randint(0, 3, n).astype(np.int32) if use_penalty else None
    return books, cols, pen, _jax_scan(books, cols, pen)


@pytest.mark.parametrize("use_penalty", [False, True])
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("clusters", CLUSTERS)
def test_out_of_range_slots_read_clamped_write_dropped(clusters, depth,
                                                       use_penalty):
    books, cols, pen, want = _oob(use_penalty)
    got = _check(books, cols, pen, clusters, depth, want)
    # only the last slot's row at the one invoker ever changed
    changed = np.argwhere(got[1] != books[1])
    assert changed.size and (changed == [1024, 3]).all(axis=1).all()
