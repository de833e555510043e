"""The three facts the card's repair kernel rests on, checked bit for bit.

1. A row that is no longer pending needs no probe: replacing every
   non-pending row's speculation with random values leaves `safe` and
   `commit` of `repair_commit_masks` unchanged, in the JAX package and in
   the port alike (flat prims on raw slots, and the pairwise form on
   clamped slots that the kernel evaluates).
2. An index outside a row's partition window never wins its probe: a
   probe of the window alone, with the forced choice completed by the
   lowest index outside the window, gives the same sel, found, fchoice and
   have_usable as the probe over all N invokers, also for a row whose
   window holds no healthy invoker.
3. A pending row may resume its walk: in an unpenalized launch, a probe of
   ranks at or above the rank the row's probe found the round before (no
   rank at all where nothing fit then) gives the same sel and found as the
   full probe, and the round before's col_conc is still the row's, unless
   the reset rule fires: a commit of the round before wrote a nonzero
   permit delta into the column of the row's (clamped) read slot, or
   raised an invoker's free memory. Rows outside the kernel's contract
   (0 <= home < m, 0 <= step_inv < m <= 2^17, gcd(step_inv, m) == 1)
   always take the full probe. Constructed cases show the rule must fire.

Inputs: the families of torch_placement_cases at B in {8, 32, 256}, with
the books and pending mask of rounds of a real repair run.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from openwhisk_tpu.ops import placement as J  # noqa: E402
from openwhisk_tpu_torch.ops import placement as T  # noqa: E402
from torch_placement_cases import (  # noqa: E402
    FAMILIES, RESUME_RULE_CASES, rule_case)

WIDTHS = (8, 32, 256)
#: rounds of a run that are checked: the first, the last and some between
MAX_ROUNDS = 6


def _setup(family, b, seed, use_penalty=False):
    rng = np.random.RandomState(seed)
    books, cols = FAMILIES[family](rng, b)
    n = books[0].shape[0]
    pen = (torch.from_numpy(rng.randint(0, 3, n).astype(np.int32))
           if use_penalty else None)
    return rng, books, T.request_batch_from_numpy(*cols, device="cpu"), pen


def _geometry(state, batch, pen):
    n, a = state.conc_free.shape
    big, in_part, rank, fkey_rot = T._probe_geometry(n, batch, pen)
    usable = in_part & state.health[None, :]
    fchoice, have_usable = T.forced_choice(usable, fkey_rot, big)
    slot_rl = batch.conc_slot.clamp(0, a - 1).long()
    return big, usable, rank, fchoice, have_usable, slot_rl


def _round_books(books, batch, pen):
    """(pending, books) as each round of the plain repair starts, at most
    MAX_ROUNDS of them spread over the run."""
    state = T.placement_state_from_numpy(*books, device="cpu")
    snaps = []

    def keep(pending):
        snaps.append((pending.clone(), T.PlacementState(
            state.free_mb.clone(), state.conc_free.T.clone().T,
            state.health.clone())))

    T.schedule_batch_repair(state, batch, pen, on_round=keep)
    pick = np.unique(np.linspace(0, len(snaps) - 1, MAX_ROUNDS).astype(int))
    return [snaps[k] for k in pick]


def _masks(sp, pending, batch, n, a):
    """(safe, commit) from the JAX package's rules and the port's two
    forms, as numpy; all three must agree."""
    b = pending.shape[0]
    kw = dict(pending=pending, placed=sp.placed, forced=sp.forced,
              sel=sp.sel, take_mem=sp.take_mem, use_conc=sp.use_conc,
              simple=batch.max_conc <= 1, need_mb=batch.need_mb,
              free_at_sel=sp.free_at_sel, col_conc=sp.col_conc, n=n,
              a_slots=a)
    flat = T.repair_commit_masks(T.flat_prims(b, "cpu"),
                                 conc_slot=batch.conc_slot, **kw)
    pair = T.repair_commit_masks(
        T.pairwise_prims(b, "cpu"), conc_slot=batch.conc_slot.clamp(0, a - 1),
        slot_ok=batch.conc_slot < a, **kw)
    jx = J.repair_commit_masks(
        J.flat_prims(b), conc_slot=jnp.asarray(batch.conc_slot.numpy()),
        **{k: jnp.asarray(v.numpy()) if torch.is_tensor(v) else v
           for k, v in kw.items()})
    out = [np.stack([x.numpy() for x in flat]),
           np.stack([x.numpy() for x in pair]),
           np.stack([np.asarray(x) for x in jx])]
    np.testing.assert_array_equal(out[0], out[1])
    np.testing.assert_array_equal(out[0], out[2])
    return out[0]


def _scramble(sp, pending, rng, n):
    """sp with every non-pending row's speculation replaced at random."""
    b = pending.shape[0]
    t = torch.from_numpy

    def rand_bool():
        return t(rng.rand(b) < 0.5)

    keep = pending
    return sp._replace(
        found=torch.where(keep, sp.found, rand_bool()),
        sel=torch.where(keep, sp.sel,
                        t(rng.randint(0, n, b).astype(np.int32))),
        placed=torch.where(keep, sp.placed, rand_bool()),
        forced=torch.where(keep, sp.forced, rand_bool()),
        use_conc=torch.where(keep, sp.use_conc, rand_bool()),
        take_mem=torch.where(keep, sp.take_mem, rand_bool()),
        col_conc=torch.where(keep, sp.col_conc, rand_bool()),
        free_at_sel=torch.where(keep, sp.free_at_sel, t(
            rng.randint(-4096, 4096, b).astype(np.int32))))


@pytest.mark.parametrize("b", WIDTHS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_settled_rows_speculation_never_reaches_commit(family, b):
    rng, books, batch, _ = _setup(family, b, seed=b)
    n, a = books[1].shape
    valid = batch.valid
    cases = _round_books(books, batch, None)
    # a random pending subset of the valid rows, on the first round's books
    cases.append((valid & torch.from_numpy(rng.rand(b) < 0.5), cases[0][1]))
    for pending, state in cases:
        big, usable, rank, fchoice, have_usable, slot_rl = _geometry(
            state, batch, None)
        sp = T.repair_speculate(state, batch, usable, rank, big, fchoice,
                                have_usable, slot_rl)
        want = _masks(sp, pending, batch, n, a)
        for _ in range(3):
            got = _masks(_scramble(sp, pending, rng, n), pending, batch, n, a)
            np.testing.assert_array_equal(want, got)


def _window(off, size, n):
    lo = min(max(off, 0), n)
    return lo, max(min(off + size, n), lo)


def _argmin(key, idx):
    """(smallest key, lowest index holding it); None for an empty window."""
    if key.numel() == 0:
        return None
    k = int(key.min())
    return k, int(idx[key == k].min())


def _windowed_probe(state, batch, pen, big):
    """The card kernel's probe in plain torch: each row's keys over its
    window only; the forced choice from the window plus (big, lowest index
    outside it). Returns (found, sel, fchoice, have_usable) per row."""
    n, a = state.conc_free.shape
    out = []
    for i in range(batch.valid.shape[0]):
        off, size = int(batch.offset[i]), int(batch.size[i])
        m = max(size, 1)
        lo, hi = _window(off, size, n)
        idx = torch.arange(lo, hi, dtype=torch.int32)
        local = idx - off
        health = state.health[lo:hi]
        slot = min(max(int(batch.conc_slot[i]), 0), a - 1)
        conc = state.conc_free[lo:hi, slot]
        eligible = health & ((conc > 0)
                             | (state.free_mb[lo:hi] >= batch.need_mb[i]))
        rank = T._mulmod(local - batch.home[i], batch.step_inv[i], m)
        if pen is not None:
            rank = rank + pen[lo:hi] * m
        best = _argmin(torch.where(eligible, rank, big), idx)
        fkey = torch.where(health, torch.remainder(local - batch.rand[i], m),
                           big)
        cands = [c for c in (_argmin(fkey, idx),
                             (big, 0) if lo > 0 else None,
                             (big, hi) if lo == 0 and hi < n else None)
                 if c is not None]
        fbest = min(cands)
        found = best is not None and best[0] < big
        out.append((found, best[1] if found else fbest[1], fbest[1],
                    fbest[0] < big))
    return [np.array(x) for x in zip(*out)]


def _dead_window(books, batch):
    """books with every invoker in the first valid row's window unhealthy,
    and that row's index."""
    n = books[0].shape[0]
    for i in np.nonzero(batch.valid.numpy())[0]:
        lo, hi = _window(int(batch.offset[i]), int(batch.size[i]), n)
        if hi > lo:
            health = books[2].copy()
            health[lo:hi] = False
            return (books[0], books[1], health), int(i)
    raise AssertionError("no valid row with a window")


@pytest.mark.parametrize("use_penalty", [False, True])
@pytest.mark.parametrize("b", WIDTHS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_windowed_probe_equals_full_probe(family, b, use_penalty):
    _, books, batch, pen = _setup(family, b, seed=100 + b, use_penalty=True)
    pen = pen if use_penalty else None
    dead_books, dead_row = _dead_window(books, batch)
    for which, bk in (("as given", books), ("dead window", dead_books)):
        for _, state in _round_books(bk, batch, pen):
            big, usable, rank, fchoice, have_usable, slot_rl = _geometry(
                state, batch, pen)
            sp = T.repair_speculate(state, batch, usable, rank, big, fchoice,
                                    have_usable, slot_rl)
            found, sel, wfchoice, whave = _windowed_probe(state, batch, pen,
                                                          big)
            np.testing.assert_array_equal(found, sp.found.numpy(), which)
            np.testing.assert_array_equal(sel, sp.sel.numpy(), which)
            np.testing.assert_array_equal(wfchoice, fchoice.numpy(), which)
            np.testing.assert_array_equal(whave, have_usable.numpy(), which)
            if which == "dead window":
                # every key of the row is the sentinel: argmin gives 0
                assert not whave[dead_row] and wfchoice[dead_row] == 0


def _resumable(batch):
    """Rows inside the repair kernel's resume contract (an unpenalized
    launch): 1 <= m <= 2^17, 0 <= home < m, 0 <= step_inv < m and
    gcd(step_inv, m) == 1, so rank is a bijection of the window."""
    size = batch.size.numpy().astype(np.int64)
    home = batch.home.numpy().astype(np.int64)
    sinv = batch.step_inv.numpy().astype(np.int64)
    return (batch.valid.numpy() & (size >= 1) & (size <= 1 << 17)
            & (home >= 0) & (home < size) & (sinv >= 0) & (sinv < size)
            & (np.gcd(sinv, np.maximum(size, 1)) == 1))


def _rounds(books, batch):
    """Every round of the plain repair: (pending, books as the round
    starts, its speculation, its commit mask)."""
    n, a = books[1].shape
    state = T.placement_state_from_numpy(*books, device="cpu")
    snaps = []

    def keep(pending):
        snaps.append((pending.clone(), T.PlacementState(
            state.free_mb.clone(), state.conc_free.T.clone().T,
            state.health.clone())))

    T.schedule_batch_repair(state, batch, None, on_round=keep)
    out = []
    for pending, st in snaps:
        g = _geometry(st, batch, None)
        sp = T.repair_speculate(st, batch, *g[1:3], g[0], *g[3:])
        _, commit = T.repair_commit_masks(
            T.flat_prims(batch.valid.shape[0], "cpu"), pending=pending,
            placed=sp.placed, forced=sp.forced, sel=sp.sel,
            take_mem=sp.take_mem, use_conc=sp.use_conc,
            simple=batch.max_conc <= 1, need_mb=batch.need_mb,
            conc_slot=batch.conc_slot, free_at_sel=sp.free_at_sel,
            col_conc=sp.col_conc, n=n, a_slots=a)
        out.append((pending, st, sp, commit))
    return out


def _reset_rule(batch, st, sp, commit, a):
    """bool[B]: the rows whose next probe may not resume after a round
    with speculation `sp` and commit mask `commit` on books `st`: its
    read slot's permit column took a nonzero delta, or any commit raised
    an invoker's free memory (a negative need, or int32 wrap)."""
    slot = batch.conc_slot.numpy()
    slot_ok = (slot >= 0) & (slot < a)
    slot_r = np.clip(slot, 0, a - 1)
    commit, tm = commit.numpy(), sp.take_mem.numpy()
    use = sp.use_conc.numpy()
    maxc, need = batch.max_conc.numpy(), batch.need_mb.numpy()
    delta = np.where(use, -1, np.where(tm & (maxc > 1), maxc - 1, 0))
    written = set(slot_r[commit & slot_ok & (delta != 0)].tolist())
    free_at = st.free_mb.numpy().astype(np.int64)[sp.sel.numpy()]
    raised = (commit & tm & ((need < 0) | (free_at - need < -2 ** 31))).any()
    return np.array([raised or int(s) in written for s in slot_r])


def _bounded_probe(st, batch, bound):
    """The resumed probe in plain torch: each row's keys over its window at
    ranks >= bound[i] only -> (found, sel) (sel of an unfound row:
    undefined, -1)."""
    g = _geometry(st, batch, None)
    big, usable, rank = g[0], g[1], g[2]
    slot_rl = g[5]
    conc_bn = st.conc_free.T.index_select(0, slot_rl)
    eligible = usable & ((conc_bn > 0)
                         | (st.free_mb[None, :] >= batch.need_mb[:, None]))
    eligible &= rank >= torch.from_numpy(bound)[:, None]
    key = torch.where(eligible, rank, big)
    sel = torch.argmin(key, 1)
    found = key.gather(1, sel[:, None])[:, 0] < big
    return found.numpy(), torch.where(found, sel, -1).numpy()


def _resume_bounds(batch, st, sp):
    """Each row's rank at the round's sel where found, else its m."""
    g = _geometry(st, batch, None)
    rank = g[2].gather(1, sp.sel.long()[:, None])[:, 0].numpy()
    m = np.maximum(batch.size.numpy(), 1)
    return np.where(sp.found.numpy(), rank, m).astype(np.int32)


def _check_resumes(books, batch):
    """Fact 3 on every round pair of a plain repair run; returns (rows
    resumed, rows reset)."""
    a = books[1].shape[1]
    ok = _resumable(batch)
    trace = _rounds(books, batch)
    resumed = reset_n = 0
    for (_, st0, sp0, commit0), (pend1, st1, sp1, _) in zip(trace,
                                                           trace[1:]):
        reset = _reset_rule(batch, st0, sp0, commit0, a)
        rows = pend1.numpy() & ok & ~reset
        reset_n += int((pend1.numpy() & ok & reset).sum())
        if not rows.any():
            continue
        found, sel = _bounded_probe(st1, batch, _resume_bounds(batch, st0,
                                                               sp0))
        f1, s1 = sp1.found.numpy(), sp1.sel.numpy()
        np.testing.assert_array_equal(found[rows], f1[rows])
        np.testing.assert_array_equal(sel[rows & f1], s1[rows & f1])
        np.testing.assert_array_equal(sp0.col_conc.numpy()[rows],
                                      sp1.col_conc.numpy()[rows])
        resumed += int(rows.sum())
    return resumed, reset_n


@pytest.mark.parametrize("b", WIDTHS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_resumed_probe_equals_full_probe(family, b):
    _, books, batch, _ = _setup(family, b, seed=200 + b)
    resumed, reset = _check_resumes(books, batch)
    if len(_rounds(books, batch)) > 1:
        assert resumed + reset > 0
        # container_open: every row opens containers on one slot, so every
        # commit resets every row left
        assert resumed > 0 or family == "container_open"


@pytest.mark.parametrize("case", sorted(RESUME_RULE_CASES))
def test_resume_reset_rule_must_fire(case):
    """Constructed cases: a forced container open on a shared slot, an
    out-of-range slot clamped onto a written one, a permit use. The rule
    fires for row 1 after round 0, and the resume without it is wrong."""
    n, a, free, cells, rows = RESUME_RULE_CASES[case]
    books, cols = rule_case(n, a, free, cells, rows)
    batch = T.request_batch_from_numpy(*cols, device="cpu")
    trace = _rounds(books, batch)
    assert len(trace) >= 2 and trace[1][0].tolist() == [False, True]
    (_, st0, sp0, commit0), (_, st1, sp1, _) = trace[0], trace[1]
    assert _resumable(batch).all()
    assert commit0.tolist() == [True, False]
    assert _reset_rule(batch, st0, sp0, commit0, a).tolist()[1]
    # the resume without the reset would be wrong for row 1
    found, sel = _bounded_probe(st1, batch, _resume_bounds(batch, st0, sp0))
    wrong_sel = (bool(found[1]) != bool(sp1.found[1])
                 or (found[1] and sel[1] != int(sp1.sel[1])))
    wrong_conc = bool(sp0.col_conc[1]) != bool(sp1.col_conc[1])
    if case == "permit_use":
        assert wrong_conc and not wrong_sel
    else:
        assert wrong_sel
    # with the rule, every resume of the run is exact
    _check_resumes(books, batch)
