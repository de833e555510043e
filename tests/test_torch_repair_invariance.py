"""The two facts the card's repair kernel rests on, checked bit for bit.

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
from torch_placement_cases import FAMILIES  # noqa: E402

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
