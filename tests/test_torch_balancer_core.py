"""The port's BalancerCore against the JAX package's balancer arithmetic.

Host arithmetic (home hash, coprime steps, modular inverse, slot
allocator) must equal the JAX package's; a 40-step BalancerCore run on the
CPU with releases and health flips must place exactly as a reference loop
built from the JAX package's own row arithmetic and its packed fused step
under `_xla_pair("auto")`.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from openwhisk_tpu.controller.loadbalancer import tpu_balancer as JB  # noqa: E402
from openwhisk_tpu.models import sharding_policy as JS  # noqa: E402
from openwhisk_tpu.ops import placement as J  # noqa: E402
from openwhisk_tpu_torch.controller.loadbalancer import \
    tpu_balancer as TB  # noqa: E402
from openwhisk_tpu_torch.models import sharding_policy as TS  # noqa: E402
from openwhisk_tpu_torch.ops import placement as T  # noqa: E402
from openwhisk_tpu_torch.utils.ring_buffer import ColumnRing  # noqa: E402


@pytest.mark.parametrize("ns,action", [("guest", "hello"), ("a/b", "c/d/e"),
                                       ("", ""), ("ns9", "pkg/act9")])
def test_generate_hash_matches_jax(ns, action):
    assert TS.generate_hash(ns, action) == JS.generate_hash(ns, action)


@pytest.mark.parametrize("x", [1, 2, 10, 97, 900, 1000, 4096])
def test_pairwise_coprimes_and_inverse_match_jax(x):
    steps = TS.pairwise_coprimes(x)
    assert steps == JS.pairwise_coprimes(x)
    for s in steps:
        assert TB._mod_inverse(s, x) == JB._mod_inverse(s, x)
    assert TS.MIN_SLOT_MB == JS.MIN_SLOT_MB


def test_slot_allocator_sequence_matches_jax():
    """Acquire/release sequences past saturation (CRC32 overflow slots)
    return the same slots in both packages."""
    rng = np.random.RandomState(0)
    ta, ja = TB._SlotAllocator(8), JB._SlotAllocator(8)
    held = []
    for _ in range(400):
        if held and rng.rand() < 0.45:
            key, slot = held.pop(rng.randint(len(held)))
            ta.release(key, slot)
            ja.release(key, slot)
        else:
            key = f"ns/act{rng.randint(0, 14)}:256"
            s = ta.acquire(key)
            assert s == ja.acquire(key)
            held.append((key, s))
        assert ta.slots == ja.slots and ta.overflow == ja.overflow
        assert ta.free == ja.free


def test_bucket_matches_jax():
    for n in range(0, 300):
        for cap in (8, 64, 256):
            assert TB.BalancerCore._bucket(n, cap) == \
                JB.TpuBalancer._bucket(n, cap)


def test_placement_state_from_numpy_round_trips():
    rng = np.random.RandomState(1)
    free = rng.randint(-100, 1000, 64).astype(np.int32)
    conc = rng.randint(0, 5, (64, 16)).astype(np.int32)
    health = rng.rand(64) < 0.5
    st = T.placement_state_from_numpy(free, conc, health, "cpu")
    assert st.conc_free.shape == (64, 16)
    assert st.conc_free.T.is_contiguous()  # held as [A, N]
    np.testing.assert_array_equal(st.free_mb.numpy(), free)
    np.testing.assert_array_equal(st.conc_free.numpy(), conc)
    np.testing.assert_array_equal(st.health.numpy(), health)


def test_no_device_means_the_card(monkeypatch):
    """device=None is the card: without one it raises, never runs on the
    CPU silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TB.BalancerCore([1024] * 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_state(4, 1024)


def test_unknown_placement_kernel_raises():
    with pytest.raises(ValueError):
        TB.BalancerCore([1024] * 4, device="cpu", placement_kernel="bogus")


def test_column_ring_wraps_and_grows():
    ring = ColumnRing(3, 8)
    cols = [(i, i + 1, i + 2) for i in range(20)]
    for c in cols[:6]:
        ring.push(c)
    out = np.zeros((3, 4), np.int32)
    ring.pop_into(out, 4)
    np.testing.assert_array_equal(out.T, cols[:4])
    ring.push_block(np.array(cols[6:20]).T)  # wraps, then grows
    rest = np.zeros((2, 16), np.int32)
    ring.pop_into(rest, 16)
    np.testing.assert_array_equal(rest.T, [c[:2] for c in cols[4:20]])
    assert len(ring) == 0


class JaxReference:
    """A reference balancer loop built from the JAX package's own row
    arithmetic, slot allocator, bucket rule and packed fused step."""

    def __init__(self, mem, max_batch, action_slots):
        self.n = n = len(mem)
        self.max_batch = max_batch
        self.managed = max(int(0.9 * n), 1)
        self.blackbox = max(int(0.1 * n), 1)
        self.steps_m = JS.pairwise_coprimes(self.managed)
        self.steps_b = JS.pairwise_coprimes(self.blackbox)
        self.state = J.init_state(
            n, [max(m, JS.MIN_SLOT_MB) for m in mem],
            n_pad=max(64, JB._next_pow2(n)), action_slots=action_slots)
        self.slots = JB._SlotAllocator(action_slots)
        self.rand_counter = 0
        self.fn = J.make_fused_step_packed(*JB._xla_pair("auto")[1::-1])
        self.queued, self.releases, self.health = [], [], {}

    def build_row(self, ns, fqn, mem, maxc, blackbox):
        size = self.blackbox if blackbox else self.managed
        offset = self.n - self.blackbox if blackbox else 0
        h = JS.generate_hash(ns, fqn)
        steps = self.steps_b if blackbox else self.steps_m
        step_inv = JB._mod_inverse(steps[h % len(steps)], size)
        self.rand_counter += 1
        key = f"{fqn}:{mem}"
        return (offset, size, h % size, step_inv, mem,
                self.slots.acquire(key), maxc,
                (h ^ (self.rand_counter * 2654435761)) % max(size, 1),
                1), key

    def step(self):
        bucket = JB.TpuBalancer._bucket
        batch, self.queued = (self.queued[:self.max_batch],
                              self.queued[self.max_batch:])
        b = len(batch)
        rel, self.releases = (self.releases[:self.max_batch],
                              self.releases[self.max_batch:])
        bp = max(bucket(b, self.max_batch),
                 bucket(len(rel), self.max_batch) if rel else 8)
        req = np.zeros((9, bp), np.int32)
        req[1, b:] = 1
        req[6, b:] = 1
        if b:
            req[:, :b] = np.array([r for r, _ in batch], np.int32).T
        rel_np = np.zeros((5, bp), np.int32)
        rel_np[3] = 1
        if rel:
            rel_np[:4, :len(rel)] = np.array([r[:4] for r in rel]).T
            rel_np[4, :len(rel)] = 1
        for r in rel:
            self.slots.release(r[4], r[1])
        take = list(self.health.items())[:64]
        for k, _ in take:
            del self.health[k]
        hp = np.zeros((3, 64), np.int32)
        if take:
            pad = 64 - len(take)
            hp[0] = [k for k, _ in take] + [take[-1][0]] * pad
            hp[1] = [int(v) for _, v in take] + [int(take[-1][1])] * pad
            hp[2] = 1
        buf = np.concatenate([rel_np.ravel(), hp.ravel(), req.ravel()])
        self.state, out = self.fn(self.state, jnp.asarray(buf), bp, 64, bp)
        chosen, forced, _, rounds = J.unpack_step_output(np.asarray(out))
        for (r, key), inv in zip(batch, chosen[:b]):
            if inv < 0:
                self.slots.release(key, r[5])
        return chosen[:b], forced[:b], rounds, req[:, :b], \
            [k for _, k in batch]


def _drive(core, seed, n_steps, n_inv):
    """A seeded run: 1-64 rows a step over 24 actions (some blackbox, some
    max_conc > 1), completions 1-3 steps later, health flips every 5 steps.
    `core` is a BalancerCore or a JaxReference."""
    rng = np.random.RandomState(seed)
    mem = rng.choice([128, 256, 512], 24)
    maxc = np.where(rng.rand(24) < 0.3, rng.randint(2, 5, 24), 1)
    bb = rng.rand(24) < 0.2
    due, log = {}, []
    is_ref = isinstance(core, JaxReference)
    for step in range(n_steps):
        for c in due.pop(step, []):
            if is_ref:
                core.releases.append(c)
            else:
                core.complete(*c)
        if step % 5 == 4:
            idx = int(rng.randint(0, n_inv))
            usable = bool(rng.rand() < 0.5)
            if is_ref:
                core.health[idx] = usable
            else:
                core.set_health(idx, usable)
        acts = rng.randint(0, 24, int(rng.randint(1, 65)))
        rows = [core.build_row(f"ns{a % 3}", f"ns{a % 3}/act{a}",
                               int(mem[a]), int(maxc[a]), bool(bb[a]))
                for a in acts]
        if is_ref:
            core.queued.extend(rows)
            chosen, forced, rounds, req, keys = core.step()
        else:
            core.submit(rows)
            res = core.step()
            chosen, forced, rounds, req, keys = res[0], res[1], res[2], \
                res[4], res[5]
        log.append((np.asarray(chosen).copy(), np.asarray(forced).copy(),
                    rounds))
        delays = rng.randint(1, 4, len(chosen))
        for k, inv in enumerate(chosen):
            if inv >= 0:
                due.setdefault(step + int(delays[k]), []).append(
                    (int(inv), int(req[5, k]), int(req[4, k]),
                     int(req[6, k]), keys[k]))
    return log


def test_forty_steps_match_jax_reference_loop():
    n_inv, max_batch, slots = 40, 64, 32
    mem = [1024] * n_inv
    core = TB.BalancerCore(mem, device="cpu", max_batch=max_batch,
                           action_slots=slots)
    ref = JaxReference(mem, max_batch, slots)
    got = _drive(core, 3, 40, n_inv)
    want = _drive(ref, 3, 40, n_inv)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g[0], w[0], err_msg=f"step {k}")
        np.testing.assert_array_equal(g[1], w[1], err_msg=f"step {k}")
        assert g[2] == w[2], f"step {k} rounds"
    free, conc_an, health = core.books()
    np.testing.assert_array_equal(free, np.asarray(ref.state.free_mb))
    np.testing.assert_array_equal(conc_an.T, np.asarray(ref.state.conc_free))
    np.testing.assert_array_equal(health, np.asarray(ref.state.health))
    assert core._slots.slots == ref.slots.slots
    # the run exercised both schedules, the repair loop and over-commit
    assert any(w[2] > 0 for w in want) and any(w[2] == 0 for w in want)
    assert core.counters["forced"] > 0
    assert core.counters["placed"] > 0


def test_idle_step_folds_releases_and_health():
    core = TB.BalancerCore([1024] * 8, device="cpu", max_batch=16,
                           action_slots=8)
    row, key = core.build_row("ns", "ns/a", 256, 1, False)
    core.submit([(row, key)])
    res = core.step()
    inv = int(res.chosen[0])
    assert core.books()[0][inv] == 1024 - 256
    core.complete(inv, row[5], 256, 1, key)
    core.set_health(3, False)
    empty = core.step()
    assert len(empty.chosen) == 0
    free, _, health = core.books()
    assert free[inv] == 1024 and not health[3]
    assert core._slots.slots == {}
