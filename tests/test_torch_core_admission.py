"""`BalancerCore` with rate admission (`rate_limit_per_minute`), on the CPU.

It is held against two references: a loop over the JAX package's own row
arithmetic, bucket rule, token buckets and fused admit step, and the
benchmark's plain NumPy reference (`owbench/reference/throttled.py`)
driven through the benchmark's own step loop. Decisions, throttled flags,
rounds, rows, books and the slot allocator are exactly equal. Tokens agree
with the JAX package's within `TOKEN_ULPS` (`test_torch_throttle.py` says
why) and with the plain reference's exactly: it repeats the port's float32
arithmetic.
"""
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from openwhisk_tpu.controller.loadbalancer import \
    tpu_balancer as JB  # noqa: E402
from openwhisk_tpu.models import sharding_policy as JS  # noqa: E402
from openwhisk_tpu.ops import placement as J  # noqa: E402
from openwhisk_tpu.ops import throttle as JT  # noqa: E402
from openwhisk_tpu_torch.controller.loadbalancer import \
    tpu_balancer as TB  # noqa: E402
from owbench.lib.check import compare_books, compare_steps  # noqa: E402
from owbench.lib.drive import Loop, StepInputs  # noqa: E402
from owbench.lib.traffic import Traffic  # noqa: E402
from owbench.reference.throttled import \
    Reference as Throttled  # noqa: E402
from owbench.tests.conftest import TINY_CONFIG, TINY_MIX  # noqa: E402
from test_torch_throttle import TOKEN_ULPS  # noqa: E402

#: the benchmark's 64k fleet's traffic clock: steps a traffic second
STEPS_PER_S = 139.645


def _bucket_rule(cls):
    """`cls._ns_slot` (a balancer's bucket rule) over a registry of its
    own, without building the balancer."""
    holder = type("Holder", (), {"_ns_slots": None,
                                 "RATE_NS_BUCKETS": cls.RATE_NS_BUCKETS,
                                 "RATE_NS_SHARED_BUCKETS":
                                     cls.RATE_NS_SHARED_BUCKETS})()
    holder._ns_slots = {}
    return lambda ns: cls._ns_slot(holder, ns)


class JaxAdmitReference:
    """A balancer loop of the JAX package's row arithmetic, slot allocator,
    bucket rule, token buckets and packed fused admit step under
    `_xla_pair("auto")`, with a clock."""

    def __init__(self, mem, max_batch, action_slots, rate):
        self.n = n = len(mem)
        self.max_batch = max_batch
        self.managed = max(int(0.9 * n), 1)
        self.blackbox = max(int(0.1 * n), 1)
        self.steps_m = JS.pairwise_coprimes(self.managed)
        self.steps_b = JS.pairwise_coprimes(self.blackbox)
        self.state = J.init_state(
            n, [max(m, JS.MIN_SLOT_MB) for m in mem],
            n_pad=max(64, JB._next_pow2(n)), action_slots=action_slots)
        self.buckets = JT.init_buckets(JB.TpuBalancer.RATE_NS_BUCKETS, rate)
        self.ns_slot = _bucket_rule(JB.TpuBalancer)
        self.slots = JB._SlotAllocator(action_slots)
        self.rand_counter = 0
        self.fn = J.make_fused_admit_step_packed(*JB._xla_pair("auto")[1::-1])
        self.queued, self.releases, self.health = [], [], {}
        self.now = np.float32(0.0)

    def set_clock(self, now_s):
        self.now = np.float32(now_s)

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
                (h ^ (self.rand_counter * 2654435761)) % max(size, 1), 1,
                self.ns_slot(ns)), key

    def submit(self, rows):
        self.queued.extend(rows)

    def complete(self, *c):
        self.releases.append(c)

    def set_health(self, idx, usable):
        self.health[idx] = usable

    def step(self):
        bucket = JB.TpuBalancer._bucket
        batch, self.queued = (self.queued[:self.max_batch],
                              self.queued[self.max_batch:])
        b = len(batch)
        rel, self.releases = (self.releases[:self.max_batch],
                              self.releases[self.max_batch:])
        bp = max(bucket(b, self.max_batch),
                 bucket(len(rel), self.max_batch) if rel else 8)
        req = np.zeros((10, bp), np.int32)
        req[1, b:] = 1
        req[6, b:] = 1
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
        (self.state, self.buckets), out = self.fn(
            (self.state, self.buckets), jnp.asarray(buf), self.now, bp, 64,
            bp)
        chosen, forced, throttled, rounds = J.unpack_step_output(
            np.asarray(out))
        for (r, key), inv in zip(batch, chosen[:b]):
            if inv < 0:
                self.slots.release(key, r[5])
        return (chosen[:b], forced[:b], throttled[:b], rounds, req[:, :b],
                [k for _, k in batch])


def _drive(core, seed, n_steps, n_inv, dt):
    """A seeded run on a fractional clock (step k at k * dt seconds): 1-64
    rows a step over 24 actions in 4 namespaces of skewed traffic,
    completions 1-3 steps later, health flips every 5 steps."""
    rng = np.random.RandomState(seed)
    mem = rng.choice([128, 256, 512], 24)
    maxc = np.where(rng.rand(24) < 0.3, rng.randint(2, 5, 24), 1)
    bb = rng.rand(24) < 0.2
    p = 0.8 ** np.arange(24)
    due, log = {}, []
    for step in range(n_steps):
        core.set_clock(step * dt)
        for c in due.pop(step, []):
            core.complete(*c)
        if step % 5 == 4:
            core.set_health(int(rng.randint(0, n_inv)), bool(rng.rand() < .5))
        acts = rng.choice(24, int(rng.randint(1, 65)), p=p / p.sum())
        core.submit([core.build_row(f"ns{a % 4}", f"ns{a % 4}/act{a}",
                                    int(mem[a]), int(maxc[a]), bool(bb[a]))
                     for a in acts])
        res = core.step()
        if isinstance(core, JaxAdmitReference):
            chosen, forced, throttled, rounds, req, keys = res
        else:
            chosen, forced, rounds, req, keys = (res.chosen, res.forced,
                                                 res.rounds, res.rows,
                                                 res.slot_keys)
            throttled = res.throttled
        log.append((chosen.copy(), forced.copy(), throttled.copy(), rounds,
                    req.copy()))
        delays = rng.randint(1, 4, len(chosen))
        for k, inv in enumerate(chosen):
            if inv >= 0:
                due.setdefault(step + int(delays[k]), []).append(
                    (int(inv), int(req[5, k]), int(req[4, k]),
                     int(req[6, k]), keys[k]))
    return log


def test_forty_admitted_steps_match_the_jax_admit_loop():
    n_inv, max_batch, slots, rate = 40, 64, 32, 240
    mem = [1024] * n_inv
    core = TB.BalancerCore(mem, device="cpu", max_batch=max_batch,
                           action_slots=slots, rate_limit_per_minute=rate)
    ref = JaxAdmitReference(mem, max_batch, slots, rate)
    got = _drive(core, 5, 40, n_inv, 0.377)
    want = _drive(ref, 5, 40, n_inv, 0.377)
    for k, (g, w) in enumerate(zip(got, want)):
        for name, x, y in zip(("chosen", "forced", "throttled"), g, w):
            np.testing.assert_array_equal(x, y, err_msg=f"step {k} {name}")
        assert g[3] == w[3], f"step {k} rounds"
        np.testing.assert_array_equal(g[4], w[4], err_msg=f"step {k} rows")
    free, conc_an, health = core.books()
    np.testing.assert_array_equal(free, np.asarray(ref.state.free_mb))
    np.testing.assert_array_equal(conc_an.T, np.asarray(ref.state.conc_free))
    np.testing.assert_array_equal(health, np.asarray(ref.state.health))
    assert core._slots.slots == ref.slots.slots
    np.testing.assert_array_max_ulp(np.asarray(ref.buckets.tokens),
                                    core._buckets.tokens.numpy(),
                                    maxulp=TOKEN_ULPS)
    assert float(ref.buckets.last_refill) == float(core._buckets.last_refill)
    throttled = sum(int(g[2].sum()) for g in got)
    assert throttled == core.counters["throttled"] > 0
    assert core.counters["placed"] > 0
    assert any(g[3] > 0 for g in got)  # the repair schedule ran


def _tiny_loops(rate, seed, steps):
    """The port's core on the CPU and the plain reference, each driven by
    the benchmark's step loop over the same seeded tiny traffic on the
    64k cell's clock."""
    traffic = Traffic(TINY_CONFIG, TINY_MIX, seed)
    kw = {k: TINY_CONFIG[k] for k in ("cluster_size", "managed_fraction",
                                      "blackbox_fraction", "max_batch",
                                      "action_slots")}
    fleet = [TINY_CONFIG["invoker_memory_mb"]] * TINY_CONFIG["invokers"]
    inputs = StepInputs(traffic)
    program = Loop(TB.BalancerCore(fleet, device="cpu",
                                   rate_limit_per_minute=rate, **kw),
                   inputs, traffic.table, STEPS_PER_S)
    program.run(steps)
    reference = Loop(Throttled(fleet, rate_limit_per_minute=rate, **kw),
                     inputs.replay(), traffic.table, STEPS_PER_S)
    reference.run(steps)
    return program, reference


@pytest.mark.parametrize("rate, seed", [(600, 2**31 + 5), (1500, 7)])
def test_core_matches_the_benchmarks_plain_reference(rate, seed):
    program, reference = _tiny_loops(rate, seed, 300)
    core, ref = program.core, reference.core
    assert compare_steps(program.results, reference.results) == {
        "rows_differ": 0, "decisions_differ": 0}
    assert compare_books(core.books(), ref.books()) == 0
    for (pc, _, pr, _, pt), (rc, _, rr, _, rt) in zip(program.results,
                                                      reference.results):
        assert pr.shape[0] == rr.shape[0] == 10
        np.testing.assert_array_equal(pt, rt)
        assert not (pt & (pc >= 0)).any()  # a throttled row is unplaced
    np.testing.assert_array_equal(core._buckets.tokens.numpy(), ref.tokens)
    flags = sum(int(r[4].sum()) for r in program.results)
    assert core.counters["throttled"] == flags > 0
    assert core.counters["placed"] > 0


def test_throttled_rows_book_nothing_and_free_their_slots():
    """A 60-token bucket against 100 rows of one namespace: the first 60
    in batch order place, the rest come back throttled, unplaced; a pool
    whose every row was throttled gives its slot back; the books hold
    exactly the placed rows; the plain reference agrees."""
    fleet = [2048] * 64
    kw = dict(max_batch=128, action_slots=16, rate_limit_per_minute=60)
    core = TB.BalancerCore(fleet, device="cpu", **kw)
    ref = Throttled(fleet, managed_fraction=0.9, blackbox_fraction=0.1,
                    **kw)
    calls = ([("a", "a/x", 256)] * 60 + [("a", "a/late", 512)] * 40
             + [("b", "b/y", 128)] * 10)
    for side in (core, ref):
        side.set_clock(0.0)
        side.submit([side.build_row(ns, fqn, m, 1, False)
                     for ns, fqn, m in calls])
    res, want = core.step(), ref.step()
    assert res.throttled.tolist() == [False] * 60 + [True] * 40 + [False] * 10
    np.testing.assert_array_equal(res.throttled, want.throttled)
    np.testing.assert_array_equal(res.chosen, want.chosen)
    assert (res.chosen[60:100] == -1).all() and (res.chosen[:60] >= 0).all()
    assert not res.forced.any()
    assert core.books()[0][:64].sum() == 64 * 2048 - 60 * 256 - 10 * 128
    assert compare_books(core.books(), ref.books()) == 0
    assert set(core._slots.slots) == {"a/x:256", "b/y:128"}
    assert set(ref._slot_of) == set(core._slots.slots)
    assert core.counters["throttled"] == 40
    assert core.counters["placed"] == 70


def test_bucket_rule_dedicates_960_buckets_then_shares_the_tail():
    """1,000 namespaces: the first 960 seen get buckets 0-959, the rest
    land in the 64 shared at the tail, by crc32; the port's helper, its
    core's tenth row, its balancer, the JAX package's balancer and the
    plain reference give the same buckets."""
    names = [f"tenant-{i}" for i in range(1000)] + ["tenant-3", "tenant-999"]
    slots = {}
    port = [TB.namespace_bucket(slots, n) for n in names]
    assert port[:960] == list(range(960))
    assert all(960 <= s < 1024 for s in port[960:1000])
    assert len(set(port[960:1000])) > 16  # spread over the tail
    assert port[1000:] == [3, port[999]]
    assert len(slots) == 960
    core = TB.BalancerCore([1024] * 8, device="cpu", max_batch=8,
                           action_slots=8, rate_limit_per_minute=60)
    assert [core.build_row(n, f"{n}/a", 128, 1, False)[0][9]
            for n in names] == port
    ref = Throttled([1024] * 8, managed_fraction=0.9, blackbox_fraction=0.1,
                    max_batch=8, action_slots=8, rate_limit_per_minute=60)
    assert [ref.bucket(n) for n in names] == port
    for balancer in (TB.TpuBalancer, JB.TpuBalancer):
        rule = _bucket_rule(balancer)
        assert [rule(n) for n in names] == port, balancer.__module__


def test_without_the_option_the_step_is_unchanged():
    """No admission: nine rows, no flags, a counter at 0, and a clock that
    nothing reads."""
    core = TB.BalancerCore([2048] * 16, device="cpu", max_batch=16,
                           action_slots=8)
    core.set_clock(12.5)
    row, key = core.build_row("ns", "ns/a", 256, 1, False)
    assert len(row) == 9
    core.submit([(row, key)] * 4)
    res = core.step()
    assert res.throttled is None and res.rows.shape == (9, 4)
    assert tuple(res._asdict()) == ("chosen", "forced", "rounds", "bucket",
                                    "rows", "slot_keys")
    assert res[4] is res.rows and res[5] == [key] * 4
    assert core.counters["throttled"] == 0 and core._buckets is None
    empty = core.step()
    assert empty.throttled is None and empty.rows.shape == (9, 0)
    admit = TB.BalancerCore([2048] * 16, device="cpu", max_batch=16,
                            action_slots=8, rate_limit_per_minute=60)
    idle = admit.step()
    assert idle.throttled.shape == (0,) and idle.rows.shape == (10, 0)


def _admitting_core():
    core = TB.BalancerCore([2048] * 40, device="cpu", max_batch=64,
                           action_slots=32, rate_limit_per_minute=600)
    rows = [core.build_row(f"ns{k % 3}", f"ns{k % 3}/a{k % 5}", 128, 1,
                           k % 7 == 0) for k in range(64)]
    return core, rows


def _ranges(prof, names):
    spans = {n: [] for n in names}
    for e in prof.profiler.kineto_results.events():
        if e.name() in spans:
            spans[e.name()].append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return spans


def test_admission_range_opens_inside_the_dispatch():
    core, rows = _admitting_core()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for k in range(3):
            core.set_clock(k * 0.5)
            core.submit(rows[:24])
            core.step()
    spans = _ranges(prof, ("core.dispatch", "core.admit", "schedule"))
    assert {n: len(v) for n, v in spans.items()} == dict.fromkeys(spans, 3)
    for (ds, de), (a_s, a_e), (ss, _) in zip(*spans.values()):
        assert ds <= a_s and a_e <= de and a_e <= ss


def test_no_admission_range_without_a_profiler_or_the_option(monkeypatch):
    core, rows = _admitting_core()

    def refuse(name):
        raise AssertionError(f"range {name!r} opened with no profiler")

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        core.submit(rows[:16])
        assert len(core.step().chosen) == 16
    plain = TB.BalancerCore([2048] * 40, device="cpu", max_batch=64,
                            action_slots=32)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        plain.submit([plain.build_row("ns", "ns/a", 128, 1, False)] * 8)
        plain.step()
    spans = _ranges(prof, ("core.assembly", "core.dispatch", "core.admit"))
    assert {n: len(v) for n, v in spans.items()} == {
        "core.assembly": 1, "core.dispatch": 1, "core.admit": 0}
