"""The port's device rate admission against the JAX package.

`openwhisk_tpu_torch.ops.throttle.admit_batch` and the port's
`make_fused_admit_step_packed` take the same seeded inputs as
`openwhisk_tpu.ops.throttle.admit_batch` and the JAX package's fused admit
step under `_xla_pair("auto")`, on the CPU.

Tolerance: admitted / throttled bits, decisions, repair rounds and books
must be EXACTLY equal; bucket tokens agree within 1 float32 ulp. XLA may
fuse the refill `tokens + rate * dt` into one fused multiply-add; the port
computes it rounded once, as that fused operation does, through float64,
where a rare double rounding can still land one ulp away.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from openwhisk_tpu.controller.loadbalancer.tpu_balancer import \
    _xla_pair  # noqa: E402
from openwhisk_tpu.ops import placement as J  # noqa: E402
from openwhisk_tpu.ops import throttle as JT  # noqa: E402
from openwhisk_tpu_torch.controller.loadbalancer.tpu_balancer import \
    _torch_pair  # noqa: E402
from openwhisk_tpu_torch.ops import placement as T  # noqa: E402
from openwhisk_tpu_torch.ops import throttle as TT  # noqa: E402
from torch_placement_cases import random_batch, random_books  # noqa: E402

#: the stated tolerance on bucket tokens
TOKEN_ULPS = 1


def assert_buckets_match(jst, tst):
    np.testing.assert_array_max_ulp(np.asarray(jst.tokens),
                                    tst.tokens.numpy(), maxulp=TOKEN_ULPS)
    np.testing.assert_array_equal(np.asarray(jst.rate_per_s),
                                  tst.rate_per_s.numpy())
    np.testing.assert_array_equal(np.asarray(jst.burst), tst.burst.numpy())
    assert float(jst.last_refill) == float(tst.last_refill)


def admit_both(jst, tst, now, ns, valid):
    jst, ja = JT.admit_batch(jst, jnp.float32(now), jnp.asarray(ns),
                             jnp.asarray(valid))
    tst, ta = TT.admit_batch(tst, np.float32(now), torch.from_numpy(ns),
                             torch.from_numpy(valid))
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    assert_buckets_match(jst, tst)
    return jst, tst, ta.numpy()


def test_init_buckets_match_jax():
    for rate, burst in ((60, None), (7, None), (6, 3), (1000, 50)):
        assert_buckets_match(JT.init_buckets(8, rate, burst),
                             TT.init_buckets(8, rate, burst, device="cpu"))


def test_no_device_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_buckets(4, 60)


@pytest.mark.parametrize("seed", range(6))
def test_admit_sequence_matches_jax(seed):
    """Seeded batches over a few namespaces: same-namespace contention in
    one batch, invalid rows, buckets drained empty, then refills after
    short and long idle gaps (including a clock that does not move and one
    that steps back, which refills nothing)."""
    rng = np.random.RandomState(seed)
    m = 8
    rate = int(rng.choice([6, 12, 30]))
    jst = JT.init_buckets(m, rate)
    tst = TT.init_buckets(m, rate, device="cpu")
    now = 0.0
    admitted_any = throttled_any = False
    for k in range(14):
        b = int(rng.choice([8, 32, 64]))
        ns = rng.randint(0, 3 if k % 2 else m, b).astype(np.int32)
        valid = rng.rand(b) < 0.85
        jst, tst, adm = admit_both(jst, tst, now, ns, valid)
        assert not (adm & ~valid).any()  # invalid rows never admit
        admitted_any |= bool(adm.any())
        throttled_any |= bool((valid & ~adm).any())
        now += float(rng.choice([0.0, 0.013, 0.7, 3.3, 61.0, -0.5]))
        now = max(now, 0.0)
    assert admitted_any and throttled_any


def test_contention_in_batch_order_matches_jax():
    """A 3-token bucket against 8 same-namespace requests: the first 3 in
    batch order win, in both packages."""
    jst = JT.init_buckets(1, 60)._replace(tokens=jnp.asarray([3.0],
                                                            jnp.float32))
    tst = TT.init_buckets(1, 60, device="cpu")._replace(
        tokens=torch.tensor([3.0]))
    ns = np.zeros(8, np.int32)
    _, _, adm = admit_both(jst, tst, 0.0, ns, np.ones(8, bool))
    assert adm.tolist() == [True] * 3 + [False] * 5


def test_fractional_refill_matches_jax():
    """Refills that leave fractional tokens (floor decides admission)."""
    jst = JT.init_buckets(2, 7)
    tst = TT.init_buckets(2, 7, device="cpu")
    ns = np.array([0, 1] * 6, np.int32)
    valid = np.ones(12, bool)
    for now in (0.0, 1.1, 9.7, 17.3, 17.31, 60.0, 200.0):
        jst, tst, _ = admit_both(jst, tst, now, ns, valid)


def _admit_buffer(rng, n, b, r, h, slots, ns_count):
    """A packed 10-row buffer: releases, health flips, requests + ns_slot."""
    rel = np.zeros((5, r), np.int32)
    rel[3] = 1
    k = int(rng.randint(0, r + 1))
    rel[0, :k] = rng.randint(0, n, k)
    rel[1, :k] = rng.randint(0, slots, k)
    rel[2, :k] = rng.choice([128, 256], k)
    rel[3, :k] = rng.choice([1, 1, 4], k)
    rel[4, :k] = 1
    health = np.zeros((3, h), np.int32)
    if rng.rand() < 0.5:
        health[0] = rng.randint(0, n)
        health[1] = int(rng.rand() < 0.5)
        health[2] = 1
    cols = random_batch(n, b, rng, slots=slots)
    req = np.stack([np.asarray(c, np.int32) for c in cols]
                   + [rng.randint(0, ns_count, b).astype(np.int32)])
    return np.concatenate([rel.ravel(), health.ravel(), req.ravel()])


@pytest.mark.parametrize("seed", range(3))
def test_fused_admit_step_matches_jax(seed):
    """Eight packed admit steps (B in {8, 32}: the scan and the repair
    schedule) through both packages' fused admit step: packed decisions
    with the throttled bit, rounds and books exactly; tokens within
    TOKEN_ULPS."""
    rng = np.random.RandomState(100 + seed)
    n, slots, h = 32, 8, 8
    free, conc, health = random_books(n, rng, mem=1024, slots=slots)
    jfn = J.make_fused_admit_step_packed(*_xla_pair("auto")[1::-1])
    tfn = T.make_fused_admit_step_packed(*_torch_pair("auto")[1::-1])
    jst = J.PlacementState(jnp.asarray(free), jnp.asarray(conc),
                           jnp.asarray(health))
    tst = T.placement_state_from_numpy(free, conc, health, "cpu")
    jbk = JT.init_buckets(4, 12)
    tbk = TT.init_buckets(4, 12, device="cpu")
    now = 0.0
    throttled = 0
    for step in range(8):
        b = (8, 32)[step % 2]
        buf = _admit_buffer(rng, n, b, b, h, slots, 4)
        now32 = np.float32(now)
        (jst, jbk), jout = jfn((jst, jbk), jnp.asarray(buf), now32, b, h, b)
        (tst, tbk), tout = tfn((tst, tbk), torch.from_numpy(buf), now32,
                               b, h, b)
        np.testing.assert_array_equal(np.asarray(jout), tout.numpy(),
                                      err_msg=f"step {step}")
        np.testing.assert_array_equal(np.asarray(jst.free_mb),
                                      tst.free_mb.numpy())
        np.testing.assert_array_equal(np.asarray(jst.conc_free),
                                      tst.conc_free.numpy())
        np.testing.assert_array_equal(np.asarray(jst.health),
                                      tst.health.numpy())
        assert_buckets_match(jbk, tbk)
        throttled += int(T.unpack_step_output(tout.numpy())[2].sum())
        now += float(rng.choice([0.0, 0.5, 20.0]))
    assert throttled > 0


def test_throttled_rows_take_no_capacity():
    """A drained bucket throttles every row: bit 1 set, chosen -1, books
    untouched."""
    n, slots = 8, 4
    fn = T.make_fused_admit_step_packed(*_torch_pair("auto")[1::-1])
    st = T.init_state(n, 1024, action_slots=slots, device="cpu")
    bk = TT.init_buckets(2, 60, device="cpu")._replace(
        tokens=torch.zeros(2))
    rng = np.random.RandomState(5)
    buf = _admit_buffer(rng, n, 8, 8, 8, slots, 2)
    buf[:5 * 8] = 0  # no releases
    buf[3 * 8:4 * 8] = 1
    buf[5 * 8:5 * 8 + 3 * 8] = 0  # no health flips
    buf[40 + 24 + 8 * 8:40 + 24 + 9 * 8] = 1  # every request valid
    (st, bk), out = fn((st, bk), torch.from_numpy(buf), np.float32(0.0),
                       8, 8, 8)
    chosen, forced, thr, _ = T.unpack_step_output(out.numpy())
    assert thr.all() and (chosen == -1).all() and not forced.any()
    assert (st.free_mb.numpy() == 1024).all()
    assert (st.conc_free.numpy() == 0).all()
