"""The port's placement quality plane and shadow pass against the JAX
package, on the CPU.

  (a) the scorer: the port's torch `make_quality_step` against JAX's
      `make_quality_step` and `quality_step_np` on seeded random books and
      decision vectors (the `tests/test_decision_quality.py` fuzz), both
      conc layouts, with and without a shadow vector. Tolerance: the
      histogram, the counters and the divergence vector exact; the float32
      sums (`inv_regret_ms`, the summary row) within rtol 1e-5, atol 1e-4
      (reduction order). The port's NumPy twin equals JAX's exactly.
  (b) the shadow steps: with a zero penalty the shadow's vector is the
      production step's, bit for bit, for the scan, the repair and the
      admit variant, and the live books and bucket state are unchanged;
      with a penalty it is JAX's `make_shadow_step_packed` /
      `make_shadow_admit_step_packed` vector, bit for bit. The JAX oracles
      run the XLA schedules (the JAX suite holds them bit-exact with the
      Pallas kernels).
  (c) the plane: disabled is a true no-op (tracemalloc), the fleet merge
      equals the JAX package's on the same raw bodies.
  (d) `TpuBalancer(device="cpu")` with the plane on against the JAX
      `TpuBalancer` on one seeded publish/ack sequence with stragglers
      injected into the anomaly scores: decisions, quality counters,
      regret histogram and shadow divergence equal; with the plane off the
      decisions are the same. The CPU balancers' attribution counters
      equal the JAX package's.
  (e) `/admin/placement/quality` and `?raw=1` over HTTP as the JAX
      controller answers them; the disabled plane's 404; the fleet route
      and the /admin index as the JAX controller's.
"""
import subprocess
import sys
import tracemalloc
from pathlib import Path

import aiohttp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from openwhisk_tpu.controller import monitoring as JMon  # noqa: E402
from openwhisk_tpu.ops import decision_quality as JQ  # noqa: E402
from openwhisk_tpu.ops import placement as JP  # noqa: E402
from openwhisk_tpu.ops import throttle as JT  # noqa: E402
from openwhisk_tpu_torch.controller import monitoring as TMon  # noqa: E402
from openwhisk_tpu_torch.controller.loadbalancer.quality import (  # noqa: E402
    QualityConfig, QualityPlane)
from openwhisk_tpu_torch.ops import decision_quality as TQ  # noqa: E402
from openwhisk_tpu_torch.ops.anomaly import (  # noqa: E402
    S_EWMA_MS as S_EWMA, S_STRAGGLER_FLAG as S_FLAG, S_TOTAL)
from openwhisk_tpu_torch.ops import placement as TP  # noqa: E402
from openwhisk_tpu_torch.ops import throttle as TT  # noqa: E402
from test_decision_quality import (_fuzz_scorer_inputs,  # noqa: E402
                                   _packed_buf, _random_state, _raw_member)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-4


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port_inputs(free, conc, health, ewma, cap, req, out, sh):
    return (_t(free, np.int32), _t(conc, np.int32), _t(health, bool),
            _t(ewma, np.float32), _t(cap, np.int32), _t(req, np.int32),
            _t(out, np.int32), None if sh is None else _t(sh, np.int32))


def _assert_states(port, ref):
    for name in ("regret_hist", "counters", "inv_divergence"):
        np.testing.assert_array_equal(_np(getattr(port, name)),
                                      _np(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(_np(port.inv_regret_ms),
                               _np(ref.inv_regret_ms), rtol=RTOL, atol=ATOL)


# -- (a) the scorer ------------------------------------------------------------
@pytest.mark.parametrize("transposed", [False, True], ids=["NA", "AN"])
@pytest.mark.parametrize("shadow", [True, False], ids=["shadow", "plain"])
@pytest.mark.parametrize("seed", range(3))
def test_scorer_matches_jax_and_the_numpy_twin(seed, shadow, transposed):
    """Three chained steps over random books and decisions: the port's
    torch step against JAX's step, the port's NumPy twin against JAX's
    exactly."""
    rng = np.random.RandomState(100 * seed + 7 * shadow + transposed)
    n = int(rng.choice([4, 8, 32]))
    b = int(rng.choice([8, 16, 64]))
    nb = int(rng.choice([8, 24]))
    step_t = TQ.make_quality_step(nb, transposed=transposed)
    step_j = JQ.make_quality_step(nb, transposed=transposed)
    qs_t = TQ.init_quality_state(n, nb, device=CPU)
    qs_j = JQ.init_quality_state(n, nb)
    qs_tn = TQ.init_quality_state(n, nb, numpy=True)
    qs_jn = JQ.init_quality_state(n, nb, numpy=True)
    for _ in range(3):
        free, conc, health, ewma, cap, req, out, sh = _fuzz_scorer_inputs(
            rng, n, b, shadow=shadow)
        conc_in = conc.T.copy() if transposed else conc
        qs_t, sum_t = step_t(qs_t, *_port_inputs(free, conc_in, health, ewma,
                                                 cap, req, out, sh))
        qs_j, sum_j = step_j(
            qs_j, *(jnp.asarray(x) for x in (free, conc_in, health, ewma,
                                              cap, req, out)),
            None if sh is None else jnp.asarray(sh))
        args = (free, conc_in, health, ewma, cap, req, out, sh)
        qs_tn, sum_tn = TQ.quality_step_np(qs_tn, *args,
                                           transposed=transposed)
        qs_jn, sum_jn = JQ.quality_step_np(qs_jn, *args,
                                           transposed=transposed)
        assert sum_t.dtype == torch.float32 and sum_t.shape == (8,)
        np.testing.assert_allclose(_np(sum_t), np.asarray(sum_j),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(sum_tn, sum_jn)
    _assert_states(qs_t, qs_j)
    _assert_states(qs_t, qs_jn)
    for x, y in zip(qs_tn, qs_jn):
        np.testing.assert_array_equal(x, y)
    assert int(qs_t.regret_hist.sum()) == int(qs_t.counters[TQ.C_PLACED])


def test_an_accumulation_continues_across_the_packages():
    """Two batches scored by JAX, the state carried into the port
    (`quality_state_from_numpy`), a third scored there: the same state as
    three JAX steps."""
    rng = np.random.RandomState(3)
    n, b, nb = 16, 32, 24
    batches = [_fuzz_scorer_inputs(rng, n, b) for _ in range(3)]
    step_j = JQ.make_quality_step(nb)
    qs_j = JQ.init_quality_state(n, nb)
    for i, args in enumerate(batches):
        if i == 2:
            carried = TQ.quality_state_from_numpy(
                [np.asarray(x) for x in qs_j], device=CPU)
        qs_j, _ = step_j(qs_j, *(None if x is None else jnp.asarray(x)
                                 for x in args))
    qs_t, _ = TQ.make_quality_step(nb)(carried, *_port_inputs(*batches[2]))
    _assert_states(qs_t, qs_j)


def test_counter_semantics_and_divergence_attribution():
    """The JAX suite's hand-built batches through the port's torch step:
    every attribution counter, the regret at the chosen invoker and the
    divergence at the production choice."""
    n, nb = 4, 8
    step = TQ.make_quality_step(nb)
    conc = np.zeros((n, 2), np.int32)
    conc[1, 0] = 1
    req = np.zeros((9, 5), np.int32)
    req[1], req[4], req[8] = n, 128, [1, 1, 1, 1, 0]
    chosen = np.asarray([0, 1, -1, -1, 0], np.int32)
    throttled = np.asarray([0, 0, 1, 0, 0], np.int32)
    out = (((chosen + 1) << 2) | (throttled << 1)).astype(np.int32)
    qs, _ = step(TQ.init_quality_state(n, nb, device=CPU), *_port_inputs(
        np.full(n, 512), conc, [True, True, True, False],
        [100.0, 5.0, 0.0, 0.0], np.full(n, 1024), req, out, None))
    assert {k: int(qs.counters[i]) for i, k in enumerate(TQ.COUNTERS)} == {
        "rows": 4, "placed": 2, "forced": 0, "overflow": 1, "throttled": 1,
        "unplaced": 1, "cold_start": 1, "shadow_rows": 0,
        "shadow_divergent": 0}
    assert float(qs.inv_regret_ms[0]) == pytest.approx(100.0)
    assert float(qs.inv_regret_ms[1]) == pytest.approx(5.0)

    req = np.zeros((9, 3), np.int32)
    req[1], req[4], req[8] = n, 128, 1
    out = ((np.asarray([0, 1, 2]) + 1) << 2).astype(np.int32)
    sh = ((np.asarray([1, 1, 2]) + 1) << 2).astype(np.int32)
    qs, summary = step(TQ.init_quality_state(n, nb, device=CPU),
                       *_port_inputs(np.full(n, 512), np.zeros((n, 2)),
                                     np.ones(n, bool),
                                     [50.0, 10.0, 0.0, 0.0],
                                     np.full(n, 1024), req, out, sh))
    assert int(qs.counters[TQ.C_SHADOW_ROWS]) == 3
    assert int(qs.counters[TQ.C_SHADOW_DIVERGENT]) == 1
    assert qs.inv_divergence.tolist() == [1, 0, 0, 0]
    assert float(summary[TQ.S_SHADOW_DELTA_MS]) == pytest.approx(40.0)


def test_per_invoker_adds_past_the_accumulator_are_dropped():
    """Books grown past the accumulator's pad (the JAX package keeps the
    pad it allocated at): choices beyond it add nothing per invoker, as
    the JAX scatter drops them; the counters still count them."""
    n_books, n_acc, nb = 16, 8, 8
    rng = np.random.RandomState(5)
    args = _fuzz_scorer_inputs(rng, n_books, 32)
    qs_t, _ = TQ.make_quality_step(nb)(
        TQ.init_quality_state(n_acc, nb, device=CPU), *_port_inputs(*args))
    qs_j, _ = JQ.make_quality_step(nb)(
        JQ.init_quality_state(n_acc, nb),
        *(None if x is None else jnp.asarray(x) for x in args))
    _assert_states(qs_t, qs_j)
    assert qs_t.inv_regret_ms.shape == (n_acc,)


# -- (b) the shadow steps ------------------------------------------------------
def _port_state(state):
    return TP.placement_state_from_numpy(np.asarray(state.free_mb),
                                         np.asarray(state.conc_free),
                                         np.asarray(state.health), CPU)


def _clone(state):
    return [t.clone() for t in state]


def _pen(rng, n):
    return np.where(rng.rand(n) < 0.3, rng.randint(1, 4, n),
                    0).astype(np.int32)


FAMILIES = {"scan": ((JP.release_batch, JP.schedule_batch),
                     (TP.release_batch, TP.schedule_batch)),
            "repair": ((JP.release_batch_vector, JP.schedule_batch_repair),
                       (TP.release_batch_vector,
                        TP.schedule_batch_repair))}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_zero_penalty_shadow_is_the_production_vector(family):
    """The shadow with the penalty zeroed reproduces the production
    packed vector bit for bit and leaves the live books untouched, with
    and without a preallocated copy; the copy is reused."""
    _, (rel_fn, sched_fn) = FAMILIES[family]
    rng = np.random.RandomState(5)
    n, r, h, b = 32, 8, 4, 16
    state = _port_state(_random_state(n, rng))
    buf = _t(_packed_buf(rng, n, r, h, b), np.int32)
    live = _clone(state)
    shadow = TP.make_shadow_step_packed(rel_fn, sched_fn)
    zero = torch.zeros((n,), dtype=torch.int32)
    s_out = shadow(state, buf, zero, r, h, b)
    scratch = TP.empty_books_like(state)
    s_out2 = shadow(state, buf, zero, r, h, b, scratch=scratch)
    for t, t0 in zip(state, live):
        assert torch.equal(t, t0)
    assert s_out.shape == (b,)  # no repair-round tail
    assert scratch.conc_free.T.is_contiguous()
    _, p_out = TP.make_fused_step_packed(rel_fn, sched_fn)(state, buf, r, h,
                                                           b)
    assert torch.equal(s_out, p_out[:-1]) and torch.equal(s_out2, s_out)
    # the production step wrote the books the shadow copied
    assert not all(torch.equal(t, t0) for t, t0 in zip(state, live))
    assert TP.shadow_books(state, scratch) is scratch


def test_shadow_books_refuses_a_mis_shaped_scratch():
    """A scratch copy of other shapes raises instead of being silently
    re-allocated (its owner sizes it with the books); the live books are
    not written."""
    rng = np.random.RandomState(4)
    state = _port_state(_random_state(32, rng))
    live = _clone(state)
    small = TP.empty_books_like(_port_state(_random_state(16, rng)))
    with pytest.raises(ValueError, match="do not match"):
        TP.shadow_books(state, small)
    for t, t0 in zip(state, live):
        assert torch.equal(t, t0)


def test_zero_penalty_admit_shadow_is_the_production_vector():
    rng = np.random.RandomState(6)
    n, r, h, b = 32, 8, 4, 16
    state = _port_state(_random_state(n, rng))
    buckets = TT.init_buckets(64, 6, device=CPU)
    live, tokens0 = _clone(state), buckets.tokens.clone()
    buf = _t(_packed_buf(rng, n, r, h, b, rows=10), np.int32)
    now = np.float32(1.0)
    s_out = TP.make_shadow_admit_step_packed(
        TP.release_batch, TP.schedule_batch)(
        (state, buckets), buf, torch.zeros((n,), dtype=torch.int32), now,
        r, h, b)
    for t, t0 in zip(state, live):
        assert torch.equal(t, t0)
    assert torch.equal(buckets.tokens, tokens0)
    _, p_out = TP.make_fused_admit_step_packed(
        TP.release_batch, TP.schedule_batch)((state, buckets), buf, now, r,
                                             h, b)
    assert torch.equal(s_out, p_out[:-1])
    assert TP.unpack_step_output(p_out.numpy())[2].any()  # bit 1 is live


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("seed", range(3))
def test_penalized_shadow_matches_jax(family, seed):
    (j_rel, j_sched), (t_rel, t_sched) = FAMILIES[family]
    rng = np.random.RandomState(40 + seed)
    n, r, h, b = 32, 8, 4, int(rng.choice([8, 16, 32]))
    jstate = _random_state(n, rng, slots=8)
    buf = _packed_buf(rng, n, r, h, b, slots=8)
    pen = _pen(rng, n)
    ref = JP.make_shadow_step_packed(j_rel, j_sched)(
        jstate, jnp.asarray(buf), jnp.asarray(pen), r, h, b)
    state = _port_state(jstate)
    live = _clone(state)
    got = TP.make_shadow_step_packed(t_rel, t_sched)(
        state, _t(buf, np.int32), _t(pen, np.int32), r, h, b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for t, t0 in zip(state, live):
        assert torch.equal(t, t0)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_penalized_admit_shadow_matches_jax(family):
    (j_rel, j_sched), (t_rel, t_sched) = FAMILIES[family]
    rng = np.random.RandomState(11)
    n, r, h, b = 32, 8, 4, 32
    jstate = _random_state(n, rng, slots=8)
    buf = _packed_buf(rng, n, r, h, b, rows=10, slots=8)
    pen = _pen(rng, n)
    now = np.float32(2.5)
    ref = JP.make_shadow_admit_step_packed(j_rel, j_sched)(
        (jstate, JT.init_buckets(64, 6)), jnp.asarray(buf), jnp.asarray(pen),
        now, r, h, b)
    got = TP.make_shadow_admit_step_packed(t_rel, t_sched)(
        (_port_state(jstate), TT.init_buckets(64, 6, device=CPU)),
        _t(buf, np.int32), _t(pen, np.int32), now, r, h, b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert ((got >> 1) & 1).any()


def test_penalty_demotes_a_straggler_by_probe_laps():
    """Each penalty level pushes an invoker one full probe-ring lap down
    the preference order: a penalized home loses to the next probe stop,
    and penalizing every invoker reorders without unplacing (the JAX
    suite's case, on both plain schedules)."""
    n = 4
    z, one = np.zeros(1, np.int32), np.ones(1, np.int32)
    for sched in (TP.schedule_batch, TP.schedule_batch_repair):
        def place(pen):
            state = TP.init_state(n, [1024] * n, action_slots=4, device=CPU)
            batch = TP.request_batch_from_numpy(
                z, one * n, z, one, one * 128, z, one, z, one.astype(bool),
                CPU)
            out = sched(state, batch, None if pen is None
                        else _t(pen, np.int32))
            return int(out[1][0]), bool(out[2][0])

        assert place(None) == (0, False)
        assert place([2, 0, 0, 0]) == (1, False)
        assert place([3] * n)[0] >= 0


# -- (c) the plane -------------------------------------------------------------
def test_disabled_plane_is_a_true_noop():
    """Every hook a disabled plane sits on allocates nothing (tracemalloc,
    as the JAX suite holds its plane), and no state exists."""
    qp = QualityPlane(QualityConfig(enabled=False))
    qp.attach(anomaly=None, invoker_names=lambda: ["invoker0"])

    def drive():
        qp.observe_decision(True, False, False)
        assert qp.device_step(None, None, None, None, None, None,
                              None) is None
        qp.note_summary(None)
        qp.use_device(8, device=CPU)
        qp.maybe_tick(None)

    drive()
    tracemalloc.start()
    try:
        s1 = tracemalloc.take_snapshot()
        for _ in range(256):
            drive()
        s2 = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    flt = [tracemalloc.Filter(True, "*loadbalancer/quality.py")]
    grown = [d for d in s2.filter_traces(flt).compare_to(
        s1.filter_traces(flt), "lineno") if d.size_diff > 0]
    total = sum(d.size_diff for d in grown)
    assert total < 2048, f"disabled quality plane allocated {total}B"
    assert qp._qstate is None
    assert qp.tick() == {}
    assert qp.prometheus_text(["invoker0"]) == ""
    assert qp.quality_report(["invoker0"]) == {"enabled": False}
    assert qp.raw_counts(["invoker0"]) == {"enabled": False}


def _members():
    n, b, nb = 8, 32, 8
    names = [f"invoker{i}" for i in range(n)]
    raws = []
    for m in range(2):
        qs = JQ.init_quality_state(n, nb, numpy=True)
        for i in range(2):
            qs, _ = JQ.quality_step_np(qs, *_fuzz_scorer_inputs(
                np.random.RandomState(100 + 2 * m + i), n, b))
        raws.append(_raw_member(qs, names, f"m{m}", imbalance=0.1 * m))
    odd = _raw_member(JQ.init_quality_state(n, nb + 4, numpy=True), names,
                      "odd")
    return raws, odd


@pytest.mark.parametrize("case", ["two", "mismatch", "disabled", "empty"])
def test_fleet_merge_matches_jax(case):
    raws, odd = _members()
    bodies = {"two": raws, "mismatch": raws + [odd],
              "disabled": [{"enabled": False}] + raws[:1], "empty": []}[case]
    port = TMon.merged_quality_report(bodies)
    assert port == JMon.merged_quality_report(bodies)
    if case == "mismatch":
        assert [m["instance"] for m in port["members_skipped"]] == ["odd"]
    if case == "empty":
        assert port == {"enabled": False, "members": []}
    assert TMon._pctl_from_hist([0, 3, 1], 0.99) == \
        JMon._pctl_from_hist([0, 3, 1], 0.99)


def test_the_plane_on_the_cpu_device_reports_as_the_jax_plane():
    """The same batches through the port's plane on `device="cpu"` and the
    JAX plane on its default device: raw counts and the report agree
    (ints exact, floats to the tolerance)."""
    n, b, nb = 8, 16, 8
    names = [f"invoker{i}" for i in range(n)]
    from openwhisk_tpu.controller.loadbalancer.quality import (
        QualityConfig as JCfg, QualityPlane as JPlane)
    port = QualityPlane(QualityConfig(enabled=True, buckets=nb))
    ref = JPlane(JCfg(enabled=True, buckets=nb))
    port.use_device(n, device=CPU)
    ref.use_device(n)
    rng = np.random.RandomState(8)
    for _ in range(3):
        args = _fuzz_scorer_inputs(rng, n, b)
        port.note_summary(_np(port.device_step(*_port_inputs(*args))))
        ref.note_summary(np.asarray(ref.device_step(
            *(None if x is None else jnp.asarray(x) for x in args))))
    assert port.SYNCS_DEVICE and ref.SYNCS_DEVICE
    _same_report(port.quality_report(names), ref.quality_report(names))
    _same_report(port.raw_counts(names), ref.raw_counts(names))
    text = port.prometheus_text(names)
    for family in ("openwhisk_loadbalancer_placement_regret",
                   "openwhisk_loadbalancer_decision_divergence_total",
                   "openwhisk_loadbalancer_fleet_imbalance"):
        assert f"# TYPE {family}" in text


def _same_report(port, ref, path="report"):
    """Equal JSON-like values: ints, strings and shapes exact, floats to
    the tolerance; `identity` blocks (pids) are not compared."""
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), path
        for k in ref:
            if k != "identity":
                _same_report(port[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert len(port) == len(ref), path
        for i, (x, y) in enumerate(zip(port, ref)):
            _same_report(x, y, f"{path}[{i}]")
    elif isinstance(ref, float):
        assert port == pytest.approx(ref, rel=RTOL, abs=1e-3), path
    else:
        assert port == ref, path


# -- (d) the balancers ---------------------------------------------------------
QUALITY_ON = {"CONFIG_whisk_placementQuality_enabled": "true",
              "CONFIG_whisk_placementQuality_shadowEveryN": "2",
              "CONFIG_whisk_anomaly_enabled": "false"}
#: injected anomaly scores: invokers 0 and 2 straggle
STRAGGLERS = (0, 2)


def _scores(n):
    sc = np.zeros((7, n), np.float32)
    sc[S_EWMA] = np.linspace(5.0, 40.0, n, dtype=np.float32)
    sc[S_TOTAL] = 50
    for i in STRAGGLERS:
        sc[S_EWMA, i] = 900.0
        sc[S_FLAG, i] = 1
    return sc


def _inject(bal):
    bal.anomaly._scores = _scores(bal._n_pad)
    if bal.quality.enabled:
        bal._refresh_quality_signals()


def _quality_of(bal):
    names = bal._telemetry_invoker_names()
    return bal.quality.quality_report(names), bal.quality.raw_counts(names)


@pytest.mark.parametrize("rate", [None, 4], ids=["no_rate", "rate"])
def test_balancer_quality_matches_the_jax_balancer(rate, monkeypatch):
    from test_torch_balancer_front import (_jax_package, _port_package,
                                           _scenario, run)
    jax_pkg, port_pkg = _jax_package(), _port_package()
    for pkg in (jax_pkg, port_pkg):
        monkeypatch.setattr(pkg.E.ConcurrencyLimit, "MAX", 16)
    seed = 53 + (rate or 0)
    off = run(_scenario(port_pkg, rate, False, seed, setup=_inject), 90)
    for k, v in QUALITY_ON.items():
        monkeypatch.setenv(k, v)
    port = run(_scenario(port_pkg, rate, False, seed, setup=_inject,
                         inspect=_quality_of), 90)
    ref = run(_scenario(jax_pkg, rate, False, seed, setup=_inject,
                        inspect=_quality_of), 90)
    assert port["decisions"] == ref["decisions"] == off["decisions"]
    for k in ("free", "conc", "health"):
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(port[k], off[k], err_msg=k)
    (rep, raw), (jrep, jraw) = port["inspect"], ref["inspect"]
    # the imbalance reads capacities refreshed on the 1 Hz tick, whose
    # timing differs between the runs
    for r in (rep, raw, jrep, jraw):
        r.pop("fleet_imbalance_cov")
        r.pop("last_batch", None)
    _same_report(rep, jrep)
    _same_report(raw, jraw)
    assert rep["batches"] > 0 and rep["shadow_batches"] == rep["batches"] // 2
    # every published row, throttled ones included, was scored
    assert rep["counters"]["rows"] == len(port["decisions"])
    assert rep["counters"]["throttled"] == port["throttled"]
    assert rep["divergent_rows"] > 0  # the stragglers moved the shadow
    assert any(r["divergent_rows"] for r in rep["invokers"])


def test_attribution_follows_the_fleet_past_the_initial_pad(monkeypatch):
    """A fleet that grows past `initial_pad` with stragglers among the new
    invokers. The JAX balancer keeps the accumulator at the pad it was
    made at, so its per-invoker divergence misses the new invokers' rows
    (a reference fault, fixed in the port only); the port grows it with
    the books, so the per-invoker divergence adds up to the divergent
    rows and the regret to the summed regret."""
    from test_torch_balancer_front import (N_GROW, _jax_package,
                                           _port_package, _scenario, run)
    for pkg in (_jax_package(), _port_package()):
        monkeypatch.setattr(pkg.E.ConcurrencyLimit, "MAX", 16)
    for k, v in QUALITY_ON.items():
        monkeypatch.setenv(k, v)

    def inject(bal):
        sc = _scores(N_GROW)
        sc[S_FLAG] = 0
        sc[S_FLAG, [N_GROW - 4, N_GROW - 2]] = 1  # two of the new invokers
        bal.anomaly._scores = sc
        bal._refresh_quality_signals()

    def inspect(bal):
        c = bal.quality.counts()
        return dict(pad=int(bal.state.free_mb.shape[0]),
                    steps=getattr(bal, "counters", {}).get("steps"),
                    rows=int(c["inv_divergence"].shape[0]),
                    divergence=int(c["inv_divergence"].sum()),
                    regret=float(c["inv_regret_ms"].sum()),
                    report=bal.quality.quality_report())

    port = run(_scenario(_port_package(), None, True, 61, setup=inject,
                         inspect=inspect), 90)["inspect"]
    ref = run(_scenario(_jax_package(), None, True, 61, setup=inject,
                        inspect=inspect), 90)["inspect"]
    assert port["pad"] == ref["pad"] == 16
    assert ref["rows"] == 8 and port["rows"] == 16
    rep = port["report"]
    assert rep["divergent_rows"] > 0
    assert port["divergence"] == rep["divergent_rows"]
    assert port["regret"] == pytest.approx(rep["regret_sum_ms"], rel=1e-5,
                                           abs=1e-2)
    assert rep["batches"] == port["steps"]  # no scored batch lost
    assert ref["divergence"] < ref["report"]["divergent_rows"]


@pytest.mark.parametrize("balancer", ["sharding", "lean"])
def test_cpu_balancer_attribution_matches_jax(balancer, monkeypatch):
    """The CPU balancers count attribution through `record_placement`:
    the same traffic through each package's balancer gives the same
    counters."""
    import test_torch_cpu_balancers as C
    for k, v in QUALITY_ON.items():
        monkeypatch.setenv(k, v)
    for pkg in (C._jax_package(), C._port_package()):
        monkeypatch.setattr(pkg.E.ConcurrencyLimit, "MAX", 16)
    if balancer == "sharding":
        reports = []
        for pkg in (C._jax_package(), C._port_package()):
            real = pkg.Balancer.close

            async def close(self, real=real):
                reports.append(self.quality.quality_report())
                await real(self)
            monkeypatch.setattr(pkg.Balancer, "close", close)
            C.run(C._drive(pkg, 17, 0.9, 0.1))
    else:
        reports = [C.run(_lean_run(pkg)) for pkg in ("jax", "port")]
    jrep, rep = reports
    assert rep["counters"]["rows"] > 0
    assert rep == jrep


async def _lean_run(which):
    import importlib
    import types
    base = "openwhisk_tpu" if which == "jax" else "openwhisk_tpu_torch"
    E_ = importlib.import_module(base + ".core.entity")
    Mem = importlib.import_module(base + ".messaging.memory")
    Msg = importlib.import_module(base + ".messaging.message")
    Tx = importlib.import_module(base + ".utils.transaction")
    Lean = importlib.import_module(
        base + ".controller.loadbalancer.lean").LeanBalancer

    async def factory(invoker_id, messaging_provider):
        async def stop():
            return None
        return types.SimpleNamespace(stop=stop)

    async def no_send(msg, invoker):
        return None

    bal = Lean(Mem.MemoryMessagingProvider(), E_.ControllerInstanceId("0"),
               factory, user_memory=E_.MB(1024))
    bal.send_activation_to_invoker = no_send
    await bal.start()
    ident = E_.Identity.generate("guest")
    a = E_.ExecutableWhiskAction(
        E_.EntityPath("guest"), E_.EntityName("lean"),
        E_.CodeExec(kind="python:3", code="x"),
        limits=E_.ActionLimits(E_.TimeLimit(5000),
                               E_.MemoryLimit(E_.MB(256))))
    a.rev = E_.DocRevision("1-b")
    for _ in range(5):
        await bal.publish(a, Msg.ActivationMessage(
            Tx.TransactionId(), a.fully_qualified_name, "1-b", ident,
            E_.ActivationId.generate(), E_.ControllerInstanceId("0"), False,
            {}))
    report = bal.quality.quality_report()
    await bal.close()
    return report


# -- (e) the API ---------------------------------------------------------------
def _controller_fixture(on):
    import test_torch_controller as TC
    with pytest.MonkeyPatch.context() as mp:
        for pkg in (TC.JP, TC.TP):
            mp.setattr(pkg.core.entity.ConcurrencyLimit, "MAX", 4)
        loop = TC.Loop()
        built = {name: TC.Assembly(pkg, TC.free_port())
                 for name, pkg in (("jax", TC.JP), ("port", TC.TP))}
        try:
            for a in built.values():
                # the planes read their switches when the balancer is built
                with pytest.MonkeyPatch.context() as env:
                    for k, v in (QUALITY_ON if on else {}).items():
                        env.setenv(k, v)
                    loop.run(a.start())
                loop.run(TC.create_actions(a))
            yield TC, loop, built
        finally:
            try:
                for a in built.values():
                    loop.run(a.stop())
            finally:
                loop.close()


@pytest.fixture(scope="module")
def quality_on():
    yield from _controller_fixture(True)


@pytest.fixture(scope="module")
def quality_off():
    yield from _controller_fixture(False)


async def _admin(a, paths):
    import test_torch_controller as TC
    base = a.url.split("/api/")[0]
    out = {}
    async with aiohttp.ClientSession(headers=TC.HDRS) as s:
        for path in paths:
            async with s.get(base + path) as r:
                out[path] = (r.status, await r.json())
    return out


def test_placement_quality_route_answers_as_the_jax_controller(quality_on):
    TC, loop, built = quality_on
    picks = np.random.RandomState(9).choice(len(TC.ACTIONS), 12)
    paths = ("/admin/placement/quality", "/admin/placement/quality?raw=1")
    got = {}
    for name, a in built.items():
        loop.run(TC.sequential(a, picks))
        got[name] = loop.run(_admin(a, paths))
    (st, rep), (jst, jrep) = (got["port"][paths[0]], got["jax"][paths[0]])
    assert st == jst == 200
    for r in (rep, jrep):
        r.pop("fleet_imbalance_cov")
        r.pop("last_batch")
    _same_report(rep, jrep)
    assert rep["counters"]["rows"] == len(picks) == rep["counters"]["placed"]
    (st, raw), (jst, jraw) = (got["port"][paths[1]], got["jax"][paths[1]])
    assert st == jst == 200
    for r in (raw, jraw):
        r.pop("fleet_imbalance_cov")
    _same_report(raw, jraw)
    assert raw["counters"][0] == len(picks)
    # the balancer's /metrics families (the divergence family needs a
    # divergent row, and no invoker straggles here)
    for a in built.values():
        text = a.bal.metrics.prometheus_text()
        for family in ("openwhisk_loadbalancer_placement_regret histogram",
                       "openwhisk_loadbalancer_fleet_imbalance gauge"):
            assert f"# TYPE {family}" in text, (a.pkg.__name__, family)


def test_disabled_plane_answers_the_jax_404(quality_off):
    _, loop, built = quality_off
    paths = ("/admin/placement/quality", "/admin/placement/quality?raw=1",
             "/admin/fleet/quality", "/admin")
    got = {name: loop.run(_admin(a, paths)) for name, a in built.items()}
    for path in paths[:2]:
        assert got["port"][path][0] == got["jax"][path][0] == 404
        assert got["port"][path][1]["error"] == got["jax"][path][1]["error"]
    # the fleet route answers as the JAX controller's: 200 with nothing
    # to merge from a member whose plane is off
    (st, body), (jst, jbody) = (got["port"]["/admin/fleet/quality"],
                                got["jax"]["/admin/fleet/quality"])
    assert st == jst == 200
    assert body == jbody
    rows = {r["path"]: r for r in got["port"]["/admin"][1]["routes"]}
    jrows = {r["path"]: r for r in got["jax"]["/admin"][1]["routes"]}
    assert rows["/admin/placement/quality"]["enabled"] is False
    assert rows == jrows


# -- the package exports ------------------------------------------------------
def test_package_exports_name_what_the_jax_package_exports():
    """Every name the JAX package's `ops` and `models` export exists in
    the port's, the port has a `__version__`, and importing the three
    pulls in no jax."""
    import openwhisk_tpu
    import openwhisk_tpu.models
    import openwhisk_tpu.ops
    code = ("import sys, json\n"
            "import openwhisk_tpu_torch as P, openwhisk_tpu_torch.ops as O,"
            " openwhisk_tpu_torch.models as M\n"
            "print(json.dumps({'version': P.__version__, 'ops': O.__all__,"
            " 'models': M.__all__, 'bad': sorted(m for m in sys.modules if"
            " m.split('.')[0] in ('jax', 'jaxlib', 'openwhisk_tpu'))}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    import json
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["bad"] == []
    assert got["version"] == openwhisk_tpu.__version__
    assert set(openwhisk_tpu.ops.__all__) <= set(got["ops"])
    assert set(openwhisk_tpu.models.__all__) <= set(got["models"])
