"""The port's anomaly scoring and alerting against the JAX package's.

`make_anomaly_step` (ops/anomaly.py) against the JAX step and the NumPy
twin over 30 seeded ticks of cumulative telemetry (three slow invokers,
an error burst, a timeout burst, invokers joining late), the masked
median, the step's no-host-read rule, the `AlertEngine` transitions and
`alerts_report`, the anomaly plane on a device accumulator (one-tick-deep
harvest) against the JAX plane, carry growth on the device, and the
advisory hints reaching `InvokerPool` only with `hintUnhealthy`.

Tolerances: flags exact; scores within rtol=1e-5, atol=1e-5 of the JAX
step's (XLA may contract the EWMA `(1 - a) * ewma + a * x` into a fused
multiply-add, the port rounds each product) and of the NumPy twin's
float64 scores; alert transitions, rules and hints equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from openwhisk_tpu.controller.loadbalancer import anomaly as JP  # noqa: E402
from openwhisk_tpu.controller.loadbalancer import \
    supervision as JS  # noqa: E402
from openwhisk_tpu.controller.loadbalancer import \
    telemetry as JTP  # noqa: E402
from openwhisk_tpu.core import entity as JE  # noqa: E402
from openwhisk_tpu.messaging import memory as JM  # noqa: E402
from openwhisk_tpu.ops import anomaly as JA  # noqa: E402
from openwhisk_tpu.ops import telemetry as JT  # noqa: E402
from openwhisk_tpu_torch.controller.loadbalancer import \
    anomaly as TP  # noqa: E402
from openwhisk_tpu_torch.controller.loadbalancer import \
    supervision as TS  # noqa: E402
from openwhisk_tpu_torch.controller.loadbalancer import \
    telemetry as TTP  # noqa: E402
from openwhisk_tpu_torch.core import entity as TE  # noqa: E402
from openwhisk_tpu_torch.messaging import memory as TM  # noqa: E402
from openwhisk_tpu_torch.ops import anomaly as TA  # noqa: E402

CFG = (0.3, 3.5, 3.0, 8, 1.0)  # alpha, z, spike, min_samples, mad floor
N, B, M = 64, 24, 8
SLOW = (3, 17, 40)
RTOL = ATOL = 1e-5


def tick_events(rng, tick, n_active=48, e=256):
    """One tick's completions: duplicate invokers, three slow ones, an
    error burst on invoker 5 (ticks 10-12) and a timeout burst on invoker
    9 (tick 20); invokers 48+ join at tick 15."""
    ev = np.zeros((5, e), np.int32)
    k = e - 16  # 16 padding rows
    top = n_active if tick < 15 else N
    ev[0, :k] = rng.randint(0, top, k)
    ev[1, :k] = rng.randint(0, M, k)
    lat = rng.lognormal(3.0, 0.3, k) * 1000
    lat[np.isin(ev[0, :k], SLOW)] *= 8
    ev[2, :k] = lat.astype(np.int32)
    if 10 <= tick < 13:
        ev[3, :k][ev[0, :k] == 5] = JT.OUTCOME_ERROR
    if tick == 20:
        ev[3, :k][ev[0, :k] == 9] = JT.OUTCOME_TIMEOUT
    ev[4, :k] = 1
    return ev


def assert_scores(port, ref):
    for row in (TA.S_STRAGGLER_FLAG, TA.S_ANOMALY_FLAG):
        np.testing.assert_array_equal(port[row], ref[row])
    np.testing.assert_array_equal(port[TA.S_TOTAL], ref[TA.S_TOTAL])
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_30_ticks_match_jax_and_the_numpy_twin(seed):
    rng = np.random.RandomState(seed)
    acc = JT.NumpyLatencyAccumulator(N, M, B)
    jstep, tstep = JA.make_anomaly_step(*CFG), TA.make_anomaly_step(*CFG)
    js = JA.init_anomaly(N, B)
    ts = TA.init_anomaly(N, B, device="cpu")
    ns = JA.init_anomaly_np(N, B)
    flagged = set()
    for tick in range(30):
        acc.fold(tick_events(rng, tick))
        c = acc.counts()
        bk, lat, out = (c["inv_buckets"].astype(np.int32),
                        c["inv_lat_ms"].astype(np.float32),
                        c["inv_outcomes"].astype(np.int32))
        js, jsc = jstep(js, bk, lat, out)
        ts, tsc = tstep(ts, torch.from_numpy(bk), torch.from_numpy(lat),
                        torch.from_numpy(out))
        ns, nsc = JA.anomaly_step_np(ns, bk, lat, out, *CFG)
        tsc = tsc.numpy()
        assert tsc.shape == (TA.N_SCORE_ROWS, N) and tsc.dtype == np.float32
        assert_scores(tsc, np.asarray(jsc))
        assert_scores(tsc, nsc)
        for f in TA.AnomalyState._fields:  # the carry too
            np.testing.assert_allclose(getattr(ts, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       rtol=RTOL, atol=ATOL, err_msg=f)
        flagged |= {(tick, int(i)) for i in
                    np.nonzero(tsc[TA.S_ANOMALY_FLAG])[0]}
    # the run exercised what it claims: the slow invokers flag, and both
    # bursts flag their invoker
    assert {i for _, i in flagged} >= set(SLOW) | {5, 9}
    assert (10, 5) in flagged and (20, 9) in flagged


@pytest.mark.parametrize("mask_of", ["none", "one", "odd", "even", "all"])
def test_masked_median_matches_numpy(mask_of):
    rng = np.random.RandomState(11)
    x = rng.lognormal(2, 1, 33).astype(np.float32)
    mask = {"none": np.zeros(33, bool), "one": np.arange(33) == 7,
            "odd": rng.rand(33) < 0.5, "even": np.arange(33) < 10,
            "all": np.ones(33, bool)}[mask_of]
    got = TA._masked_median(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.dim() == 0
    assert float(got) == pytest.approx(JA._masked_median_np(x, mask),
                                       rel=1e-7)


def test_step_reads_no_value_back_to_the_host(monkeypatch):
    """The step enqueues and returns: no `.item()`, `.tolist()`,
    `bool(t)`, `int(t)` or `float(t)` on a tensor anywhere in it."""
    rng = np.random.RandomState(2)
    acc = JT.NumpyLatencyAccumulator(N, M, B)
    acc.fold(tick_events(rng, 0))
    c = acc.counts()
    args = [torch.from_numpy(c[f].astype(dt)) for f, dt in (
        ("inv_buckets", np.int32), ("inv_lat_ms", np.float32),
        ("inv_outcomes", np.int32))]
    step = TA.make_anomaly_step(*CFG)
    state = TA.init_anomaly(N, B, device="cpu")

    def refuse(*a, **k):
        raise AssertionError("the anomaly step read a tensor value")
    for name in ("item", "tolist", "__bool__", "__int__", "__float__",
                 "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    state, scores = step(state, *args)
    monkeypatch.undo()
    assert scores.shape == (TA.N_SCORE_ROWS, N)


def _engine(pkg):
    rules = pkg.build_rules({"straggler": {"for_s": 5}})
    return pkg.AlertEngine(rules, log_size=8)


def test_alert_engine_transitions_match_jax():
    """The same signal sequence through both engines: every transition,
    the transition counts, the active set and the firing counts equal
    (the log ring wraps: 8 rows)."""
    rng = np.random.RandomState(5)
    engines = [_engine(JP), _engine(TP)]
    seen = [[], []]
    for k, e in enumerate(engines):
        e.listeners.append(lambda *a, k=k: seen[k].append(a[1:]))
    for step in range(40):
        now = 100.0 + 2.0 * step
        sig = {
            "straggler": [((("invoker", f"invoker{i}"),),
                           float(rng.choice([0.5, 4.0, 9.0])))
                          for i in range(4) if rng.rand() < 0.7],
            "slo_fast_burn": [((), float(rng.choice([0.0, 20.0])))],
            "recompile_churn": [((), float(rng.choice([0.0, 0.0, 2.0])))],
        }
        for e in engines:
            e.evaluate(now, sig)
        assert engines[1].active(now) == engines[0].active(now)
    strip = [[{k: v for k, v in row.items() if k != "ts"}
              for row in e.log.last(8)] for e in engines]
    assert strip[1] == strip[0] and len(strip[0]) == 8
    assert engines[1].log.evicted == engines[0].log.evicted > 0
    assert engines[1].transition_counts == engines[0].transition_counts
    assert engines[1].firing_counts() == engines[0].firing_counts()
    assert [(r.name, labels, old, new, v) for r, labels, old, new, v
            in seen[1]] == [(r.name, labels, old, new, v)
                            for r, labels, old, new, v in seen[0]]


def test_rules_from_env_match_jax(monkeypatch):
    monkeypatch.setenv(
        "CONFIG_whisk_alerts_rules",
        '{"straggler": {"threshold": 1.5, "forS": 2, "severity": '
        '"critical"}, "timeout_spike": {"enabled": false}, '
        '"my_burn": {"signal": "burn_rate_1m", "threshold": 2.5}}')
    monkeypatch.setenv("CONFIG_whisk_anomaly_zThreshold", "2.0")
    ref, port = JP.AnomalyPlane.from_config(), TP.AnomalyPlane.from_config()
    assert port.config == TP.AnomalyConfig(**vars(ref.config))
    assert port.alerts_report() == ref.alerts_report()
    assert {n: r.to_json() for n, r in port.engine.rules.items()} == \
        {n: r.to_json() for n, r in ref.engine.rules.items()}


def _planes(hint_unhealthy=False):
    """(JAX, port) anomaly planes over device telemetry accumulators,
    straggler rule firing at once."""
    out = []
    for tp_mod, an_mod in ((JTP, JP), (TTP, TP)):
        tp = tp_mod.TelemetryPlane(tp_mod.TelemetryConfig(
            namespaces=M, shared_namespace_buckets=2))
        if tp_mod is TTP:
            tp.use_device(N, "cpu")
        else:
            tp.use_device(N)
        plane = an_mod.AnomalyPlane(
            an_mod.AnomalyConfig(hint_unhealthy=hint_unhealthy),
            an_mod.AlertsConfig(rules={"straggler": {"for_s": 0},
                                       "error_spike": {"for_s": 0}}))
        plane.attach(telemetry=tp, invoker_names=lambda: [
            f"invoker{i}" for i in range(N)])
        out.append((tp, plane))
    return out


def _drive(planes, ticks, seed=3):
    rng = np.random.RandomState(seed)
    t0 = 5000.0
    for tick in range(ticks):
        ev = tick_events(rng, tick)
        for tp, _ in planes:
            for col in ev[:, ev[4] == 1].T:
                tp.observe(int(col[0]), f"ns{col[1]}", col[2] / 1000.0,
                           int(col[3]))
            tp.device_fold()
        for tp, plane in planes:
            plane.tick(now=t0 + tick)


def _masked_anomalies(rep):
    rows = []
    for r in rep["invokers"]:
        r = dict(r)
        scores = [r.pop(k) for k in ("straggler_score", "error_spike_score",
                                     "timeout_spike_score",
                                     "ewma_latency_ms")]
        rows.append((r, scores))
    rep = dict(rep, invokers=None)
    rep["fleet"] = dict(rep["fleet"], median_ewma_ms=None)
    return rep, rows


def test_device_plane_harvests_a_tick_late_like_jax():
    """Both planes on device accumulators: the first tick harvests
    nothing, every later tick harvests the previous one; scores, flags,
    the alert log and both reports agree."""
    (jtp, jplane), (ttp, tplane) = planes = _planes()
    _drive(planes, 1)
    assert jplane._scores is None and tplane._scores is None
    assert tplane.device_ticks == 1 and tplane.harvested == 0
    _drive(planes, 14, seed=4)
    assert tplane.device_ticks == 15 and tplane.harvested == 14
    assert tplane.step_failures == 0
    assert_scores(tplane._scores, jplane._scores)
    strip = [[{k: v for k, v in row.items() if k not in ("ts", "value")}
              for row in p.engine.log.last(256)] for p in (jplane, tplane)]
    assert strip[1] == strip[0] and strip[0]
    jrep, trep = jplane.anomalies_report(), tplane.anomalies_report()
    (jmeta, jrows), (tmeta, trows) = (_masked_anomalies(jrep),
                                      _masked_anomalies(trep))
    assert tmeta == jmeta and tmeta["kernel"] == "device"
    assert [r for r, _ in trows] == [r for r, _ in jrows]
    np.testing.assert_allclose([s for _, s in trows], [s for _, s in jrows],
                               rtol=1e-4, atol=1e-4)  # rounded to 4 places
    assert tplane.alerts_report()["rules"] == jplane.alerts_report()["rules"]
    assert tplane.hints == jplane.hints and tplane.hints


def test_carry_grows_on_the_device():
    """The invoker axis grows between ticks: the port pads its carry on
    the device, the estimates survive, and the next ticks agree with the
    JAX plane's, which pads its own."""
    planes = _planes()
    _drive(planes, 4)
    for tp, _ in planes:
        tp.accumulator.ensure_invokers(2 * N)
    _drive(planes, 3, seed=9)
    (_, jplane), (_, tplane) = planes
    st = tplane._state
    assert isinstance(st.ewma_ms, torch.Tensor)
    assert st.prev_buckets.shape == (2 * N, B)
    for f in TA.AnomalyState._fields:
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(jplane._state, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    assert tplane._scores.shape == (TA.N_SCORE_ROWS, 2 * N)
    assert_scores(tplane._scores, jplane._scores)


@pytest.mark.parametrize("hint_unhealthy", [True, False])
def test_hints_reach_the_pool_only_with_hint_unhealthy(hint_unhealthy):
    """A firing straggler alert becomes an advisory hint on the invoker
    pool in both packages, only when `hintUnhealthy` is set; the pool's
    status derivation never reads it."""
    planes = _planes(hint_unhealthy)
    pools = []
    for (tp, plane), sup, ent, mem in ((planes[0], JS, JE, JM),
                                       (planes[1], TS, TE, TM)):
        pool = sup.InvokerPool(mem.MemoryMessagingProvider())
        for i in range(N):
            pool.on_ping(ent.InvokerInstanceId(i, user_memory=ent.MB(512)))
        plane.hint_sink = pool.set_unhealthy_hints
        pools.append(pool)
    _drive(planes, 12)
    jh, th = ([h.to_json() for h in p.health()] for p in pools)
    jh, th = list(jh), list(th)
    assert th == jh
    hinted = {r["invoker"]: r.get("unhealthyHint") for r in th
              if "unhealthyHint" in r}
    if hint_unhealthy:
        assert set(hinted) >= {f"invoker{i}" for i in SLOW}
        assert set(hinted.values()) <= {"straggler", "error_spike"}
    else:
        assert hinted == {}
    assert {r["status"] for r in th} == {"up"}
    assert planes[1][1].hints == planes[0][1].hints != {}


def test_disabled_plane_is_inert():
    tp = TTP.TelemetryPlane(TTP.TelemetryConfig(namespaces=M,
                                                shared_namespace_buckets=2))
    tp.use_device(N, "cpu")
    plane = TP.AnomalyPlane(TP.AnomalyConfig(enabled=False))
    plane.attach(telemetry=tp)
    tp.observe(0, "ns", 500.0, 0)
    assert plane.tick() == {}
    plane.maybe_tick()
    assert plane._state is None and plane._scores is None
    assert plane.prometheus_text() == ""
    assert plane.alerts_report() == {"enabled": False}
    assert plane.anomalies_report() == {"enabled": False}


def test_a_failing_step_is_counted():
    _, (tp, plane) = _planes()
    tp.observe(0, "ns", 5.0, 0)
    tp.device_fold()

    def broken(*a):
        raise RuntimeError("device lost")
    plane._step = broken
    plane.tick()
    assert plane.step_failures == 1 and plane.device_ticks == 0
