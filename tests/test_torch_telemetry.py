"""The port's completion telemetry against the JAX package's.

`record_packed` (ops/telemetry.py) against the JAX program
`make_record_packed` (run on the CPU, as tests/test_telemetry.py runs it)
and against the NumPy twin, on seeded event matrices with duplicate
invoker and namespace indices, padding rows and latencies past the last
bound and past int32; growth of the invoker axis; the telemetry plane's
shared namespace tail, `slo_report`, `raw_counts` and `prometheus_text`
against the JAX plane fed the same events.

Tolerances: integer arrays exact; the float32 latency sums within
rtol=1e-6 of the JAX program's (both packages add them in index order on
the CPU) and within rtol=1e-5 of the NumPy twin's float64 sums (float32
accumulation of up to 8,192 samples of up to 2^31 us); JSON and
exposition text equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from openwhisk_tpu.controller.loadbalancer import telemetry as JP  # noqa: E402
from openwhisk_tpu.ops import telemetry as JT  # noqa: E402
from openwhisk_tpu_torch.controller.loadbalancer import \
    telemetry as TP  # noqa: E402
from openwhisk_tpu_torch.ops import telemetry as TT  # noqa: E402

N_INV, N_NS, N_BUCKETS = 64, 16, 24
#: latencies (us) on and around the bounds, past the last finite bound
#: and at the int32 saturation point
EDGE_US = [0, 1, 999, 1000, 1001, 2000, 4000, 4001, 2 ** 21 * 1000,
           2 ** 22 * 1000 - 1, 10 ** 9, 2 ** 31 - 1]


def events(rng, e, n_inv=N_INV, n_ns=N_NS, fill=0.75):
    """A seeded int32[5, e] event matrix: the first `fill` of the columns
    valid, the rest padding; duplicate invoker and namespace indices."""
    ev = np.zeros((5, e), np.int32)
    k = max(1, int(e * fill))
    ev[0, :k] = rng.randint(0, min(n_inv, 12), k)  # few invokers: dups
    ev[1, :k] = rng.randint(0, n_ns, k)
    lat = rng.lognormal(2.0, 1.5, k) * 1000
    edge = rng.rand(k) < 0.25
    lat[edge] = rng.choice(EDGE_US, int(edge.sum()))
    ev[2, :k] = np.minimum(lat, 2 ** 31 - 1).astype(np.int64)
    ev[3, :k] = rng.randint(0, 3, k)
    ev[4, :k] = 1
    # padding rows carry garbage indices and latencies: they must add 0
    ev[0, k:] = rng.randint(0, n_inv, e - k)
    ev[2, k:] = rng.randint(0, 10 ** 6, e - k)
    return ev


def assert_counts_equal(port, ref, rtol=1e-6):
    assert set(port) == set(ref)
    for f in ref:
        p, r = np.asarray(port[f]), np.asarray(ref[f])
        assert p.shape == r.shape, f
        if r.dtype.kind == "f":
            np.testing.assert_allclose(p, r, rtol=rtol, err_msg=f)
        else:
            np.testing.assert_array_equal(p, r, err_msg=f)


@pytest.mark.parametrize("e", [8, 64, 4096])
def test_record_packed_matches_jax_and_numpy(e):
    rng = np.random.RandomState(100 + e)
    ev = events(rng, e)
    port = TT.DeviceLatencyAccumulator(N_INV, N_NS, N_BUCKETS, device="cpu")
    ref = JT.DeviceLatencyAccumulator(N_INV, N_NS, N_BUCKETS)
    twin = TT.NumpyLatencyAccumulator(N_INV, N_NS, N_BUCKETS)
    for acc in (port, ref, twin):
        acc.fold(ev)
        acc.fold(ev[:, ::-1].copy())  # same rows, other order
    pc = port.counts()
    assert_counts_equal(pc, ref.counts())
    for f, v in pc.items():  # same dtypes as the JAX arrays
        assert v.dtype == np.asarray(ref.counts()[f]).dtype, f
    assert_counts_equal(pc, twin.counts(), rtol=1e-5)
    assert pc["inv_buckets"].sum() == 2 * ev[4].sum()
    assert port.folds == 2


@pytest.mark.parametrize("n_buckets", [2, 8, 23, 24, 40])
def test_bucket_math_matches_jax(n_buckets):
    assert TT.bucket_bounds_ms(n_buckets) == JT.bucket_bounds_ms(n_buckets)
    np.testing.assert_array_equal(TT._bounds_us(n_buckets),
                                  JT._bounds_us(n_buckets))
    np.testing.assert_array_equal(
        TT.DeviceLatencyAccumulator(1, 1, n_buckets, device="cpu")
        .bounds.numpy(),
        JT._bounds_us(n_buckets).astype(np.int32))
    np.testing.assert_array_equal(TT.bucket_of_us(EDGE_US, n_buckets),
                                  JT.bucket_of_us(EDGE_US, n_buckets))


def test_growth_on_the_device_preserves_counts():
    """The invoker axis grows to the next power of two without a host
    round trip; counts folded before and after match the JAX accumulator
    (which grows through the host) row for row."""
    rng = np.random.RandomState(7)
    port = TT.DeviceLatencyAccumulator(2, N_NS, N_BUCKETS, device="cpu")
    ref = JT.DeviceLatencyAccumulator(2, N_NS, N_BUCKETS)
    small = events(rng, 64, n_inv=2)
    for acc in (port, ref):
        acc.fold(small)
    big = events(rng, 64, n_inv=40)
    big[0, :8] = 37  # forces growth to 64 rows at fold time
    for acc in (port, ref):
        acc.fold(big)
    assert port.n_invokers == ref.n_invokers == 64
    assert_counts_equal(port.counts(), ref.counts())
    port.ensure_invokers(65)
    c = port.counts()
    assert c["inv_buckets"].shape == (128, N_BUCKETS)
    assert c["inv_buckets"][64:].sum() == 0
    assert c["inv_buckets"].sum() == small[4].sum() + big[4].sum()


def test_fold_leaves_the_old_state_as_it_was():
    """A fold returns a new state: a reader holding the previous one keeps
    a consistent snapshot while folds go on."""
    rng = np.random.RandomState(3)
    acc = TT.DeviceLatencyAccumulator(N_INV, N_NS, N_BUCKETS, device="cpu")
    acc.fold(events(rng, 64))
    held = acc.state
    before = {f: getattr(held, f).clone() for f in TT.TelemetryState._fields}
    acc.fold(events(rng, 64))
    acc.ensure_invokers(200)
    for f in TT.TelemetryState._fields:
        assert torch.equal(getattr(held, f), before[f]), f
        assert getattr(acc.state, f) is not getattr(held, f), f


def _planes(**slo):
    cfg = dict(buckets=N_BUCKETS, namespaces=8, shared_namespace_buckets=2)
    ref = JP.TelemetryPlane(JP.TelemetryConfig(**cfg), JP.SloConfig(**slo))
    port = TP.TelemetryPlane(TP.TelemetryConfig(**cfg), TP.SloConfig(**slo))
    ref.use_device(4)
    port.use_device(4, "cpu")
    return ref, port


def test_shared_namespace_tail_matches_jax():
    ref, port = _planes()
    names = [f"ns{i}" for i in range(40)]
    assert [port._ns_slot(n) for n in names] == [ref._ns_slot(n)
                                                 for n in names]
    assert [port._ns_label(s) for s in range(8)] == [ref._ns_label(s)
                                                     for s in range(8)]


@pytest.mark.parametrize("seed", [0, 1])
def test_slo_report_and_exposition_match_jax(seed):
    """The same completions through both planes (device accumulators,
    folds on the same cadence): `slo_report`, `raw_counts` and the
    Prometheus text are equal, per-namespace overrides and the shared
    namespace tail included."""
    rng = np.random.RandomState(seed)
    ref, port = _planes(e2e_p99_ms=16.0, error_ratio=0.05,
                        overrides={"ns1": {"e2eP99Ms": 2.0}})
    names = [f"invoker{i}" for i in range(20)]
    for wave in range(6):
        for _ in range(int(rng.randint(20, 90))):
            inv = int(rng.randint(0, 20))
            ns = f"ns{int(rng.randint(0, 11))}"
            lat = float(rng.choice([0.4, 3.0, 7.9, 40.0, 5000.0, 1e7]))
            out = int(rng.choice([0, 0, 0, 1, 2]))
            for plane in (ref, port):
                plane.observe(inv, ns, lat, out)
        if wave % 2:
            for plane in (ref, port):
                plane.device_fold(max_events=64)
    assert port.pending == ref.pending > 0  # counts() drains the rest
    assert port.slo_report(names) == ref.slo_report(names)
    # `identity` is each package's process-wide declared identity (set by
    # whichever controller a process ran), not part of the plane
    port_raw, ref_raw = port.raw_counts(names), ref.raw_counts(names)
    assert set(port_raw.pop("identity")) == set(ref_raw.pop("identity"))
    assert port_raw == ref_raw
    assert port.prometheus_text(names) == ref.prometheus_text(names)
    assert port.prometheus_text(names, openmetrics=True) == \
        ref.prometheus_text(names, openmetrics=True)
    assert port.pending == ref.pending == 0
    assert port.SYNCS_DEVICE and ref.SYNCS_DEVICE


def test_burn_rates_match_jax():
    ref, port = _planes(error_ratio=0.1)
    t0 = 1000.0
    for plane in (ref, port):
        plane._snapshots = [(t0, 0, 0)]
        for k in range(100):
            plane.observe(k % 3, "ns", 1.0, 1 if k % 10 == 0 else 0)
    assert port.tick(now=t0 + 2.0) == ref.tick(now=t0 + 2.0)
    for plane in (ref, port):
        for _ in range(100):
            plane.observe(0, "ns", 1.0, 0)
    assert port.tick(now=t0 + 100.0) == ref.tick(now=t0 + 100.0)
    assert port.error_budget_remaining() == ref.error_budget_remaining()


def test_disabled_plane_is_inert(monkeypatch):
    monkeypatch.setenv("CONFIG_whisk_telemetry_enabled", "false")
    tp = TP.TelemetryPlane.from_config()
    tp.use_device(4, "cpu")
    assert tp.accumulator.kernel == "cpu"  # never swapped in
    tp.observe(0, "ns", 1.0, TT.OUTCOME_SUCCESS)
    assert tp.prometheus_text() == ""
    assert tp.slo_report() == {"enabled": False}
    assert tp.raw_counts() == {"enabled": False}
    assert tp.tick() == {}
    assert tp.device_fold() is False
