"""The port's host planes against the JAX package's: the host observatory,
the placement flight recorder, the tail-sampled trace store and the
incident recorder.

Each test builds its own plane objects (or resets a process-wide one and
restores it), uninstalls what it installs, and sleeps no longer than the
lag probe's 20 ms tick. Comparisons are exact: counts, bytes, JSON fields
and keep/drop verdicts (tolerance: none; clocks and timings are left out).
"""
import asyncio
import gc
import threading

import numpy as np
import pytest

from openwhisk_tpu.controller.loadbalancer import flight_recorder as JFR
from openwhisk_tpu.messaging import columnar as JCOL
from openwhisk_tpu.messaging import connector as JCN
from openwhisk_tpu.utils import blackbox as JBB
from openwhisk_tpu.utils import hostprof as JHP
from openwhisk_tpu.utils import tracestore as JTS
from openwhisk_tpu_torch.controller.loadbalancer import \
    flight_recorder as TFR
from openwhisk_tpu_torch.messaging import columnar as TCOL
from openwhisk_tpu_torch.messaging import connector as TCN
from openwhisk_tpu_torch.utils import blackbox as TBB
from openwhisk_tpu_torch.utils import eventlog as TEL
from openwhisk_tpu_torch.utils import hostprof as THP
from openwhisk_tpu_torch.utils import tracestore as TTS
from test_torch_messaging import JAX_PKG, PORT_PKG, build

SIDES = {"jax": (JAX_PKG, JCN, JCOL, JHP), "port": (PORT_PKG, TCN, TCOL, THP)}


def _sampler_threads():
    return [t for t in threading.enumerate() if t.name == "hostprof-sampler"]


# -- the host observatory ----------------------------------------------------
def test_disabled_observatory_installs_nothing():
    """CONFIG_whisk_hostProfiling_enabled=false: install() refuses and
    leaves the loop's task factory, gc.callbacks and the threads as they
    were; the snapshot and the exposition are empty."""
    obs = THP.HostObservatory(THP.HostProfilingConfig(enabled=False))

    async def go():
        loop = asyncio.get_event_loop()
        factory, callbacks = loop.get_task_factory(), list(gc.callbacks)
        threads = set(threading.enumerate())
        assert obs.install() is False
        assert loop.get_task_factory() is factory
        assert gc.callbacks == callbacks
        assert set(threading.enumerate()) == threads
        assert not obs.sampler_running and not obs.installed
        assert obs.snapshot() == {"enabled": False}
        assert obs.prometheus_text() == ""

    asyncio.run(go())


def test_env_switch_reads_through_the_port_config(monkeypatch):
    monkeypatch.setenv("CONFIG_whisk_hostProfiling_enabled", "false")
    assert THP.HostObservatory.from_config().enabled is False
    monkeypatch.setenv("CONFIG_whisk_hostProfiling_enabled", "true")
    monkeypatch.setenv("CONFIG_whisk_hostProfiling_stallThresholdMs", "75")
    obs = THP.HostObservatory.from_config()
    assert obs.enabled and obs.config.stall_threshold_ms == 75.0


@pytest.mark.parametrize("sample_hz", [0.0, 23.0])
def test_uninstall_restores_the_loop(sample_hz):
    """install() swaps the task factory, adds one gc callback and (with a
    sample rate) starts the sampler thread; uninstall() puts back exactly
    what was there and stops the thread."""
    obs = THP.HostObservatory(THP.HostProfilingConfig(sample_hz=sample_hz))

    async def go():
        loop = asyncio.get_event_loop()
        factory, callbacks = loop.get_task_factory(), list(gc.callbacks)
        sampler0 = len(_sampler_threads())
        assert obs.install() is True
        try:
            assert loop.get_task_factory() is not factory
            assert len(gc.callbacks) == len(callbacks) + 1
            assert obs.sampler_running == (sample_hz > 0)
            assert len(_sampler_threads()) == sampler0 + (sample_hz > 0)
            # wrapped tasks keep their results
            assert await asyncio.ensure_future(asyncio.sleep(0, 7)) == 7
            await asyncio.sleep(0.02)
        finally:
            obs.uninstall()
        assert loop.get_task_factory() is factory
        assert gc.callbacks == callbacks
        assert not obs.sampler_running and not obs.installed
        for t in _sampler_threads():
            t.join(timeout=2.0)
        assert len(_sampler_threads()) == sampler0
        snap = obs.snapshot()
        assert snap["tasks"]["created"] >= 1 and snap["loop_lag"]["ticks"] >= 1

    asyncio.run(go())


@pytest.fixture
def serde_counting():
    """Both packages' process-wide observatories counting serde from zero;
    restored afterwards."""
    saved = [(m.GLOBAL_HOST_OBSERVATORY, m.GLOBAL_HOST_OBSERVATORY.enabled)
             for m in (JHP, THP)]
    for obs, _ in saved:
        obs.enabled = True
        obs.reset()
    yield
    for obs, was in saved:
        obs.reset()
        obs.enabled = was


def _serde_rows(hp):
    return {(r["hop"], r["direction"]): (r["count"], r["bytes"])
            for r in hp.GLOBAL_HOST_OBSERVATORY.snapshot()["serde"]}


def _drive_serde(side, seed):
    """Encode and decode seeded messages and frames through the connector
    helpers: the per-message hops, one activation frame, one lazy ack frame
    and a read of one lazily shipped result."""
    pkg, cn, col, _ = side
    msgs = [build(pkg, kind, seed + k) for k, kind in enumerate(
        ("activation", "completion", "combined", "result", "ping"))]
    for m in msgs:
        raw = cn.encode_message(m)
        assert raw == m.serialize()
        if m.__class__.__name__ == "ActivationMessage":
            cn.decode_message(pkg.M.ActivationMessage.parse, raw,
                              "activation")
        elif m.__class__.__name__ != "PingMessage":
            cn.decode_message(pkg.M.parse_ack, raw, "completion_ack")
    acts = [build(pkg, "activation", seed + 10 + k) for k in range(4)]
    payload, _ = cn.encode_batch(col.KIND_ACTIVATION, acts)
    assert cn.decode_batch(payload)[0] == col.KIND_ACTIVATION
    acks = [build(pkg, "combined", seed + 20 + k) for k in range(3)]
    payload, _ = cn.encode_batch(col.KIND_ACK, acks, lazy_results=True)
    _kind, back = cn.decode_batch(payload)
    assert back[0].activation.response is not None  # one result read
    assert cn.hop_of(msgs[0]) == "activation"
    assert cn.hop_of(msgs[4]) == "health_ping"


@pytest.mark.parametrize("seed", range(3))
def test_serde_counters_by_hop_match_the_jax_package(seed, serde_counting):
    for side in SIDES.values():
        _drive_serde(side, seed)
    port, jax = _serde_rows(THP), _serde_rows(JHP)
    assert port == jax
    assert port[("activation", "serialize")][0] == 2
    assert port[("completion_ack", "deserialize")][0] == 4
    assert port[("ack_result", "deserialize")][0] == 1
    assert ("health_ping", "serialize") in port


def test_disabled_serde_helpers_count_nothing(serde_counting):
    THP.GLOBAL_HOST_OBSERVATORY.enabled = False
    _drive_serde(SIDES["port"], 0)
    assert THP.GLOBAL_HOST_OBSERVATORY.snapshot() == {"enabled": False}
    THP.GLOBAL_HOST_OBSERVATORY.enabled = True
    assert _serde_rows(THP) == {}


# -- the flight recorder -----------------------------------------------------
def _records(fr_mod, seed):
    """A scripted sequence of batch records: 40 batches of 1-6 decisions
    into a ring of 16, through one package's recorder."""
    rng = np.random.RandomState(seed)
    fr = fr_mod.FlightRecorder(size=16)
    aids = []
    for b in range(40):
        free = rng.randint(0, 4097, 32)
        rec = fr_mod.BatchRecord(digest={
            "kernel": "repair", "healthy_invokers": 30 + b % 3,
            "queue_depth": int(rng.randint(1, 64)), "oldest_age_ms": 1.5,
            "free_slot_hist": fr_mod.free_slot_histogram(free, 128)})
        for k in range(int(rng.randint(1, 7))):
            aid = f"{b:04x}{k:028x}"
            aids.append(aid)
            ci = int(rng.randint(-2, 32))
            rec.decisions.append((aid, f"ns/act{k}", ci,
                                  f"invoker{ci}" if ci >= 0 else None,
                                  bool(rng.rand() < 0.2), ci == -2,
                                  int(rng.choice([128, 256]))))
        fr.record(rec)
    return fr, aids


def _mask(rec):
    rec = dict(rec)
    rec.pop("ts", None)
    return rec


@pytest.mark.parametrize("seed", range(2))
def test_flight_recorder_records_and_explain_match(seed):
    port, aids = _records(TFR, seed)
    jax, _ = _records(JFR, seed)
    assert (len(port), port.dropped, port.size) == \
        (len(jax), jax.dropped, jax.size)
    assert [_mask(r) for r in port.recent(16, with_decisions=True)] == \
        [_mask(r) for r in jax.recent(16, with_decisions=True)]
    for aid in aids:
        p, j = port.explain(aid), jax.explain(aid)
        assert (p is None) == (j is None)
        if p is not None:
            assert p["decision"] == j["decision"]
            assert _mask(p["batch"]) == _mask(j["batch"])
    assert port.explain(aids[0]) is None  # wrapped past
    assert TFR.occupancy_json("repair", [("invoker0", True, 2048, 512,
                                          1536)]) == \
        JFR.occupancy_json("repair", [("invoker0", True, 2048, 512, 1536)])


# -- the trace store ---------------------------------------------------------
def _verdicts(ts_mod, seed):
    """One scripted tail-sampling run through a fresh store: spans for
    60 traces, marks on some, completions with errors, timeouts, slow and
    fast e2e times; returns the kept summaries and the counters."""
    rng = np.random.RandomState(seed)
    store = ts_mod.TraceStore(ts_mod.TraceTailConfig(keep_floor=0.1,
                                                     keep_ring=32))
    store.default_threshold_ms = 250.0
    for t in range(60):
        tid = f"{seed:08x}{t:024x}"
        for s in range(int(rng.randint(1, 4))):
            store.emit(ts_mod.synthetic_span(
                tid, f"stage{s}", 100.0 + t + s / 10, 100.0 + t + s / 5,
                tags={"proc": "controller0"}))
        if t % 7 == 0:
            store.mark(tid, "forced")
        e2e = float(rng.choice([5.0, 40.0, 400.0]))
        store.complete(f"aid{t}", tid if t % 9 else None, e2e,
                       error=bool(t % 11 == 0), timeout=bool(t % 13 == 0))
    kept = [{k: v for k, v in e.items() if k != "ts"} for e in store.list(n=64)]
    return kept, store.stats(), store.get(f"{seed:08x}{0:024x}")


@pytest.mark.parametrize("seed", range(2))
def test_trace_store_sampling_and_completion_match(seed):
    port = _verdicts(TTS, seed)
    jax = _verdicts(JTS, seed)
    assert port[0] == jax[0]
    for k in ("kept", "kept_total", "dropped_total", "seen", "pending",
              "pending_evicted", "tail_threshold_ms"):
        assert port[1][k] == jax[1][k], k
    assert port[0] and port[1]["dropped_total"] > 0
    assert set(port[1]["kept_total"]) >= {"error", "timeout", "slow"}
    assert (port[2] is None) == (jax[2] is None)


def test_trace_store_off_switch_touches_nothing(monkeypatch):
    monkeypatch.setenv("CONFIG_whisk_tracing_tail_enabled", "false")
    store = TTS.TraceStore()
    tracer = TTS.Tracer()
    reporter = tracer.reporter
    store.attach(tracer)
    assert tracer.reporter is reporter and not store.active
    assert store.complete("a", "t", 1e6, error=True) is None


# -- the incident recorder ---------------------------------------------------
@pytest.mark.parametrize("side", ["jax", "port"])
def test_incident_recorder_arms_only_when_enabled(side, tmp_path,
                                                  monkeypatch):
    bb = JBB if side == "jax" else TBB
    monkeypatch.delenv("CONFIG_whisk_incidents_enabled", raising=False)
    assert bb.IncidentRecorder().install() is False
    off = bb.IncidentRecorder(bb.IncidentConfig(enabled=False,
                                                directory=str(tmp_path)))
    assert off.install() is False and off.stats()["installed"] is False
    on = bb.IncidentRecorder(bb.IncidentConfig(enabled=True,
                                               directory=str(tmp_path)))
    owner, other = object(), object()
    try:
        assert on.install(owner=owner) is True
        assert on.install(owner=other) is False
        on.uninstall(owner=other)
        assert on.stats()["installed"] is True
    finally:
        on.uninstall(owner=owner)
    assert on.stats()["installed"] is False


def test_port_recorder_restores_the_event_log(tmp_path):
    rec = TBB.IncidentRecorder(TBB.IncidentConfig(enabled=True,
                                                  directory=str(tmp_path)))
    log = TEL.GLOBAL_EVENT_LOG
    was = log.enabled
    log.enabled = False
    try:
        assert rec.install() is True and log.enabled is True
        rec.uninstall()
        assert log.enabled is False
    finally:
        rec.uninstall()
        log.enabled = was
