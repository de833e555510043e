"""The device planes inside the port's TpuBalancer, against the JAX
package's TpuBalancer on the CPU.

  (a) one seeded run of the front's parity scenario (registration pings,
      `publish_many` waves, a trickle, acks from the scenario's fleet)
      through the JAX balancer, the port with its planes at their defaults
      and the port with all three planes off: every decision identical;
      the telemetry counts that do not depend on the clock (outcomes per
      invoker and per namespace, completions per row) equal the JAX
      balancer's exactly; the port's bucket counts and latency sums equal
      the NumPy twin fed the port's own observations, and its
      `/admin/slo` report equals the JAX plane's on those observations;
      `kernel_profile()["compiles"]` equals the JAX balancer's;
  (b) the supervision tick runs the fold, the burn rates, the anomaly step
      (harvested a tick later) and the HBM watermarks;
  (c) an alert that fires arms the incident recorder in both packages;
  (c') the fleet grows on the loop while a scrape thread is inside a fold:
      every event still lands in its own invoker's row;
  (d) importing the port's planes pulls in neither jax nor the JAX
      package (a fresh interpreter).

Tolerances: decisions, counts and JSON exact; latency sums within
rtol=1e-6 of the twin's float64 sums. Every run bounds itself.
"""
import asyncio
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from openwhisk_tpu.controller.loadbalancer import \
    telemetry as JTP  # noqa: E402
from openwhisk_tpu_torch.controller.loadbalancer import \
    telemetry as TTP  # noqa: E402
from test_torch_balancer_front import (RATE, _jax_package,  # noqa: E402
                                       _port_package, _scenario, run)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANES_OFF = {"CONFIG_whisk_telemetry_enabled": "false",
              "CONFIG_whisk_anomaly_enabled": "false",
              "CONFIG_whisk_profiling_enabled": "false"}


def _observing(events):
    """A scenario `setup` that records every completion the balancer's
    telemetry plane observes (invoker, namespace, latency, outcome)."""
    def setup(bal):
        tp = bal.telemetry
        real = tp.observe

        def observe(inv, ns, lat_ms, outcome):
            if tp.enabled and inv >= 0:
                events.append((inv, ns, lat_ms, outcome))
            return real(inv, ns, lat_ms, outcome)
        tp.observe = observe
    return setup


def _inspect(bal):
    names = bal._telemetry_invoker_names()
    counts = bal.telemetry.counts() if bal.telemetry.enabled else None
    return dict(counts=counts, names=names,
                slo=bal.telemetry.slo_report(names),
                profile=bal.kernel_profile(),
                pending=bal.telemetry.pending)


def _replay(events, plane_mod, names, **slo):
    """The observations through a fresh plane of `plane_mod` with the
    NumPy accumulator: the oracle for the clock-dependent counts."""
    tp = plane_mod.TelemetryPlane(plane_mod.TelemetryConfig(),
                                  plane_mod.SloConfig(**slo))
    for ev in events:
        tp.observe(*ev)
    return tp, tp.slo_report(names)


def _rows(counts, n):
    return {f: np.asarray(v)[:n] if f.startswith("inv_") else np.asarray(v)
            for f, v in counts.items()}


@pytest.mark.parametrize("rate,grow", [(None, True), (RATE, False)],
                         ids=["grow", "rate"])
def test_planes_keep_every_decision_and_match_jax(rate, grow, monkeypatch):
    seed = 57 + (rate or 0) + 5 * grow
    jax_pkg, port_pkg = _jax_package(), _port_package()
    for pkg in (jax_pkg, port_pkg):  # deployments opt in to max_conc > 1
        monkeypatch.setattr(pkg.E.ConcurrencyLimit, "MAX", 16)
    port_events, jax_events = [], []
    port = run(_scenario(port_pkg, rate, grow, seed,
                         setup=_observing(port_events), inspect=_inspect), 90)
    ref = run(_scenario(jax_pkg, rate, grow, seed,
                        setup=_observing(jax_events), inspect=_inspect), 90)
    with monkeypatch.context() as mp:
        for k, v in PLANES_OFF.items():
            mp.setenv(k, v)
        off = run(_scenario(port_pkg, rate, grow, seed, inspect=_inspect), 90)
    # (a) the planes change no decision, and the port places as JAX does
    assert port["decisions"] == ref["decisions"] == off["decisions"]
    for k in ("free", "conc", "health"):
        np.testing.assert_array_equal(port[k], off[k], err_msg=k)
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    pi, ji, oi = port["inspect"], ref["inspect"], off["inspect"]
    assert oi["counts"] is None and oi["profile"]["compiles"] == {
        "expected": 0, "unexpected": 0, "log": []}
    # every acked activation was observed once, in the same order
    placed = sum(1 for inv, _ in port["decisions"].values() if inv >= 0)
    assert len(port_events) == len(jax_events) == placed
    assert [e[:2] + e[3:] for e in port_events] == \
        [e[:2] + e[3:] for e in jax_events]
    n = port["n"]
    pc, jc = _rows(pi["counts"], n), _rows(ji["counts"], n)
    for f in ("inv_outcomes", "ns_outcomes"):
        np.testing.assert_array_equal(pc[f], jc[f], err_msg=f)
    for f in ("inv_buckets", "ns_buckets"):
        np.testing.assert_array_equal(pc[f].sum(axis=1), jc[f].sum(axis=1),
                                      err_msg=f)
    # the clock-dependent counts: the port's device accumulator equals
    # the NumPy twin fed its own observations
    twin, _ = _replay(port_events, TTP, pi["names"])
    tc = _rows(twin.counts(), n)
    for f in ("inv_buckets", "ns_buckets", "inv_outcomes", "ns_outcomes"):
        np.testing.assert_array_equal(pc[f], tc[f], err_msg=f)
    for f in ("inv_lat_ms", "ns_lat_ms"):
        np.testing.assert_allclose(pc[f], tc[f], rtol=1e-6, err_msg=f)
    # /admin/slo: the port's report is the JAX plane's on the same events
    _, jslo = _replay(port_events, JTP, pi["names"])
    pslo = dict(pi["slo"])
    assert pslo.pop("kernel") == "device" and jslo.pop("kernel") == "cpu"
    assert pslo == jslo
    assert pi["slo"]["global"]["count"] == placed
    assert pi["pending"] == 0
    # the signature census: same entries, same classification
    strip = [[(e["entry"], e["signature"], e["expected"], e["reason"])
              for e in d["profile"]["compiles"]["log"]] for d in (pi, ji)]
    assert strip[0] == strip[1] and strip[0]
    for k in ("expected", "unexpected"):
        assert pi["profile"]["compiles"][k] == ji["profile"]["compiles"][k]
    assert pi["profile"]["compiles"]["unexpected"] == 0
    assert pi["profile"]["cache_census"] == ji["profile"]["cache_census"]


def _make(pkg, provider):
    return pkg.make(provider, managed_fraction=1.0, blackbox_fraction=0.0,
                    max_batch=64, initial_pad=8)


async def _ticked(pkg):
    """A balancer with 4 invokers and a few acked activations; the
    supervision tick runs twice."""
    ent, msgs = pkg.E, pkg.Msg
    provider = pkg.Mem.MemoryMessagingProvider()
    bal = _make(pkg, provider)
    bal.supervision.ping_timeout = 3600.0
    await bal.start()
    producer = provider.get_producer()
    for i in range(4):
        await producer.send("health", msgs.PingMessage(
            ent.InvokerInstanceId(i, user_memory=ent.MB(1024))))
    for _ in range(400):
        if len(bal._registry) == 4 and all(bal._healthy):
            break
        await asyncio.sleep(0.005)
    from test_torch_balancer_front import _identity_json
    ident = ent.Identity.from_json(_identity_json(1))
    a = ent.ExecutableWhiskAction(
        ent.EntityPath("ns1"), ent.EntityName("tick"),
        ent.CodeExec(kind="python:3", code="x"),
        limits=ent.ActionLimits(ent.TimeLimit(5000),
                                ent.MemoryLimit(ent.MB(128))))
    a.rev = ent.DocRevision("1-b")
    msg_list = []
    for k in range(12):
        m = msgs.ActivationMessage(
            pkg.Tx.TransactionId(f"k{k}", start_wallclock=1.0),
            a.fully_qualified_name, "1-b", ident,
            ent.ActivationId(f"{k + 1:032x}"), ent.ControllerInstanceId("0"),
            False, {})
        await bal.publish(a, m)
        msg_list.append(m)
    ack_topic = f"completed{ent.ControllerInstanceId('0').as_string}"
    for k, m in enumerate(msg_list):
        inv = bal.activation_slots[m.activation_id.asString].invoker
        await producer.send(ack_topic, msgs.CompletionMessage(
            m.transid, m.activation_id, k % 5 == 0, inv))
    for _ in range(1000):
        if not bal.activation_slots:
            break
        await asyncio.sleep(0.002)
    ticks0 = getattr(bal.anomaly, "device_ticks", 0)
    bal._telemetry_tick()
    bal._telemetry_tick()
    out = dict(
        pending=bal.telemetry.pending,
        ticks=getattr(bal.anomaly, "device_ticks", 0) - ticks0,
        harvested=getattr(bal.anomaly, "harvested", None),
        failures=getattr(bal.anomaly, "step_failures", None),
        scores=None if bal.anomaly._scores is None
        else bal.anomaly._scores.copy(),
        slo=bal.telemetry.slo_report(bal._telemetry_invoker_names()),
        gauges={k: bal.metrics.gauge_value(k) for k in (
            "slo_burn_rate_1m", "slo_error_budget_remaining",
            "loadbalancer_anomaly_stragglers",
            "loadbalancer_alerts_firing_count")},
        text=bal.metrics.prometheus_text())
    await bal.close()
    return out


def test_supervision_tick_runs_the_planes_like_jax():
    port = run(_ticked(_port_package()), 30)
    ref = run(_ticked(_jax_package()), 60)
    assert port["pending"] == ref["pending"] == 0
    assert port["ticks"] == 2 and port["failures"] == 0
    assert port["harvested"] >= 1  # a tick late: the last step is in flight
    assert ref["scores"] is not None
    assert port["scores"].shape[0] == ref["scores"].shape[0]
    np.testing.assert_array_equal(port["scores"][6], ref["scores"][6][
        :port["scores"].shape[1]])  # completions per invoker
    assert port["gauges"] == ref["gauges"]
    assert port["slo"]["global"]["count"] == ref["slo"]["global"]["count"]
    assert port["slo"]["global"]["outcomes"] == \
        ref["slo"]["global"]["outcomes"]
    for fam in ("openwhisk_invoker_activation_latency_seconds",
                "openwhisk_loadbalancer_phase_duration_seconds",
                "openwhisk_alerts_firing"):
        assert (f"# TYPE {fam}" in port["text"]) == \
            (f"# TYPE {fam}" in ref["text"]), fam


async def _grow_during_scrape(monkeypatch):
    """A port balancer grows its fleet from 8 to 64 rows while a worker
    thread's `counts()` is inside a fold: the worker holds its fold
    between reading the state and installing the new one until the
    growth has returned (or 1 s has passed), then more events arrive from
    the new rows. Returns the counts, the accumulator's axis, the events
    observed per invoker and whether the growth ran inside the fold."""
    from openwhisk_tpu_torch.ops import telemetry as TT
    pkg = _port_package()
    bal = _make(pkg, pkg.Mem.MemoryMessagingProvider())
    tp = bal.telemetry
    folding, grown = threading.Event(), threading.Event()
    real = TT.record_packed

    def held(state, ev, bounds):
        out = real(state, ev, bounds)
        if threading.current_thread() is not threading.main_thread():
            folding.set()
            grown.wait(1.0)
        return out
    monkeypatch.setattr(TT, "record_packed", held)
    seen = np.zeros(64, np.int64)

    def observe(invokers):
        for inv in invokers:
            tp.observe(inv, f"ns{inv % 3}", 1.0 + inv, inv % 3)
            seen[inv] += 1
    try:
        observe(range(8))
        scrape = threading.Thread(target=tp.counts)
        scrape.start()
        inside = folding.wait(10.0)
        for pad in (16, 32, 64):
            bal._grow_padding(pad)
        grown.set()
        scrape.join(10.0)
        observe(range(64))
        observe(range(40, 64))
        counts = tp.counts()
        return dict(counts=counts, axis=tp.accumulator.n_invokers,
                    seen=seen, inside=inside, pending=tp.pending)
    finally:
        grown.set()
        await bal.close()


def test_fleet_growth_during_a_scrape_keeps_every_event(monkeypatch):
    out = run(_grow_during_scrape(monkeypatch), 30)
    assert out["inside"] and out["pending"] == 0
    c, seen = out["counts"], out["seen"]
    assert out["axis"] == c["inv_outcomes"].shape[0] == 64
    for f in ("inv_buckets", "inv_outcomes", "inv_lat_ms"):
        assert c[f].shape[0] == 64, f
    np.testing.assert_array_equal(c["inv_outcomes"].sum(axis=1), seen)
    np.testing.assert_array_equal(c["inv_buckets"].sum(axis=1), seen)
    assert c["ns_outcomes"].sum() == seen.sum()


async def _alert_arms_recorder(pkg, bb):
    provider = pkg.Mem.MemoryMessagingProvider()
    bal = _make(pkg, provider)
    rec = bb.GLOBAL_INCIDENTS
    try:
        armed = rec._owner is bal
        listening = rec._on_alert in bal.anomaly.engine.listeners
        # `captured` counts for the whole process: wait for this capture,
        # not for any earlier test's
        base = rec.stats()["captured"]
        # the watchdog's rule fires at once: churn of 3 recompiles
        bal.anomaly.engine.evaluate(time.monotonic(),
                                    {"recompile_churn": [((), 3.0)]})
        for _ in range(500):
            if rec.stats()["captured"] > base:
                break
            await asyncio.sleep(0.01)
        rows = rec.list_incidents()
        bundle = rec.get(rows[0]["id"]) if rows else None
        return dict(armed=armed, listening=listening,
                    reasons=[r["reason"] for r in rows],
                    planes=sorted((bundle or {}).get("planes", {})))
    finally:
        await bal.close()


@pytest.mark.parametrize("side,after_a_capture", [
    pytest.param(side, after, id=side + ("-after_a_capture" if after else ""))
    for after in (False, True) for side in ("port", "jax")])
def test_a_firing_alert_arms_the_incident_recorder(side, after_a_capture,
                                                   tmp_path, monkeypatch):
    from openwhisk_tpu.utils import blackbox as JBB
    from openwhisk_tpu_torch.utils import blackbox as TBB
    pkg, bb = ((_port_package(), TBB) if side == "port"
               else (_jax_package(), JBB))
    monkeypatch.setenv("CONFIG_whisk_incidents_enabled", "true")
    if after_a_capture:
        # an earlier capture in this process (another test's) leaves the
        # recorder's process-wide count above 0
        monkeypatch.setenv("CONFIG_whisk_incidents_directory",
                           str(tmp_path / "earlier"))
        run(_alert_arms_recorder(pkg, bb), 60)
        assert bb.GLOBAL_INCIDENTS.stats()["captured"] > 0
    monkeypatch.setenv("CONFIG_whisk_incidents_directory", str(tmp_path))
    out = run(_alert_arms_recorder(pkg, bb), 60)
    assert bb.GLOBAL_INCIDENTS.stats()["installed"] is False
    assert out["armed"] and out["listening"]
    assert out["reasons"] == ["alert:recompile_churn"]
    assert {"alerts", "anomaly_scores", "telemetry_slo"} <= set(out["planes"])


def test_importing_the_planes_pulls_in_no_jax():
    code = (
        "import sys, json\n"
        "import openwhisk_tpu_torch.ops.telemetry\n"
        "import openwhisk_tpu_torch.ops.anomaly\n"
        "import openwhisk_tpu_torch.ops.profiler\n"
        "import openwhisk_tpu_torch.controller.loadbalancer.telemetry\n"
        "import openwhisk_tpu_torch.controller.loadbalancer.anomaly\n"
        "import openwhisk_tpu_torch.controller.loadbalancer.tpu_balancer\n"
        "import openwhisk_tpu_torch.controller.api\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'openwhisk_tpu' or "
        "m.startswith('openwhisk_tpu.'))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


async def _tail_sampled(pkg, threshold_ms, capture):
    """12 placements with the tail sampler at `threshold_ms`, optionally
    inside a capture window: (records filed, batches skipped, rows
    captured)."""
    provider = pkg.Mem.MemoryMessagingProvider()
    bal = _make(pkg, provider)
    bal.profiler.tail_threshold_ms = threshold_ms
    if capture:
        bal.profiler.arm_capture(64)
    bal.supervision.ping_timeout = 3600.0
    await bal.start()
    ent, msgs = pkg.E, pkg.Msg
    producer = provider.get_producer()
    await producer.send("health", msgs.PingMessage(
        ent.InvokerInstanceId(0, user_memory=ent.MB(4096))))
    for _ in range(400):
        if bal._registry and all(bal._healthy):
            break
        await asyncio.sleep(0.005)
    from test_torch_balancer_front import _identity_json
    ident = ent.Identity.from_json(_identity_json(2))
    a = ent.ExecutableWhiskAction(
        ent.EntityPath("ns2"), ent.EntityName("tail"),
        ent.CodeExec(kind="python:3", code="x"),
        limits=ent.ActionLimits(ent.TimeLimit(5000),
                                ent.MemoryLimit(ent.MB(128))))
    a.rev = ent.DocRevision("1-b")
    for k in range(12):
        await bal.publish(a, msgs.ActivationMessage(
            pkg.Tx.TransactionId(f"t{k}", start_wallclock=1.0),
            a.fully_qualified_name, "1-b", ident,
            ent.ActivationId(f"{k + 100:032x}"),
            ent.ControllerInstanceId("0"), False, {}))
    out = (len(bal.flight_recorder), bal.profiler.tail_skipped,
           bal.profiler.profile_json()["capture"]["captured"])
    await bal.close()
    return out


@pytest.mark.parametrize("capture", [False, True],
                         ids=["sampled", "capture_window"])
def test_tail_sampling_and_capture_window_like_jax(capture):
    """With a tail threshold no step reaches, the flight recorder files no
    record and the sampler counts each skipped batch; a capture window
    keeps every batch and records its rows — in both packages."""
    port = run(_tail_sampled(_port_package(), 1e9, capture), 30)
    ref = run(_tail_sampled(_jax_package(), 1e9, capture), 60)
    assert port == ref
    filed, skipped, captured = port
    assert (filed, skipped, captured) == ((12, 0, 12) if capture
                                          else (0, 12, 0))
