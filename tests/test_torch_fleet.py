"""The fleet observatory and the monitoring service in both packages.

  (a) every case of `tests/test_fleet_observatory.py`, run on the JAX
      package and on the port (`pkg` parametrises each case): the identity
      block and the causal event log, `reconstruct_phases`, the wire
      checks (heartbeats and pings byte-exact without an admin address,
      the peer directory), the bit-exact merges, spillover continuity,
      the merged timeline, the new families' grammar, the federation
      endpoints over HTTP (auth-gated, a dead peer labeled, disabled a
      404) and `FleetEvents` over the bus;
  (b) every merge function's output equal across the packages on seeded
      random raws made with numpy, compared as `json.dumps(sort_keys=True)`;
  (c) a mixed fleet: the port's controller federates a JAX controller's
      `/admin/metrics/raw` and `/admin/latency/waterfall?raw=1`, and the
      reverse; both directions give the same merged body, no member
      missing;
  (d) the port's controller with the default settings: it records events,
      announces its admin address, starts `FleetEvents` and answers every
      fleet route;
  (e) `UserEventsRecorder` (the case of `tests/test_aux_subsystems.py`) on
      both packages, and the monitoring service's main as a process over
      the TCP bus (`slow`).

Ports are free ports, never fixed ones: the JAX package's file may run at
the same time.
"""
import asyncio
import base64
import importlib
import json
import os
import random
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
_NAME = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
PACKAGES = ("openwhisk_tpu", "openwhisk_tpu_torch")


class Pkg:
    """One package's modules under the names the cases use."""

    def __init__(self, root):
        self.root = root
        self.M = self.mod("controller.monitoring")
        self.EL = self.mod("utils.eventlog")
        self.WF = self.mod("utils.waterfall")

    def mod(self, name):
        return importlib.import_module(f"{self.root}.{name}")

    def __repr__(self):
        return self.root


_PKGS = {}


@pytest.fixture(params=PACKAGES)
def pkg(request):
    p = _PKGS.get(request.param)
    if p is None:
        p = _PKGS[request.param] = Pkg(request.param)
    enabled = p.EL.GLOBAL_EVENT_LOG.enabled
    yield p
    p.EL.reset_identity()
    p.EL.GLOBAL_EVENT_LOG.enabled = enabled


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dumps(x):
    return json.dumps(x, sort_keys=True)


# -- identity & event log --------------------------------------------------
def test_identity_block_shape_and_live_pid(pkg):
    pkg.EL.set_identity(instance=3, role="controller",
                        partitions_fn=lambda: [5, 1])
    assert pkg.EL.identity() == {"instance": 3, "pid": os.getpid(),
                                 "role": "controller", "partitions": [1, 5]}


def test_identity_never_raises(pkg):
    pkg.EL.set_identity(instance=0, role="controller",
                        partitions_fn=lambda: 1 / 0)
    assert pkg.EL.identity()["partitions"] == []


def test_record_stamps_both_clocks_and_seq(pkg):
    log = pkg.EL.EventLog(size=8)
    pkg.EL.set_identity(instance=7, role="controller")
    a = log.record("lead_claim", epoch=2)
    b = log.record("member_silent", instance=9, peer=7)
    assert a["kind"] == "lead_claim" and a["epoch"] == 2
    assert a["instance"] == 7
    assert b["instance"] == 9
    assert b["seq"] == a["seq"] + 1
    assert a["mono"] <= b["mono"] and a["ts"] <= b["ts"]


def test_disabled_records_nothing(pkg):
    log = pkg.EL.EventLog(size=8, enabled=False)
    assert log.record("lead_claim") is None
    assert log.recent() == []


def test_ring_eviction_counted(pkg):
    log = pkg.EL.EventLog(size=4)
    for i in range(10):
        log.record("k", i=i)
    recent = log.recent()
    assert len(recent) == 4 and recent[-1]["i"] == 9
    assert log.evicted == 6


def test_publisher_sees_records_and_never_breaks_recording(pkg):
    log = pkg.EL.EventLog(size=8)
    seen = []
    log.attach_publisher(seen.append)
    log.record("a")
    log.attach_publisher(lambda rec: 1 / 0)
    assert log.record("b") is not None
    log.attach_publisher(None)
    log.record("c")
    assert [r["kind"] for r in seen] == ["a"]
    assert [r["kind"] for r in log.recent()] == ["a", "b", "c"]


# -- reconstruct_phases ----------------------------------------------------
def _ev(kind, mono, **f):
    return {"kind": kind, "mono": mono, "ts": 1000.0 + mono,
            "seq": int(mono * 1000), **f}


def test_phases_telescope_to_downtime(pkg):
    ev = [_ev("chaos_kill", 10.0), _ev("member_silent", 10.4, peer=0),
          _ev("part_claim", 10.45), _ev("absorb_end", 10.6),
          _ev("first_placement", 10.7)]
    out = pkg.M.reconstruct_phases(ev)
    assert out["complete"]
    assert out["phases"] == {"detect_s": 0.4, "claim_s": 0.05,
                             "absorb_s": 0.15, "first_placement_s": 0.1}
    assert round(sum(out["phases"].values()), 6) == out["downtime_s"]


def test_first_mark_at_or_after_previous_wins(pkg):
    ev = [_ev("member_silent", 5.0, peer=9), _ev("chaos_kill", 10.0),
          _ev("member_silent", 10.4), _ev("part_claim", 10.45),
          _ev("absorb_end", 10.6), _ev("first_placement", 10.7),
          _ev("member_silent", 20.0), _ev("first_placement", 21.0)]
    out = pkg.M.reconstruct_phases(ev)
    assert out["phases"]["detect_s"] == 0.4
    assert out["downtime_s"] == 0.7


def test_missing_mark_is_incomplete_not_an_error(pkg):
    out = pkg.M.reconstruct_phases([_ev("chaos_kill", 10.0),
                                    _ev("member_silent", 10.4)])
    assert not out["complete"]
    assert out["downtime_s"] is None
    assert "claim_s" not in out["phases"]


def test_phase_marks_catalog_is_causal_order(pkg):
    assert [k for k, _ in pkg.M.PHASE_MARKS] == [
        "chaos_kill", "member_silent", "part_claim", "absorb_end",
        "first_placement"]


# -- off-switch byte-exactness ---------------------------------------------
def _membership(pkg, **kw):
    Mem = pkg.mod("controller.loadbalancer.membership").ControllerMembership
    E = pkg.mod("core.entity")
    return Mem(pkg.mod("messaging").MemoryMessagingProvider(),
               E.ControllerInstanceId("0"), kw.pop("balancer", object()),
               **kw)


def test_heartbeat_without_admin_url_is_byte_exact(pkg):
    plain = _membership(pkg)._heartbeat_msg()
    assert plain == json.dumps({"kind": "heartbeat", "instance": 0}).encode()
    assert b"admin" not in _membership(pkg, admin_url=None)._heartbeat_msg()
    assert b"admin" not in _membership(pkg, admin_url="")._heartbeat_msg()
    announced = _membership(
        pkg, admin_url="http://127.0.0.1:3233")._heartbeat_msg()
    assert json.loads(announced)["admin"] == "http://127.0.0.1:3233"


def test_ping_without_admin_is_byte_exact_and_parse_tolerates(pkg):
    E = pkg.mod("core.entity")
    PingMessage = pkg.mod("messaging.message").PingMessage
    inst = E.InvokerInstanceId(0, user_memory=E.MB(256))
    plain = PingMessage(inst)
    assert plain.to_json() == {"name": inst.to_json()}
    assert b"admin" not in plain.serialize()
    assert PingMessage.parse(plain.serialize()).admin is None
    back = PingMessage.parse(
        PingMessage(inst, admin="http://127.0.0.1:9001").serialize())
    assert back.admin == "http://127.0.0.1:9001"
    assert back.instance.instance == 0


def test_peer_directory_tracks_announcing_live_peers(pkg):
    class _Balancer:
        def update_cluster(self, n):
            pass

    m = _membership(pkg, balancer=_Balancer(), member_timeout_s=60.0)
    m._on_message(json.dumps({"kind": "heartbeat", "instance": 1,
                              "admin": "http://127.0.0.1:41"}).encode())
    m._on_message(json.dumps({"kind": "heartbeat", "instance": 2}).encode())
    assert m.peer_directory() == {1: "http://127.0.0.1:41"}
    m._on_message(json.dumps({"kind": "leave", "instance": 1}).encode())
    assert m.peer_directory() == {}


# -- exact-merge property tests --------------------------------------------
def _feed(wf, samples, t0=1_000_000_000):
    for i, deltas in enumerate(samples):
        aid = f"a{t0}-{i}"
        now = t0
        wf.begin(aid, t0_ns=now)
        for stage in sorted(deltas):
            now += deltas[stage] * 1000
            wf.stamp(aid, stage, now_ns=now)
        wf.finish(aid)


def _rand_samples(W, rng, n):
    return [{W.STAGE_API_ACCEPT: rng.randint(1, 50),
             W.STAGE_PUBLISH_ENQUEUE: rng.randint(1, 2000),
             W.STAGE_INVOKER_PICKUP: rng.randint(1, 500),
             W.STAGE_RUN: rng.randint(10, 100_000),
             W.STAGE_COMPLETION_ACK: rng.randint(1, 300),
             W.STAGE_RECORD_WRITE: rng.randint(1, 300)} for _ in range(n)]


def _wf(W, buckets=30):
    return W.ActivationWaterfall(W.WaterfallConfig(enabled=True,
                                                   buckets=buckets))


@pytest.mark.parametrize("seed", [1, 7, 23])
def test_bucketwise_merge_equals_pooled_samples(pkg, seed):
    W = pkg.WF
    rng = random.Random(seed)
    a, b, pooled = _wf(W), _wf(W), _wf(W)
    sa, sb = _rand_samples(W, rng, 120), _rand_samples(W, rng, 80)
    _feed(a, sa)
    _feed(b, sb, t0=2_000_000_000)
    _feed(pooled, sa)
    _feed(pooled, sb, t0=2_000_000_000)
    ra, rb = a.raw_counts(), b.raw_counts()
    merged = pkg.M.merged_waterfall_report([ra, rb])
    ref = pooled.report()
    assert merged["per_stage"] == ref["per_stage"]
    true_tb = pooled._pctl_bucket(pooled._total_hist, 0.99)
    assert merged["tail"]["tail_threshold_ms"] == \
        W.bucket_bounds_ms(pooled.n_buckets)[true_tb]
    assert merged["tail"]["dominant"] == ref["tail"]["dominant"]
    summed = [x + y for x, y in zip(ra["dominant_tail"], rb["dominant_tail"])]
    assert merged["tail"]["dominant_tail"] == {
        W.STAGES[i]: summed[i] for i in range(W.N_STAGES) if summed[i]}
    assert merged["finished"] == ref["finished"] == 200
    assert merged["buckets_le_ms"] == ref["buckets_le_ms"]
    assert merged["identity"]["role"] == "fleet"
    assert len(merged["members"]) == 2


def test_mismatched_bucket_grids_are_skipped_not_pooled(pkg):
    W = pkg.WF
    pkg.EL.set_identity(instance=0, role="controller")
    a, b = _wf(W, 30), _wf(W, 16)
    _feed(a, _rand_samples(W, random.Random(1), 5))
    _feed(b, _rand_samples(W, random.Random(2), 5))
    ra, rb = a.raw_counts(), b.raw_counts()
    rb["identity"] = {"instance": 9, "role": "controller"}
    merged = pkg.M.merged_waterfall_report([ra, rb])
    assert merged["finished"] == 5
    assert [m.get("instance") for m in merged["members_skipped"]] == [9]


def _slo_raw(pkg, inst, hits_slow, nb=24):
    T = pkg.mod("ops.telemetry")
    bounds = T.bucket_bounds_ms(nb)
    buckets = [0] * nb
    buckets[4] = 90
    buckets[20] = hits_slow
    return {"identity": {"instance": inst, "role": "controller"},
            "enabled": True, "kernel": "xla", "buckets": nb,
            "targets": {"e2e_p99_ms": bounds[10], "error_ratio": 0.5},
            "overrides": {}, "dropped_events": 0,
            "namespaces": {"guest": {
                "buckets": buckets,
                "outcomes": [sum(buckets)] + [0] * (T.N_OUTCOMES - 1),
                "lat_ms": {}}},
            "invokers": {}}


def test_merged_slo_is_judged_over_merged_counts(pkg):
    bounds = pkg.mod("ops.telemetry").bucket_bounds_ms(24)
    merged = pkg.M.merged_slo_report([_slo_raw(pkg, 0, 0),
                                      _slo_raw(pkg, 1, 4)])
    ns = merged["namespaces"]["guest"]
    assert ns["count"] == 184
    assert merged["members"] == [{"instance": 0, "role": "controller"},
                                 {"instance": 1, "role": "controller"}]
    assert ns["p99_le_ms"] > bounds[10]
    assert ns["latency_compliant"] is False
    solo = pkg.M.merged_slo_report([_slo_raw(pkg, 0, 0)])
    assert solo["namespaces"]["guest"]["latency_compliant"] is True


def test_merged_metrics_counters_sum_gauges_stay_per_member(pkg):
    def raw(inst, n):
        return {"identity": {"instance": inst},
                "counters": [["requests_total", [["code", "200"]], n]],
                "gauges": [["load", [], inst * 1.5]],
                "histograms": [["lat_ms", [], {"count": n,
                                               "sum": 10.0 * n}]]}

    out = pkg.M.merged_metrics([raw(0, 3), raw(1, 4)])
    assert out["counters"] == [["requests_total", [["code", "200"]], 7]]
    assert out["histograms"] == [["lat_ms", [], {"count": 7, "sum": 70.0}]]
    assert [g["identity"]["instance"] for g in out["gauges_by_member"]] \
        == [0, 1]
    assert "gauges" not in out


def _host_raw(inst, lag_bucket, n, nb=30):
    lag = [0] * nb
    lag[lag_bucket] = n
    return {"identity": {"instance": inst, "role": "controller"},
            "enabled": True, "buckets": nb, "uptime_s": 1.0,
            "lag": {"hist": lag, "sum_us": 100 * n, "max_us": 900,
                    "ticks": n},
            "stalls": {"count": 1, "sum_us": 50},
            "gc": {"hist": [[0] * nb] * 3, "sum_us": [0, 0, 0],
                   "count": [0, 0, 0], "collected": 2, "uncollectable": 0,
                   "overlapping_dispatch": 1},
            "tasks": {"created": 10 * n, "finished": 9 * n},
            "serde": [["health", "encode", n, 64 * n, 1000 * n]]}


def test_merged_host_report_bucketwise(pkg):
    out = pkg.M.merged_host_report([_host_raw(0, 5, 10), _host_raw(1, 9, 10)])
    assert out["loop_lag"]["ticks"] == 20
    assert out["tasks"] == {"created": 200, "finished": 180, "active": 20}
    assert out["serde"] == [{"hop": "health", "direction": "encode",
                             "count": 20, "bytes": 1280, "ms": 0.02}]
    assert [m["instance"] for m in out["members"]] == [0, 1]


def test_metrics_raw_wire_shape_roundtrips_through_merge(pkg):
    ME = pkg.mod("utils.logging").MetricEmitter
    a, b = ME(), ME()
    for m in (a, b):
        m.counter("loadbalancer_activations_total",
                  tags={"invoker": "invoker0"})
    a.counter("loadbalancer_activations_total", tags={"invoker": "invoker0"})
    ra = pkg.M.metrics_raw(a.snapshot(), {"instance": 0})
    rb = pkg.M.metrics_raw(b.snapshot(), {"instance": 1})
    assert pkg.M.merge_serialized_counters([ra, rb]) == [
        ["loadbalancer_activations_total", [["invoker", "invoker0"]], 3]]


# -- spillover continuity --------------------------------------------------
def test_trace_context_survives_the_ctrlspill_columnar_frame(pkg):
    E = pkg.mod("core.entity")
    C = pkg.mod("messaging.columnar")
    AM = pkg.mod("messaging.message").ActivationMessage
    TX = pkg.mod("utils.transaction").TransactionId
    tc = {"traceparent":
          "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"}
    msg = AM(TX(), E.FullyQualifiedEntityName.parse("guest/spilled"), "1-a",
             E.Identity.generate("guest"), E.ActivationId.generate(),
             E.ControllerInstanceId("0"), True, {}, trace_context=tc)
    plain = AM(TX(), E.FullyQualifiedEntityName.parse("guest/other"), "1-a",
               E.Identity.generate("guest"), E.ActivationId.generate(),
               E.ControllerInstanceId("0"), True, {})
    _, out = C.parse_batch(C.ActivationBatchMessage([msg, plain]).serialize())
    assert out[0].trace_context == tc
    assert out[1].trace_context is None


def _half(W, aid, stamped, inst, trace=None, ts=1.0):
    deltas = [-1] * W.N_STAGES
    for stage, us in stamped.items():
        deltas[stage] = us
    return {"activation_id": aid, "trace_id": trace, "ts": ts,
            "total_us": sum(stamped.values()), "deltas_us": deltas,
            "clamped": 0, "instance": inst}


def test_join_spill_rows_telescopes_origin_and_peer_halves(pkg):
    W = pkg.WF
    origin = _half(W, "aid1", {W.STAGE_API_ACCEPT: 100,
                               W.STAGE_SPILL_FORWARD: 400}, 0,
                   trace="t-origin", ts=1.0)
    peer = _half(W, "aid1", {W.STAGE_PUBLISH_ENQUEUE: 50, W.STAGE_RUN: 250},
                 1, ts=1.1)
    lone = _half(W, "aid2", {W.STAGE_API_ACCEPT: 10, W.STAGE_RUN: 20}, 1,
                 ts=0.5)
    rows = pkg.M.join_spill_rows([peer, lone, origin])
    assert [r["activation_id"] for r in rows] == ["aid2", "aid1"]
    joined = rows[1]
    assert joined["joined"] is True
    assert joined["origin_instance"] == 0 and joined["peer_instance"] == 1
    assert joined["trace_id"] == "t-origin"
    assert joined["total_us"] == 100 + 400 + 50 + 250
    assert joined["deltas_us"][W.STAGE_SPILL_FORWARD] == 400
    assert joined["deltas_us"][W.STAGE_RUN] == 250


def test_merged_waterfall_renders_joined_row_with_provenance(pkg):
    W = pkg.WF
    a, b = _wf(W), _wf(W)
    t0 = 1_000_000_000
    a.begin("sp1", t0_ns=t0)
    a.stamp("sp1", W.STAGE_API_ACCEPT, now_ns=t0 + 100_000)
    a.stamp("sp1", W.STAGE_SPILL_FORWARD, now_ns=t0 + 500_000)
    a.finish("sp1")
    b.begin("sp1", t0_ns=t0 + 500_000)
    b.stamp("sp1", W.STAGE_PUBLISH_ENQUEUE, now_ns=t0 + 600_000)
    b.stamp("sp1", W.STAGE_RUN, now_ns=t0 + 900_000)
    b.finish("sp1")
    ra, rb = a.raw_counts(rows=8), b.raw_counts(rows=8)
    ra["identity"] = {"instance": 0, "role": "controller"}
    rb["identity"] = {"instance": 1, "role": "controller"}
    merged = pkg.M.merged_waterfall_report([ra, rb], recent=8)
    assert merged["joined_rows"] == 1
    row = [r for r in merged["recent"] if r["activation_id"] == "sp1"][0]
    assert row["joined"] is True
    assert row["origin_instance"] == 0 and row["peer_instance"] == 1
    assert row["total_ms"] == 0.9


# -- merged timeline -------------------------------------------------------
def test_timeline_orders_by_wall_then_mono_then_seq(pkg):
    ev = {0: [{"kind": "b", "ts": 2.0, "mono": 5.0, "seq": 1},
              {"kind": "d", "ts": 3.0, "mono": 6.0, "seq": 2}],
          1: [{"kind": "a", "ts": 1.0, "mono": 9.0, "seq": 0},
              {"kind": "c", "ts": 2.0, "mono": 5.5, "seq": 0}]}
    out = pkg.M.merged_timeline(ev)
    assert out["members"] == [0, 1]
    assert out["count"] == 4
    assert [e["kind"] for e in out["events"]] == ["a", "b", "c", "d"]


def test_timeline_limit_keeps_the_tail_and_member_key_backfills_instance(pkg):
    out = pkg.M.merged_timeline(
        {3: [{"kind": f"k{i}", "ts": float(i)} for i in range(5)]}, limit=2)
    assert [e["kind"] for e in out["events"]] == ["k3", "k4"]
    assert all(e["instance"] == 3 for e in out["events"])


# -- exposition grammar for the new families -------------------------------
EDGE_FAMILIES = ("edge_retry_total", "edge_upstream_attempts_total",
                 "edge_upstream_http_503_total")


def _edge(pkg, **kw):
    edge = pkg.mod("edge")
    return edge.EdgeProxy(upstreams=[edge.Upstream("http://127.0.0.1:3233")],
                          **kw)


def test_edge_stats_counter_rows_obey_the_grammar(pkg):
    from aiohttp.test_utils import make_mocked_request
    edge = _edge(pkg, admin_token="tok")
    edge.retry_total["http_503"] = 2
    edge.upstreams[0].attempts = 5
    edge.upstreams[0].http_503 = 2
    req = make_mocked_request("GET", "/admin/edge/stats",
                              headers={"Authorization": "Bearer tok"})
    payload = json.loads(edge._edge_stats(req).body)
    names = [row[0] for row in payload["counters"]]
    for fam in EDGE_FAMILIES:
        assert fam in names
    for name, tags, value in payload["counters"]:
        assert _NAME.match(name), name
        for k, _v in tags:
            assert _LABEL_NAME.match(k), k
        assert isinstance(value, int) and value >= 0
    assert payload["identity"]["role"] == "edge"


def test_edge_stats_denied_without_or_with_wrong_token(pkg):
    from aiohttp import web
    from aiohttp.test_utils import make_mocked_request
    sealed, gated = _edge(pkg), _edge(pkg, admin_token="tok")
    for edge, hdrs in ((sealed, {}),
                       (sealed, {"Authorization": "Bearer anything"}),
                       (gated, {}), (gated, {"Authorization": "Bearer wrong"}),
                       (gated, {"Authorization": "Basic dG9r"})):
        req = make_mocked_request("GET", "/admin/edge/stats", headers=hdrs)
        with pytest.raises(web.HTTPForbidden):
            edge._edge_stats(req)


def test_metrics_page_posture_unchanged(pkg):
    assert "/metrics" in _edge(pkg).extra_denied_paths


# -- federation endpoints over HTTP ----------------------------------------
def _controller(pkg):
    """A controller of `pkg` over a lean balancer (no invokers), and a
    generated guest identity."""
    E = pkg.mod("core.entity")
    NullLogging = pkg.mod("utils.logging").NullLogging
    Lean = pkg.mod("controller.loadbalancer.lean").LeanBalancer
    Controller = pkg.mod("controller.core").Controller

    async def noop_factory(invoker_id, provider):
        class _Stub:
            async def stop(self):
                pass

        return _Stub()

    logger = NullLogging()
    provider = pkg.mod("messaging").MemoryMessagingProvider()
    lb = Lean(provider, E.ControllerInstanceId("0"), noop_factory,
              logger=logger, metrics=logger.metrics, user_memory=E.MB(512))
    c = Controller(E.ControllerInstanceId("0"), provider, logger=logger,
                   load_balancer=lb)
    return c, E.Identity.generate("guest")


async def _put_auth(pkg, c, ident_json):
    E = pkg.mod("core.entity")
    ident = E.Identity.from_json(ident_json)
    await c.auth_store.put(E.WhiskAuthRecord(ident.subject, [ident.namespace],
                                             [ident.authkey]))


def _hdrs(ident):
    return {"Authorization": "Basic " + base64.b64encode(
        ident.authkey.compact.encode()).decode()}


class _Peers:
    """A membership stand-in: a fixed peer directory."""

    def __init__(self, directory):
        self.directory = directory

    def peer_directory(self):
        return dict(self.directory)

    async def stop(self):
        pass


def test_partial_failure_is_labeled_not_an_error(pkg):
    import aiohttp
    from aiohttp import web
    W = pkg.WF
    GW = W.GLOBAL_WATERFALL
    wf_was = GW.enabled
    port, peer_port = _free_port(), _free_port()

    async def go():
        GW.enabled = True
        GW.reset()
        c, ident = _controller(pkg)
        await _put_auth(pkg, c, ident.to_json())
        assert c.fleet_config.enabled  # default ON
        peer_wf = _wf(W)
        _feed(peer_wf, _rand_samples(W, random.Random(3), 10))
        praw = peer_wf.raw_counts(rows=4)
        praw["identity"] = {"instance": 1, "role": "controller"}

        async def peer_waterfall(request):
            assert request.query.get("raw") == "1"
            return web.json_response(praw)

        papp = web.Application()
        papp.router.add_get("/admin/latency/waterfall", peer_waterfall)
        prunner = web.AppRunner(papp)
        await prunner.setup()
        await web.TCPSite(prunner, "127.0.0.1", peer_port).start()
        await c.start(port=port)
        c.membership = _Peers({1: f"http://127.0.0.1:{peer_port}",
                               2: "http://127.0.0.1:9"})  # a dead peer
        out = {}
        try:
            base = f"http://127.0.0.1:{port}"
            async with aiohttp.ClientSession() as s:
                for key, path in (("wf", "/admin/fleet/waterfall"),
                                  ("m", "/admin/fleet/metrics"),
                                  ("t", "/admin/fleet/timeline")):
                    async with s.get(base + path) as r:
                        out[key + "_status"] = r.status
                async with s.get(f"{base}/admin/fleet/waterfall",
                                 headers=_hdrs(ident)) as r:
                    out["wf_auth_status"] = r.status
                    out["wf_auth"] = await r.json()
                async with s.get(f"{base}/admin/metrics/raw",
                                 headers=_hdrs(ident)) as r:
                    out["raw_status"] = r.status
        finally:
            await prunner.cleanup()
            await c.stop()
        return out

    try:
        out = asyncio.run(go())
    finally:
        GW.enabled = wf_was
    assert out["wf_status"] == out["m_status"] == out["t_status"] == 401
    assert out["raw_status"] == 200
    body = out["wf_auth"]
    assert out["wf_auth_status"] == 200
    assert body["members_missing"] == [2]
    assert "controller" in [m.get("role") for m in body["members"]]
    assert body["finished"] >= 10


FLEET_ROUTES = ("/admin/fleet/metrics", "/admin/fleet/waterfall",
                "/admin/fleet/slo", "/admin/fleet/host",
                "/admin/fleet/quality", "/admin/fleet/timeline",
                "/admin/fleet/incidents", "/admin/metrics/raw")


async def _get_all(c, ident, port, paths):
    import aiohttp
    out = {}
    async with aiohttp.ClientSession() as s:
        for path in paths:
            async with s.get(f"http://127.0.0.1:{port}{path}",
                             headers=_hdrs(ident)) as r:
                out[path] = (r.status, await r.json(content_type=None))
    return out


def test_disabled_is_a_404_no_op(pkg, monkeypatch):
    monkeypatch.setenv("CONFIG_whisk_fleetObservatory_enabled", "false")
    assert pkg.EL.fleet_config().enabled is False
    port = _free_port()

    async def go():
        c, ident = _controller(pkg)
        await _put_auth(pkg, c, ident.to_json())
        assert c.fleet_config.enabled is False
        await c.start(port=port)
        try:
            assert c.fleet_events is None
            assert pkg.EL.GLOBAL_EVENT_LOG.enabled is False
            return await _get_all(c, ident, port, FLEET_ROUTES)
        finally:
            await c.stop()

    out = asyncio.run(go())
    assert all(st == 404 for st, _ in out.values()), out


def test_default_controller_records_announces_and_answers_every_route(pkg):
    """The fleet observatory's defaults: the event log on, the identity
    set, `FleetEvents` started, all eight routes 200."""
    port = _free_port()

    async def go():
        c, ident = _controller(pkg)
        await _put_auth(pkg, c, ident.to_json())
        await c.start(port=port)
        try:
            assert c.fleet_events is not None
            assert pkg.EL.GLOBAL_EVENT_LOG.enabled is True
            assert pkg.EL.identity()["role"] == "controller"
            rec = pkg.EL.GLOBAL_EVENT_LOG.record("first_placement")
            assert rec is not None and rec["instance"] == 0
            return await _get_all(c, ident, port, FLEET_ROUTES)
        finally:
            await c.stop()

    out = asyncio.run(go())
    assert {p: st for p, (st, _) in out.items()} == {
        p: 200 for p in FLEET_ROUTES}
    assert "first_placement" in [
        e["kind"] for e in out["/admin/fleet/timeline"][1]["events"]]


def test_a_clustering_controller_announces_its_admin_url(pkg):
    """`Controller.start` hands its admin address to membership (a
    clustering balancer joins it), so a peer's directory lists it."""
    port = _free_port()
    E = pkg.mod("core.entity")
    NullLogging = pkg.mod("utils.logging").NullLogging
    SB = pkg.mod("controller.loadbalancer.sharding_balancer")
    Controller = pkg.mod("controller.core").Controller

    async def go():
        logger = NullLogging()
        provider = pkg.mod("messaging").MemoryMessagingProvider()
        lb = SB.ShardingBalancer(provider, E.ControllerInstanceId("0"),
                                 logger=logger, metrics=logger.metrics)
        c = Controller(E.ControllerInstanceId("0"), provider, logger=logger,
                       load_balancer=lb)
        await c.start(port=port)
        try:
            return json.loads(c.membership._heartbeat_msg())
        finally:
            await c.stop()

    assert asyncio.run(go())["admin"] == f"http://127.0.0.1:{port}"


# -- ctrlevents bus bridging -----------------------------------------------
def test_frames_fold_into_peer_rings_and_own_frames_skip(pkg):
    FleetEvents = pkg.mod("controller.fleet").FleetEvents

    async def go():
        provider = pkg.mod("messaging").MemoryMessagingProvider()
        log0, log1 = pkg.EL.EventLog(size=16), pkg.EL.EventLog(size=16)
        fe0 = FleetEvents(provider, 0, event_log=log0)
        fe1 = FleetEvents(provider, 1, event_log=log1)
        fe0.start()
        fe1.start()
        try:
            log0.record("lead_claim", instance=0, epoch=1)
            log1.record("part_claim", instance=1, parts={"3": 2}, prev={})
            for _ in range(100):
                if fe0.peer_events.get(1) and fe1.peer_events.get(0):
                    break
                await asyncio.sleep(0.05)
        finally:
            await fe0.stop()
            await fe1.stop()
        return fe0, fe1

    fe0, fe1 = asyncio.run(go())
    assert [r["kind"] for r in fe0.peer_events[1]] == ["part_claim"]
    assert [r["kind"] for r in fe1.peer_events[0]] == ["lead_claim"]
    assert 0 not in fe0.peer_events
    ev0 = fe0.events_by_member()
    assert set(ev0) == {0, 1}
    assert [e["kind"] for e in pkg.M.merged_timeline(ev0)["events"]] == [
        "lead_claim", "part_claim"]


# -- identity blocks on existing snapshots ---------------------------------
def test_waterfall_and_hostprof_and_slo_raw_carry_identity(pkg):
    HO = pkg.mod("utils.hostprof").HostObservatory
    pkg.EL.set_identity(instance=4, role="controller")
    wf = _wf(pkg.WF, 8)
    for snap in (wf.report(), wf.raw_counts(), HO().raw_counts()):
        ident = snap["identity"]
        assert ident["instance"] == 4
        assert ident["role"] == "controller"
        assert isinstance(ident["pid"], int)
        assert "partitions" in ident


# -- (b) the merges, byte-equal across the packages ---------------------------
def _rng_waterfall_raws(W, rng, members):
    raws = []
    for k in range(members):
        wf = _wf(W)
        samples = [{s: int(rng.randint(1, 5000)) for s in
                    (W.STAGE_API_ACCEPT, W.STAGE_PUBLISH_ENQUEUE,
                     W.STAGE_INVOKER_PICKUP, W.STAGE_RUN,
                     W.STAGE_COMPLETION_ACK)}
                   for _ in range(int(rng.randint(5, 60)))]
        _feed(wf, samples, t0=1_000_000_000 * (k + 1))
        raw = wf.raw_counts(rows=16)
        raw["identity"] = {"instance": k, "role": "controller"}
        raws.append(raw)
    return raws


def _rng_metric_raws(M, ME, rng, members):
    raws = []
    for k in range(members):
        m = ME()
        for _ in range(int(rng.randint(3, 30))):
            m.counter(f"c{int(rng.randint(0, 4))}_total",
                      int(rng.randint(1, 9)),
                      tags={"invoker": f"invoker{int(rng.randint(0, 3))}"})
            m.gauge(f"g{int(rng.randint(0, 2))}", float(rng.randint(0, 99)))
            m.histogram("lat_ms", float(rng.randint(0, 500)),
                        tags={"stage": "run"})
        raws.append(M.metrics_raw(m.snapshot(),
                                  {"instance": k, "role": "controller"}))
    return raws


def _rng_slo_raws(rng, members, nb=24, n_out=None):
    raws = []
    for k in range(members):
        nss = {}
        for ns in ("guest", "ns1", "ns2")[:int(rng.randint(1, 4))]:
            b = [int(x) for x in rng.randint(0, 40, nb)]
            nss[ns] = {"buckets": b,
                       "outcomes": [sum(b)] + [int(x) for x in
                                               rng.randint(0, 5, n_out - 1)],
                       "lat_ms": {}}
        raws.append({"identity": {"instance": k, "role": "controller"},
                     "enabled": True, "kernel": "device", "buckets": nb,
                     "targets": {"e2e_p99_ms": 100.0, "error_ratio": 0.05},
                     "overrides": {}, "dropped_events": int(rng.randint(0, 3)),
                     "namespaces": nss, "invokers": {}})
    return raws


def _rng_host_raws(rng, members):
    return [_host_raw(k, int(rng.randint(0, 29)), int(rng.randint(1, 50)))
            for k in range(members)]


def _rng_timeline(rng, members, marks):
    kinds = [k for k, _ in marks] + ["lead_claim", "leave"]
    return {k: [{"kind": kinds[int(rng.randint(0, len(kinds)))],
                 "ts": float(rng.randint(0, 50)) / 4,
                 "mono": float(rng.randint(0, 50)) / 4,
                 "seq": int(rng.randint(0, 99))}
                for _ in range(int(rng.randint(1, 12)))]
            for k in range(members)}


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_every_merge_equals_the_jax_packages_on_seeded_raws(seed):
    J, T = Pkg("openwhisk_tpu"), Pkg("openwhisk_tpu_torch")
    n_out = J.mod("ops.telemetry").N_OUTCOMES
    assert T.mod("ops.telemetry").N_OUTCOMES == n_out
    rng = np.random.RandomState(seed)
    members = int(rng.randint(1, 5))
    wf = _rng_waterfall_raws(J.WF, rng, members)
    metrics = _rng_metric_raws(J.M, J.mod("utils.logging").MetricEmitter,
                               np.random.RandomState(seed), members)
    tmetrics = _rng_metric_raws(T.M, T.mod("utils.logging").MetricEmitter,
                                np.random.RandomState(seed), members)
    assert _dumps(metrics) == _dumps(tmetrics)  # metrics_raw
    slo = _rng_slo_raws(rng, members, n_out=n_out)
    host = _rng_host_raws(rng, members)
    tl = _rng_timeline(rng, members, J.M.PHASE_MARKS)
    halves = [row for raw in wf for row in raw.get("recent", [])]
    cases = {
        "merged_waterfall_report": lambda M: M.merged_waterfall_report(
            json.loads(_dumps(wf)), recent=8),
        "merged_metrics": lambda M: M.merged_metrics(
            json.loads(_dumps(metrics))),
        "merge_serialized_counters": lambda M: M.merge_serialized_counters(
            json.loads(_dumps(metrics))),
        "merged_slo_report": lambda M: M.merged_slo_report(
            json.loads(_dumps(slo))),
        "merged_host_report": lambda M: M.merged_host_report(
            json.loads(_dumps(host))),
        "merged_timeline": lambda M: M.merged_timeline(
            json.loads(_dumps(tl)), limit=int(seed)),
        "join_spill_rows": lambda M: M.join_spill_rows(
            json.loads(_dumps(halves))),
        "reconstruct_phases": lambda M: M.reconstruct_phases(
            M.merged_timeline(json.loads(_dumps(tl)))["events"]),
    }
    for name, fn in cases.items():
        assert _dumps(fn(T.M)) == _dumps(fn(J.M)), name


# -- (c) a mixed fleet ----------------------------------------------------------
def test_a_mixed_fleet_federates_in_both_directions():
    """A JAX controller and the port's (CPU) controller, each with the
    other as its one peer: each federates the other's `/admin/metrics/raw`
    and `/admin/latency/waterfall?raw=1`. Both directions give the same
    merged body (members in scrape order aside: local first), and no
    member is missing."""
    J, T = Pkg("openwhisk_tpu"), Pkg("openwhisk_tpu_torch")
    ports = {"jax": _free_port(), "port": _free_port()}
    was = {p.root: (p.WF.GLOBAL_WATERFALL.enabled,
                    p.EL.GLOBAL_EVENT_LOG.enabled) for p in (J, T)}

    async def go():
        built = {}
        ident_json = None
        for name, p in (("jax", J), ("port", T)):
            GW = p.WF.GLOBAL_WATERFALL
            GW.enabled = True
            GW.reset()
            _feed(GW, _rand_samples(p.WF, random.Random(17), 12),
                  t0=(1 if name == "jax" else 2) * 1_000_000_000)
            c, ident = _controller(p)
            ident_json = ident_json or ident.to_json()
            await _put_auth(p, c, ident_json)
            built[name] = c
        for name, c in built.items():
            await c.start(port=ports[name])
        for name, c in built.items():
            other = "port" if name == "jax" else "jax"
            c.membership = _Peers({1: f"http://127.0.0.1:{ports[other]}"})
            c.metrics.counter("mixed_fleet_total", 5,
                              tags={"member": "any"})
        ident = J.mod("core.entity").Identity.from_json(ident_json)
        out = {}
        try:
            for name in built:
                out[name] = await _get_all(
                    built[name], ident, ports[name],
                    ("/admin/fleet/metrics", "/admin/fleet/waterfall"))
        finally:
            for c in built.values():
                await c.stop()
        return out

    try:
        out = asyncio.run(go())
    finally:
        for p in (J, T):
            p.WF.GLOBAL_WATERFALL.enabled, p.EL.GLOBAL_EVENT_LOG.enabled = \
                was[p.root]
            p.WF.GLOBAL_WATERFALL.reset()
            p.EL.reset_identity()
    bodies = {}
    for name, got in out.items():
        for path, (st, body) in got.items():
            assert st == 200, (name, path, body)
            assert body["members_missing"] == [], (name, path)
            assert len(body["members"]) == 2, (name, path)
            bodies[name, path] = body
    m = {k: bodies[k, "/admin/fleet/metrics"] for k in ("jax", "port")}
    rows = {k: [r for r in v["counters"] if r[0] == "mixed_fleet_total"]
            for k, v in m.items()}
    assert rows["jax"] == rows["port"] == [
        ["mixed_fleet_total", [["member", "any"]], 10]]
    w = {k: bodies[k, "/admin/fleet/waterfall"] for k in ("jax", "port")}
    for key in ("finished", "per_stage", "buckets_le_ms", "tail"):
        assert _dumps(w["jax"][key]) == _dumps(w["port"][key]), key
    assert w["jax"]["finished"] == 24
    assert sorted(_dumps(x) for x in w["jax"]["members"]) == \
        sorted(_dumps(x) for x in w["port"]["members"])


# -- (e) the user-events service ------------------------------------------------
def test_user_events_recorder_records_activation_and_metric_events(pkg):
    E = pkg.mod("core.entity")
    msg = pkg.mod("messaging")
    Rec = pkg.M.UserEventsRecorder

    async def go():
        provider = msg.MemoryMessagingProvider()
        rec = Rec(provider)
        rec.start()
        prod = provider.get_producer()
        act = E.WhiskActivation(E.EntityPath("guest"), E.EntityName("hello"),
                                E.Subject("guest-user"),
                                E.ActivationId.generate(), 1.0, 2.0,
                                E.ActivationResponse.success({}), duration=42)
        await prod.send("events", msg.EventMessage.for_activation(
            "invoker0", act, "uuid-1", kind="python:3", init_time=7))
        await prod.send("events", msg.EventMessage.for_metric(
            "controller", "ConcurrentRateLimit", 1, "guest-user", "guest",
            "uuid-1"))
        await asyncio.sleep(0.15)
        text = rec.prometheus_text()
        await rec.stop()
        return text

    text = asyncio.run(go())
    assert ('openwhisk_userevents_activations_total'
            '{action="guest/hello"} 1') in text
    assert ('openwhisk_userevents_cold_starts_total'
            '{action="guest/hello"} 1') in text
    assert ('openwhisk_userevents_rate_limit_total'
            '{metric="ConcurrentRateLimit",namespace="guest"} 1') in text


@pytest.mark.slow
def test_the_monitoring_service_main_counts_events_over_the_tcp_bus():
    """`python -m openwhisk_tpu_torch.controller.monitoring --bus ...` as
    its own process beside the port's broker: 8 activation events
    published onto the bus are counted on its /metrics page."""
    import urllib.request
    T = Pkg("openwhisk_tpu_torch")
    E = T.mod("core.entity")
    msg = T.mod("messaging")
    bus, mport = _free_port(), _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    broker = subprocess.Popen(
        [sys.executable, "-m", "openwhisk_tpu_torch.messaging", "--port",
         str(bus)], env=env, cwd=ROOT)
    mon = None
    try:
        time.sleep(1.0)
        mon = subprocess.Popen(
            [sys.executable, "-m", "openwhisk_tpu_torch.controller.monitoring",
             "--bus", f"127.0.0.1:{bus}", "--port", str(mport)],
            env=env, cwd=ROOT)

        def scrape():
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{mport}/metrics", timeout=2) as r:
                return r.read().decode()

        t0 = time.monotonic()
        while True:
            try:
                scrape()
                break
            except OSError:
                assert time.monotonic() - t0 < 30, "monitoring never up"
                time.sleep(0.2)

        async def publish():
            provider = msg.provider_for_bus(f"127.0.0.1:{bus}")
            prod = provider.get_producer()
            for i in range(8):
                act = E.WhiskActivation(
                    E.EntityPath("guest"), E.EntityName("hello"),
                    E.Subject("guest-user"), E.ActivationId.generate(),
                    1.0, 2.0, E.ActivationResponse.success({}), duration=i)
                await prod.send("events", msg.EventMessage.for_activation(
                    "invoker0", act, "uuid-1", kind="python:3"))
            await prod.close()

        asyncio.run(publish())
        want = 'openwhisk_userevents_activations_total{action="guest/hello"} 8'
        t0 = time.monotonic()
        while want not in scrape():
            assert time.monotonic() - t0 < 30, scrape()
            time.sleep(0.2)
    finally:
        for p in (mon, broker):
            if p is not None:
                p.terminate()
                p.wait(timeout=30)
