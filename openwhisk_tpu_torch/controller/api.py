"""Controller REST API: /api/v1 route tree.

A copy of `openwhisk_tpu/controller/api.py` with every /api/v1 route,
/ping, /invokers and /metrics. Of its /admin surface the port serves the
flight recorder, the occupancy books, the SLO report, the kernel profiler
and its capture window, the host observatory, the alerts and anomaly
scores, the latency waterfall, the trace store, the incident recorder,
the readiness probe and the index; the routes of planes not ported yet
(placement quality, fleet federation) answer 404 naming the plane.

Rebuild of core/controller/.../controller/RestAPIs.scala:160-228 (versioned
route tree + auth directive) with the per-collection APIs:
  Actions.scala      CRUD + invoke (?blocking, ?result, ?timeout)
  Activations.scala  list/get/logs/result
  Namespaces.scala   namespace listing
  Triggers.scala     CRUD + fire (direct internal rule dispatch, not the
                     reference's HTTP loopback — Triggers.scala:390-412)
  Rules.scala        CRUD + status
  Packages.scala     CRUD incl. bindings
JSON wire shapes follow the reference so `wsk`-style clients port over.
Every /api/v1 response carries the REST CORS headers (RestAPIs.scala:200,
controller/cors.py); web actions manage their own CORS + OPTIONS preflight.
"""
from __future__ import annotations

import asyncio
import json
from typing import Optional

from aiohttp import web

from ..core.entity import (ACTIVE, ActivationId, Binding, EntityName,
                           EntityPath, Exec, ExecManifest, Identity,
                           LimitViolation, MalformedEntity, MemoryLimit,
                           Parameters,
                           ReducedRule, SequenceExec, TimeLimit, WhiskAction,
                           WhiskActivation, WhiskPackage, WhiskRule,
                           WhiskTrigger)
from ..core.entity.action import ActionLimits
from ..core.entity.names import FullyQualifiedEntityName
from ..database import DocumentConflict, NoDocumentException
from ..utils.transaction import TransactionId
from .entitlement import (ACTIVATE, DELETE, EntitlementException, PUT, READ,
                          RejectRequest)
from .loadbalancer.base import (LoadBalancerException,
                                LoadBalancerThrottleException)
from .invoke import resolve_action
from .routemgmt import ApiManagementException

MAX_LIST_LIMIT = 200


def _error(status: int, message: str, transid: Optional[TransactionId] = None
           ) -> web.Response:
    return web.json_response({"error": message,
                              "code": transid.id if transid else None},
                             status=status)


def _amend_annotations(annotations: Parameters, exec_: Exec,
                       create: bool) -> Parameters:
    """System annotations stamped on action create/update
    (ref Actions.scala:55-84 amendAnnotations): on *create* with the
    requireApiKeyAnnotation feature flag on, `provide-api-key: false` is added
    unless the client already declared it (existing actions are never
    retrofitted — it would break them); the `exec` kind annotation is always
    added and overrides any client-supplied value, so list views can show kinds
    without fetching each action."""
    from ..core.feature_flags import (EXEC_ANNOTATION,
                                      PROVIDE_API_KEY_ANNOTATION,
                                      feature_flags)
    from ..core.entity.parameters import ParameterValue
    if create and feature_flags().require_api_key_annotation \
            and PROVIDE_API_KEY_ANNOTATION not in annotations:
        annotations = annotations + Parameters(
            {PROVIDE_API_KEY_ANNOTATION: ParameterValue(False)})
    return annotations + Parameters({EXEC_ANNOTATION: ParameterValue(exec_.kind)})


class ControllerApi:
    def __init__(self, controller):
        """`controller` is openwhisk_tpu_torch.controller.core.Controller."""
        self.c = controller

    # ------------------------------------------------------------------ app
    def make_app(self) -> web.Application:
        app = web.Application(middlewares=[self._cors_middleware,
                                           self._auth_middleware])
        r = app.router
        r.add_get("/ping", self.ping)
        r.add_get("/api/v1", self.api_info)
        r.add_get("/api/v1/api-docs", self.api_docs)
        r.add_get("/api/v1/api-docs/ui", self.api_docs_ui)
        r.add_get("/docs", self.docs_redirect)
        r.add_get("/api/v1/namespaces", self.list_namespaces)
        base = "/api/v1/namespaces/{ns}"
        # actions (name may contain a package segment)
        r.add_get(base + "/actions", self.list_actions)
        r.add_route("*", base + "/actions/{name:[^/]+(?:/[^/]+)?}", self.action_entry)
        # activations
        r.add_get(base + "/activations", self.list_activations)
        r.add_get(base + "/activations/{id}", self.get_activation)
        r.add_get(base + "/activations/{id}/logs", self.get_activation_logs)
        r.add_get(base + "/activations/{id}/result", self.get_activation_result)
        # triggers
        r.add_get(base + "/triggers", self.list_triggers)
        r.add_route("*", base + "/triggers/{name}", self.trigger_entry)
        # rules
        r.add_get(base + "/rules", self.list_rules)
        r.add_route("*", base + "/rules/{name}", self.rule_entry)
        # packages
        r.add_get(base + "/packages", self.list_packages)
        r.add_route("*", base + "/packages/{name}", self.package_entry)
        # api-gateway route management (reference: core/routemgmt JS actions,
        # surfaced here as a first-class /apis collection)
        r.add_route("*", base + "/apis", self.apis_entry)
        # web actions (anonymous)
        r.add_route("*", "/api/v1/web/{ns}/{pkg}/{name:.+}", self.web_action)
        # system
        r.add_get("/invokers", self.invokers)
        r.add_get("/metrics", self.metrics)
        # placement introspection plane (flight recorder + books), auth-gated
        # like /invokers: none of these paths are in the anonymous whitelist
        r.add_get("/admin/placement/recent", self.placement_recent)
        r.add_get("/admin/placement/explain/{activation_id}",
                  self.placement_explain)
        r.add_get("/admin/placement/occupancy", self.placement_occupancy)
        # SLO plane: compliance / budget / burn rates from the balancer's
        # telemetry accumulator, auth-gated like the placement endpoints
        r.add_get("/admin/slo", self.slo_report)
        # kernel profiling plane: compile log / phase percentiles / HBM
        # stats, plus the on-demand capture window (auth-gated)
        r.add_get("/admin/profile/kernel", self.profile_kernel)
        r.add_post("/admin/profile/capture", self.profile_capture)
        # host hot-loop observatory: event-loop lag / GC pauses / task
        # churn / serde shares / sampler self-time census, plus the
        # bounded full-rate capture window (auth-gated)
        r.add_get("/admin/profile/host", self.profile_host)
        r.add_post("/admin/profile/host/capture", self.profile_host_capture)
        # anomaly & alerting plane: active/recent alerts and per-invoker
        # anomaly scores with bucket-movement evidence (auth-gated)
        r.add_get("/admin/alerts", self.alerts_report)
        r.add_get("/admin/anomalies", self.anomalies_report)
        # end-to-end latency waterfall: live per-stage percentiles, the
        # tail budget breakdown and slowest-activation exemplars joined to
        # flight-recorder trace ids (auth-gated; host-side reads only)
        r.add_get("/admin/latency/waterfall", self.latency_waterfall)
        r.add_get("/admin/ready", self.admin_ready)
        # trace observatory: the tail-sampled kept-trace read side.
        # `local` (a peer-scrape leaf) must register before the assembling
        # route — aiohttp matches in registration order. Auth-gated; every
        # handler 404s while CONFIG_whisk_tracing_tail_enabled=false.
        r.add_get("/admin/traces", self.traces_list)
        r.add_get("/admin/trace/local/{trace_id}", self.trace_local)
        r.add_get("/admin/trace/{trace_id}", self.trace_assembled)
        r.add_get("/admin", self.admin_index)
        # incident forensics observatory: alert-triggered black-box
        # bundles (utils/blackbox.py). The `local` leaf must register
        # before the parameterized route (aiohttp registration order, same
        # as traces). Every handler 404s while
        # CONFIG_whisk_incidents_enabled=false.
        r.add_get("/admin/incidents", self.incidents_list)
        r.add_get("/admin/incident/local/{incident_id}",
                  self.incident_local)
        r.add_get("/admin/incident/{incident_id}", self.incident_get)
        # the planes not ported yet answer 404 naming the plane
        self._add_unported_admin_routes(r)
        return app

    # ----------------------------------------------------------- middleware
    @web.middleware
    async def _cors_middleware(self, request: web.Request, handler):
        """Access-Control-* on every /api/v1 response (ref RestAPIs.scala:200
        sendCorsHeaders). Web actions are excluded: they manage their own
        wider CORS surface incl. OPTIONS preflight (RestAPIs.scala:214)."""
        applies = (request.path.startswith("/api/v1")
                   and not request.path.startswith("/api/v1/web/"))
        try:
            resp = await handler(request)
        except web.HTTPException as e:
            if applies:
                e.headers.update(self.c.cors.rest_headers())
            raise
        if applies:
            resp.headers.update(self.c.cors.rest_headers())
        return resp

    @web.middleware
    async def _auth_middleware(self, request: web.Request, handler):
        if request.path in ("/ping", "/api/v1", "/metrics", "/docs",
                            "/api/v1/api-docs", "/api/v1/api-docs/ui") or \
                request.path.startswith("/api/v1/web/") or \
                request.path in self.c.public_extra_paths:
            return await handler(request)
        identity = await self.c.authenticator.identity_from_header(
            request.headers.get("Authorization"))
        if identity is None:
            return _error(401, "The supplied authentication is invalid.")
        request["identity"] = identity
        request["transid"] = TransactionId()
        try:
            return await handler(request)
        except MalformedEntity as e:
            # wrong-typed entity JSON: the reference's 400, never a 500
            return _error(400, f"The request content was malformed ({e}).",
                          request.get("transid"))
        except EntitlementException as e:
            return _error(e.status, e.message, request.get("transid"))
        except NoDocumentException:
            return _error(404, "The requested resource does not exist.",
                          request.get("transid"))
        except DocumentConflict:
            return _error(409, "Concurrent modification to resource detected.",
                          request.get("transid"))
        except LimitViolation as e:
            return _error(400, str(e), request.get("transid"))
        except LoadBalancerThrottleException as e:
            # device rate admission: same surface as an entitlement throttle
            return _error(429, str(e), request.get("transid"))
        except LoadBalancerException as e:
            return _error(503, str(e), request.get("transid"))
        except (json.JSONDecodeError, ValueError) as e:
            return _error(400, f"malformed request: {e}", request.get("transid"))
        except KeyError as e:
            return _error(400, f"missing required field: {e}", request.get("transid"))

    # -------------------------------------------------------------- helpers
    def _namespace(self, request: web.Request) -> str:
        ns = request.match_info["ns"]
        identity: Identity = request["identity"]
        return str(identity.namespace.name) if ns == "_" else ns

    async def _check(self, request, right, namespace, throttle=False,
                     is_trigger_fire=False, waterfall_ctx=None):
        await self.c.entitlement.check(request["identity"], right, namespace,
                                       throttle=throttle,
                                       is_trigger_fire=is_trigger_fire,
                                       waterfall_ctx=waterfall_ctx)

    @staticmethod
    def _list_params(request):
        try:
            limit = min(int(request.query.get("limit", 30)), MAX_LIST_LIMIT)
            skip = int(request.query.get("skip", 0))
        except ValueError:
            raise LimitViolation("limit/skip must be integers") from None
        return max(0, limit), max(0, skip)

    @staticmethod
    def _bool_param(request, name: str) -> bool:
        v = request.query.get(name, "false").lower()
        return v in ("true", "1", "yes", "")

    # ---------------------------------------------------------------- misc
    async def ping(self, request):
        return web.json_response("pong")

    async def api_info(self, request):
        return web.json_response({
            "description": "OpenWhisk-TPU", "api_version": "1.0.0",
            "api_paths": ["/api/v1"], "runtimes": ExecManifest.runtimes().kinds,
            "limits": {
                "actions_per_minute": self.c.entitlement.invoke_rate.default_per_minute,
                "concurrent_actions": self.c.entitlement.concurrent.default_concurrent,
                "triggers_per_minute": self.c.entitlement.fire_rate.default_per_minute,
                "max_action_duration": TimeLimit.MAX_MS,
                "max_action_memory": MemoryLimit.MAX.bytes,
                "min_action_duration": TimeLimit.MIN_MS,
                "min_action_memory": MemoryLimit.MIN.bytes,
            }})

    _api_docs_cache: Optional[dict] = None

    async def api_docs(self, request):
        """Swagger 2.0 description of the REST surface (ref SwaggerDocs,
        RestAPIs.scala:50-81). Static content, built once."""
        if ControllerApi._api_docs_cache is not None:
            return web.json_response(ControllerApi._api_docs_cache)

        def crud(noun, extra_ops=None):
            item = {
                "get": {"summary": f"get {noun}", "responses": {"200": {"description": "ok"}}},
                "put": {"summary": f"create/update {noun}",
                        "parameters": [{"name": "overwrite", "in": "query", "type": "boolean"}],
                        "responses": {"200": {"description": "ok"}, "409": {"description": "conflict"}}},
                "delete": {"summary": f"delete {noun}", "responses": {"200": {"description": "ok"}}},
            }
            item.update(extra_ops or {})
            return item

        invoke_op = {"post": {
            "summary": "invoke action",
            "parameters": [{"name": "blocking", "in": "query", "type": "boolean"},
                           {"name": "result", "in": "query", "type": "boolean"}],
            "responses": {"200": {"description": "activation"},
                          "202": {"description": "activation id"},
                          "502": {"description": "action error"}}}}
        def listing(noun):
            return {"get": {"summary": f"list {noun}",
                            "responses": {"200": {"description": "ok"}}}}

        web_op = {"summary": "invoke web action (anonymous; any verb)",
                  "responses": {"200": {"description": "ok"},
                                "401": {"description": "require-whisk-auth"}}}
        paths = {
            "/api/v1": {"get": {"summary": "API info",
                                "responses": {"200": {"description": "ok"}}}},
            "/api/v1/namespaces": {"get": {"summary": "namespaces for identity",
                                           "responses": {"200": {"description": "ok"}}}},
            "/api/v1/namespaces/{ns}/actions": listing("actions"),
            "/api/v1/namespaces/{ns}/actions/{name}": crud("action", invoke_op),
            "/api/v1/namespaces/{ns}/triggers": listing("triggers"),
            "/api/v1/namespaces/{ns}/triggers/{name}": crud("trigger", {
                "post": {"summary": "fire trigger",
                         "responses": {"202": {"description": "activation id"},
                                       "204": {"description": "no active rules"}}}}),
            "/api/v1/namespaces/{ns}/rules": listing("rules"),
            "/api/v1/namespaces/{ns}/rules/{name}": crud("rule", {
                "post": {"summary": "set rule status active/inactive",
                         "responses": {"200": {"description": "ok"}}}}),
            "/api/v1/namespaces/{ns}/packages": listing("packages"),
            "/api/v1/namespaces/{ns}/packages/{name}": crud("package"),
            "/api/v1/namespaces/{ns}/activations": {
                "get": {"summary": "list activations",
                        "parameters": [{"name": p, "in": "query", "type": "string"}
                                       for p in ("name", "limit", "skip",
                                                 "since", "upto", "docs")],
                        "responses": {"200": {"description": "ok"}}}},
            "/api/v1/namespaces/{ns}/activations/{id}": {
                "get": {"summary": "activation record",
                        "responses": {"200": {"description": "ok"}}}},
            "/api/v1/namespaces/{ns}/activations/{id}/logs": {
                "get": {"summary": "activation logs",
                        "responses": {"200": {"description": "ok"}}}},
            "/api/v1/namespaces/{ns}/activations/{id}/result": {
                "get": {"summary": "activation result",
                        "responses": {"200": {"description": "ok"}}}},
            "/api/v1/namespaces/{ns}/apis": {
                "get": {"summary": "list API routes", "responses": {"200": {"description": "ok"}}},
                "post": {"summary": "create API route", "responses": {"200": {"description": "ok"}}},
                "delete": {"summary": "delete API route", "responses": {"204": {"description": "ok"}}}},
            "/api/v1/web/{ns}/{pkg}/{name}": {
                verb: dict(web_op) for verb in
                ("get", "post", "put", "delete", "patch", "head")},
        }
        ControllerApi._api_docs_cache = {
            "swagger": "2.0",
            "info": {"title": "OpenWhisk-TPU", "version": "1.0.0"},
            "basePath": "/",
            "paths": paths,
        }
        return web.json_response(ControllerApi._api_docs_cache)

    async def docs_redirect(self, request):
        """`/docs` -> the swagger UI (ref RestAPIs.scala:50-81, where the
        reference redirects to its bundled swagger-ui)."""
        raise web.HTTPFound("/api/v1/api-docs/ui")

    async def api_docs_ui(self, request):
        """The operator-visible half of the swagger surface: a
        SELF-CONTAINED API explorer (no CDN assets — this must render in
        air-gapped deployments) that fetches /api/v1/api-docs and lays the
        paths out with methods, parameters and response codes."""
        return web.Response(text=_SWAGGER_UI_HTML, content_type="text/html")

    async def invokers(self, request):
        health = await self.c.load_balancer.invoker_health()
        body = {h.id.as_string: h.status for h in health}
        # observability for membership re-sharding ("/" keeps it disjoint
        # from invoker ids, which never contain one)
        body["cluster/size"] = self.c.load_balancer.cluster_size
        return web.json_response(body)

    async def metrics(self, request):
        # worker thread: the balancer's telemetry renderer reads the
        # device-accumulated histogram counts, which forces a device->host
        # sync that must not stall the event loop mid-step.
        # A scrape that negotiates OpenMetrics (Prometheus sends this
        # Accept header when exemplar scraping is on) gets the exemplar-
        # annotated rendering + the required EOF marker; the classic text
        # format never carries exemplars (its parsers reject them).
        openmetrics = ("application/openmetrics-text"
                       in request.headers.get("Accept", ""))
        text = await asyncio.to_thread(self.c.metrics.prometheus_text,
                                       openmetrics)
        if openmetrics:
            return web.Response(
                text=text + "# EOF\n",
                content_type="application/openmetrics-text")
        return web.Response(text=text, content_type="text/plain")

    # ------------------------------------------- placement introspection
    def _flight_recorder(self):
        return getattr(self.c.load_balancer, "flight_recorder", None)

    async def placement_recent(self, request):
        """Last N flight-recorder batch records (newest last). `?limit=N`
        bounds the answer (default 20, capped at the ring size);
        `?decisions=false` returns digests + timings only."""
        fr = self._flight_recorder()
        if fr is None:
            return _error(404, "this balancer has no flight recorder",
                          request.get("transid"))
        try:
            limit = max(0, int(request.query.get("limit", 20)))
        except ValueError:
            return _error(400, "limit must be an integer",
                          request.get("transid"))
        with_decisions = request.query.get(
            "decisions", "true").lower() not in ("false", "0", "no")
        return web.json_response({
            "enabled": fr.enabled,
            "size": fr.size,
            "recorded": len(fr),
            "dropped": fr.dropped,
            "records": fr.recent(limit, with_decisions=with_decisions),
        })

    async def placement_explain(self, request):
        """Why did activation X land on invoker Y: the recorded decision row
        plus the batch record it rode in (input digest + phase timings),
        cross-linked to the kept trace (if the tail sampler kept one) and
        any incident bundles whose window covers this activation — the
        triage jumping-off points, one lookup instead of three.
        404 once the ring has wrapped past the activation."""
        aid = request.match_info["activation_id"]
        fr = self._flight_recorder()
        found = fr.explain(aid) if fr is not None else None
        if found is None:
            return _error(
                404, "activation not in the flight recorder (never placed "
                "by this controller, recorder disabled, or the ring has "
                "wrapped past it)", request.get("transid"))
        trace_id = (found.get("batch") or {}).get(
            "digest", {}).get("trace_id")
        store = self._trace_store()
        if store is not None:
            kept = next((r["trace_id"] for r in store.list(n=4096)
                         if r.get("activation_id") == aid
                         and r.get("trace_id")), None)
            trace_id = kept or trace_id
        rec = self._incidents()
        incident_ids = []
        if rec is not None:
            # bundle index scan reads retention-bounded files — worker
            # thread, never on the event loop
            incident_ids = await asyncio.to_thread(
                rec.incidents_for_activation, aid)
        found["cross_links"] = {"trace_id": trace_id,
                                "incident_ids": incident_ids}
        return web.json_response(found)

    async def profile_host(self, request):
        """The host hot-loop observatory snapshot (utils/hostprof.py):
        event-loop lag percentiles (measured from each probe tick's
        SCHEDULED deadline), the worst-stall ring, per-generation GC pause
        accounting with the dispatch-overlap counter, task churn, per-hop
        serde shares and the sampler's self-time top-N. Host-side reads
        only — never a device sync, so it runs inline. `?collapsed=1`
        adds the always-on census as flamegraph-format collapsed stacks
        (the capture endpoint returns a full-rate bounded window
        instead)."""
        from ..utils.hostprof import GLOBAL_HOST_OBSERVATORY as obs
        if request.query.get("raw", "").lower() in ("1", "true", "yes"):
            # the exact-merge export the fleet federation scrapes
            return web.json_response(obs.raw_counts())
        snap = obs.snapshot()
        if snap.get("enabled") and request.query.get(
                "collapsed", "").lower() in ("1", "true", "yes"):
            snap["collapsed"] = obs.collapsed_text()
        return web.json_response(snap)

    async def profile_host_capture(self, request):
        """Arm a bounded full-rate host sampling window: `{"seconds": N}`
        (capped at CONFIG_whisk_hostProfiling_captureLimitS) samples the
        event-loop thread at CAPTURE_HZ and returns the window's self-time
        top-N plus the collapsed (flamegraph-format) stacks. One window at
        a time; 409 while host profiling is off or the sampler is down."""
        from ..utils.hostprof import GLOBAL_HOST_OBSERVATORY as obs
        if not obs.enabled:
            return _error(409, "host profiling is disabled "
                          "(CONFIG_whisk_hostProfiling_enabled=false)",
                          request.get("transid"))
        if not obs.sampler_running:
            return _error(409, "the host sampler is not running "
                          "(observatory not installed or sampleHz=0)",
                          request.get("transid"))
        body = (await request.json()) if request.can_read_body else {}
        if not isinstance(body, dict):
            return _error(400, "capture request body must be a JSON object",
                          request.get("transid"))
        try:
            seconds = float(body.get("seconds", 2.0))
        except (TypeError, ValueError):
            return _error(400, "seconds must be a number",
                          request.get("transid"))
        if seconds <= 0:
            return _error(400, "seconds must be > 0", request.get("transid"))
        try:
            return web.json_response(await obs.capture(seconds))
        except RuntimeError as e:
            # a concurrent window is already armed (or the sampler died
            # between the check above and the arm)
            return _error(409, str(e), request.get("transid"))

    def _trace_store(self):
        from ..utils.tracestore import GLOBAL_TRACE_STORE
        return GLOBAL_TRACE_STORE if GLOBAL_TRACE_STORE.enabled else None

    def _trace_disabled(self, request):
        return _error(404, "the trace observatory is disabled "
                      "(CONFIG_whisk_tracing_tail_enabled=false)",
                      request.get("transid"))

    async def traces_list(self, request):
        """Kept-trace summaries, newest first: `?reason=` filters by
        verdict reason (error/timeout/fenced/spilled/forced/divergent/
        exemplar/slow/floor), `?n=` caps the page. The `stats` block
        carries the keep/drop/pending counters and the live tail
        threshold."""
        store = self._trace_store()
        if store is None:
            return self._trace_disabled(request)
        try:
            n = max(1, int(request.query.get("n", 50)))
        except ValueError:
            return _error(400, "n must be an integer",
                          request.get("transid"))
        reason = request.query.get("reason") or None
        return web.json_response({"traces": store.list(reason=reason, n=n),
                                  "stats": store.stats()})

    async def trace_local(self, request):
        """This process's kept half of one trace — the leaf the
        assembling route scrapes from every peer. Unknown trace ids
        answer 200 `{"found": false}` (a live peer that never kept the
        trace is NOT a missing member); only a disabled plane 404s."""
        store = self._trace_store()
        if store is None:
            return self._trace_disabled(request)
        tid = request.match_info["trace_id"]
        entry = store.get(tid)
        return web.json_response({"trace_id": tid,
                                  "found": entry is not None,
                                  "entry": entry})

    async def trace_assembled(self, request):
        """ONE causal span tree for a trace id, assembled from the halves
        this process kept (the peers' `/admin/trace/local/{id}` leaves
        come with the fleet observatory's directory), clock-aligned at the
        bus handoff pairs and telescoping to the measured e2e. Answers 200
        with whatever halves there are, never a 500."""
        store = self._trace_store()
        if store is None:
            return self._trace_disabled(request)
        from ..utils.tracestore import assemble_trace
        tid = request.match_info["trace_id"]
        halves = []
        local = store.get(tid)
        if local is not None:
            halves.append(local)
        # the peers' halves come with the fleet observatory's directory
        return web.json_response(
            assemble_trace(tid, halves, members_missing=[]))

    # --------------------------------------------- incident forensics
    def _incidents(self):
        from ..utils.blackbox import GLOBAL_INCIDENTS
        return GLOBAL_INCIDENTS if GLOBAL_INCIDENTS.enabled else None

    def _incidents_disabled(self, request):
        return _error(404, "the incident forensics observatory is "
                      "disabled (CONFIG_whisk_incidents_enabled=false)",
                      request.get("transid"))

    async def incidents_list(self, request):
        """Captured incident bundles, newest first: summary rows (trigger,
        planes captured, journal window, coalesced count) plus the
        recorder's counters. The rows are the in-memory index — no disk
        read on this path."""
        rec = self._incidents()
        if rec is None:
            return self._incidents_disabled(request)
        return web.json_response({"incidents": rec.list_incidents(),
                                  "stats": rec.stats()})

    async def incident_local(self, request):
        """This process's copy of one bundle — the leaf the federated
        lookup scrapes from every peer. Unknown ids answer 200
        `{"found": false}` (a live peer that never captured the incident
        is NOT a missing member); only a disabled plane 404s. The bundle
        read is a CRC-checked file parse — worker thread, never on the
        event loop."""
        rec = self._incidents()
        if rec is None:
            return self._incidents_disabled(request)
        iid = request.match_info["incident_id"]
        payload = await asyncio.to_thread(rec.get, iid)
        return web.json_response({"incident_id": iid,
                                  "found": payload is not None,
                                  "incident": payload})

    async def incident_get(self, request):
        """One full forensic bundle. Local bundles answer directly (the
        peers' `local` leaves come with the fleet observatory's
        directory)."""
        rec = self._incidents()
        if rec is None:
            return self._incidents_disabled(request)
        iid = request.match_info["incident_id"]
        payload = await asyncio.to_thread(rec.get, iid)
        if payload is not None:
            return web.json_response({"incident": payload,
                                      "member": "local"})
        return _error(404, "incident not found (unknown id, pruned by "
                      "retention, or corrupt bundle)",
                      request.get("transid"))

    # ------------------------------------------------------- admin surface
    #: the admin routes of the JAX package's API whose plane this package
    #: does not carry yet, by plane: each answers 404 naming its plane
    UNPORTED_ADMIN = (
        ("placement quality plane", (
            ("GET", "/admin/placement/quality"),)),
        ("fleet observatory", (
            ("GET", "/admin/metrics/raw"),
            ("GET", "/admin/fleet/metrics"),
            ("GET", "/admin/fleet/waterfall"),
            ("GET", "/admin/fleet/slo"),
            ("GET", "/admin/fleet/host"),
            ("GET", "/admin/fleet/quality"),
            ("GET", "/admin/fleet/timeline"),
            ("GET", "/admin/fleet/incidents"))),
    )

    def _add_unported_admin_routes(self, router) -> None:
        for plane, routes in self.UNPORTED_ADMIN:
            async def not_ported(request, plane=plane):
                return _error(404, f"the {plane} is not ported to "
                              "openwhisk_tpu_torch yet",
                              request.get("transid"))
            for method, path in routes:
                router.add_route(method, path, not_ported)

    async def slo_report(self, request):
        """Is the fleet meeting its latency/error SLOs, and which invokers
        or tenants are burning the budget: the telemetry plane's evaluation
        of the `CONFIG_whisk_slo_*` targets against the accumulated
        per-invoker / per-namespace latency buckets."""
        tp = getattr(self.c.load_balancer, "telemetry", None)
        if tp is None:
            return _error(404, "this balancer has no telemetry plane",
                          request.get("transid"))
        names = []
        lb = self.c.load_balancer
        if hasattr(lb, "_telemetry_invoker_names"):
            names = lb._telemetry_invoker_names()
        # ?raw=1: the label-keyed exact-merge export the fleet federation
        # scrapes (integer bucket/outcome counts, no verdicts)
        raw = request.query.get("raw", "").lower() in ("1", "true", "yes")
        fn = tp.raw_counts if raw else tp.slo_report
        if tp.SYNCS_DEVICE:
            # reading device counts forces a device sync — worker thread,
            # same policy as the occupancy endpoint
            report = await asyncio.to_thread(fn, names)
        else:
            report = fn(names)
        return web.json_response(report)

    async def profile_kernel(self, request):
        """The kernel profiling observatory: compile log + classification,
        cache-key census, kernel builds, per-phase p50/p99 over the last N
        batches, HBM / memory stats, and capture-window status. Reads are
        host-side only (no device sync), so this runs inline."""
        lb = self.c.load_balancer
        if getattr(lb, "profiler", None) is None:
            return _error(404, "this balancer has no kernel profiler",
                          request.get("transid"))
        if hasattr(lb, "kernel_profile"):
            return web.json_response(lb.kernel_profile())
        return web.json_response(lb.profiler.profile_json())

    async def profile_capture(self, request):
        """Arm a bounded capture window: `{"steps": N}` records the next N
        dispatch steps at full detail (capped at the configured limit);
        `"trace_dir"` additionally runs a server-side `torch.profiler`
        session whose Chrome trace lands there; `"tail_threshold_ms"`
        re-targets the tail sampler (0 disables it)."""
        lb = self.c.load_balancer
        prof = getattr(lb, "profiler", None)
        if prof is None:
            return _error(404, "this balancer has no kernel profiler",
                          request.get("transid"))
        if not prof.enabled:
            return _error(409, "kernel profiling is disabled "
                          "(CONFIG_whisk_profiling_enabled=false)",
                          request.get("transid"))
        body = (await request.json()) if request.can_read_body else {}
        if not isinstance(body, dict):
            return _error(400, "capture request body must be a JSON object",
                          request.get("transid"))
        try:
            steps = int(body.get("steps", 16))
            ttl = body.get("tail_threshold_ms")
            ttl = float(ttl) if ttl is not None else None
        except (TypeError, ValueError):
            return _error(400, "steps must be an integer and "
                          "tail_threshold_ms a number",
                          request.get("transid"))
        if steps < 1:
            return _error(400, "steps must be >= 1", request.get("transid"))
        trace_dir = body.get("trace_dir")
        if trace_dir is not None and not isinstance(trace_dir, str):
            return _error(400, "trace_dir must be a string",
                          request.get("transid"))
        return web.json_response(prof.arm_capture(
            steps, trace_dir=trace_dir, tail_threshold_ms=ttl))

    async def alerts_report(self, request):
        """The alert plane: configured rules, active (pending + firing)
        alerts, and the recent transition log from the alert ring.
        `?limit=N` bounds the transition history (default 50)."""
        plane = getattr(self.c.load_balancer, "anomaly", None)
        if plane is None:
            return _error(404, "this balancer has no anomaly plane",
                          request.get("transid"))
        try:
            limit = max(0, int(request.query.get("limit", 50)))
        except ValueError:
            return _error(400, "limit must be an integer",
                          request.get("transid"))
        return web.json_response(plane.alerts_report(limit))

    async def anomalies_report(self, request):
        """Per-invoker anomaly scores (straggler / error-spike /
        timeout-spike), flags, and evidence — which latency buckets moved
        since the last detection tick. Device-path evidence forces a
        device->host sync, so the report runs on a worker thread then
        (same policy as /admin/slo)."""
        lb = self.c.load_balancer
        plane = getattr(lb, "anomaly", None)
        if plane is None:
            return _error(404, "this balancer has no anomaly plane",
                          request.get("transid"))
        names = None
        if hasattr(lb, "_telemetry_invoker_names"):
            names = lb._telemetry_invoker_names()
        if plane.SYNCS_DEVICE:
            report = await asyncio.to_thread(plane.anomalies_report, names)
        else:
            report = plane.anomalies_report(names)
        return web.json_response(report)

    async def admin_ready(self, request):
        """Readiness probe: which placement role this controller holds.
        The port runs its controllers without HA or partitions, so the
        mode is `single` and the answer 200; a controller in the
        membership protocol adds the live cluster size."""
        lb = self.c.load_balancer
        doc = {"mode": "single", "ready": True}
        journal = getattr(lb, "journal", None)
        jdoc = {"attached": journal is not None}
        if journal is not None:
            jdoc["lag_batches"] = journal.lag_batches
        plane = getattr(lb, "anomaly", None)
        if plane is not None:
            jdoc["stall_firing"] = any(
                name == "journal_stall"
                for (name, _sev) in plane.engine.firing_counts())
        doc["journal"] = jdoc
        mem = self.c.membership
        if mem is not None:
            doc["cluster_size"] = mem.cluster_size
        return web.json_response(doc)

    async def latency_waterfall(self, request):
        """Where does the end-to-end latency live: per-stage p50/p90/p99
        from the waterfall plane's log2 histograms, the stage-median budget
        against the measured e2e median, dominant-stage tail attribution,
        and the slowest-activation exemplar rows. Host-side numpy only, so
        it runs inline on the event loop. `?recent=N` adds the last N
        completed rows."""
        wf = getattr(self.c.load_balancer, "waterfall", None)
        if wf is None:
            return _error(404, "this balancer has no latency waterfall",
                          request.get("transid"))
        try:
            recent = max(0, int(request.query.get("recent", 0)))
            rows = max(0, int(request.query.get("rows", 0)))
        except ValueError:
            return _error(400, "recent/rows must be integers",
                          request.get("transid"))
        if request.query.get("raw", "").lower() in ("1", "true", "yes"):
            return web.json_response(wf.raw_counts(rows=rows))
        return web.json_response(wf.report(recent=recent))

    async def admin_index(self, request):
        """Every /admin route of the JAX package's surface with its state
        here: `enabled: false` rows answer 404, and `plane` names what is
        not ported yet."""
        return web.json_response({"routes": self._admin_routes()})

    def _admin_routes(self) -> list:
        lb = self.c.load_balancer

        fr = self._flight_recorder()
        prof = getattr(lb, "profiler", None)
        from ..utils.hostprof import GLOBAL_HOST_OBSERVATORY as obs
        traces_on = self._trace_store() is not None
        incidents_on = self._incidents() is not None

        def row(path, method, enabled, plane=None, knob=None):
            return {"path": path, "method": method, "knob": knob,
                    "enabled": bool(enabled), "plane": plane}

        rows = [
            row("/admin", "GET", True),
            row("/admin/placement/recent", "GET", fr is not None,
                knob="CONFIG_whisk_loadBalancer_flightRecorder_enabled"),
            row("/admin/placement/explain/{activation_id}", "GET",
                fr is not None,
                knob="CONFIG_whisk_loadBalancer_flightRecorder_enabled"),
            row("/admin/placement/occupancy", "GET", lb is not None),
            row("/admin/slo", "GET",
                getattr(lb, "telemetry", None) is not None),
            row("/admin/profile/kernel", "GET", prof is not None,
                knob="CONFIG_whisk_profiling_enabled"),
            row("/admin/profile/capture", "POST",
                prof is not None and prof.enabled,
                knob="CONFIG_whisk_profiling_enabled"),
            row("/admin/profile/host", "GET", True,
                knob="CONFIG_whisk_hostProfiling_enabled"),
            row("/admin/profile/host/capture", "POST",
                obs.enabled and obs.sampler_running,
                knob="CONFIG_whisk_hostProfiling_enabled"),
            row("/admin/alerts", "GET",
                getattr(lb, "anomaly", None) is not None,
                knob="CONFIG_whisk_anomaly_enabled"),
            row("/admin/anomalies", "GET",
                getattr(lb, "anomaly", None) is not None,
                knob="CONFIG_whisk_anomaly_enabled"),
            row("/admin/latency/waterfall", "GET",
                getattr(lb, "waterfall", None) is not None),
            row("/admin/ready", "GET", True),
            row("/admin/traces", "GET", traces_on,
                knob="CONFIG_whisk_tracing_tail_enabled"),
            row("/admin/trace/local/{trace_id}", "GET", traces_on,
                knob="CONFIG_whisk_tracing_tail_enabled"),
            row("/admin/trace/{trace_id}", "GET", traces_on,
                knob="CONFIG_whisk_tracing_tail_enabled"),
            row("/admin/incidents", "GET", incidents_on,
                knob="CONFIG_whisk_incidents_enabled"),
            row("/admin/incident/local/{incident_id}", "GET", incidents_on,
                knob="CONFIG_whisk_incidents_enabled"),
            row("/admin/incident/{incident_id}", "GET", incidents_on,
                knob="CONFIG_whisk_incidents_enabled"),
        ]
        for plane, routes in self.UNPORTED_ADMIN:
            rows += [row(path, method, False, plane)
                     for method, path in routes]
        return rows

    async def placement_occupancy(self, request):
        """Per-invoker slots-in-use/capacity derived from the balancer
        books (device books for the TPU balancer, host semaphores for the
        CPU balancers)."""
        lb = self.c.load_balancer
        if lb is None:
            return _error(404, "no load balancer", request.get("transid"))
        if getattr(lb, "OCCUPANCY_SYNCS_DEVICE", False):
            # worker thread: the TPU balancer's books read forces a device
            # sync that must not stall the event loop mid-step
            return web.json_response(await asyncio.to_thread(lb.occupancy))
        # CPU balancers read loop-owned books: run inline so the iteration
        # cannot race event-loop mutation
        return web.json_response(lb.occupancy())

    async def list_namespaces(self, request):
        identity: Identity = request["identity"]
        return web.json_response([str(identity.namespace.name)])

    # -------------------------------------------------------------- actions
    async def list_actions(self, request):
        ns = self._namespace(request)
        await self._check(request, READ, ns)
        limit, skip = self._list_params(request)
        docs = await self.c.entity_store.list("actions", ns, skip, limit)
        return web.json_response([self._summary(d) for d in docs])

    @staticmethod
    def _summary(doc: dict) -> dict:
        out = {k: doc.get(k) for k in
               ("namespace", "name", "version", "publish", "annotations", "updated")}
        if doc.get("entityType") == "actions":
            exec_meta = {k: v for k, v in (doc.get("exec") or {}).items() if k != "code"}
            out["exec"] = exec_meta
            out["limits"] = doc.get("limits")
        if doc.get("entityType") == "rules":
            out["trigger"] = doc.get("trigger")
            out["action"] = doc.get("action")
        if doc.get("entityType") == "packages":
            out["binding"] = doc.get("binding") or {}
        return out

    async def action_entry(self, request):
        ns = self._namespace(request)
        name = request.match_info["name"]
        fqn = FullyQualifiedEntityName.parse(f"{ns}/{name}")
        if request.method == "PUT":
            return await self._put_action(request, ns, fqn)
        if request.method == "GET":
            return await self._get_action(request, ns, fqn)
        if request.method == "DELETE":
            return await self._delete_action(request, ns, fqn)
        if request.method == "POST":
            return await self._invoke_action(request, ns, fqn)
        return _error(405, "method not allowed")

    async def _check_sequence_limits(self, request, fqn, ns, components):
        """Validate a sequence at PUT (ref Actions.scala:588-673
        checkSequenceActionLimits): a sequence must have components; the
        atomic-action count — computed by inlining nested sequences — must
        stay within the sequence limit; no component may refer (directly or
        through nested sequences) back to the sequence being created, and
        every component must exist. Recursion terminates because pre-existing
        sequences were validated at their own PUT, so any cycle must pass
        through `fqn`. Returns an error response, or None when valid."""
        limit = self.c.action_sequence_limit
        transid = request["transid"]
        if not components:
            return _error(400, "No component specified for the sequence.",
                          transid)
        if len(components) > limit:
            return _error(400, "Too many actions in the sequence.", transid)
        seq_key = str(fqn)

        class _Invalid(Exception):
            def __init__(self, message):
                self.message = message

        identity = request["identity"]
        own_ns = str(identity.namespace.name)

        async def check_component_readable(resolved) -> None:
            """Cross-namespace components need READ entitlement or a
            published provider package — checked BEFORE resolution, with one
            403 for missing and unauthorized alike, so a foreign caller
            cannot probe which private actions exist (ref Actions.scala PUT:
            entitlement on ReferencedEntities precedes lookup; publicity is
            package-level, same rule as cross-namespace binds above)."""
            comp_ns = resolved.path.root_str
            if comp_ns == own_ns:
                return
            try:
                await self.c.entitlement.check(identity, READ, comp_ns)
                return
            except RejectRequest:
                segs = resolved.path.segments
                if len(segs) == 2:
                    try:
                        provider = await self.c.entity_store.get_package(
                            f"{segs[0]}/{segs[1]}")
                        if provider.publish:
                            return
                    except NoDocumentException:
                        pass
                raise

        async def count_atomic(root) -> int:
            # iterative traversal: Python recursion would overflow on a deep
            # (legal) chain of nested sequences, and the path-scoped visited
            # set makes traversal of an already-corrupted graph (a cycle
            # committed by racing PUTs) fail as cyclic instead of looping —
            # the Scala reference re-recurses forever on that graph
            total = 0
            on_path = {seq_key}
            stack = [(iter(root), None)]  # (component iterator, owner key)
            fetched = {}  # str(resolved) -> action: diamonds resolve once
            while stack:
                it, owner = stack[-1]
                c = next(it, None)
                if c is None:
                    stack.pop()
                    if owner is not None:
                        on_path.discard(owner)
                    continue
                resolved = c.resolve(ns)
                if str(resolved) in on_path:
                    raise _Invalid("Sequence may not refer to itself.")
                comp = fetched.get(str(resolved))
                if comp is None:
                    await check_component_readable(resolved)
                    try:
                        comp, _ = await resolve_action(
                            self.c.entity_store, resolved, identity)
                    except NoDocumentException:
                        raise _Invalid("Sequence component does not exist.")
                    fetched[str(resolved)] = comp
                # a binding alias resolves to the real action: compare that
                # identity too, so aliased self-references are still cycles
                real = str(comp.fully_qualified_name)
                if real in on_path:
                    raise _Invalid("Sequence may not refer to itself.")
                if comp.is_sequence:
                    on_path.add(real)
                    stack.append((iter(comp.exec.components), real))
                else:
                    total += 1
                    if total > limit:
                        raise _Invalid("Too many actions in the sequence.")
            return total

        try:
            await count_atomic(components)
        except _Invalid as e:
            return _error(400, e.message, transid)
        return None

    async def _put_action(self, request, ns, fqn):
        await self._check(request, PUT, ns)
        overwrite = self._bool_param(request, "overwrite")
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return _error(400, "malformed JSON body", request["transid"])
        try:
            old = await self.c.entity_store.get_action(str(fqn))
        except NoDocumentException:
            old = None
        if old is not None and not overwrite:
            return _error(409, "resource already exists", request["transid"])
        if "exec" in body:
            try:
                exec_ = Exec.from_json(body["exec"])
            except MalformedEntity:
                raise  # the middleware answers the reference's malformed-400
            except ValueError as e:
                # e.g. an unparsable component FQN in a sequence
                return _error(400, f"malformed exec: {e}", request["transid"])
            if exec_.kind not in ("sequence", "blackbox"):
                resolved = ExecManifest.runtimes().resolve_default(exec_.kind)
                if not ExecManifest.runtimes().knows(resolved):
                    return _error(
                        400, f"kind '{exec_.kind}' not in Set({', '.join(ExecManifest.runtimes().kinds)})",
                        request["transid"])
                exec_.kind = resolved
                self.c.entitlement.check_kind(request["identity"], exec_.kind)
            if isinstance(exec_, SequenceExec):
                exec_.components = [c.resolve(ns) for c in exec_.components]
                err = await self._check_sequence_limits(
                    request, fqn, ns, exec_.components)
                if err is not None:
                    return err
        elif old is not None:
            # exec, like every other field, is optional on update
            # (ref WhiskActionPut: `content.exec getOrElse action.exec`)
            exec_ = old.exec
        else:
            return _error(400, "exec undefined", request["transid"])
        action = WhiskAction(
            fqn.path if not fqn.path.default_package else EntityPath(ns),
            fqn.name if isinstance(fqn.name, EntityName) else EntityName(str(fqn.name)),
            exec_,
            Parameters.from_json(body.get("parameters")),
            ActionLimits.from_json(body.get("limits")),
            publish=bool(body.get("publish", False)),
            annotations=Parameters.from_json(body.get("annotations")),
        )
        # correct namespace for packaged actions: ns/pkg
        action.namespace = fqn.path
        if old is not None:
            action.version = old.version.up_patch()
            action.rev = old.rev
            # an update inherits every field the request omits (ref
            # Actions.scala WhiskActionPut `getOrElse old`) — else a routine
            # exec-only PUT would drop the stamped provide-api-key:false
            # (re-exposing the key), reset limits to defaults (killing a
            # long-timeout action at 60s), and unpublish
            if "annotations" not in body:
                action.annotations = old.annotations
            if "parameters" not in body:
                action.parameters = old.parameters
            if "limits" not in body:
                action.limits = old.limits
            if "publish" not in body:
                action.publish = old.publish
            action.annotations = _amend_annotations(
                action.annotations, exec_, create=False)
        else:
            action.annotations = _amend_annotations(
                action.annotations, exec_, create=True)
        await self.c.entity_store.put(action)
        return web.json_response(action.to_json())

    async def _get_action(self, request, ns, fqn):
        await self._check(request, READ, ns)
        action, _ = await resolve_action(self.c.entity_store, fqn, request["identity"])
        j = action.to_json()
        if request.query.get("code", "true").lower() == "false" and "exec" in j:
            j["exec"].pop("code", None)
        return web.json_response(j)

    async def _delete_action(self, request, ns, fqn):
        await self._check(request, DELETE, ns)
        action = await self.c.entity_store.get_action(str(fqn))
        await self.c.entity_store.delete(action)
        return web.json_response(action.to_json())

    async def _invoke_action(self, request, ns, fqn):
        # latency waterfall: anchor the stage vector at handler entry
        # (api_accept), then thread it through entitle/throttle and — for
        # the primitive path — down to the activation id minted in
        # ActionInvoker.invoke. Sequences/compositions anchor their
        # components at publish instead (each gets its own vector).
        from ..utils.waterfall import GLOBAL_WATERFALL, STAGE_API_ACCEPT
        wf_ctx = GLOBAL_WATERFALL.open()
        GLOBAL_WATERFALL.stamp_ctx(wf_ctx, STAGE_API_ACCEPT)
        await self._check(request, ACTIVATE, ns, throttle=True,
                          waterfall_ctx=wf_ctx)
        blocking = self._bool_param(request, "blocking")
        result_only = self._bool_param(request, "result")
        try:
            wait_override = float(request.query["timeout"]) / 1000.0 \
                if "timeout" in request.query else None
        except ValueError:
            wait_override = None
        try:
            payload = await request.json() if request.can_read_body else {}
        except json.JSONDecodeError:
            return _error(400, "malformed JSON body", request["transid"])
        action, pkg_params = await resolve_action(self.c.entity_store, fqn,
                                                  request["identity"])
        from .conductors import is_conductor
        if action.is_sequence:
            outcome = await self.c.sequencer.invoke_sequence(
                request["identity"], action, payload, blocking,
                transid=request["transid"])
        elif is_conductor(action):
            outcome = await self.c.conductor.invoke_composition(
                request["identity"], action, payload, blocking,
                transid=request["transid"], package_params=pkg_params)
        else:
            outcome = await self.c.invoker.invoke(
                request["identity"], action, pkg_params, payload, blocking,
                transid=request["transid"], wait_override=wait_override,
                waterfall_ctx=wf_ctx)
        if outcome.accepted:
            return web.json_response(
                {"activationId": outcome.activation_id.asString}, status=202)
        activation = outcome.activation
        if result_only:
            status = 200 if activation.response.is_success else 502
            return web.json_response(activation.resulting_json(), status=status)
        status = 200 if activation.response.is_success else 502
        return web.json_response(activation.to_json(), status=status)

    # ---------------------------------------------------------- activations
    async def list_activations(self, request):
        ns = self._namespace(request)
        await self._check(request, READ, ns)
        limit, skip = self._list_params(request)
        name = request.query.get("name")
        since = float(request.query["since"]) / 1000 if "since" in request.query else None
        upto = float(request.query["upto"]) / 1000 if "upto" in request.query else None
        if self._bool_param(request, "count"):
            n = await self.c.activation_store.count(ns, name, since, upto)
            return web.json_response({"activations": n})
        docs = await self.c.activation_store.list(ns, name, skip, limit, since, upto)
        if self._bool_param(request, "docs"):
            # full records incl. response/logs (ref Activations.scala ?docs)
            return web.json_response(
                [WhiskActivation.from_json(d).to_json() for d in docs])
        summaries = [WhiskActivation.from_json(d).summary_json() for d in docs]
        return web.json_response(summaries)

    async def _activation(self, request) -> WhiskActivation:
        ns = self._namespace(request)
        await self._check(request, READ, ns)
        try:
            aid = ActivationId(request.match_info["id"])
        except ValueError:
            raise NoDocumentException("malformed activation id") from None
        return await self.c.activation_store.get(ns, aid)

    async def get_activation(self, request):
        return web.json_response((await self._activation(request)).to_json())

    async def get_activation_logs(self, request):
        a = await self._activation(request)
        # LogStore SPI fetch side (ref LogStore.fetchLogs): remote stores
        # (Elastic/Splunk) pull from their backend; default reads the record
        logs = await self.c.log_store.fetch_logs(request["identity"], a)
        return web.json_response({"logs": logs})

    async def get_activation_result(self, request):
        a = await self._activation(request)
        return web.json_response({"result": a.response.result,
                                  "status": a.response.status,
                                  "success": a.response.is_success})

    # -------------------------------------------------------------- triggers
    async def list_triggers(self, request):
        ns = self._namespace(request)
        await self._check(request, READ, ns)
        limit, skip = self._list_params(request)
        docs = await self.c.entity_store.list("triggers", ns, skip, limit)
        return web.json_response([self._summary(d) for d in docs])

    async def trigger_entry(self, request):
        ns = self._namespace(request)
        name = request.match_info["name"]
        doc_id = f"{ns}/{name}"
        if request.method == "PUT":
            await self._check(request, PUT, ns)
            overwrite = self._bool_param(request, "overwrite")
            body = await request.json() if request.can_read_body else {}
            trigger = WhiskTrigger(EntityPath(ns), EntityName(name),
                                   Parameters.from_json(body.get("parameters")),
                                   annotations=Parameters.from_json(body.get("annotations")),
                                   publish=bool(body.get("publish", False)))
            # feed annotation must name a feed action: 1-3 path segments
            # (name | package/name | namespace/package/name), each a valid
            # entity name (ref Triggers.scala validateTriggerFeed :282-303;
            # the feed lifecycle invoke itself is the CLI's macro operation,
            # tools/wsk.py)
            feed = trigger.annotations.get("feed")
            if feed is not None:
                try:
                    if not isinstance(feed, str):
                        raise ValueError(feed)
                    segs = EntityPath(feed).segments
                    # a leading slash claims full qualification, which needs
                    # at least namespace + action
                    if not 1 <= len(segs) <= 3 or \
                            (feed.startswith("/") and len(segs) < 2):
                        raise ValueError(feed)
                except ValueError:
                    return _error(400, "Feed name is not valid",
                                  request["transid"])
            try:
                old = await self.c.entity_store.get_trigger(doc_id)
                if not overwrite:
                    return _error(409, "resource already exists", request["transid"])
                trigger.version = old.version.up_patch()
                trigger.rev = old.rev
                trigger.rules = old.rules
                # fields absent from the update body keep their stored
                # values (ref Triggers.scala update: `content.annotations
                # getOrElse trigger.annotations` etc., :265-278) — an update
                # that only changes parameters must not erase, e.g., the
                # feed annotation
                if "annotations" not in body:
                    trigger.annotations = old.annotations
                if "parameters" not in body:
                    trigger.parameters = old.parameters
            except NoDocumentException:
                pass
            await self.c.entity_store.put(trigger)
            return web.json_response(trigger.to_json())
        if request.method == "GET":
            await self._check(request, READ, ns)
            return web.json_response((await self.c.entity_store.get_trigger(doc_id)).to_json())
        if request.method == "DELETE":
            await self._check(request, DELETE, ns)
            trigger = await self.c.entity_store.get_trigger(doc_id)
            await self.c.entity_store.delete(trigger)
            return web.json_response(trigger.to_json())
        if request.method == "POST":
            await self._check(request, ACTIVATE, ns, throttle=True,
                              is_trigger_fire=True)
            try:
                payload = await request.json() if request.can_read_body else {}
            except json.JSONDecodeError:
                payload = {}
            trigger = await self.c.entity_store.get_trigger(doc_id)
            result = await self.c.trigger_service.fire(request["identity"], trigger,
                                                       payload, request["transid"])
            if result is None:
                return web.Response(status=204)
            return web.json_response({"activationId": result.asString}, status=202)
        return _error(405, "method not allowed")

    # ----------------------------------------------------------------- rules
    async def list_rules(self, request):
        ns = self._namespace(request)
        await self._check(request, READ, ns)
        limit, skip = self._list_params(request)
        docs = await self.c.entity_store.list("rules", ns, skip, limit)
        return web.json_response([self._summary(d) for d in docs])

    async def rule_entry(self, request):
        ns = self._namespace(request)
        name = request.match_info["name"]
        doc_id = f"{ns}/{name}"
        if request.method == "PUT":
            await self._check(request, PUT, ns)
            overwrite = self._bool_param(request, "overwrite")
            body = await request.json()
            rule = WhiskRule(EntityPath(ns), EntityName(name),
                             FullyQualifiedEntityName.parse(body["trigger"]).resolve(ns),
                             FullyQualifiedEntityName.parse(body["action"]).resolve(ns),
                             annotations=Parameters.from_json(body.get("annotations")))
            return await self._put_rule(request, ns, doc_id, rule, overwrite)
        if request.method == "GET":
            await self._check(request, READ, ns)
            rule = await self.c.entity_store.get_rule(doc_id)
            j = rule.to_json()
            j["status"] = await self.c.rule_status(rule)
            return web.json_response(j)
        if request.method == "DELETE":
            await self._check(request, DELETE, ns)
            return web.json_response(await self.c.delete_rule(doc_id))
        if request.method == "POST":  # status change {"status": "active"|"inactive"}
            await self._check(request, PUT, ns)
            body = await request.json()
            status = body.get("status")
            if status not in (ACTIVE, "inactive"):
                return _error(400, "status must be 'active' or 'inactive'",
                              request["transid"])
            await self.c.set_rule_status(doc_id, status)
            return web.Response(status=200, text="{}",
                                content_type="application/json")
        return _error(405, "method not allowed")

    async def _put_rule(self, request, ns, doc_id, rule: WhiskRule, overwrite: bool):
        # validate trigger + action exist (ref Rules.scala)
        trigger = await self.c.entity_store.get_trigger(str(rule.trigger))
        await self.c.entity_store.get_action(str(rule.action))
        try:
            old = await self.c.entity_store.get_rule(doc_id)
            if not overwrite:
                return _error(409, "resource already exists", request["transid"])
            rule.version = old.version.up_patch()
            rule.rev = old.rev
            old_trigger = await self.c.entity_store.get_trigger(str(old.trigger))
            if str(old.trigger) != str(rule.trigger):
                old_trigger.remove_rule(doc_id)
                await self.c.entity_store.put(old_trigger)
                trigger = await self.c.entity_store.get_trigger(str(rule.trigger))
        except NoDocumentException:
            pass
        await self.c.entity_store.put(rule)
        trigger.add_rule(doc_id, ReducedRule(rule.action, ACTIVE))
        await self.c.entity_store.put(trigger)
        j = rule.to_json()
        j["status"] = ACTIVE
        return web.json_response(j)

    # -------------------------------------------------------------- packages
    async def list_packages(self, request):
        ns = self._namespace(request)
        await self._check(request, READ, ns)
        limit, skip = self._list_params(request)
        docs = await self.c.entity_store.list("packages", ns, skip, limit)
        return web.json_response([self._summary(d) for d in docs])

    async def package_entry(self, request):
        ns = self._namespace(request)
        name = request.match_info["name"]
        doc_id = f"{ns}/{name}"
        if request.method == "PUT":
            await self._check(request, PUT, ns)
            overwrite = self._bool_param(request, "overwrite")
            body = await request.json() if request.can_read_body else {}
            binding = None
            b = body.get("binding") or {}
            if b:
                # "_" in the binding reference resolves to the caller's
                # namespace, like everywhere else on the API surface
                b_ns = ns if b["namespace"] == "_" else b["namespace"]
                binding = Binding(EntityPath(b_ns), EntityName(b["name"]))
                # a cross-namespace bind requires the provider be published
                # — otherwise any authenticated user could lift a private
                # package's parameters (credentials) into their own
                # namespace. Nonexistent and private providers answer
                # IDENTICALLY so the bind surface cannot be used as an
                # existence oracle for other namespaces' package names.
                try:
                    provider = await self.c.entity_store.get_package(
                        str(binding.fqn))  # must exist
                except NoDocumentException:
                    if b_ns != ns:
                        return _error(
                            403, "the referenced package is not accessible",
                            request["transid"])
                    raise
                if b_ns != ns and not provider.publish:
                    return _error(
                        403, "the referenced package is not accessible",
                        request["transid"])
                # ref Packages.scala bind semantics: no chains — a provider
                # that is itself a binding dereferences only one level, so
                # its "actions" could never resolve
                if provider.is_binding:
                    return _error(400, "cannot bind to another binding",
                                  request["transid"])
            pkg = WhiskPackage(EntityPath(ns), EntityName(name), binding,
                               Parameters.from_json(body.get("parameters")),
                               publish=bool(body.get("publish", False)),
                               annotations=Parameters.from_json(body.get("annotations")))
            try:
                old = await self.c.entity_store.get_package(doc_id)
                if not overwrite:
                    return _error(409, "resource already exists", request["transid"])
                pkg.version = old.version.up_patch()
                pkg.rev = old.rev
            except NoDocumentException:
                pass
            await self.c.entity_store.put(pkg)
            return web.json_response(pkg.to_json())
        if request.method == "GET":
            await self._check(request, READ, ns)
            pkg = await self.c.entity_store.get_package(doc_id)
            j = pkg.to_json()
            # include package contents (actions in the package), ref Packages.scala
            actions = await self.c.entity_store.list("actions", f"{ns}/{name}",
                                                     0, MAX_LIST_LIMIT)
            j["actions"] = [{"name": d["name"], "version": d.get("version")}
                            for d in actions]
            return web.json_response(j)
        if request.method == "DELETE":
            await self._check(request, DELETE, ns)
            pkg = await self.c.entity_store.get_package(doc_id)
            contents = await self.c.entity_store.list("actions", f"{ns}/{name}", 0, 1)
            if contents:
                return _error(409, "Package not empty (contains at least one entity)",
                              request["transid"])
            await self.c.entity_store.delete(pkg)
            return web.json_response(pkg.to_json())
        return _error(405, "method not allowed")

    # ------------------------------------------------------- api gateway mgmt
    async def apis_entry(self, request):
        """Route-management surface (reference core/routemgmt createApi/
        getApi/deleteApi actions): CRUD swagger-shaped API route docs served
        by the edge proxy."""
        ns = self._namespace(request)
        rm = self.c.route_manager
        if request.method == "GET":
            await self._check(request, READ, ns)
            apis = await rm.get_apis(ns, request.query.get("basepath"),
                                     request.query.get("relpath"),
                                     request.query.get("operation"))
            return web.json_response({"apis": apis})
        if request.method in ("PUT", "POST"):
            await self._check(request, PUT, ns)
            body = await request.json()
            apidoc = body.get("apidoc", body)
            # resolve the "_" namespace placeholder inside the apidoc the
            # same way the URL path resolves it, else the stored backend
            # URL would point at the literal "_" namespace and 404
            target = apidoc.get("action")
            if isinstance(target, dict) and target.get("namespace") in ("_", None):
                target["namespace"] = ns
            try:
                view = await rm.create_api(ns, apidoc)
            except ApiManagementException as e:
                return _error(e.status, e.message, request["transid"])
            return web.json_response(view)
        if request.method == "DELETE":
            await self._check(request, DELETE, ns)
            basepath = request.query.get("basepath")
            if not basepath:
                return _error(400, "basepath query parameter required",
                              request["transid"])
            await rm.delete_api(ns, basepath,
                                request.query.get("relpath"),
                                request.query.get("operation"))
            return web.Response(status=204)
        return _error(405, "method not allowed")

    # ----------------------------------------------------------- web actions
    async def web_action(self, request):
        """Anonymous invocation of actions annotated web-export
        (ref WebActions.scala:375-460): /api/v1/web/{ns}/{pkg}/{name}.{ext};
        pkg 'default' means no package."""
        return await self.c.web_actions.handle(request)


_SWAGGER_UI_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>OpenWhisk-TPU API</title>
<style>
  body { font-family: -apple-system, 'Segoe UI', sans-serif; margin: 0;
         background: #fafafa; color: #1a1a1a; }
  header { background: #14334d; color: #fff; padding: 14px 24px; }
  header h1 { margin: 0; font-size: 18px; font-weight: 600; }
  header a { color: #9cc7e8; font-size: 13px; text-decoration: none; }
  main { max-width: 960px; margin: 18px auto; padding: 0 16px; }
  .path { background: #fff; border: 1px solid #e2e2e2; border-radius: 6px;
          margin-bottom: 8px; overflow: hidden; }
  .path > summary { padding: 8px 12px; cursor: pointer; font-family: ui-monospace, monospace;
          font-size: 13px; display: flex; gap: 8px; align-items: center; flex-wrap: wrap; }
  .op { border-top: 1px solid #eee; padding: 8px 12px 10px; font-size: 13px; }
  .verb { display: inline-block; min-width: 52px; text-align: center;
          border-radius: 3px; color: #fff; font-size: 11px; font-weight: 700;
          padding: 2px 6px; text-transform: uppercase; }
  .get { background: #2f81b7; } .post { background: #3f9c5f; }
  .put { background: #c78a28; } .delete { background: #c0392b; }
  .patch { background: #7b5ea7; } .head { background: #6a7a86; }
  .summary { color: #444; }
  table { border-collapse: collapse; margin-top: 6px; }
  td, th { border: 1px solid #e8e8e8; padding: 3px 8px; font-size: 12px; text-align: left; }
  code { background: #f0f3f5; padding: 1px 4px; border-radius: 3px; font-size: 12px; }
</style></head><body>
<header><h1>OpenWhisk-TPU REST API</h1>
<a href="/api/v1/api-docs">raw swagger 2.0 JSON</a></header>
<main id="m">loading /api/v1/api-docs…</main>
<script>
fetch('/api/v1/api-docs').then(r => r.json()).then(doc => {
  const m = document.getElementById('m'); m.textContent = '';
  const h = document.createElement('p');
  h.innerHTML = '<b>' + doc.info.title + '</b> v' + doc.info.version +
    ' — swagger ' + doc.swagger;
  m.appendChild(h);
  for (const [path, ops] of Object.entries(doc.paths)) {
    const d = document.createElement('details'); d.className = 'path';
    const s = document.createElement('summary');
    let badges = '';
    for (const verb of Object.keys(ops))
      badges += '<span class="verb ' + verb + '">' + verb + '</span>';
    s.innerHTML = badges + ' <span>' + path + '</span>';
    d.appendChild(s);
    for (const [verb, op] of Object.entries(ops)) {
      const o = document.createElement('div'); o.className = 'op';
      let html = '<span class="verb ' + verb + '">' + verb + '</span> ' +
                 '<span class="summary">' + (op.summary || '') + '</span>';
      if (op.parameters && op.parameters.length) {
        html += '<table><tr><th>query param</th><th>type</th></tr>';
        for (const p of op.parameters)
          html += '<tr><td><code>' + p.name + '</code></td><td>' +
                  (p.type || '') + '</td></tr>';
        html += '</table>';
      }
      if (op.responses) {
        html += '<table><tr><th>status</th><th>meaning</th></tr>';
        for (const [code, r] of Object.entries(op.responses))
          html += '<tr><td>' + code + '</td><td>' + (r.description || '') +
                  '</td></tr>';
        html += '</table>';
      }
      o.innerHTML = html;
      d.appendChild(o);
    }
    m.appendChild(d);
  }
}).catch(e => { document.getElementById('m').textContent =
  'failed to load api-docs: ' + e; });
</script></body></html>
"""
