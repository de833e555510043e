"""Asyncio edge reverse-proxy — the nginx role of the reference deployment.
A copy of `openwhisk_tpu/edge/proxy.py`.

Behavior ported from ansible/roles/nginx/templates/nginx.conf.j2:
  * upstream pool over all controllers with keepalive + failover: a
    connect-failed upstream is skipped for `fail_timeout` seconds
    (nginx `server ... fail_timeout=60s`);
  * vanity URLs: a request whose Host is `{namespace}.{domain}` is rewritten
    to `/api/v1/web/{namespace}{path}` (root → `/public/index.html`);
  * `/metrics` is denied from the edge (`location /metrics { deny all; }`);
  * a per-request transaction id header is injected and echoed
    (`proxy_set_header X-Request-ID`);
  * optional TLS termination via an `ssl.SSLContext`.

On top of that it serves API-gateway routes (reference: external gateway +
core/routemgmt): requests matching a registered (basePath, relPath, verb)
are forwarded to the backing web action.

Active/active partitioned controllers: with a `ring`
(controller/loadbalancer/partitions.py — upstream list order must match
controller instance numbering), requests whose path names an explicit
namespace are routed OWNER-FIRST: the upstream order is the partition's
rendezvous ranking, so the first hop is the controller that owns the
namespace's partition, and a 503 (an owner mid-handoff, or a stale
ranking during a rebalance) walks to the next candidate. Retries are
BOUNDED with jittered exponential backoff (`retry_attempts`,
`retry_backoff_ms`) on 503/connect-error — the first pass over the pool
walks sleep-free (the pre-existing behavior), then backoff bridges the
membership detection window during a failover instead of burning the
attempt budget in the first milliseconds — and every retry counts into
`retry_total[reason]` (the `edge_retry_total{reason}` family) so chaos
riders assert retries stayed bounded.
"""
from __future__ import annotations

import asyncio
import random
import secrets
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Dict, List, Optional

import aiohttp
from aiohttp import web

TRANSACTION_HEADER = "X-Request-ID"
MAX_BODY = 50 * 1024 * 1024  # nginx client_max_body_size 50M
HOP_HEADERS = {"connection", "keep-alive", "transfer-encoding", "upgrade",
               "proxy-authenticate", "proxy-authorization", "te", "trailers",
               "host", "content-length"}


@dataclass
class Upstream:
    url: str  # e.g. http://127.0.0.1:3233
    fail_until: float = 0.0
    fails: int = 0
    #: fleet observatory: requests sent to / 503s answered by
    #: this upstream — which controller the edge actually leans on
    attempts: int = 0
    http_503: int = 0

    def usable(self) -> bool:
        return time.monotonic() >= self.fail_until


@dataclass
class EdgeProxy:
    upstreams: List[Upstream]
    domain: str = ""  # vanity base domain; "" disables subdomain rewrite
    fail_timeout: float = 60.0
    read_timeout: float = 75.0  # nginx proxy_read_timeout 75s
    route_matcher: Optional[Callable[[str, str], Awaitable[Optional[Dict]]]] = None
    #: active/active: PartitionRing for owner-first routing (module doc);
    #: None keeps the round-robin order bit-exactly
    ring: Optional[object] = None
    #: total upstream attempts per request; 0 = auto (two passes over the
    #: pool, min 4 — one pass is today's behavior, the second rides the
    #: backoff through a failover's detection window)
    retry_attempts: int = 0
    retry_backoff_ms: float = 25.0
    retry_backoff_max_ms: float = 400.0
    #: retries performed, by reason ("http_503" | "connect" | "read") —
    #: the edge_retry_total{reason} counter family
    retry_total: Dict[str, int] = field(default_factory=dict)
    _rr: int = 0
    #: partition -> upstream-index ranking, computed once per pid: the
    #: member set here is always the fixed range(len(upstreams)), so the
    #: per-request rendezvous hash+sort is pure repeated work
    _rank_cache: Dict[int, List[int]] = field(default_factory=dict)
    _session: Optional[aiohttp.ClientSession] = None
    _runner: Optional[web.AppRunner] = None
    extra_denied_paths: tuple = ("/metrics",)
    #: bearer token for GET /admin/edge/stats. Empty = the
    #: endpoint always answers 403 — the nginx-era `/metrics { deny
    #: all; }` posture stays the default, stats are strictly opt-in
    admin_token: str = ""

    @classmethod
    def for_controllers(cls, urls: List[str], **kwargs) -> "EdgeProxy":
        return cls(upstreams=[Upstream(u.rstrip("/")) for u in urls], **kwargs)

    # --------------------------------------------------------------- server
    def make_app(self) -> web.Application:
        app = web.Application(client_max_size=MAX_BODY)
        app.router.add_route("*", "/{tail:.*}", self.handle)
        return app

    async def start(self, host: str = "0.0.0.0", port: int = 8080,
                    ssl_context=None) -> None:
        self._session = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=self.read_timeout))
        self._runner = web.AppRunner(self.make_app())
        await self._runner.setup()
        await web.TCPSite(self._runner, host, port,
                          ssl_context=ssl_context).start()

    async def stop(self) -> None:
        if self._runner:
            await self._runner.cleanup()
        if self._session:
            await self._session.close()

    # -------------------------------------------------------------- routing
    def _vanity_namespace(self, request: web.Request) -> Optional[str]:
        if not self.domain:
            return None
        host = request.host.split(":")[0]
        suffix = "." + self.domain
        if host.endswith(suffix):
            ns = host[: -len(suffix)]
            if ns and all(c.isalnum() or c == "-" for c in ns):
                return ns
        return None

    async def _rewrite(self, request: web.Request) -> str:
        """Return the upstream path for this request; raise to deny/404."""
        path = request.path
        if path in self.extra_denied_paths:
            raise web.HTTPForbidden(text="forbidden")
        if path.startswith("/api/"):
            return path
        ns = self._vanity_namespace(request)
        if ns is not None:
            target = "/public/index.html" if path == "/" else path
            return f"/api/v1/web/{ns}{target}"
        if self.route_matcher is not None:
            op = await self.route_matcher(request.method, path)
            if op is not None:
                url = op.get("url", "")
                # strip any host prefix the route doc may carry
                if "://" in url:
                    rest = url.split("://", 1)[1]
                    _, _, tail = rest.partition("/")
                    url = "/" + tail
                return url
        # no API path, no vanity host, no gateway route: nothing to serve
        raise web.HTTPNotFound(text="no route")

    # ----------------------------------------------------------- edge stats
    def _edge_stats(self, request: web.Request) -> web.Response:
        """`GET /admin/edge/stats`: the edge's in-process counters, shaped
        so the fleet metrics merger folds the edge in as one more member
        (`counters` rows are the federation wire format). Bearer-gated on
        `admin_token`; `/metrics` itself stays denied."""
        auth = request.headers.get("Authorization", "")
        token = auth[len("Bearer "):] if auth.startswith("Bearer ") else ""
        if not self.admin_token or not token or \
                not secrets.compare_digest(token, self.admin_token):
            raise web.HTTPForbidden(text="forbidden")
        from ..utils.eventlog import identity
        ident = {**identity(), "role": "edge"}
        counters = [["edge_retry_total", [["reason", reason]], n]
                    for reason, n in sorted(self.retry_total.items())]
        for u in self.upstreams:
            counters.append(["edge_upstream_attempts_total",
                             [["upstream", u.url]], u.attempts])
            counters.append(["edge_upstream_http_503_total",
                             [["upstream", u.url]], u.http_503])
        return web.json_response({
            "identity": ident,
            "counters": counters,
            "retry_total": dict(self.retry_total),
            "upstreams": [{"url": u.url, "attempts": u.attempts,
                           "http_503": u.http_503, "fails": u.fails,
                           "usable": u.usable()} for u in self.upstreams],
        })

    # ---------------------------------------------------------------- proxy
    async def handle(self, request: web.Request) -> web.Response:
        if request.path == "/admin/edge/stats" and request.method == "GET":
            return self._edge_stats(request)
        target = await self._rewrite(request)
        transid = request.headers.get(TRANSACTION_HEADER) or secrets.token_hex(8)
        body = await request.read() if request.can_read_body else None
        headers = {k: v for k, v in request.headers.items()
                   if k.lower() not in HOP_HEADERS}
        headers[TRANSACTION_HEADER] = transid

        qs = request.query_string
        suffix = target + (("?" + qs) if qs else "")
        last_error: Optional[Exception] = None
        last_503: Optional[web.Response] = None
        order = self._pick_order(self._path_namespace(request.path))
        attempts = self.retry_attempts or max(4, 2 * len(order))
        for attempt in range(attempts):
            if attempt >= len(order):
                # past the first pass over the pool. The first walk stays
                # sleep-free (a standby's 503 forwards to the active with
                # zero added latency, exactly the pre-retry behavior);
                # later passes back off with full jitter so a failover's
                # synchronized retry wave doesn't hammer the surviving
                # controllers in lockstep — the backoff is what bridges
                # the membership detection window
                await asyncio.sleep(self._backoff_s(attempt - len(order) + 1))
            upstream = order[attempt % len(order)]
            upstream.attempts += 1
            try:
                async with self._session.request(
                        request.method, upstream.url + suffix,
                        headers=headers, data=body,
                        allow_redirects=False) as resp:
                    payload = await resp.read()
                    upstream.fails = 0
                    out_headers = {k: v for k, v in resp.headers.items()
                                   if k.lower() not in HOP_HEADERS
                                   and k.lower() != "content-encoding"}
                    out_headers[TRANSACTION_HEADER] = transid
                    if resp.status == 503:
                        # a 503 is emitted BEFORE any state change (an HA
                        # standby refusing placement, a partition owned
                        # elsewhere, or no usable fleet): trying the next
                        # upstream is safe for any method (nginx
                        # `proxy_next_upstream http_503`). No blacklist —
                        # a standby answers everything else fine and
                        # becomes active without re-resolving.
                        upstream.http_503 += 1
                        last_503 = web.Response(status=503, body=payload,
                                                headers=out_headers)
                        if attempt + 1 < attempts:
                            self._count_retry("http_503")
                        continue
                    return web.Response(status=resp.status, body=payload,
                                        headers=out_headers)
            except aiohttp.ClientConnectorError as e:
                # connect failed — the request was never sent, so retrying
                # the next upstream is safe for ANY method; blacklist this
                # upstream for fail_timeout (nginx `fail_timeout=60s`)
                upstream.fails += 1
                upstream.fail_until = time.monotonic() + self.fail_timeout
                last_error = e
                if attempt + 1 < attempts:
                    self._count_retry("connect")
            except (aiohttp.ClientConnectionError, asyncio.TimeoutError):
                # the request may already be executing upstream (e.g. a slow
                # blocking invoke hit read_timeout): do NOT re-send non-
                # idempotent methods (nginx proxy_next_upstream excludes
                # them), and a slow request is no reason to blacklist
                if request.method in ("GET", "HEAD", "OPTIONS"):
                    last_error = RuntimeError("upstream read failed")
                    if attempt + 1 < attempts:
                        self._count_retry("read")
                    continue
                return web.Response(status=504, text="upstream timeout")
        if last_503 is not None:
            # every attempt said 503: surface the real refusal (body and
            # all) instead of a generic 502
            return last_503
        return web.Response(status=502, text=f"no upstream available: {last_error}")

    def _count_retry(self, reason: str) -> None:
        self.retry_total[reason] = self.retry_total.get(reason, 0) + 1

    def _backoff_s(self, attempt: int) -> float:
        """Full-jitter exponential backoff for retry `attempt` (>= 1)."""
        cap = min(self.retry_backoff_max_ms,
                  self.retry_backoff_ms * (2 ** (attempt - 1)))
        return random.uniform(0.0, cap) / 1e3

    def _path_namespace(self, path: str) -> Optional[str]:
        """The explicit namespace in an API path, for ring routing
        (`/api/v1/namespaces/{ns}/...`). `_` resolves to the caller's
        subject namespace upstream — unknowable here, so it falls back to
        round-robin (the bounded 503 retry still finds the owner).

        The hint is approximate by design: controllers partition by the
        AUTHENTICATED identity's namespace (tenant affinity — the edge
        has no auth store to resolve a key to one), which equals the
        path namespace for ordinary self-namespace invokes but not for
        cross-namespace shared-package calls. A miss costs extra
        sleep-free 503 hops on the first pass over the pool — the
        owner-side refusal stays the correctness gate either way."""
        prefix = "/api/v1/namespaces/"
        if not path.startswith(prefix):
            return None
        ns = path[len(prefix):].split("/", 1)[0]
        return ns if ns and ns != "_" else None

    def _pick_order(self, namespace: Optional[str] = None) -> List[Upstream]:
        """Round-robin over usable upstreams; all down → try everyone anyway
        (nginx resurrects a dead pool rather than hard-failing). With a
        ring and an explicit namespace, the order is the partition's
        rendezvous ranking instead — the first hop is the owner."""
        n = len(self.upstreams)
        if self.ring is not None and namespace is not None:
            pid = self.ring.partition_of(namespace)
            ranked = self._rank_cache.get(pid)
            if ranked is None:
                ranked = self._rank_cache[pid] = self.ring.rank(
                    pid, range(n))
            order = [self.upstreams[i] for i in ranked]
        else:
            order = [self.upstreams[(self._rr + i) % n] for i in range(n)]
            self._rr = (self._rr + 1) % n
        usable = [u for u in order if u.usable()]
        return usable or order
