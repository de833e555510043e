"""Distributed tracing: spans correlated by transaction id.

Rebuild of common/scala/.../common/tracing/OpenTracingProvider.scala:43-160 —
a per-transid stack of spans; the active span's context serializes into
`ActivationMessage.trace_context` (W3C traceparent style) and is restored on
the invoker side, so traces survive the bus hop (Message.scala:61,
InvokerReactive.scala:224). Finished spans go to a pluggable reporter:
in-memory buffer by default, `ZipkinReporter` (Zipkin v2 JSON over HTTP,
the reference's reporting backend, OpenTracingProvider.scala:43-160 +
application.conf:461-476) when CONFIG_whisk_tracing_zipkinUrl is set —
see `maybe_enable_zipkin`. Span caches expire so abandoned transactions
don't leak.
"""
from __future__ import annotations

import asyncio
import json
import secrets
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str
    start: float
    end: Optional[float] = None
    tags: Dict[str, str] = field(default_factory=dict)

    @property
    def duration_ms(self) -> float:
        return ((self.end or time.time()) - self.start) * 1e3

    def to_json(self) -> dict:
        return {"traceId": self.trace_id, "id": self.span_id,
                "parentId": self.parent_id, "name": self.name,
                "timestamp": int(self.start * 1e6),
                "duration": int(self.duration_ms * 1e3), "tags": self.tags}


class Reporter:
    def report(self, span: Span) -> None:
        raise NotImplementedError


class BufferReporter(Reporter):
    """In-memory span sink, ring-shaped: a full buffer evicts the OLDEST
    span so the NEWEST always survive — on a long soak the buffer tracks
    live traffic instead of fossilizing at startup spans. Evictions count
    as `dropped_spans` (like ZipkinReporter), so a saturated buffer stays
    visible to tests/operators instead of silently lossy."""

    def __init__(self, max_spans: int = 10_000):
        from collections import deque
        self.spans = deque(maxlen=max(1, max_spans))
        self.max_spans = max_spans
        self.sent_spans = 0
        self.dropped_spans = 0

    def report(self, span: Span) -> None:
        if len(self.spans) >= self.max_spans:
            self.dropped_spans += 1
        self.spans.append(span)
        self.sent_spans += 1


class ZipkinReporter(Reporter):
    """Zipkin v2 JSON-over-HTTP reporter (POST {url}/api/v2/spans).

    Spans buffer host-side and flush asynchronously — at `batch_size`, on
    the `flush_interval` tick, or at close(). A dead collector costs one
    failed POST per flush window and drops those spans; tracing must never
    take the data plane down with it.
    """

    def __init__(self, url: str, service_name: str = "openwhisk-tpu",
                 batch_size: int = 100, flush_interval: float = 1.0,
                 logger=None):
        self.url = url.rstrip("/") + "/api/v2/spans"
        self.service_name = service_name
        self.batch_size = batch_size
        self.flush_interval = flush_interval
        self.logger = logger
        self._pending: List[Span] = []
        self._flush_task: Optional[asyncio.Task] = None
        self._flushing = False  # True only while a POST is in flight
        self._session = None  # lazily-created, kept for connection reuse
        self.sent_spans = 0
        self.dropped_spans = 0

    def report(self, span: Span) -> None:
        self._pending.append(span)
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop (sync tooling): spans flush on explicit close()
        full = len(self._pending) >= self.batch_size
        if self._flush_task is None or self._flush_task.done():
            self._flush_task = loop.create_task(
                self._flush_later(0.0 if full else self.flush_interval))
        elif full and not self._flushing:
            # a flush is scheduled but still sleeping out its interval —
            # the batch is full NOW, so replace it with an immediate one.
            # A flush that is already mid-POST is never preempted: its
            # backlog drains on the next flush once it completes.
            self._flush_task.cancel()
            self._flush_task = loop.create_task(self._flush_later(0.0))

    async def _flush_later(self, delay: float) -> None:
        if delay:
            await asyncio.sleep(delay)
        while True:
            self._flushing = True
            try:
                await self.flush()
            finally:
                self._flushing = False
            # a full batch accumulated during the POST: drain it now rather
            # than waiting for the next report() to schedule a task
            if len(self._pending) < self.batch_size:
                return

    def _encode(self, spans: List[Span]) -> bytes:
        out = []
        for s in spans:
            doc = s.to_json()
            doc["localEndpoint"] = {"serviceName": self.service_name}
            doc["tags"] = {k: str(v) for k, v in doc["tags"].items()}
            if doc["parentId"] is None:
                del doc["parentId"]
            out.append(doc)
        return json.dumps(out).encode()

    async def flush(self) -> None:
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        try:
            import aiohttp

            if self._session is None or self._session.closed:
                self._session = aiohttp.ClientSession()
            async with self._session.post(
                    self.url, data=self._encode(batch),
                    headers={"Content-Type": "application/json"},
                    timeout=aiohttp.ClientTimeout(total=5)) as resp:
                if resp.status >= 400:
                    raise RuntimeError(f"collector returned {resp.status}")
            self.sent_spans += len(batch)
        except asyncio.CancelledError:
            # cancelled mid-POST (full-batch preemption or close()): the
            # popped batch goes back so the next flush re-sends it instead
            # of losing it uncounted
            self._pending = batch + self._pending
            raise
        except Exception as e:  # noqa: BLE001 — tracing is best-effort
            self.dropped_spans += len(batch)
            if self.logger:
                self.logger.warn(None, f"zipkin flush failed, dropped "
                                       f"{len(batch)} spans: {e}")

    async def close(self) -> None:
        if self._flush_task and not self._flush_task.done():
            self._flush_task.cancel()
            try:
                await self._flush_task
            except asyncio.CancelledError:
                pass
        await self.flush()
        if self._session is not None and not self._session.closed:
            await self._session.close()


@dataclass
class TracingSettings:
    zipkin_url: Optional[str] = None
    batch_size: int = 100
    flush_interval: float = 1.0


def maybe_enable_zipkin(service_name: str,
                        tracer: Optional["Tracer"] = None) -> Optional[ZipkinReporter]:
    """Swap the Zipkin reporter in when CONFIG_whisk_tracing_zipkinUrl is
    exported (the reference gates identically on a configured zipkin url,
    application.conf:461-476). Returns the reporter, or None when unset."""
    from .config import load_config

    cfg = load_config(TracingSettings, env_path="tracing")
    if not cfg.zipkin_url:
        return None
    reporter = ZipkinReporter(cfg.zipkin_url, service_name=service_name,
                              batch_size=cfg.batch_size,
                              flush_interval=cfg.flush_interval)
    t = tracer or GLOBAL_TRACER
    current = t.reporter
    if hasattr(current, "swap_inner"):
        # a trace-store tee (utils/tracestore.py) wraps the real sink:
        # swap the sink INSIDE it so the tail-sampling tee survives
        current.swap_inner(reporter)
    else:
        t.reporter = reporter
    return reporter


class Tracer:
    """Span lifecycle keyed by transid (ref OpenTracer)."""

    def __init__(self, reporter: Optional[Reporter] = None,
                 expiry_seconds: float = 3600.0):
        self.reporter = reporter or BufferReporter()
        self.expiry = expiry_seconds
        #: opportunistic-sweep cadence: a fraction of the expiry so small
        #: populations of abandoned stacks (below the size trigger) still
        #: age out within ~1.25x the expiry window
        self._sweep_interval = max(0.05, expiry_seconds / 4.0)
        self._last_sweep = time.monotonic()
        self._stacks: Dict[str, List[Span]] = {}
        self._touched: Dict[str, float] = {}
        #: finish_span calls that found nothing to finish (no stack for the
        #: transid, or a span that was already finished/expired): each one
        #: is a span silently lost to the trace — counted so a miswired
        #: caller shows up in the tracing gauges instead of as a mystery
        #: hole in the waterfall
        self.orphan_finishes = 0

    def start_span(self, name: str, transid) -> Span:
        stack = self._stacks.setdefault(transid.id, [])
        parent = stack[-1] if stack else None
        span = Span(
            trace_id=parent.trace_id if parent else secrets.token_hex(16),
            span_id=secrets.token_hex(8),
            parent_id=parent.span_id if parent else None,
            name=name, start=time.time())
        stack.append(span)
        now = time.monotonic()
        self._touched[transid.id] = now
        self._expire(now)
        return span

    def finish_span(self, transid, tags: Optional[Dict[str, str]] = None,
                    span: Optional[Span] = None) -> Optional[Span]:
        """Finish `span` (or the top of the stack when omitted). Passing the
        span start_span returned makes concurrent invokes sharing one transid
        safe: each finishes its OWN span even when interleaving reordered the
        stack."""
        stack = self._stacks.get(transid.id)
        if not stack:
            self.orphan_finishes += 1
            return None
        if span is not None:
            if span not in stack:
                self.orphan_finishes += 1
                return None
            stack.remove(span)
        else:
            span = stack.pop()
        span.end = time.time()
        if tags:
            span.tags.update(tags)
        if not stack:
            self._stacks.pop(transid.id, None)
            self._touched.pop(transid.id, None)
        self.reporter.report(span)
        return span

    # -- stack-free spans (invoker side) -----------------------------------
    def start_remote_child(self, name: str,
                           context: Optional[Dict[str, str]]) -> Span:
        """A span parented directly from a serialized traceparent, touching
        no per-transid stack — safe when many activations share one transid
        (e.g. all rules of one trigger fire) and finish out of order."""
        parts = (context or {}).get("traceparent", "").split("-")
        if len(parts) == 4:
            trace_id, parent_id = parts[1], parts[2]
        else:
            trace_id, parent_id = secrets.token_hex(16), None
        return Span(trace_id=trace_id, span_id=secrets.token_hex(8),
                    parent_id=parent_id, name=name, start=time.time())

    def finish(self, span: Span, tags: Optional[Dict[str, str]] = None) -> None:
        """Finish and report a stack-free span."""
        span.end = time.time()
        if tags:
            span.tags.update(tags)
        self.reporter.report(span)

    def error(self, transid, message: str) -> None:
        stack = self._stacks.get(transid.id)
        if stack:
            stack[-1].tags["error"] = message

    # -- context propagation (traceparent style) ---------------------------
    def get_trace_context(self, transid) -> Optional[Dict[str, str]]:
        stack = self._stacks.get(transid.id)
        if not stack:
            return None
        s = stack[-1]
        return {"traceparent": f"00-{s.trace_id}-{s.span_id}-01"}

    def set_trace_context(self, transid, context: Optional[Dict[str, str]]) -> None:
        """Restore a remote parent so child spans link across the bus."""
        if not context:
            return
        tp = context.get("traceparent", "")
        parts = tp.split("-")
        if len(parts) != 4:
            return
        remote = Span(trace_id=parts[1], span_id=parts[2], parent_id=None,
                      name="remote-parent", start=time.time())
        self._stacks.setdefault(transid.id, []).append(remote)
        self._touched[transid.id] = time.monotonic()

    def clear(self, transid) -> None:
        """Drop any remaining spans for a transaction WITHOUT reporting them
        (e.g. the invoker's restored remote parent after the work is done)."""
        self._stacks.pop(transid.id, None)
        self._touched.pop(transid.id, None)

    def _expire(self, now: Optional[float] = None) -> None:
        """Drop abandoned transaction stacks. Two triggers: the size
        threshold (a burst of live transactions) and an opportunistic
        time-based sweep — without it, fewer than 1000 abandoned stacks
        would linger FOREVER. Amortized: the sweep reuses the caller's
        monotonic read and runs at most once per `_sweep_interval`, so
        the per-span cost below both triggers is two comparisons."""
        if now is None:
            now = time.monotonic()
        if (len(self._touched) < 1000
                and now - self._last_sweep < self._sweep_interval):
            return
        self._last_sweep = now
        cutoff = now - self.expiry
        for tid in [t for t, at in self._touched.items() if at < cutoff]:
            self._stacks.pop(tid, None)
            self._touched.pop(tid, None)


def trace_id_of(context: Optional[Dict[str, str]]) -> Optional[str]:
    """The trace id carried by a serialized W3C traceparent context, or
    None when the context is absent or malformed (exemplar plumbing:
    histogram bucket lines link back to traces by this id)."""
    if not context:
        return None
    parts = context.get("traceparent", "").split("-")
    return parts[1] if len(parts) == 4 and parts[1] else None


def export_tracing_gauges(metrics, tracer: Optional["Tracer"] = None) -> None:
    """Refresh the tracing health gauges on a MetricEmitter (ridden by the
    balancers' supervision tick): span send/drop counts from the live
    reporter, open transaction stacks, and orphan finish_span calls —
    the silent-return path that used to be invisible."""
    t = tracer if tracer is not None else GLOBAL_TRACER
    metrics.gauge("tracing_orphan_finishes", t.orphan_finishes)
    metrics.gauge("tracing_active_transactions", len(t._stacks))
    rep = t.reporter
    metrics.gauge("tracing_spans_sent", getattr(rep, "sent_spans", 0))
    metrics.gauge("tracing_spans_dropped", getattr(rep, "dropped_spans", 0))


# process-wide default tracer (ref WhiskTracerProvider)
GLOBAL_TRACER = Tracer()
