"""First-class front-end -> balancer admission funnel.
A copy of `openwhisk_tpu/controller/loadbalancer/funnel.py`. Its named
cuts keep one frame in flight on each side of the hop: the front end's
rows admitted while a frame is on its way to the broker join one waiting
frame, which is on the retry clock from its first row's admission and
leaves when the frame in flight lands (or when its own timer fires
first); the receiver ships each origin's outcome rows the same way. The
reference ships a frame a wave and a frame a flush, each one broker round
trip on one connection, so a busy broker queued them
(`tests/test_torch_deploy.py` CUTS).

The spillover plane proved the shape: a whole admission batch
as ONE columnar frame on a peer's `ctrlspill<N>` topic. This module
generalizes it into the repo's multi-process deployment primitive — N
front-end worker PROCESSES (each running the HTTP edge, entitlement /
rate admission, activation-id mint and columnar batch assembly) funnel
their admission waves into the ONE device-owning balancer process:

  * `FunnelBalancer` — the front-end process's LoadBalancer SPI. It owns
    no device: `publish_many` packs the wave into ONE fence-stamped
    `fun1` struct-of-arrays frame on `ctrlfunnel<target>` and resolves
    each row off the per-row outcome stream (`funA` frames on
    `ctrlfunnelack<origin>`), so blocking invokes and the serial throttle
    texts survive the hop. A funnel-depth bound turns overflow into the
    front door's OWN 429 (`CONCURRENT_LIMIT_MESSAGE`, exact serial text)
    instead of unbounded queueing.
  * `FunnelReceiver` — the balancer process's ingest side: consumes the
    own `ctrlfunnel<N>` topic, fences whole frames by placement epoch,
    dedupes PER ROW (the `pubN` discipline one layer up: a retried frame
    replays only rows whose first delivery or outcome was lost), and
    places each frame through `balancer.publish_many` — one ring
    `push_block` per frame. Placement refusals keep their exact serial
    exception type + text across the wire (a one-char kind code picks
    LoadBalancerThrottleException vs LoadBalancerException back).
  * `FrameSender` — the shared lazily-built producer / ensure-once /
    one-task-per-frame machinery; `SpilloverSender` now rides it too.

Retry discipline: the sender re-ships a frame (same `seq`, same rows)
when no outcome arrived within `retry_seconds`, up to `max_retries`; the
receiver's bounded per-row outcome cache answers replayed rows from
memory, so zero double executions by construction. Epoch fencing covers
both failure directions: a frame stamped at an epoch the balancer has
moved past (zombie sender) AND a frame stamped ahead of a demoted,
stale-epoch balancer are refused whole, with the refusal text naming
both epochs.

Knobs (CONFIG_whisk_funnel_*): `depth` (default 2048 rows in flight per
front end), `retrySeconds`, `maxRetries`.
"""
from __future__ import annotations

import asyncio
from collections import OrderedDict
from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional

from ...core.entity import ActivationId, ControllerInstanceId
from ...messaging.columnar import (FUNNEL_COMPLETED, FUNNEL_EXC_ERROR,
                                   FUNNEL_EXC_THROTTLE, FUNNEL_FORCED,
                                   FUNNEL_PLACED, FUNNEL_REFUSED,
                                   FunnelAckMessage, FunnelBatchMessage,
                                   FunnelOutcome, KIND_FUNNEL,
                                   KIND_FUNNEL_ACK, is_batch_payload)
from ...messaging.connector import MessageFeed, decode_batch
from ...utils.config import load_config
from ...utils.transaction import TransactionId
from ..entitlement import CONCURRENT_LIMIT_MESSAGE
from .base import (ActiveAckTimeout, LoadBalancer, LoadBalancerException,
                   LoadBalancerThrottleException)

FUNNEL_TOPIC_PREFIX = "ctrlfunnel"
#: funnel traffic is live admission, not history (the spillover posture)
FUNNEL_RETENTION_BYTES = 8 * 1024 * 1024
#: bounded per-row outcome cache on the receiver (mirrors the TCP
#: broker's pub-mid dedupe LRU size)
SEEN_ROWS_MAX = 8192


def funnel_topic(instance: int) -> str:
    """The balancer-side ingest topic."""
    return f"{FUNNEL_TOPIC_PREFIX}{int(instance)}"


def funnel_ack_topic(origin: int) -> str:
    """The front-end-side outcome topic."""
    return f"{FUNNEL_TOPIC_PREFIX}ack{int(origin)}"


def stale_epoch_text(frame_epoch: int, balancer_epoch: int) -> str:
    """The frame-fence refusal: one exact text both sides (and the
    tests) agree on, naming both epochs so the operator can tell a
    zombie sender from a demoted balancer."""
    return (f"funnel: placement is fenced (frame epoch {frame_epoch}, "
            f"balancer epoch {balancer_epoch})")


@dataclass(frozen=True)
class FunnelConfig:
    """`CONFIG_whisk_funnel_*` env overrides."""
    #: max rows in flight (sent, outcome or completion still pending)
    #: per front-end process before the front door answers 429
    depth: int = 2048
    #: re-ship a frame when no outcome arrived within this window
    retry_seconds: float = 2.0
    #: give up (fail the rows 503) after this many re-sends
    max_retries: int = 3

    @classmethod
    def from_env(cls) -> "FunnelConfig":
        return load_config(cls, env_path="funnel")


class FrameSender:
    """Shared frame-forwarding core: lazily-built producer, once-per-
    topic ensure, and a one-task-per-frame send that fails a list of
    row futures instead of the event loop's task machinery."""

    def __init__(self, provider, logger=None):
        self.provider = provider
        self.logger = logger
        self._producer = None
        self._topics_ensured: set = set()

    @property
    def producer(self):
        if self._producer is None:
            self._producer = self.provider.get_producer()
        return self._producer

    def ensure_topic(self, topic: str, retention_bytes: int) -> None:
        if topic not in self._topics_ensured:
            self.provider.ensure_topic(topic,
                                       retention_bytes=retention_bytes)
            self._topics_ensured.add(topic)

    def send_frame(self, topic: str, message, outs=(), on_error=None):
        """Ship `message` as one frame; a send failure fails every
        still-pending future in `outs` (and calls `on_error`), success
        resolves them True."""

        async def _send() -> None:
            try:
                await self.producer.send(topic, message)
            except Exception as e:  # noqa: BLE001 — fail the rows, not
                # the event loop's task machinery
                for out in outs:
                    if not out.done():
                        out.set_exception(e)
                if on_error is not None:
                    on_error(e)
                return
            for out in outs:
                if not out.done():
                    out.set_result(True)

        return asyncio.get_event_loop().create_task(_send())


class _Row:
    """One in-flight funnel row at the front end."""

    __slots__ = ("aid", "out", "msg", "ns", "blocking", "promise")

    def __init__(self, aid, out, msg, ns, blocking):
        self.aid = aid
        self.out = out
        self.msg = msg
        self.ns = ns
        self.blocking = blocking
        self.promise: Optional[asyncio.Future] = None


class _Frame:
    """Sender-side retry bookkeeping for one shipped frame."""

    __slots__ = ("seq", "rows", "retries", "timer")

    def __init__(self, seq, rows):
        self.seq = seq
        self.rows = rows
        self.retries = 0
        self.timer = None


class FunnelBalancer(LoadBalancer):
    """The front-end process's load balancer: forward-and-await over the
    bus instead of owning a device (module doc). `batch_publish = True`
    opts into the admission coalescer, so one API wave becomes one
    `publish_many` call becomes ONE wire frame."""

    batch_publish = True

    def __init__(self, provider, controller_instance, target: int,
                 config: Optional[FunnelConfig] = None, logger=None,
                 metrics=None):
        self.provider = provider
        self.controller = controller_instance
        self.target = int(target)
        self.config = config or FunnelConfig.from_env()
        self.logger = logger
        self.metrics = metrics
        self.sender = FrameSender(provider, logger)
        #: placement epoch adopted from outcome frames (0 = unfenced)
        self.epoch = 0
        self._seq = 0
        self._rows: Dict[str, _Row] = {}
        self._frames: Dict[int, _Frame] = {}
        self._active_ns: Dict[str, int] = {}
        self._feed: Optional[MessageFeed] = None
        self._closed = False
        #: a wave's frame is on its way to the broker: the rows admitted
        #: meanwhile join the frame that waits for it
        self._shipping = False
        self._next: Optional[_Frame] = None
        # counters (exported through the controller's MetricEmitter when
        # one is attached; always readable as attributes)
        self.rows_sent = 0
        self.rows_refused_local = 0
        self.frames_sent = 0
        self.frame_retries = 0
        self.rows_timed_out = 0

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        origin = self.controller.instance
        self.sender.ensure_topic(funnel_topic(self.target),
                                 FUNNEL_RETENTION_BYTES)
        self.sender.ensure_topic(funnel_ack_topic(origin),
                                 FUNNEL_RETENTION_BYTES)
        consumer = self.provider.get_consumer(
            funnel_ack_topic(origin), f"funnelack{origin}", max_peek=64)
        box = {}

        async def handle(payload: bytes):
            try:
                await self._on_ack(payload)
            finally:
                box["feed"].processed()

        self._feed = MessageFeed("funnel-ack", consumer, 64, handle,
                                 logger=self.logger)
        box["feed"] = self._feed
        self._feed.start()

    async def close(self) -> None:
        self._closed = True
        for frame in list(self._frames.values()):
            if frame.timer is not None:
                frame.timer.cancel()
        self._frames.clear()
        self._next = None
        for row in list(self._rows.values()):
            if not row.out.done():
                row.out.set_exception(LoadBalancerException(
                    "funnel front end shutting down"))
            if row.promise is not None and not row.promise.done():
                row.promise.set_exception(LoadBalancerException(
                    "funnel front end shutting down"))
        self._rows.clear()
        self._active_ns.clear()
        if self._feed is not None:
            await self._feed.stop()
            self._feed = None

    # -- SPI ---------------------------------------------------------------
    async def publish(self, action, msg) -> asyncio.Future:
        return await self.publish_many([(action, msg)])[0]

    def publish_many(self, pairs) -> List[asyncio.Future]:
        loop = asyncio.get_event_loop()
        outs: List[asyncio.Future] = []
        accepted: List[_Row] = []
        for _action, msg in pairs:
            out = loop.create_future()
            outs.append(out)
            if self._closed:
                out.set_exception(LoadBalancerException(
                    "funnel front end shutting down"))
                continue
            if len(self._rows) + len(accepted) >= self.config.depth:
                # the funnel-depth bound IS the front door's 429: exact
                # serial concurrent-limit text, never unbounded queueing
                self.rows_refused_local += 1
                if self.metrics is not None:
                    self.metrics.counter("funnel_rows_refused_backpressure")
                out.set_exception(LoadBalancerThrottleException(
                    CONCURRENT_LIMIT_MESSAGE))
                continue
            # acks / capacity books / the activation record pipeline all
            # live at the device-owning balancer (the spillover rewrite)
            msg.root_controller_index = ControllerInstanceId(
                str(self.target))
            accepted.append(_Row(msg.activation_id.asString, out, msg,
                                 msg.user.namespace.uuid.asString,
                                 bool(msg.blocking)))
        if accepted:
            for row in accepted:
                self._rows[row.aid] = row
                self._active_ns[row.ns] = self._active_ns.get(row.ns,
                                                              0) + 1
            if self._next is not None:
                self._next.rows.extend(accepted)
                self.rows_sent += len(accepted)
                if self.metrics is not None:
                    self.metrics.counter("funnel_rows_sent", len(accepted))
            else:
                self._send_wave(accepted)
        return outs

    def _send_wave(self, rows: List[_Row]) -> None:
        seq = self._seq
        self._seq += 1
        frame = _Frame(seq, rows)
        self._frames[seq] = frame
        self.rows_sent += len(rows)
        self.frames_sent += 1
        if self.metrics is not None:
            self.metrics.counter("funnel_rows_sent", len(rows))
            self.metrics.counter("funnel_frames_sent")
        if self._shipping:
            # on the retry clock from now: a row waits no longer for its
            # outcome than if its frame had left at once
            self._next = frame
            frame.timer = asyncio.get_event_loop().call_later(
                self.config.retry_seconds, self._retry, frame.seq)
        else:
            self._shipping = True
            self._ship(frame).add_done_callback(self._shipped)

    def _shipped(self, _task: asyncio.Task) -> None:
        """A wave's frame landed at the broker (or failed): the frame
        that waited leaves, its timer left running. One frame in flight
        keeps a busy broker's round trips from queueing behind each
        other."""
        self._shipping = False
        if self._next is not None:
            self._shipping = True
            self._ship(self._next, arm=False).add_done_callback(
                self._shipped)

    def _ship(self, frame: _Frame, arm: bool = True) -> asyncio.Task:
        if self._next is frame:
            self._next = None  # sent: the next wave makes a new frame
        message = FunnelBatchMessage([r.msg for r in frame.rows],
                                     self.controller.instance, frame.seq,
                                     self.epoch)

        def on_error(e):
            # a failed hand-off fails the rows here (send_frame's
            # success path must NOT touch them: resolution belongs to
            # the outcome feed, so outs stays empty)
            self._drop_frame(frame.seq)
            for row in frame.rows:
                if not row.out.done():
                    row.out.set_exception(LoadBalancerException(
                        f"funnel forward failed: {e!r}"))
                self._finish(row.aid)
            if self.logger:
                self.logger.warn(TransactionId.LOADBALANCER,
                                 f"funnel frame {frame.seq} send failed: "
                                 f"{e!r}", "Funnel")

        task = self.sender.send_frame(funnel_topic(self.target), message,
                                      on_error=on_error)
        if arm:
            frame.timer = asyncio.get_event_loop().call_later(
                self.config.retry_seconds, self._retry, frame.seq)
        return task

    def _retry(self, seq: int) -> None:
        frame = self._frames.get(seq)
        if frame is None:
            return
        pending = [r for r in frame.rows if not r.out.done()]
        if not pending:
            self._drop_frame(seq)
            return
        if frame.retries >= self.config.max_retries:
            self._drop_frame(seq)
            for row in pending:
                self.rows_timed_out += 1
                if not row.out.done():
                    row.out.set_exception(LoadBalancerException(
                        f"funnel: no outcome from balancer{self.target} "
                        f"after {frame.retries + 1} sends"))
                self._finish(row.aid)
            return
        frame.retries += 1
        self.frame_retries += 1
        if self.metrics is not None:
            self.metrics.counter("funnel_frame_retries")
        # same seq, same rows: the receiver's per-row dedupe replays
        # only what was actually lost (the pubN discipline)
        self._ship(frame)

    # -- outcome stream ----------------------------------------------------
    async def _on_ack(self, payload: bytes) -> None:
        try:
            if not is_batch_payload(payload):
                raise ValueError("not a batch payload")
            kind, frame = decode_batch(payload)
            if kind != KIND_FUNNEL_ACK:
                raise ValueError(f"unexpected kind {kind!r}")
        except (ValueError, KeyError, IndexError, TypeError) as e:
            if self.logger:
                self.logger.error(TransactionId.LOADBALANCER,
                                  f"corrupt funnel ack frame: {e!r}",
                                  "Funnel")
            return
        if frame.epoch > self.epoch:
            self.epoch = frame.epoch
        loop = asyncio.get_event_loop()
        for o in frame.rows:
            row = self._rows.get(o.aid)
            if row is None:
                continue  # late duplicate of an already-settled row
            if o.code == FUNNEL_REFUSED:
                exc_cls = (LoadBalancerThrottleException
                           if o.exc is not None
                           and o.exc[0] == FUNNEL_EXC_THROTTLE
                           else LoadBalancerException)
                text = o.exc[1] if o.exc is not None else "funnel: refused"
                if not row.out.done():
                    row.out.set_exception(exc_cls(text))
                self._finish(o.aid)
            elif o.code == FUNNEL_PLACED:
                self._ensure_placed(row, loop)
            elif o.code == FUNNEL_COMPLETED:
                promise = self._ensure_placed(row, loop)
                if not promise.done():
                    if o.resp is not None:
                        from ...core.entity import WhiskActivation
                        promise.set_result(
                            WhiskActivation.from_json(o.resp))
                    else:
                        # slim non-blocking completion: the row is done,
                        # nobody reads the result
                        promise.set_result(None)
                self._finish(o.aid)
            elif o.code == FUNNEL_FORCED:
                promise = self._ensure_placed(row, loop)
                if not promise.done():
                    promise.set_exception(
                        ActiveAckTimeout(ActivationId(o.aid)))
                self._finish(o.aid)

    @staticmethod
    def _ensure_placed(row: _Row, loop) -> asyncio.Future:
        if row.promise is None:
            row.promise = loop.create_future()
            if not row.blocking:
                # nobody awaits a non-blocking promise: retrieve late
                # exceptions so GC never logs them
                row.promise.add_done_callback(
                    lambda f: f.cancelled() or f.exception())
        if not row.out.done():
            row.out.set_result(row.promise)
        return row.promise

    def _drop_frame(self, seq: int) -> None:
        frame = self._frames.pop(seq, None)
        if frame is not None and frame.timer is not None:
            frame.timer.cancel()

    def _finish(self, aid: str) -> None:
        row = self._rows.pop(aid, None)
        if row is None:
            return
        left = self._active_ns.get(row.ns, 1) - 1
        if left <= 0:
            self._active_ns.pop(row.ns, None)
        else:
            self._active_ns[row.ns] = left

    # -- bookkeeping SPI ---------------------------------------------------
    def active_activations_for(self, namespace_id: str) -> int:
        return self._active_ns.get(namespace_id, 0)

    @property
    def total_active_activations(self) -> int:
        return len(self._rows)

    async def invoker_health(self):
        return []  # the front end owns no invokers

    def export_gauges(self) -> dict:
        return {
            "funnel_rows_in_flight": len(self._rows),
            "funnel_rows_sent": self.rows_sent,
            "funnel_rows_refused_backpressure": self.rows_refused_local,
            "funnel_frames_sent": self.frames_sent,
            "funnel_frame_retries": self.frame_retries,
            "funnel_rows_timed_out": self.rows_timed_out,
            "funnel_epoch": self.epoch,
        }


class FunnelReceiver:
    """Balancer side: consume the own `ctrlfunnel<N>` topic, fence +
    dedupe, place frames through the local balancer's batched publish
    path and stream per-row outcomes back to each origin."""

    def __init__(self, provider, instance, balancer, entity_store=None,
                 resolver=None, logger=None, metrics=None):
        self.provider = provider
        self.instance = instance
        self.balancer = balancer
        self.logger = logger
        self.metrics = metrics
        if resolver is None and entity_store is not None:
            async def resolver(name: str, rev):
                doc = await entity_store.get_action(name, rev=rev)
                executable = doc.to_executable()
                if executable is None:
                    raise ValueError("not executable")
                return executable
        self.resolver = resolver
        self.sender = FrameSender(provider, logger)
        self._feed: Optional[MessageFeed] = None
        #: bounded per-row outcome cache: aid -> [FunnelOutcome...] so a
        #: replayed row re-emits everything it already earned
        self._seen: "OrderedDict[str, list]" = OrderedDict()
        self._origins: Dict[str, int] = {}
        self._ack_buf: Dict[int, List[FunnelOutcome]] = {}
        self._flush_armed = False
        #: origins with an outcome frame on its way to the broker: their
        #: next rows wait in the buffer and leave as one frame when it lands
        self._sending: set = set()
        self.frames_received = 0
        self.rows_received = 0
        self.dup_rows = 0
        self.rows_refused = 0
        self.stale_frames = 0
        self.acks_sent = 0

    def current_epoch(self) -> int:
        return int(getattr(self.balancer, "fence_epoch", None) or 0)

    def start(self) -> None:
        topic = funnel_topic(self.instance.instance)
        self.provider.ensure_topic(topic,
                                   retention_bytes=FUNNEL_RETENTION_BYTES)
        consumer = self.provider.get_consumer(
            topic, f"funnel{self.instance.instance}", max_peek=64)
        box = {}

        async def handle(payload: bytes):
            try:
                await self._consume(payload)
            finally:
                box["feed"].processed()

        self._feed = MessageFeed("funnel", consumer, 64, handle,
                                 logger=self.logger)
        box["feed"] = self._feed
        self._feed.start()

    async def stop(self) -> None:
        if self._feed is not None:
            await self._feed.stop()
            self._feed = None

    # -- ingest ------------------------------------------------------------
    async def _consume(self, payload: bytes) -> None:
        try:
            if not is_batch_payload(payload):
                raise ValueError("not a batch payload")
            kind, frame = decode_batch(payload)
            if kind != KIND_FUNNEL:
                raise ValueError(f"unexpected kind {kind!r}")
        except (ValueError, KeyError, IndexError, TypeError) as e:
            if self.logger:
                self.logger.error(TransactionId.LOADBALANCER,
                                  f"corrupt funnel frame: {e!r}", "Funnel")
            return
        origin = frame.origin
        self.frames_received += 1
        if self.metrics is not None:
            self.metrics.counter("funnel_frames_received")
        cur = self.current_epoch()
        if frame.epoch and frame.epoch != cur:
            # whole-frame fence: zombie sender (frame behind) or demoted
            # stale-epoch balancer (frame ahead) — refuse every row,
            # naming both epochs; epoch 0 = unfenced bootstrap, admitted
            # (publish_many's standby/partition fences still apply)
            self.stale_frames += 1
            text = stale_epoch_text(frame.epoch, cur)
            for m in frame.msgs:
                self._record(origin, FunnelOutcome(
                    FUNNEL_REFUSED, m.activation_id.asString,
                    exc=(FUNNEL_EXC_ERROR, text)), cache=False)
            self.rows_refused += len(frame.msgs)
            if self.metrics is not None:
                self.metrics.counter("funnel_rows_refused",
                                     len(frame.msgs))
            return
        fresh = []
        dups_here = 0
        for m in frame.msgs:
            aid = m.activation_id.asString
            cached = self._seen.get(aid)
            if cached is not None:
                # partial dedupe: this row already arrived on an earlier
                # delivery — re-emit what it earned so far, never
                # re-place it (zero double executions)
                dups_here += 1
                self._seen.move_to_end(aid)
                for rec in cached:
                    self._enqueue(origin, rec)
                continue
            self._seen[aid] = []
            while len(self._seen) > SEEN_ROWS_MAX:
                old_aid, _ = self._seen.popitem(last=False)
                self._origins.pop(old_aid, None)
            self._origins[aid] = origin
            fresh.append(m)
        if dups_here:
            self.dup_rows += dups_here
            if self.metrics is not None:
                self.metrics.counter("funnel_dup_rows", dups_here)
        if not fresh:
            return
        pairs = []
        for m in fresh:
            try:
                if self.resolver is None:
                    raise ValueError("no action resolver attached")
                executable = await self.resolver(str(m.action), m.revision)
                pairs.append((executable, m))
            except Exception as e:  # noqa: BLE001 — per-row isolation;
                # unlike spillover, the origin is WAITING: answer it
                self._record(origin, FunnelOutcome(
                    FUNNEL_REFUSED, m.activation_id.asString,
                    exc=(FUNNEL_EXC_ERROR,
                         f"funnel: action resolve failed: {e!r}")))
        if not pairs:
            return
        self.rows_received += len(pairs)
        if self.metrics is not None:
            self.metrics.counter("funnel_rows_received", len(pairs))
        wf = getattr(self.balancer, "waterfall", None)
        if wf is not None and wf.enabled:
            from ...utils.tracing import trace_id_of
            for _executable, m in pairs:
                wf.adopt(m.activation_id.asString, wf.open(),
                         trace_id=trace_id_of(
                             getattr(m, "trace_context", None)))
        # one frame -> one publish_many -> one ring push_block
        rows = self.balancer.publish_many(pairs)
        for fut, (_executable, m) in zip(rows, pairs):
            fut.add_done_callback(partial(self._row_outcome, origin, m))

    def _row_outcome(self, origin: int, msg, fut: asyncio.Future) -> None:
        aid = msg.activation_id.asString
        exc = None if fut.cancelled() else fut.exception()
        if fut.cancelled():
            exc = LoadBalancerException("funnel: placement cancelled")
        if exc is not None:
            code = (FUNNEL_EXC_THROTTLE
                    if isinstance(exc, LoadBalancerThrottleException)
                    else FUNNEL_EXC_ERROR)
            self.rows_refused += 1
            if self.metrics is not None:
                self.metrics.counter("funnel_rows_refused")
            self._record(origin, FunnelOutcome(FUNNEL_REFUSED, aid,
                                               exc=(code, str(exc))))
            return
        self._record(origin, FunnelOutcome(FUNNEL_PLACED, aid))
        promise = fut.result()
        if isinstance(promise, asyncio.Future):
            if promise.done():
                self._completion(origin, aid, bool(msg.blocking), promise)
            else:
                promise.add_done_callback(
                    partial(self._completion, origin, aid,
                            bool(msg.blocking)))

    def _completion(self, origin: int, aid: str, blocking: bool,
                    promise: asyncio.Future) -> None:
        if promise.cancelled() or promise.exception() is not None:
            # the serial path's forced completion (ActiveAckTimeout) or
            # a shutdown: the origin synthesizes the same exception
            self._record(origin, FunnelOutcome(FUNNEL_FORCED, aid,
                                               err=True))
            return
        act = promise.result()
        resp = None
        err = False
        if blocking and act is not None and hasattr(act, "to_json"):
            try:
                resp = act.to_json()
                response = getattr(act, "response", None)
                err = bool(getattr(response, "is_whisk_error", False))
            except Exception:  # noqa: BLE001 — a corrupt lazy result
                # must degrade to a slim completion, not kill the feed
                resp = None
        self._record(origin, FunnelOutcome(FUNNEL_COMPLETED, aid,
                                           err=err, resp=resp))

    # -- outcome stream ----------------------------------------------------
    def _record(self, origin: int, rec: FunnelOutcome,
                cache: bool = True) -> None:
        if cache:
            earned = self._seen.get(rec.aid)
            if earned is not None:
                # cache slim (response-free) outcomes only: a replay
                # re-learns placement/refusal; a lost blocking result
                # self-heals through the activation-store poll
                earned.append(rec if rec.resp is None else FunnelOutcome(
                    rec.code, rec.aid, rec.err))
        self._enqueue(origin, rec)

    def _enqueue(self, origin: int, rec: FunnelOutcome) -> None:
        self._ack_buf.setdefault(origin, []).append(rec)
        if not self._flush_armed:
            self._flush_armed = True
            asyncio.get_event_loop().call_soon(self._flush)

    def _flush(self) -> None:
        self._flush_armed = False
        epoch = self.current_epoch()
        for origin in [o for o in self._ack_buf if o not in self._sending]:
            rows = self._ack_buf.pop(origin)
            topic = funnel_ack_topic(origin)
            self.sender.ensure_topic(topic, FUNNEL_RETENTION_BYTES)
            self.acks_sent += 1
            if self.metrics is not None:
                self.metrics.counter("funnel_acks_sent")

            def on_error(e, _origin=origin):
                if self.logger:
                    self.logger.warn(
                        TransactionId.LOADBALANCER,
                        f"funnel ack frame to origin {_origin} failed: "
                        f"{e!r} (sender retry will replay)", "Funnel")

            self._sending.add(origin)
            self.sender.send_frame(topic,
                                   FunnelAckMessage(origin, epoch, rows),
                                   on_error=on_error).add_done_callback(
                partial(self._sent, origin))

    def _sent(self, origin: int, _task: asyncio.Task) -> None:
        """An origin's outcome frame landed (or failed): what its rows
        earned meanwhile leaves as the next frame. One frame in flight an
        origin keeps the round trips to the broker from queueing behind
        each other when the loop is busy: the rows coalesce instead."""
        self._sending.discard(origin)
        if self._ack_buf.get(origin) and not self._flush_armed:
            self._flush_armed = True
            asyncio.get_event_loop().call_soon(self._flush)

    def export_gauges(self) -> dict:
        return {
            "funnel_frames_received": self.frames_received,
            "funnel_rows_received": self.rows_received,
            "funnel_dup_rows": self.dup_rows,
            "funnel_rows_refused": self.rows_refused,
            "funnel_stale_frames": self.stale_frames,
            "funnel_acks_sent": self.acks_sent,
        }
