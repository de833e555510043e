"""InvokerReactive: the invoker's event loop.
A copy of `openwhisk_tpu/invoker/reactive.py`.

Rebuild of core/invoker/.../invoker/InvokerReactive.scala:105-342 — consume
the `invoker<N>` topic through a MessageFeed whose capacity equals the pool's
slot count (maxPeek = user-memory / min-memory scaled by the concurrency peek
factor, :172-173), fetch the action (revision-keyed cache), hand a Run to the
ContainerPool, publish active-acks + 1 Hz health pings, and synthesize error
activations when the action can't even be fetched (:280-307).
"""
from __future__ import annotations

import asyncio
import time
from typing import Optional

from ..containerpool import (ContainerPool, ContainerPoolConfig, ContainerProxy,
                             Run)
from ..containerpool.logstore import ContainerLogStore
from ..core.entity import (ActivationResponse, EntityName, EntityPath,
                           ExecManifest, InvokerInstanceId, MemoryLimit,
                           WhiskActivation)
from ..database import EntityStore, NoDocumentException
from ..messaging.columnar import KIND_ACTIVATION, is_batch_payload
from ..messaging.connector import (MessageFeed, HEALTH_RETENTION_BYTES,
                                   HEALTH_TOPIC, decode_batch,
                                   decode_message)
from ..messaging.message import (ActivationMessage,
                                 CombinedCompletionAndResultMessage,
                                 CompletionMessage, PingMessage, ResultMessage)
from ..utils.eventlog import GLOBAL_EVENT_LOG
from ..utils.scheduler import Scheduler
from ..utils.transaction import TransactionId
from ..utils.waterfall import (GLOBAL_WATERFALL, STAGE_INVOKER_PICKUP,
                               STAGE_RECORD_WRITE, STAGE_RUN)



class InvokerReactive:
    def __init__(self, instance: InvokerInstanceId, messaging_provider,
                 entity_store: EntityStore, activation_store,
                 container_factory, pool_config: Optional[ContainerPoolConfig] = None,
                 logstore: Optional[ContainerLogStore] = None, logger=None,
                 metrics=None, ping_interval: float = 1.0,
                 admin_url: Optional[str] = None):
        self.instance = instance
        self.provider = messaging_provider
        self.entity_store = entity_store
        self.activation_store = activation_store
        self.factory = container_factory
        self.config = pool_config or ContainerPoolConfig(user_memory=instance.user_memory)
        self.logstore = logstore or ContainerLogStore()
        self.logger = logger
        self.metrics = metrics
        self.ping_interval = ping_interval
        #: fleet observatory peer directory: when set, every
        #: health ping announces this invoker's scrapeable admin address.
        #: None (the default, and whenever the observatory is disabled)
        #: keeps ping payloads byte-exact with pre-16 builds.
        self.admin_url = admin_url
        # completion acks, activation events and health pings all ride the
        # coalescing wrapper: under load the ack fan-in ships one frame per
        # micro-batch instead of one bus round trip per completion
        # (CONFIG_whisk_bus_coalesce_enabled=false restores serial sends)
        from ..messaging.coalesce import maybe_coalesce
        self.producer = maybe_coalesce(messaging_provider.get_producer())

        prewarm = []
        for manifest, cell in ExecManifest.runtimes().stem_cells():
            prewarm.append((manifest.kind, manifest.image.resolved,
                            cell.memory.to_mb, cell.count))
        self.pool = ContainerPool(self._make_proxy, self.config,
                                  prewarm_config=prewarm, logger=logger,
                                  metrics=metrics)
        self._feed: Optional[MessageFeed] = None
        self._pinger: Optional[Scheduler] = None
        self._pending_release: dict = {}
        self._active_spans: dict = {}
        from ..database import AuthStore
        from .blacklist import NamespaceBlacklist
        self.blacklist = NamespaceBlacklist(AuthStore(entity_store.store))
        self._blacklist_poller: Optional[Scheduler] = None
        #: HA epoch fencing: the highest placement-leadership epoch seen on
        #: this invoker's topic. A message stamped with a LOWER epoch is a
        #: zombie active's late batch — the standby that superseded it owns
        #: placement now — and is discarded instead of run (the
        #: no-double-execution half of the failover contract). -1 until the
        #: first fenced message; unfenced messages never participate.
        self._max_fence_epoch = -1
        #: active/active partitions: the same discard rule scoped per ring
        #: partition (messages carrying fence_part) — partition P's epoch
        #: bump must not fence partition Q's in-flight owner
        self._fence_epochs: dict = {}
        self.fenced_discards = 0

    # -- capacity: maxPeek mirrors ref :172-173 -----------------------------
    def max_peek(self) -> int:
        """max(containers, containers * maxConcurrency * peekFactor): the
        factor <= 1 dampens over-peeking (over-peeked messages are lost on
        crash, given the bus's at-most-once hand-off)."""
        from ..core.entity import ConcurrencyLimit
        slots = max(1, self.config.user_memory.to_mb // MemoryLimit.MIN.to_mb)
        return max(slots, int(slots * ConcurrencyLimit.MAX
                              * self.config.concurrent_peek_factor))

    # -- lifecycle ---------------------------------------------------------
    async def start(self, start_prewarm: bool = True) -> None:
        # factory bootstrap: stale-container cleanup / service registration
        # (ref InvokerReactive.scala:129-147); guarded for duck-typed test
        # factories that skip the ContainerFactory base
        init = getattr(self.factory, "init", None)
        if init is not None:
            await init()
        topic = self.instance.as_string
        self.provider.ensure_topic(topic)
        self.provider.ensure_topic(HEALTH_TOPIC,
                                   retention_bytes=HEALTH_RETENTION_BYTES)
        if start_prewarm:
            await self.pool.start()
        consumer = self.provider.get_consumer(topic, topic, max_peek=self.max_peek())
        feed_box = {}

        async def handle(payload: bytes):
            # feed capacity is released when the activation fully completes
            asyncio.get_event_loop().create_task(
                self._process(payload, feed_box["feed"]))

        self._feed = MessageFeed("activation", consumer, self.max_peek(), handle,
                                 logger=self.logger)
        feed_box["feed"] = self._feed
        self._feed.start()
        self._pinger = Scheduler(self.ping_interval, self._ping,
                                 name=f"{topic}-pinger", logger=self.logger).start()
        self._blacklist_poller = Scheduler(
            300.0, self.blacklist.refresh, name=f"{topic}-blacklist",
            logger=self.logger).start()
        await self.blacklist.refresh()

    async def _ping(self) -> None:
        await self.producer.send(HEALTH_TOPIC,
                                 PingMessage(self.instance,
                                             admin=self.admin_url))

    async def stop(self) -> None:
        if self._blacklist_poller:
            await self._blacklist_poller.stop()
        if self._pinger:
            await self._pinger.stop()
        if self._feed:
            await self._feed.stop()
        await self.pool.shutdown()
        # drain any coalescing window still holding queued acks/events and
        # release the producer transport
        await self.producer.close()
        await self.factory.cleanup()

    # -- activation processing (ref :213-307) -------------------------------
    @staticmethod
    def _make_release(feed: MessageFeed):
        """One idempotent feed-capacity release per logical activation."""
        released = False

        def release():
            nonlocal released
            if not released:
                released = True
                feed.processed()

        return release

    async def _process(self, payload: bytes, feed: MessageFeed) -> None:
        if is_batch_payload(payload):
            await self._process_batch(payload, feed)
            return
        release = self._make_release(feed)
        try:
            # decode_message: the per-activation JSON parse cost on the
            # invoker loop, counted {hop="activation",deserialize} by the
            # host observatory
            msg = decode_message(ActivationMessage.parse, payload,
                                 "activation")
        except (ValueError, KeyError) as e:
            if self.logger:
                self.logger.error(TransactionId.SYSTEM,
                                  f"corrupt activation message: {e!r}", "InvokerReactive")
            release()
            return
        GLOBAL_WATERFALL.stamp(msg.activation_id.asString,
                               STAGE_INVOKER_PICKUP)
        await self._handle_msg(msg, release)

    async def _process_batch(self, payload: bytes, feed: MessageFeed) -> None:
        """The batch-shaped pickup: one frame off the topic is
        a whole dispatch micro-batch — ONE columnar decode (shared
        identity/action parses), one waterfall stamp_many, one feed
        capacity adjustment, then the per-activation body per message.
        One frame = one handler task, so the per-activation task churn of
        the serial pickup collapses into the batch."""
        try:
            kind, msgs = decode_batch(payload)
            if kind != KIND_ACTIVATION:
                raise ValueError(f"unexpected batch kind {kind!r} on the "
                                 "activation topic")
        except (ValueError, KeyError, IndexError, TypeError,
                AssertionError) as e:
            # IndexError/TypeError included: malformed batch COLUMNS (a
            # dedup index past its table) parse as JSON but blow up in
            # from_json — same corrupt-frame posture as a bad parse
            if self.logger:
                self.logger.error(TransactionId.SYSTEM,
                                  f"corrupt activation batch: {e!r}",
                                  "InvokerReactive")
            feed.processed()
            return
        if not msgs:
            # zero-row frame (no producer ships one, but a frame that
            # decodes empty must still return its capacity unit)
            feed.processed()
            return
        # the feed booked ONE capacity unit for this frame; a frame is N
        # logical activations, each releasing independently
        feed.consume_extra(len(msgs) - 1)
        GLOBAL_WATERFALL.stamp_many(
            [m.activation_id.asString for m in msgs], STAGE_INVOKER_PICKUP)
        for msg in msgs:
            release = self._make_release(feed)
            try:
                await self._handle_msg(msg, release)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — per-message isolation:
                # in the serial path each payload ran in its own task, so
                # one activation's failure never starved its batch-mates
                # of processing or feed capacity
                if self.logger:
                    self.logger.error(TransactionId.SYSTEM,
                                      f"batch activation failed: {e!r}",
                                      "InvokerReactive")
                release()

    async def _handle_msg(self, msg: ActivationMessage, release) -> None:
        """The per-activation body shared by the serial and batch pickup
        paths (the pickup stage is already stamped by the caller)."""
        if msg.fence_epoch is not None:
            if msg.fence_part is not None:
                # active/active: one max epoch PER PARTITION
                current = self._fence_epochs.get(msg.fence_part, -1)
            else:
                current = self._max_fence_epoch
            if msg.fence_epoch < current:
                # a superseded epoch's late batch: the current active (or
                # its own retry path) owns this work now — running it here
                # would double-place
                self.fenced_discards += 1
                GLOBAL_EVENT_LOG.record(
                    "fence_discard", instance=self.instance.instance,
                    role="invoker", part=msg.fence_part,
                    epoch=msg.fence_epoch, current=current)
                if self.metrics is not None:
                    self.metrics.counter("invoker_fenced_discards")
                if self.logger:
                    part = ("" if msg.fence_part is None
                            else f" partition {msg.fence_part}")
                    self.logger.warn(
                        msg.transid,
                        f"discarding activation {msg.activation_id} from "
                        f"fenced epoch {msg.fence_epoch}{part} (current "
                        f"{current})", "InvokerReactive")
                release()
                return
            if msg.fence_part is not None:
                self._fence_epochs[msg.fence_part] = msg.fence_epoch
            else:
                self._max_fence_epoch = msg.fence_epoch
        from ..utils.tracing import GLOBAL_TRACER
        # (the waterfall invoker_pickup stamp happened at decode time —
        # single frames stamp one id, batch frames stamp_many; in
        # single-process deployments they share the controller's stage
        # map, separate processes no-op on the unknown id)
        # stack-free span: concurrent activations may SHARE a transid (all
        # rules of one trigger fire), so the span is keyed by activation id
        # and parented straight from the message's trace context
        span = GLOBAL_TRACER.start_remote_child("invoker_activation",
                                                msg.trace_context)
        if self.blacklist.is_blacklisted(msg.user):
            await self._error_activation(
                msg, "Namespace is disabled.")
            GLOBAL_TRACER.finish(span, {"error": "namespace disabled"})
            release()
            return
        try:
            action = await self.entity_store.get_action(str(msg.action),
                                                        rev=msg.revision)
            executable = action.to_executable()
            if executable is None:
                raise NoDocumentException("sequences are not executable on invokers")
            # feed capacity frees when the activation record is stored (the
            # proxy's last step) — registered by activation id
            self._pending_release[msg.activation_id.asString] = release
            self._active_spans[msg.activation_id.asString] = span
            self.pool.run(Run(executable, msg))
        except NoDocumentException:
            await self._error_activation(msg, "The requested resource does not exist.")
            GLOBAL_TRACER.finish(span, {"error": "resource does not exist"})
            release()
        except Exception as e:  # noqa: BLE001 — invoker loop must survive
            if self.logger:
                self.logger.error(msg.transid, f"activation failed: {e!r}", "InvokerReactive")
            await self._error_activation(msg, f"Invoker error: {e}")
            GLOBAL_TRACER.finish(span, {"error": str(e)})
            release()

    # -- proxy wiring ------------------------------------------------------
    def _make_proxy(self) -> ContainerProxy:
        return ContainerProxy(self.factory, self._active_ack, self._store_hook,
                              self.logstore.collect_logs, self.instance,
                              self.config, logger=self.logger)

    async def _active_ack(self, transid, activation: WhiskActivation, blocking,
                          controller, user, kind: str) -> None:
        # waterfall: user code is done (init + run); the ack produce and
        # the controller's completion processing are the remaining edges
        GLOBAL_WATERFALL.stamp(activation.activation_id.asString, STAGE_RUN)
        topic = f"completed{controller.as_string}"
        if kind == "result":
            message = ResultMessage(transid, activation)
        elif kind == "completion":
            message = CompletionMessage(transid, activation.activation_id,
                                        activation.response.is_whisk_error,
                                        self.instance)
        else:
            message = CombinedCompletionAndResultMessage(transid, activation,
                                                         self.instance)
        # trace continuity: the ack carries this activation's
        # span context back over the bus, so the controller's completion
        # processing parents into the same trace in BOTH wire formats
        # (the columnar ack frames ship it as a sparse column)
        span = self._active_spans.get(activation.activation_id.asString)
        if span is not None:
            message.trace_context = {
                "traceparent": f"00-{span.trace_id}-{span.span_id}-01"}
        await self.producer.send(topic, message.shrink())
        if kind != "result":
            # final ack: publish the user-facing activation event
            # (ref InvokerReactive.scala:182-185 -> `events` topic)
            await self._emit_activation_event(activation, user)

    async def _emit_activation_event(self, activation: WhiskActivation, user) -> None:
        from ..messaging.message import EventMessage
        try:
            annotations = activation.annotations
            await self.producer.send("events", EventMessage.for_activation(
                self.instance.as_string, activation,
                user.namespace.uuid.asString,
                kind=annotations.get("kind", "unknown"),
                memory_mb=(annotations.get("limits") or {}).get("memory", 256),
                wait_time=annotations.get("waitTime", 0) or 0,
                init_time=annotations.get("initTime", 0) or 0))
        except Exception:  # noqa: BLE001 — events are best-effort telemetry
            pass

    async def _store_hook(self, transid, activation, user) -> None:
        try:
            await self._store_activation(transid, activation, user)
        finally:
            release = self._pending_release.pop(activation.activation_id.asString, None)
            if release is not None:
                release()
            from ..utils.tracing import GLOBAL_TRACER
            span = self._active_spans.pop(activation.activation_id.asString, None)
            if span is not None:
                self._emit_container_spans(span, activation)
                GLOBAL_TRACER.finish(span, {
                    "activationId": activation.activation_id.asString,
                    "proc": f"invoker{self.instance.instance}"})

    def _emit_container_spans(self, parent, activation) -> None:
        """The container_acquire/run span pair, synthesized
        from timestamps the activation record ALREADY carries (start/end
        wall clocks, the waitTime annotation) — no new clock reads, and
        nothing at all when no tail-sampling trace store collects them."""
        from ..utils.tracestore import GLOBAL_TRACE_STORE, synthetic_span
        if not GLOBAL_TRACE_STORE.active:
            return
        proc = f"invoker{self.instance.instance}"
        ann = activation.annotations or {}
        wait_s = (ann.get("waitTime") or 0) / 1000.0
        start, end = activation.start, activation.end or activation.start
        if wait_s > 0:
            GLOBAL_TRACE_STORE.emit(synthetic_span(
                parent.trace_id, "container_acquire",
                start - wait_s, start,
                tags={"proc": proc}, parent_id=parent.span_id))
        GLOBAL_TRACE_STORE.emit(synthetic_span(
            parent.trace_id, "run", start, end,
            tags={"proc": proc,
                  "initTime_ms": ann.get("initTime") or 0},
            parent_id=parent.span_id))

    async def _store_activation(self, transid, activation, user) -> None:
        try:
            await self.activation_store.store(activation, context=user)
            # waterfall: the record is durable. May land BEFORE the
            # controller's completion_ack stamp (the ack is sent first but
            # consumed asynchronously) — the plane clamps that delta to 0 —
            # or AFTER the row finalized, where it no-ops. First-wins also
            # dedupes against the batcher-level stamp.
            GLOBAL_WATERFALL.stamp(activation.activation_id.asString,
                                   STAGE_RECORD_WRITE)
        except Exception as e:  # noqa: BLE001 — losing a record must not kill the loop
            if self.logger:
                self.logger.error(transid, f"failed to store activation: {e!r}",
                                  "InvokerReactive")

    async def _error_activation(self, msg: ActivationMessage, reason: str) -> None:
        """Fallback error activation when the action can't run at all
        (ref InvokerReactive.scala:280-307)."""
        now = time.time()
        activation = WhiskActivation(
            namespace=EntityPath(str(msg.user.namespace.name)),
            name=msg.action.name, subject=msg.user.subject,
            activation_id=msg.activation_id, start=now, end=now,
            response=ActivationResponse.whisk_error(reason))
        await self._active_ack(msg.transid, activation, msg.blocking,
                               msg.root_controller_index, msg.user, "combined")
        await self._store_activation(msg.transid, activation, msg.user)


class InvokerReactiveProvider:
    @staticmethod
    def instance(**kwargs) -> InvokerReactive:
        return InvokerReactive(**kwargs)
