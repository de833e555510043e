"""Cross-partition spillover for hot namespaces.
A copy of `openwhisk_tpu/controller/loadbalancer/spillover.py`.

Partition ownership (partitions.py) pins a namespace to ONE controller —
which is exactly what makes a hot namespace a hot CONTROLLER. This plane
lets an overloaded owner forward its overflow admission batch (the batched
`publish_many` shape) to the least-loaded peer instead of deepening its
own queue:

  * the owner's `publish_many` diverts its NON-BLOCKING tail past the
    `spillover_depth` pending-queue gate (blocking rows stay local: their
    client waits on the owner's completion promise);
  * each forwarded row is fence-stamped `(partition, current epoch)` by
    the owner BEFORE it leaves — the stamp is simultaneously the invoker
    fence AND the peer-side admission credential (`_partition_refusal`
    admits a row fenced at the partition's current epoch even though the
    peer does not own the partition), so replay stays exact: the rows
    land in the PEER's journal carrying the origin partition id and the
    epoch they were admitted under, and a later absorber of that
    partition filters them exactly like the owner's own records;
  * `root_controller_index` is REWRITTEN to the peer: completion acks,
    capacity books and the activation record pipeline all live where the
    placement happened — the origin's waterfall folds at the
    `spill_forward` stage (the extra hop, stamped) and the peer owns the
    rest of the row's life;
  * transport is the bus: one columnar `ActivationBatchMessage` frame on
    the peer's `ctrlspill<N>` topic per forwarded batch.

Off-switch: `CONFIG_whisk_ha_activeActive_spillover=false` (the default)
— no sink is attached and `publish_many` never diverts.
"""
from __future__ import annotations

import asyncio
from typing import List, Optional

from ...core.entity import ControllerInstanceId
from ...messaging.columnar import ActivationBatchMessage, is_batch_payload
from ...messaging.connector import MessageFeed, decode_batch
from ...utils.eventlog import GLOBAL_EVENT_LOG
from ...utils.transaction import TransactionId
from .funnel import FrameSender

SPILL_TOPIC_PREFIX = "ctrlspill"
#: spilled work is live traffic, not history: keep a small tail only
SPILL_RETENTION_BYTES = 4 * 1024 * 1024


def spill_topic(instance: int) -> str:
    return f"{SPILL_TOPIC_PREFIX}{int(instance)}"


class SpilloverSender(FrameSender):
    """The owner-side sink `TpuBalancer.publish_many` diverts into.
    Rides the funnel's shared `FrameSender` core: the lazy
    producer, the once-per-topic ensure and the one-task-per-frame send
    live there now."""

    def __init__(self, provider, membership, metrics=None, logger=None):
        super().__init__(provider, logger=logger)
        self.membership = membership
        self.metrics = metrics

    def has_peer(self) -> bool:
        return self.membership.least_loaded_peer() is not None

    def forward(self, pairs) -> List[asyncio.Future]:
        """Ship `pairs` ([(action, msg)], already fence-stamped by the
        caller) to the least-loaded peer as ONE batch frame. Returns one
        future per pair resolving when the frame is handed to the bus
        (send failure fails every row — the caller maps it to a refused
        publish)."""
        peer = self.membership.least_loaded_peer()
        loop = asyncio.get_event_loop()
        outs: List[asyncio.Future] = [loop.create_future() for _ in pairs]
        if peer is None:
            for out in outs:
                out.set_exception(RuntimeError("no spillover peer"))
            return outs
        msgs = []
        for _action, msg in pairs:
            # acks/books/record pipeline live at the peer from here on
            msg.root_controller_index = ControllerInstanceId(str(peer))
            msgs.append(msg)
        topic = spill_topic(peer)
        self.ensure_topic(topic, SPILL_RETENTION_BYTES)
        if self.metrics is not None:
            self.metrics.counter("loadbalancer_spillover_batches")
        GLOBAL_EVENT_LOG.record("spill_burst", peer=int(peer),
                                rows=len(msgs))
        self._emit_hop_spans(msgs, peer)
        self.send_frame(topic, ActivationBatchMessage(msgs), outs=outs)
        return outs

    def _emit_hop_spans(self, msgs, peer) -> None:
        """Stamp the spill hop into the trace observatory — one
        zero-width `spill_forward` span per forwarded row, so an assembled
        cross-process trace shows the extra controller the row visited.
        One clock read per burst (amortized over the batch; the event-log
        record above already paid one), nothing when the plane is off."""
        from ...utils.tracestore import GLOBAL_TRACE_STORE, synthetic_span
        from ...utils.tracing import trace_id_of
        if not GLOBAL_TRACE_STORE.active:
            return
        import time
        ts = time.time()
        inst = getattr(getattr(self.membership, "instance", None),
                       "instance", None)
        proc = f"controller{inst}" if inst is not None else "controller?"
        for msg in msgs:
            tid = trace_id_of(getattr(msg, "trace_context", None))
            if tid is None:
                continue
            GLOBAL_TRACE_STORE.mark(tid, "spilled")
            GLOBAL_TRACE_STORE.emit(synthetic_span(
                tid, "spill_forward", ts, ts,
                tags={"proc": proc, "peer": str(int(peer))}))


class SpilloverReceiver:
    """Peer side: consume the own `ctrlspill<N>` topic and place the
    forwarded rows through the local balancer's batched publish path.
    The fence stamp each row carries is its admission credential
    (module doc); rows whose partition epoch went stale between forward
    and pickup are refused by `_partition_refusal` exactly like any
    fenced-out zombie work — counted, logged, never run."""

    def __init__(self, provider, instance, balancer, entity_store,
                 logger=None, metrics=None):
        self.provider = provider
        self.instance = instance
        self.balancer = balancer
        self.entity_store = entity_store
        self.logger = logger
        self.metrics = metrics
        self._feed: Optional[MessageFeed] = None
        self.received = 0
        self.refused = 0

    def start(self) -> None:
        topic = spill_topic(self.instance.instance)
        self.provider.ensure_topic(topic,
                                   retention_bytes=SPILL_RETENTION_BYTES)
        consumer = self.provider.get_consumer(
            topic, f"spill{self.instance.instance}", max_peek=64)
        box = {}

        async def handle(payload: bytes):
            try:
                await self._consume(payload)
            finally:
                box["feed"].processed()

        self._feed = MessageFeed("spillover", consumer, 64, handle,
                                 logger=self.logger)
        box["feed"] = self._feed
        self._feed.start()

    async def stop(self) -> None:
        if self._feed is not None:
            await self._feed.stop()

    async def _consume(self, payload: bytes) -> None:
        try:
            if is_batch_payload(payload):
                _kind, msgs = decode_batch(payload)
            else:
                from ...messaging.message import ActivationMessage
                msgs = [ActivationMessage.parse(payload)]
        except (ValueError, KeyError, IndexError, TypeError) as e:
            if self.logger:
                self.logger.error(TransactionId.LOADBALANCER,
                                  f"corrupt spillover frame: {e!r}",
                                  "Spillover")
            return
        pairs = []
        for msg in msgs:
            try:
                action = await self.entity_store.get_action(
                    str(msg.action), rev=msg.revision)
                executable = action.to_executable()
                if executable is None:
                    raise ValueError("not executable")
                pairs.append((executable, msg))
            except Exception as e:  # noqa: BLE001 — per-row isolation
                if self.logger:
                    self.logger.warn(TransactionId.LOADBALANCER,
                                     f"spilled activation "
                                     f"{msg.activation_id} dropped: {e!r}",
                                     "Spillover")
        if not pairs:
            return
        # open the peer-side waterfall half. The origin folded
        # its stage vector at spill_forward — this process owns the rest
        # of the row's life, so its stages (publish_enqueue onward) need
        # a fresh ctx carrying the same trace id; the assembler pins this
        # half's publish_enqueue to the origin's spill_forward stamp.
        wf = getattr(self.balancer, "waterfall", None)
        if wf is not None and wf.enabled:
            from ...utils.tracing import trace_id_of
            for _executable, msg in pairs:
                wf.adopt(msg.activation_id.asString, wf.open(),
                         trace_id=trace_id_of(
                             getattr(msg, "trace_context", None)))
        self.received += len(pairs)
        if self.metrics is not None:
            self.metrics.counter("loadbalancer_spillover_received",
                                 len(pairs))
        rows = self.balancer.publish_many(pairs)
        for row in rows:
            row.add_done_callback(self._row_done)

    def _row_done(self, row: asyncio.Future) -> None:
        exc = None if row.cancelled() else row.exception()
        if exc is not None:
            # a stale-epoch spill refused by the fence, or placement
            # failure: the origin already answered its client (non-
            # blocking 202) — the row self-heals like any lost dispatch
            self.refused += 1
            if self.metrics is not None:
                self.metrics.counter("loadbalancer_spillover_refused")
            if self.logger:
                self.logger.warn(TransactionId.LOADBALANCER,
                                 f"spilled row not placed: {exc!r}",
                                 "Spillover")
