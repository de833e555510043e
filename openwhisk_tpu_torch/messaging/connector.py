"""Messaging abstractions: producer, consumer, feed.
A copy of `openwhisk_tpu/messaging/connector.py`.

Rebuild of common/scala/.../core/connector/{MessagingProvider,MessageConsumer}
.scala. The `MessageFeed` reproduces the reference's double-buffered pull
pipeline (MessageConsumer.scala:93-247): it long-polls the consumer for up to
`maximum_handler_capacity` messages, commits the offset immediately after the
peek (at-most-once hand-off, :179-190), dispatches to the handler, and only
refills as the handler signals `processed()` — so a slow handler backpressures
the bus instead of ballooning memory.
"""
from __future__ import annotations

import asyncio
import time
from typing import Awaitable, Callable, List, Optional, Tuple

from ..utils.hostprof import GLOBAL_HOST_OBSERVATORY
from ..utils.transaction import TransactionId
from ..utils.waterfall import GLOBAL_WATERFALL, STAGE_PRODUCE

#: serde hop labels by message class (by NAME, so this module needs no
#: import of messaging/message.py): the controller->invoker dispatch and
#: the invoker->controller ack are the two hot hops; pings/events are the
#: background chatter that should NOT hide inside them
_SERDE_HOPS = {
    "ActivationMessage": "activation",
    "CompletionMessage": "completion_ack",
    "ResultMessage": "completion_ack",
    "CombinedCompletionAndResultMessage": "completion_ack",
    "PingMessage": "health_ping",
    "EventMessage": "event",
}


def hop_of(msg) -> str:
    return _SERDE_HOPS.get(type(msg).__name__, "other")


def encode_message(msg, hop: Optional[str] = None) -> bytes:
    """Serialize a bus message with host-observatory serde accounting
    (`openwhisk_host_serde_*_total{hop,direction="serialize"}`): the
    byte+wall-time cost of every encode on the caller's turn becomes a
    measured number instead of loop noise. Bytes pass through untouched;
    with host profiling disabled this is a plain `msg.serialize()`."""
    if isinstance(msg, (bytes, bytearray)):
        return msg
    obs = GLOBAL_HOST_OBSERVATORY
    if not obs.serde_active:
        return msg.serialize()
    t0 = time.perf_counter_ns()
    payload = msg.serialize()
    obs.serde_observe(hop if hop is not None else hop_of(msg), "serialize",
                      len(payload), time.perf_counter_ns() - t0)
    return payload


def decode_message(parse, raw, hop: str):
    """`parse(raw)` with the matching deserialize-side accounting (the
    invoker's ActivationMessage.parse, the balancer's ack parse)."""
    obs = GLOBAL_HOST_OBSERVATORY
    if not obs.serde_active:
        return parse(raw)
    t0 = time.perf_counter_ns()
    msg = parse(raw)
    obs.serde_observe(hop, "deserialize", len(raw),
                      time.perf_counter_ns() - t0)
    return msg


def encode_batch(family: str, msgs: list,
                 lazy_results: bool = False) -> Tuple[bytes, object]:
    """ONE serialize for a whole same-family micro-batch (the columnar
    batch wire, messaging/columnar.py). Returns (payload, batch_message);
    the host observatory books the batch's bytes + wall time under the
    SAME hop label as N serial encodes would have used — so the serde
    counters stay comparable across the knob, and the per-hop byte totals
    measure the dedup win directly. `lazy_results` selects the
    lazy ack frame (opaque response-bytes column) for ack batches."""
    from .columnar import batch_hop_of, make_batch
    batch_msg = make_batch(family, msgs, lazy_results=lazy_results)
    obs = GLOBAL_HOST_OBSERVATORY
    if not obs.serde_active:
        return batch_msg.serialize(), batch_msg
    t0 = time.perf_counter_ns()
    payload = batch_msg.serialize()
    obs.serde_observe(batch_hop_of(family), "serialize", len(payload),
                      time.perf_counter_ns() - t0)
    return payload, batch_msg


def decode_batch(raw):
    """Decode one batch payload -> (kind, [messages]) with the matching
    deserialize-side accounting (one observe for the whole frame)."""
    from .columnar import batch_hop_of, parse_batch
    obs = GLOBAL_HOST_OBSERVATORY
    if not obs.serde_active:
        return parse_batch(raw)
    t0 = time.perf_counter_ns()
    kind, msgs = parse_batch(raw)
    obs.serde_observe(batch_hop_of(kind), "deserialize", len(raw),
                      time.perf_counter_ns() - t0)
    return kind, msgs


def stamp_produce(msg) -> None:
    """Waterfall `produce` edge, shared by every bus backend's producer:
    first-wins, so only the controller->invoker hand-off sets it (the
    completion ack also carries an activation_id but lands second, and
    cross-process peers stamp into an empty map — a no-op). Batch wire
    records carry `activation_ids` and stamp the whole batch at one
    shared timestamp."""
    aids = getattr(msg, "activation_ids", None)
    if aids is not None:
        GLOBAL_WATERFALL.stamp_many(aids, STAGE_PRODUCE)
        return
    aid = getattr(msg, "activation_id", None)
    if aid is not None:
        GLOBAL_WATERFALL.stamp(aid.asString, STAGE_PRODUCE)


class MessageProducer:
    async def send(self, topic: str, msg) -> None:
        """Send a Message (or raw bytes) to a topic."""
        raise NotImplementedError

    async def send_batch(self, topic: str, msgs) -> None:
        """Send a wave of messages to ONE topic. The CoalescingProducer
        overrides this task-free (one await for the whole wave); the
        default keeps serial semantics."""
        for m in msgs:
            await self.send(topic, m)

    async def send_many(self, items) -> None:
        """Ship a pre-serialized micro-batch `[(topic, payload_bytes, msg)]`
        (msg is the original Message for waterfall stamping, or None).
        Backends with a native batch op (one frame + one ack for N
        messages: the TCP bus `pubN`, Kafka's client-side batching)
        override this; the default degrades to sequential sends — serial
        semantics, so the CoalescingProducer is safe over any provider."""
        for topic, payload, msg in items:
            await self.send(topic, msg if msg is not None else payload)

    @property
    def sent_count(self) -> int:
        return 0

    async def close(self) -> None:
        pass


class MessageConsumer:
    """A consumer bound to one topic (ref MessageConsumer.scala:32-56)."""

    max_peek: int = 128

    async def peek(self, max_messages: int, timeout: float = 0.5
                   ) -> List[Tuple[str, int, int, bytes]]:
        """Long-poll up to max_messages; returns (topic, partition, offset, payload)."""
        raise NotImplementedError

    def commit(self) -> None:
        """Commit offsets of the last peek (at-most-once hand-off)."""
        raise NotImplementedError

    async def close(self) -> None:
        pass


class MessagingProvider:
    """SPI: build producers/consumers (ref MessagingProvider.scala:34-46)."""

    def get_producer(self) -> MessageProducer:
        raise NotImplementedError

    def get_consumer(self, topic: str, group_id: str, max_peek: int = 128,
                     from_latest: bool = False) -> MessageConsumer:
        """from_latest: start a NEW group at the stream head instead of the
        retained backlog — for ephemeral streams (health pings) where replay
        would resurrect stale state."""
        raise NotImplementedError

    def ensure_topic(self, topic: str, partitions: int = 1,
                     retention_bytes: Optional[int] = None) -> None:
        raise NotImplementedError


#: the invoker ping stream: smallest retention of any topic (ref gives the
#: health topic its tightest retention) and consumed from_latest
HEALTH_TOPIC = "health"
HEALTH_RETENTION_BYTES = 512 * 1024

Handler = Callable[[bytes], Awaitable[None]]


class MessageFeed:
    """Backpressured pull pipeline from a MessageConsumer to a handler.

    The handler receives raw payload bytes and MUST call `processed()` when
    it has freed its capacity (mirrors sending `MessageFeed.Processed` to the
    feed actor in the reference).
    """

    def __init__(self, description: str, consumer: MessageConsumer,
                 maximum_handler_capacity: int, handler: Handler,
                 logger=None, long_poll_timeout: float = 0.5,
                 auto_start: bool = False):
        self.description = description
        self.consumer = consumer
        self.capacity = maximum_handler_capacity
        self.handler = handler
        self.logger = logger
        self.long_poll_timeout = long_poll_timeout
        self._free = maximum_handler_capacity
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._running = False
        if auto_start:
            self.start()

    @property
    def free_capacity(self) -> int:
        return self._free

    def start(self) -> "MessageFeed":
        if not self._running:
            self._running = True
            self._task = asyncio.get_event_loop().create_task(
                self._pump(), name=f"feed-{self.description}")
        return self

    def processed(self) -> None:
        """Handler signals one unit of capacity is free again."""
        self._free += 1
        self._wake.set()

    def consume_extra(self, n: int) -> None:
        """A handler discovered its ONE payload carries `1 + n` logical
        messages (a columnar batch frame): book the extra capacity so the
        feed's backpressure still counts messages, not frames. Each
        logical message then releases via processed() as it completes.
        May drive _free negative under a large frame — the pump simply
        waits until enough releases land, which is the intended
        backpressure."""
        if n > 0:
            self._free -= n

    async def _pump(self) -> None:
        try:
            while self._running:
                if self._free <= 0:
                    self._wake.clear()
                    if self._free <= 0:
                        await self._wake.wait()
                    continue
                batch = await self.consumer.peek(self._free, self.long_poll_timeout)
                if not batch:
                    continue
                # commit BEFORE handling: at-most-once hand-off, exactly as
                # the reference (MessageConsumer.scala:179-190).
                self.consumer.commit()
                for _topic, _part, _offset, payload in batch:
                    self._free -= 1
                    try:
                        await self.handler(payload)
                    except asyncio.CancelledError:
                        raise
                    except Exception as e:  # noqa: BLE001 — feed must survive handler errors
                        self._free += 1
                        if self.logger:
                            self.logger.error(TransactionId.SYSTEM,
                                              f"feed {self.description} handler error: {e!r}")
        except asyncio.CancelledError:
            pass

    async def stop(self) -> None:
        self._running = False
        self._wake.set()
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        await self.consumer.close()
