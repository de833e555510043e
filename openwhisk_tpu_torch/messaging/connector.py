"""Messaging abstractions: producer, consumer, feed.

A copy of `openwhisk_tpu/messaging/connector.py` (rebuild of
common/scala/.../core/connector/{MessagingProvider,MessageConsumer}.scala)
without its host-observatory serde accounting and waterfall produce stamp.
The `MessageFeed` reproduces the reference's double-buffered pull pipeline
(MessageConsumer.scala:93-247): it long-polls the consumer for up to
`maximum_handler_capacity` messages, commits the offset immediately after
the peek (at-most-once hand-off, :179-190), dispatches to the handler, and
only refills as the handler signals `processed()` — so a slow handler
backpressures the bus instead of ballooning memory.
"""
from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, List, Optional, Tuple

from ..utils.transaction import TransactionId


def encode_message(msg) -> bytes:
    """Serialize a bus message; bytes pass through untouched."""
    if isinstance(msg, (bytes, bytearray)):
        return msg
    return msg.serialize()


def decode_message(parse, raw):
    """`parse(raw)`: the one place a consumer turns bus bytes into a
    message (the balancer's ack parse, an invoker's activation parse)."""
    return parse(raw)


class MessageProducer:
    async def send(self, topic: str, msg) -> None:
        """Send a Message (or raw bytes) to a topic."""
        raise NotImplementedError

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
