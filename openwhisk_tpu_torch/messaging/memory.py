"""In-memory message bus.

A copy of `openwhisk_tpu/messaging/memory.py` without its waterfall produce
stamp (rebuild of the reference's lean connector,
common/scala/.../connector/lean/: a queue per topic), used for
single-process deployments and as the test bus.

Competing consumers in the same group share a queue (each message is
delivered once per group); distinct groups each get every message — the same
observable semantics as Kafka consumer groups on a single partition.
"""
from __future__ import annotations

import asyncio
import itertools
from collections import deque
from typing import Dict, List, Optional, Tuple

from .connector import (MessageConsumer, MessageProducer, MessagingProvider,
                        encode_message)


#: backstop per-group retention — bounds queues of groups nobody drains
#: (e.g. a retired controller's health group); drop-oldest like Kafka's
#: retention. Tight per-topic caps come from ensure_topic(retention_bytes).
DEFAULT_MAX_MESSAGES = 1_000_000


class _Topic:
    def __init__(self, name: str, max_messages: int = DEFAULT_MAX_MESSAGES):
        self.name = name
        self.max_messages = max_messages
        self.offset = itertools.count()
        self.groups: Dict[str, deque] = {}
        self.cond = asyncio.Condition()

    def queue_for(self, group: str) -> deque:
        if group not in self.groups:
            self.groups[group] = deque(maxlen=self.max_messages)
        return self.groups[group]

    def set_max_messages(self, max_messages: int) -> None:
        if max_messages == self.max_messages:
            return
        self.max_messages = max_messages
        for g, q in list(self.groups.items()):
            self.groups[g] = deque(q, maxlen=max_messages)

    def set_retention_bytes(self, retention_bytes: int) -> None:
        """Map a byte budget to a message cap (~128 B/message estimate)."""
        self.set_max_messages(min(max(retention_bytes // 128, 64),
                                  DEFAULT_MAX_MESSAGES))


class MemoryBus:
    """Topic registry shared by producers/consumers of one provider."""

    def __init__(self):
        self.topics: Dict[str, _Topic] = {}

    def topic(self, name: str) -> _Topic:
        t = self.topics.get(name)
        if t is None:
            t = _Topic(name)
            self.topics[name] = t
        return t


class MemoryProducer(MessageProducer):
    def __init__(self, bus: MemoryBus):
        self.bus = bus
        self._sent = 0

    @property
    def sent_count(self) -> int:
        return self._sent

    def _append_locked(self, t: _Topic, payload) -> None:
        """Fan one payload out to every group (t.cond must be held)."""
        off = next(t.offset)
        for q in t.groups.values():
            q.append((off, bytes(payload)))
        if not t.groups:
            # retain for the first group to subscribe (queue semantics)
            t.queue_for("__default__").append((off, bytes(payload)))
        self._sent += 1

    async def send(self, topic: str, msg) -> None:
        payload = encode_message(msg)
        t = self.bus.topic(topic)
        async with t.cond:
            self._append_locked(t, payload)
            t.cond.notify_all()


class MemoryConsumer(MessageConsumer):
    def __init__(self, bus: MemoryBus, topic: str, group: str, max_peek: int = 128,
                 from_latest: bool = False):
        self.bus = bus
        self.topic_name = topic
        self.group = group
        self.max_peek = max_peek
        t = self.bus.topic(topic)
        # adopt messages produced before any subscriber existed — except for
        # from_latest consumers (ephemeral streams like health pings must
        # never replay a backlog; Kafka equivalent auto_offset_reset=latest).
        # Like Kafka's offset reset, from_latest applies only when the group
        # is NEW — re-attaching to an existing group resumes its backlog.
        if group in t.groups:
            pass
        elif from_latest:
            # New group starts empty; the pre-subscription backlog in
            # __default__ stays retained for a later queue-semantics group.
            t.queue_for(group)
        elif "__default__" in t.groups:
            t.groups[group] = t.groups.pop("__default__")
        else:
            t.queue_for(group)
        self._uncommitted: List[Tuple[str, int, int, bytes]] = []

    async def peek(self, max_messages: int, timeout: float = 0.5
                   ) -> List[Tuple[str, int, int, bytes]]:
        n = min(max_messages, self.max_peek)
        t = self.bus.topic(self.topic_name)
        out: List[Tuple[str, int, int, bytes]] = []
        async with t.cond:
            # look the queue up inside the predicate: set_max_messages may
            # swap the deque object while we are parked on the condition
            if not t.queue_for(self.group):
                try:
                    await asyncio.wait_for(
                        t.cond.wait_for(
                            lambda: len(t.queue_for(self.group)) > 0), timeout)
                except asyncio.TimeoutError:
                    return []
            q = t.queue_for(self.group)
            while q and len(out) < n:
                off, payload = q.popleft()
                out.append((self.topic_name, 0, off, payload))
        self._uncommitted = out
        return out

    def commit(self) -> None:
        self._uncommitted = []


class MemoryMessagingProvider(MessagingProvider):
    """One bus per instance: its producers and consumers share it."""

    def __init__(self):
        self.bus = MemoryBus()

    def get_producer(self) -> MemoryProducer:
        return MemoryProducer(self.bus)

    def get_consumer(self, topic: str, group_id: str, max_peek: int = 128,
                     from_latest: bool = False) -> MemoryConsumer:
        return MemoryConsumer(self.bus, topic, group_id, max_peek,
                              from_latest=from_latest)

    def ensure_topic(self, topic: str, partitions: int = 1,
                     retention_bytes: Optional[int] = None) -> None:
        t = self.bus.topic(topic)
        if retention_bytes is not None:
            t.set_retention_bytes(retention_bytes)
