"""TCP bus: the framework's own distributed messaging spine.
A copy of `openwhisk_tpu/messaging/tcp.py`.

The reference's data plane rides Kafka (SURVEY §5.8); this module provides
the framework-native equivalent for multi-process/multi-host deployments
without external brokers: a lightweight asyncio broker (`TcpBusServer`)
serving the same topic/consumer-group semantics as the in-memory bus over
length-prefixed JSON frames, and `TcpMessagingProvider` implementing the
MessagingProvider SPI against it. Kafka itself remains pluggable behind the
same SPI (`openwhisk_tpu_torch.messaging.kafka:KafkaMessagingProvider`).

Protocol (4-byte big-endian length + JSON):
  {"op": "pub",  "topic": t, "payload": <b64>}            -> {"ok": true}
  {"op": "pubN", "msgs": [{"topic": t, "mid": m,
   "payload": <b64>}, ...]}  -> {"ok": true, "results": [{"ok": true,
                                 "dup": bool}, ...]}      (one ack for N)
  {"op": "peek", "topic": t, "group": g, "max": n,
   "timeout": s}   -> {"msgs": [[offset, <b64>], ...]}    (long-poll)
  {"op": "ensure", "topic": t}                            -> {"ok": true}
Delivery is at-most-once per group, exactly like the reference's
commit-after-peek hand-off (MessageConsumer.scala:179-190). `pubN` is the
coalesced produce op (messaging/coalesce.py): N payloads, one round trip,
dedupe keyed PER SUB-MESSAGE so a retried frame replays only the payloads
whose first delivery was lost.
"""
from __future__ import annotations

import asyncio
import base64
import json
import logging
import socket
import struct
import time
import uuid
from typing import List, Optional, Tuple

from .connector import MessageConsumer, MessageProducer, MessagingProvider
from .memory import MemoryBus

_log = logging.getLogger("openwhisk_tpu_torch.messaging.tcp")

#: frames whose b64+JSON encode exceeds this many payload bytes are built on
#: the default executor instead of the event loop (a 1 MB action result
#: costs ~ms of base64 — real loop stall at thousands of sends/s)
OFFLOAD_ENCODE_BYTES = 48 * 1024

#: cap on the RAW payload bytes packed into one pubN frame: b64 inflates by
#: 4/3 and _read_frame rejects frames over 64 MiB, so a coalesced batch of
#: large bodies (64 x ~1 MiB completion acks) must SPLIT into several
#: frames rather than ship one rejected mega-frame that would fail every
#: message in the batch forever (the count-based flush bound alone cannot
#: see bytes)
MAX_PUBN_PAYLOAD_BYTES = 16 * 1024 * 1024

#: process-wide TCP-bus client health counters (export_bus_gauges)
_BUS_STATS = {"consumer_reconnects": 0}


async def _read_frame(reader: asyncio.StreamReader) -> Optional[dict]:
    try:
        header = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (length,) = struct.unpack(">I", header)
    if length > 64 * 1024 * 1024:
        return None
    try:
        body = await reader.readexactly(length)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    return json.loads(body)


def _frame(obj: dict) -> bytes:
    body = json.dumps(obj, separators=(",", ":")).encode()
    return struct.pack(">I", len(body)) + body


class TcpBusServer:
    """The broker: topic queues (a MemoryBus) served over TCP."""

    def __init__(self, host: str = "127.0.0.1", port: int = 4222):
        self.host = host
        self.port = port
        self.bus = MemoryBus()
        self._server: Optional[asyncio.AbstractServer] = None
        self._client_writers: set = set()
        self._seen_mids: dict = {}  # LRU of recent pub message ids (dedupe)

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            # sever live client connections: wait_closed() (py3.12) waits for
            # all handlers, which block in reads on long-lived clients
            for w in list(self._client_writers):
                w.close()
            await self._server.wait_closed()

    def _seen(self, mid) -> bool:
        """Record `mid` in the dedupe LRU; True when it was already there
        (a producer retried a frame whose ack was lost — the activation
        must not run twice because of a dropped TCP response)."""
        if mid is None:
            return False
        if mid in self._seen_mids:
            return True
        self._seen_mids[mid] = None
        if len(self._seen_mids) > 8192:
            self._seen_mids.pop(next(iter(self._seen_mids)))
        return False

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        from .memory import MemoryConsumer, MemoryProducer
        producer = MemoryProducer(self.bus)
        consumers = {}
        self._client_writers.add(writer)
        try:
            while True:
                req = await _read_frame(reader)
                if req is None:
                    break
                op = req.get("op")
                if op == "pub":
                    if self._seen(req.get("mid")):
                        writer.write(_frame({"ok": True, "dup": True}))
                    else:
                        payload = base64.b64decode(req["payload"])
                        await producer.send(req["topic"], payload)
                        writer.write(_frame({"ok": True}))
                elif op == "pubN":
                    # coalesced produce: dedupe each sub-message, then one
                    # grouped append for everything fresh — a retried frame
                    # replays only the sub-messages that never landed
                    results = []
                    fresh = []
                    for sub in req.get("msgs", []):
                        if self._seen(sub.get("mid")):
                            results.append({"ok": True, "dup": True})
                        else:
                            fresh.append((sub["topic"],
                                          base64.b64decode(sub["payload"]),
                                          None))
                            results.append({"ok": True})
                    if fresh:
                        await producer.send_many(fresh)
                    writer.write(_frame({"ok": True, "results": results}))
                elif op == "peek":
                    key = (req["topic"], req.get("group", "default"))
                    consumer = consumers.get(key)
                    if consumer is None:
                        consumer = MemoryConsumer(
                            self.bus, key[0], key[1], max_peek=1024,
                            from_latest=bool(req.get("latest")))
                        consumers[key] = consumer
                    batch = await consumer.peek(int(req.get("max", 128)),
                                                float(req.get("timeout", 0.5)))
                    consumer.commit()
                    writer.write(_frame({"msgs": [
                        [off, base64.b64encode(p).decode()]
                        for (_t, _p, off, p) in batch]}))
                elif op == "ensure":
                    t = self.bus.topic(req["topic"])
                    if req.get("retention_bytes") is not None:
                        t.set_retention_bytes(int(req["retention_bytes"]))
                    writer.write(_frame({"ok": True}))
                else:
                    writer.write(_frame({"error": f"unknown op {op!r}"}))
                await writer.drain()
        finally:
            self._client_writers.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, OSError):
                pass


class _TcpConnection:
    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self._lock = asyncio.Lock()

    async def request(self, obj: dict) -> dict:
        return await self.request_frame(_frame(obj))

    async def request_frame(self, frame: bytes) -> dict:
        """One request/response round trip for an already-encoded frame
        (large frames are built off-loop by the producer; the retry loop
        reuses the same bytes, which is what keeps broker-side dedupe by
        mid sound)."""
        async with self._lock:
            for attempt in (1, 2):
                if self.writer is None or self.writer.is_closing():
                    self.reader, self.writer = await asyncio.open_connection(
                        self.host, self.port)
                try:
                    self.writer.write(frame)
                    await self.writer.drain()
                    resp = await _read_frame(self.reader)
                    if resp is not None:
                        return resp
                except (ConnectionResetError, BrokenPipeError, OSError):
                    pass
                # reconnect once; close the dead transport to free its fd
                self.writer.close()
                self.writer = None
            raise ConnectionError(f"bus at {self.host}:{self.port} unreachable")

    async def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
            try:
                await self.writer.wait_closed()
            except (ConnectionResetError, OSError):
                pass
            self.writer = None


def _encode_pub(topic: str, mid: str, payload: bytes) -> bytes:
    return _frame({"op": "pub", "topic": topic, "mid": mid,
                   "payload": base64.b64encode(payload).decode()})


def _encode_pubn(msgs: List[Tuple[str, str, bytes]]) -> bytes:
    return _frame({"op": "pubN", "msgs": [
        {"topic": t, "mid": m, "payload": base64.b64encode(p).decode()}
        for (t, m, p) in msgs]})


class TcpProducer(MessageProducer):
    def __init__(self, host: str, port: int):
        self._conn = _TcpConnection(host, port)
        self._sent = 0
        # cheap unique message ids: one random prefix per producer plus a
        # counter, instead of a uuid4 per send (uuid minting was measurable
        # hot-path work at thousands of sends/s). Dedupe semantics are
        # unchanged: the mid is unique per LOGICAL send and stable across
        # the connection-level retry inside request_frame.
        self._mid_prefix = uuid.uuid4().hex[:12]
        self._mid_seq = 0

    @property
    def sent_count(self) -> int:
        return self._sent

    def _next_mid(self) -> str:
        self._mid_seq += 1
        return f"{self._mid_prefix}-{self._mid_seq}"

    async def _encoded(self, total_payload: int, encode, *args) -> bytes:
        """Build the frame inline for small payloads; push the b64+JSON
        encode of large bodies onto the default executor so it never
        blocks the event loop."""
        if total_payload <= OFFLOAD_ENCODE_BYTES:
            return encode(*args)
        return await asyncio.get_event_loop().run_in_executor(
            None, encode, *args)

    async def send(self, topic: str, msg) -> None:
        payload = bytes(msg) if isinstance(msg, (bytes, bytearray)) \
            else msg.serialize()
        # one mid per logical send: a connection-retry of the same frame is
        # deduped broker-side, keeping pub effectively-once
        frame = await self._encoded(len(payload), _encode_pub, topic,
                                    self._next_mid(), payload)
        await self._conn.request_frame(frame)
        self._sent += 1
        from .connector import stamp_produce
        stamp_produce(msg)  # waterfall produce edge (broker-acknowledged)

    async def send_many(self, items) -> None:
        """Coalesced produce: one `pubN` frame + one ack for the whole
        micro-batch instead of a lock-serialized round trip per message.
        The broker dedupes per sub-message, so a frame retry after a lost
        ack replays only what never landed. Batches whose raw payloads
        exceed MAX_PUBN_PAYLOAD_BYTES split into several frames (in
        order, same connection) so one oversized mega-frame can never be
        rejected broker-side and take the whole batch down with it; a
        single message bigger than the cap ships alone, exactly like the
        serial path would have sent it."""
        from .connector import stamp_produce
        chunk: List[Tuple[str, str, bytes]] = []
        chunk_src: list = []
        chunk_bytes = 0

        async def _ship() -> None:
            nonlocal chunk, chunk_src, chunk_bytes
            frame = await self._encoded(chunk_bytes, _encode_pubn, chunk)
            await self._conn.request_frame(frame)
            self._sent += len(chunk)
            for m in chunk_src:
                if m is not None:
                    stamp_produce(m)  # produce edge per message, one ack
            chunk, chunk_src, chunk_bytes = [], [], 0

        for topic, payload, m in items:
            payload = bytes(payload)
            if chunk and chunk_bytes + len(payload) > MAX_PUBN_PAYLOAD_BYTES:
                await _ship()
            chunk.append((topic, self._next_mid(), payload))
            chunk_src.append(m)
            chunk_bytes += len(payload)
        if chunk:
            await _ship()

    async def close(self) -> None:
        await self._conn.close()


class TcpConsumer(MessageConsumer):
    def __init__(self, host: str, port: int, topic: str, group: str,
                 max_peek: int = 128, from_latest: bool = False):
        self._conn = _TcpConnection(host, port)
        self.topic = topic
        self.group = group
        self.max_peek = max_peek
        self.from_latest = from_latest
        #: connection-loss retries inside peek() (aggregated process-wide
        #: into the bus_consumer_reconnects gauge)
        self.reconnects = 0

    async def peek(self, max_messages: int, timeout: float = 0.5
                   ) -> List[Tuple[str, int, int, bytes]]:
        # On ConnectionError, do NOT sleep out the whole window: the broker
        # may come back mid-sleep (rolling restart), and a feed that naps
        # the full long-poll timeout adds that much delivery delay per
        # blip. Capped exponential backoff with a short first retry keeps
        # reconnection snappy while not hammering a dead endpoint.
        deadline = time.monotonic() + max(0.0, timeout)
        delay = 0.02
        while True:
            remaining = deadline - time.monotonic()
            try:
                resp = await self._conn.request({
                    "op": "peek", "topic": self.topic, "group": self.group,
                    "latest": self.from_latest,
                    "max": min(max_messages, self.max_peek),
                    "timeout": max(remaining, 0.0)})
            except ConnectionError:
                self.reconnects += 1
                _BUS_STATS["consumer_reconnects"] += 1
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                await asyncio.sleep(min(delay, remaining))
                delay = min(delay * 2, 1.0)
                continue
            return [(self.topic, 0, off, base64.b64decode(p))
                    for off, p in resp.get("msgs", [])]

    def commit(self) -> None:
        pass  # the broker commits at peek (at-most-once), like the reference

    async def close(self) -> None:
        await self._conn.close()


def export_bus_gauges(metrics) -> None:
    """TCP-bus client health (ridden by the balancers' supervision tick,
    like export_tracing_gauges): consumer reconnect attempts — a rising
    count means feeds are riding out broker blips via the peek backoff."""
    metrics.gauge("bus_consumer_reconnects", _BUS_STATS["consumer_reconnects"])


class TcpMessagingProvider(MessagingProvider):
    def __init__(self, host: str = "127.0.0.1", port: int = 4222):
        self.host = host
        self.port = port
        self._admin = _TcpConnection(host, port)

    def get_producer(self) -> TcpProducer:
        return TcpProducer(self.host, self.port)

    def get_consumer(self, topic: str, group_id: str, max_peek: int = 128,
                     from_latest: bool = False) -> TcpConsumer:
        return TcpConsumer(self.host, self.port, topic, group_id, max_peek,
                           from_latest=from_latest)

    def ensure_topic(self, topic: str, partitions: int = 1,
                     retention_bytes: Optional[int] = None) -> None:
        req = {"op": "ensure", "topic": topic,
               "retention_bytes": retention_bytes}
        from ..utils.tasks import spawn
        try:
            loop = asyncio.get_event_loop()
            running = loop.is_running()
        except RuntimeError:
            running = False
        if running:
            spawn(self._admin.request(req), name=f"ensure-{topic}")
            return
        # No running loop (service boot, sync tooling): a silent skip here
        # used to leave topics with custom retention_bytes unconfigured
        # until first use reset nothing — log it and fall back to a
        # blocking one-shot connection so the retention override lands.
        _log.warning("ensure_topic(%r): no running event loop; using a "
                     "blocking one-shot connection", topic)
        self._ensure_blocking(req)

    def _ensure_blocking(self, req: dict, timeout: float = 2.0) -> None:
        """Synchronous one-shot `ensure` (only reachable from sync
        contexts). Best-effort: an unreachable broker logs and returns —
        topics still auto-create on first use, only the retention override
        is lost (and now said so, instead of silently)."""
        frame = _frame(req)
        try:
            with socket.create_connection((self.host, self.port),
                                          timeout=timeout) as s:
                s.settimeout(timeout)
                s.sendall(frame)
                header = self._recv_exact(s, 4)
                (length,) = struct.unpack(">I", header)
                self._recv_exact(s, length)
        except OSError as e:
            _log.warning("ensure_topic(%r): blocking fallback failed: %r",
                         req["topic"], e)

    @staticmethod
    def _recv_exact(s: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("bus closed mid-frame")
            buf += chunk
        return buf
