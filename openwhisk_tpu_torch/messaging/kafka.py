"""Kafka backend (gated).
A copy of `openwhisk_tpu/messaging/kafka.py`.

Rebuild of the reference's connector/kafka (KafkaMessagingProvider /
KafkaConsumerConnector / KafkaProducerConnector): topics with per-topic
retention, long-poll peek, commit-after-peek. Requires `aiokafka` (or
`kafka-python`), which is not part of this image — the provider raises a
clear error when the client library is absent; deployments with Kafka
install the client and select this provider via the MessagingProvider SPI
(CONFIG_whisk_spi_MessagingProvider=openwhisk_tpu_torch.messaging.kafka:KafkaMessagingProvider).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from .connector import MessageConsumer, MessageProducer, MessagingProvider

try:
    import aiokafka  # type: ignore[import-not-found]
    HAVE_KAFKA = True
except ImportError:
    aiokafka = None
    HAVE_KAFKA = False

# payload cap mirrors the reference: 1 MB + serdes overhead
# (application.conf:337-366)
MAX_REQUEST_SIZE = 1024 * 1024 + 6144


def _require_kafka() -> None:
    if not HAVE_KAFKA:
        raise RuntimeError(
            "Kafka backend selected but no kafka client library is installed "
            "(need aiokafka). Use the TCP bus (openwhisk_tpu_torch.messaging.tcp) "
            "or the in-memory bus instead.")


class KafkaProducer(MessageProducer):
    def __init__(self, bootstrap: str):
        _require_kafka()
        self._producer = aiokafka.AIOKafkaProducer(
            bootstrap_servers=bootstrap, max_request_size=MAX_REQUEST_SIZE,
            acks="all")
        self._started = False
        self._sent = 0

    @property
    def sent_count(self) -> int:
        return self._sent

    async def send(self, topic: str, msg) -> None:
        if not self._started:
            await self._producer.start()
            self._started = True
        payload = msg if isinstance(msg, (bytes, bytearray)) else msg.serialize()
        await self._producer.send_and_wait(topic, bytes(payload))
        self._sent += 1
        from .connector import stamp_produce
        stamp_produce(msg)  # waterfall produce edge (broker-acknowledged)

    async def send_many(self, items) -> None:
        """Coalesced produce: enqueue the whole micro-batch into the
        client's accumulator first, then await the acks together — the
        client packs them into shared produce requests (its batching is
        record-level), so N messages cost one round of broker round trips
        instead of N sequential send_and_wait barriers."""
        if not self._started:
            await self._producer.start()
            self._started = True
        futs = [await self._producer.send(topic, bytes(payload))
                for (topic, payload, _m) in items]
        import asyncio
        await asyncio.gather(*futs)
        self._sent += len(items)
        from .connector import stamp_produce
        for _topic, _payload, m in items:
            if m is not None:
                stamp_produce(m)  # produce edge per message, acks gathered

    async def close(self) -> None:
        if self._started:
            await self._producer.stop()


class KafkaConsumer(MessageConsumer):
    def __init__(self, bootstrap: str, topic: str, group: str, max_peek: int = 128,
                 from_latest: bool = False):
        _require_kafka()
        self.topic = topic
        self.max_peek = max_peek
        # from_latest: ephemeral streams (health pings) must not replay the
        # retained backlog when a new per-controller group first appears
        self._consumer = aiokafka.AIOKafkaConsumer(
            topic, bootstrap_servers=bootstrap, group_id=group,
            enable_auto_commit=False,
            auto_offset_reset="latest" if from_latest else "earliest")
        self._started = False

    async def peek(self, max_messages: int, timeout: float = 0.5
                   ) -> List[Tuple[str, int, int, bytes]]:
        if not self._started:
            await self._consumer.start()
            self._started = True
        batches = await self._consumer.getmany(
            timeout_ms=int(timeout * 1000),
            max_records=min(max_messages, self.max_peek))
        out = []
        for tp, records in batches.items():
            for r in records:
                out.append((r.topic, r.partition, r.offset, r.value))
        return out

    def commit(self):
        """Fire-and-forget offset commit (the base contract); returns the
        spawned task so callers needing commit-before-handoff ordering
        (e.g. the integration suite) can await it."""
        if self._started:
            from ..utils.tasks import spawn
            return spawn(self._consumer.commit(), name="kafka-commit")
        return None

    async def close(self) -> None:
        if self._started:
            await self._consumer.stop()


class KafkaMessagingProvider(MessagingProvider):
    def __init__(self, bootstrap: str = "localhost:9092"):
        _require_kafka()
        self.bootstrap = bootstrap

    def get_producer(self) -> KafkaProducer:
        return KafkaProducer(self.bootstrap)

    def get_consumer(self, topic: str, group_id: str, max_peek: int = 128,
                     from_latest: bool = False) -> KafkaConsumer:
        return KafkaConsumer(self.bootstrap, topic, group_id, max_peek,
                             from_latest=from_latest)

    def ensure_topic(self, topic: str, partitions: int = 1,
                     retention_bytes: Optional[int] = None):
        """Best-effort topic creation with retention.bytes (the reference
        creates topics with per-topic retention configs,
        KafkaMessagingProvider.ensureTopic). Falls back to broker
        auto-create when no admin client is importable or the broker
        rejects the call — retention is then operator-managed. Returns the
        spawned admin task (or None) so callers that need create-before-
        produce ordering can await it; the base contract ignores it."""
        from ..utils.tasks import spawn
        try:
            from aiokafka.admin import (  # type: ignore[import-not-found]
                AIOKafkaAdminClient, NewTopic)
        except ImportError:
            return

        async def create():
            admin = AIOKafkaAdminClient(bootstrap_servers=self.bootstrap)
            await admin.start()
            try:
                configs = {}
                if retention_bytes is not None:
                    configs["retention.bytes"] = str(retention_bytes)
                await admin.create_topics([NewTopic(
                    name=topic, num_partitions=partitions,
                    replication_factor=1, topic_configs=configs)])
            except Exception:  # noqa: BLE001 — exists/unsupported: broker wins
                pass
            finally:
                await admin.close()

        try:
            import asyncio
            if asyncio.get_event_loop().is_running():
                return spawn(create(), name=f"kafka-ensure-{topic}")
        except RuntimeError:
            pass
        return None
