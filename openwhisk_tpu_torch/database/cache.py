"""Entity caching + cross-controller invalidation.

Rebuild of the reference's MultipleReadersSingleWriterCache
(common/scala/.../core/database/MultipleReadersSingleWriterCache.scala:30-80 —
a protocol-checked read-through cache) and RemoteCacheInvalidation
(RemoteCacheInvalidation.scala:45-101 — controllers broadcast entity updates
on the `cacheInvalidation` topic so peers evict stale entries).

The asyncio event loop single-threads cache transitions here, so the state
machine collapses to: an entry is either a settled value or an in-flight
Future readers await (read coalescing); any write/delete invalidates.
"""
from __future__ import annotations

import asyncio
import json
import time
from typing import Any, Callable, Dict, Optional

CACHE_INVALIDATION_TOPIC = "cacheInvalidation"


class EntityCache:
    def __init__(self, max_entries: int = 10_000, ttl_seconds: Optional[float] = None):
        self.max_entries = max_entries
        self.ttl = ttl_seconds
        self._entries: Dict[str, tuple] = {}  # key -> (expires_at|None, future)
        self.hits = 0
        self.misses = 0

    async def get_or_load(self, key: str, loader: Callable[[], Any]):
        ent = self._entries.get(key)
        now = time.monotonic()
        if ent is not None and (ent[0] is None or ent[0] > now):
            self.hits += 1
            return await asyncio.shield(ent[1])
        self.misses += 1
        fut = asyncio.ensure_future(_call(loader))
        expires = now + self.ttl if self.ttl else None
        self._entries[key] = (expires, fut)
        if len(self._entries) > self.max_entries:
            # drop oldest-inserted entry (python dicts preserve order)
            self._entries.pop(next(iter(self._entries)))
        try:
            return await asyncio.shield(fut)
        except BaseException:
            self._entries.pop(key, None)
            raise

    def update(self, key: str, value: Any) -> None:
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        fut.set_result(value)
        expires = time.monotonic() + self.ttl if self.ttl else None
        self._entries[key] = (expires, fut)

    def invalidate(self, key: str) -> None:
        self._entries.pop(key, None)

    def clear(self) -> None:
        self._entries.clear()

    def __contains__(self, key: str) -> bool:
        return key in self._entries


async def _call(loader):
    r = loader()
    if asyncio.iscoroutine(r):
        return await r
    return r


class RemoteCacheInvalidation:
    """Bus-based cross-instance cache invalidation.

    Each controller publishes {key, instanceId} when it writes an entity;
    peers evict that key (messages from self are ignored by instance id).
    """

    def __init__(self, messaging_provider, instance_id: str,
                 caches: Optional[Dict[str, EntityCache]] = None, logger=None):
        self.provider = messaging_provider
        self.instance_id = instance_id
        self.caches = caches or {}
        self.logger = logger
        self._producer = messaging_provider.get_producer()
        self._feed = None

    def register(self, cache_name: str, cache: EntityCache) -> None:
        self.caches[cache_name] = cache

    async def notify_other_instances(self, cache_name: str, key: str) -> None:
        payload = json.dumps({"instanceId": self.instance_id,
                              "cache": cache_name, "key": key}).encode()
        await self._producer.send(CACHE_INVALIDATION_TOPIC, payload)

    def start(self) -> None:
        from ..messaging.connector import MessageFeed
        consumer = self.provider.get_consumer(
            CACHE_INVALIDATION_TOPIC, f"cacheInvalidation-{self.instance_id}")
        feed_ref = {}

        async def handle(payload: bytes):
            # swallow malformed payloads: signalling processed() AND raising
            # would double-credit the feed's capacity
            try:
                j = json.loads(payload)
                if j.get("instanceId") != self.instance_id:
                    cache = self.caches.get(j.get("cache", ""))
                    if cache is not None:
                        cache.invalidate(j.get("key", ""))
            except Exception:  # noqa: BLE001
                pass
            feed_ref["feed"].processed()

        self._feed = MessageFeed("cacheInvalidation", consumer, 128, handle,
                                 logger=self.logger)
        feed_ref["feed"] = self._feed
        self._feed.start()

    async def stop(self) -> None:
        if self._feed:
            await self._feed.stop()
