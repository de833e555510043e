"""Store change feed → cacheInvalidation bridge.

Rebuild of core/cosmosdb/cache-invalidator (CacheInvalidator.scala,
ChangeFeedConsumer.scala, KafkaEventProducer.scala): a standalone service
that watches the entity store for documents changed by *other* writers —
another deployment sharing the store, an admin tool writing directly — and
publishes invalidation events on the ``cacheInvalidation`` topic so every
controller drops its stale cache entry. The reference consumes CosmosDB's
change feed; generic document stores have no push feed, so this bridge polls
the `updated` timestamp index (collections whisks-equivalent: actions,
triggers, rules, packages) with a persistent high-water mark — the same
continuation-token pattern the change-feed processor uses.
"""
from __future__ import annotations

import asyncio
import json
import time
from typing import Dict, Iterable, Optional

from .cache import CACHE_INVALIDATION_TOPIC
from .store import ArtifactStore

ENTITY_COLLECTIONS = ("actions", "triggers", "rules", "packages")


class CacheInvalidatorService:
    """Polls the store's changed-docs view and emits invalidation events.

    instance_id deliberately does NOT match any controller's id: every
    controller must apply these evictions (the reference's invalidator
    publishes under its own `cache-invalidator` identity for the same
    reason).
    """

    def __init__(self, store: ArtifactStore, messaging_provider,
                 poll_interval: float = 1.0,
                 collections: Iterable[str] = ENTITY_COLLECTIONS,
                 instance_id: str = "cache-invalidator", logger=None):
        self.store = store
        self.producer = messaging_provider.get_producer()
        self.poll_interval = poll_interval
        self.collections = tuple(collections)
        self.instance_id = instance_id
        self.logger = logger
        # high-water mark = the change feed's continuation token
        self._since = time.time()
        self._seen: Dict[str, float] = {}
        self._task: Optional[asyncio.Task] = None
        self.events_published = 0

    def start(self) -> None:
        self._task = asyncio.get_event_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        while True:
            try:
                await self.poll_once()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — keep the bridge alive
                if self.logger:
                    self.logger.warn("cache-invalidator", f"poll failed: {e}")
            await asyncio.sleep(self.poll_interval)

    async def poll_once(self) -> int:
        """One change-feed turn: emit one event per doc updated since the
        high-water mark. Returns the number of events published."""
        # overlap the window by one interval so a write racing the previous
        # poll is never missed; _seen dedupes the overlap
        since = self._since - self.poll_interval
        now = time.time()
        published = 0
        for collection in self.collections:
            docs = await self.store.query(collection, None, since=since,
                                          limit=10_000)
            for doc in docs:
                doc_id = doc.get("_id") or \
                    f"{doc.get('namespace')}/{doc.get('name')}"
                updated = float(doc.get("updated", 0))
                if self._seen.get(doc_id) == updated:
                    continue
                self._seen[doc_id] = updated
                await self.producer.send(
                    CACHE_INVALIDATION_TOPIC,
                    json.dumps({"instanceId": self.instance_id,
                                "cache": "whisks",
                                "key": doc_id}).encode())
                published += 1
        # trim the dedupe map to the overlap window
        cutoff = since
        self._seen = {k: v for k, v in self._seen.items() if v >= cutoff}
        self._since = now
        self.events_published += published
        return published


async def run_forever(store, messaging_provider, poll_interval: float = 1.0,
                      logger=None) -> None:
    """Entry point for running the bridge as its own process (the reference
    ships the invalidator as a standalone service)."""
    svc = CacheInvalidatorService(store, messaging_provider,
                                  poll_interval=poll_interval, logger=logger)
    svc.start()
    try:
        while True:
            await asyncio.sleep(3600)
    finally:
        await svc.stop()
