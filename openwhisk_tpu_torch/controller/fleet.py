"""Fleet observatory plumbing: event publishing and peer scraping.

A copy of `openwhisk_tpu/controller/fleet.py`. Its two IO legs (the pure
merge math is in controller/monitoring.py):

  * `FleetEvents` — bridges the process-global `EventLog` onto the
    `ctrlevents` bus topic. Records queue in-process (the EventLog
    publisher hook is synchronous and must never block a recording call
    site) and flush as one JSON frame per `publish_interval_s`; the
    consumer side folds every peer's frames into a per-peer ring, so
    `GET /admin/fleet/timeline` merges from memory without a scrape.

  * `FleetScraper` — concurrent bounded-timeout GETs against the live
    peer directory (membership heartbeats announce admin addresses).
    Per-peer failures are isolated: a dead peer lands in
    `members_missing`, the merged response stays 200 and is labeled
    partial. The caller's Authorization header is forwarded verbatim.
"""
from __future__ import annotations

import asyncio
import json
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..messaging.connector import MessageFeed
from ..utils.eventlog import (GLOBAL_EVENT_LOG, EventLog,
                              FleetObservatoryConfig, fleet_config)
from ..utils.scheduler import Scheduler

#: structural-event frames, one per controller per flush interval.
#: Retention is tight like health: the in-memory peer rings are the
#: durable(ish) view, the topic only carries deltas.
EVENTS_TOPIC = "ctrlevents"
EVENTS_RETENTION_BYTES = 512 * 1024


class FleetEvents:
    """The `ctrlevents` publisher/consumer pair for one controller."""

    def __init__(self, messaging_provider, instance: int,
                 config: Optional[FleetObservatoryConfig] = None,
                 event_log: Optional[EventLog] = None, logger=None):
        self.provider = messaging_provider
        self.instance = int(instance)
        self.config = config or fleet_config()
        self.event_log = event_log if event_log is not None else GLOBAL_EVENT_LOG
        self.logger = logger
        self.producer = messaging_provider.get_producer()
        #: records queued between flushes (appends are GIL-atomic — the
        #: publisher hook runs on whatever thread recorded the event)
        self._pending: List[dict] = []
        #: peer instance -> ring of their most recent records
        self.peer_events: Dict[int, deque] = {}
        self.frames_sent = 0
        self.frames_received = 0
        self._feed: Optional[MessageFeed] = None
        self._flusher: Optional[Scheduler] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self.provider.ensure_topic(EVENTS_TOPIC,
                                   retention_bytes=EVENTS_RETENTION_BYTES)
        consumer = self.provider.get_consumer(
            EVENTS_TOPIC, f"fleetevents{self.instance}", max_peek=64,
            from_latest=True)
        box = {}

        async def handle(payload: bytes):
            try:
                self._fold(json.loads(payload))
            except (ValueError, KeyError, TypeError):
                pass
            box["feed"].processed()

        self._feed = MessageFeed("fleet-events", consumer, 64, handle,
                                 logger=self.logger)
        box["feed"] = self._feed
        self._feed.start()
        self._flusher = Scheduler(self.config.publish_interval_s,
                                  self._flush, name="fleet-events-flush",
                                  logger=self.logger).start()
        self.event_log.attach_publisher(self._on_record)

    async def stop(self) -> None:
        self.event_log.attach_publisher(None)
        if self._flusher:
            await self._flusher.stop()
        await self._flush()  # drain the tail so tests see final events
        if self._feed:
            await self._feed.stop()

    # -- publish side ------------------------------------------------------
    def _on_record(self, rec: dict) -> None:
        # bound the queue: a stalled flusher must not grow memory forever
        if len(self._pending) < 4 * self.config.events_ring:
            self._pending.append(rec)

    async def _flush(self) -> None:
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        frame = json.dumps({"instance": self.instance, "events": batch},
                           separators=(",", ":")).encode()
        try:
            await self.producer.send(EVENTS_TOPIC, frame)
            self.frames_sent += 1
        except Exception:  # noqa: BLE001 — observability never takes
            pass           # the controller down with the bus

    # -- consume side ------------------------------------------------------
    def _fold(self, frame: dict) -> None:
        inst = int(frame["instance"])
        if inst == self.instance:
            return  # own frames echo back through the shared topic
        ring = self.peer_events.get(inst)
        if ring is None:
            ring = self.peer_events[inst] = deque(
                maxlen=max(1, self.config.events_ring))
        for rec in frame.get("events") or []:
            if isinstance(rec, dict):
                ring.append(rec)
        self.frames_received += 1

    def events_by_member(self) -> Dict[int, List[dict]]:
        """Local ring + every peer ring — merged_timeline()'s input."""
        out: Dict[int, List[dict]] = {
            self.instance: self.event_log.recent()}
        for inst, ring in sorted(self.peer_events.items()):
            out[inst] = list(ring)
        return out


class FleetScraper:
    """Bounded concurrent scrape of the live peer directory."""

    def __init__(self, config: Optional[FleetObservatoryConfig] = None):
        self.config = config or fleet_config()

    async def scrape(self, members: Dict[Any, str], path: str,
                     authorization: Optional[str] = None
                     ) -> Tuple[Dict[Any, dict], List[Any]]:
        """GET `path` on every member base URL concurrently. Returns
        (results-by-member, members_missing) — a non-200, timeout, or
        unparsable body makes a member missing, never an exception."""
        if not members:
            return {}, []
        import aiohttp

        results: Dict[Any, dict] = {}
        missing: List[Any] = []
        headers = {"Authorization": authorization} if authorization else {}
        timeout = aiohttp.ClientTimeout(total=self.config.scrape_timeout_s)

        async def one(session, key, base):
            url = base.rstrip("/") + path
            try:
                async with session.get(url, headers=headers) as resp:
                    if resp.status != 200:
                        raise ValueError(f"HTTP {resp.status}")
                    results[key] = await resp.json()
            except Exception:  # noqa: BLE001 — dead peer => labeled
                missing.append(key)  # partial result, never a 500

        async with aiohttp.ClientSession(timeout=timeout) as session:
            await asyncio.gather(*(one(session, k, u)
                                   for k, u in sorted(members.items(),
                                                      key=lambda kv: str(kv[0]))))
        return results, sorted(missing, key=str)
