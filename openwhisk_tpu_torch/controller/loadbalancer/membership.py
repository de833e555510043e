"""Dynamic controller membership: live cluster size over the bus.
A copy of `openwhisk_tpu/controller/loadbalancer/membership.py`.

The reference re-shards every invoker's memory between controllers using
Akka Cluster membership events — MemberUp/MemberRemoved drive
`updateCluster(availableMembers.size)`
(ShardingContainerPoolBalancer.scala:217-250,561-584). This is the
framework-native replacement: each controller heartbeats on a
`controllers` topic; every controller folds the live set from heartbeat
recency and calls `balancer.update_cluster(n_live)` whenever it changes,
so capacity re-shards within a bounded window of a join or a crash. A
graceful shutdown sends a `leave` so planned departures re-shard
immediately instead of waiting out the timeout.

The deploy-time `--cluster-size` remains the initial value (the
reference's seed-node list); membership converges from there.

HA leadership (`ha=True`): the same heartbeat stream carries an
epoch-fenced active/standby claim for the STATEFUL balancer's placement
role. The active's heartbeats assert (epoch, instance); when a standby
sees the active silent for `member_timeout_s` — and it is the
lowest-numbered live controller — it claims epoch+1, restores
snapshot+journal (the `on_leadership` callback) and resumes placement.
Epoch precedence (higher epoch wins; ties break to the LOWER instance)
demotes any stale active the moment it hears a superseding claim, and the
epoch itself is stamped into every dispatched ActivationMessage so
invokers discard a zombie's late batches (invoker/reactive.py) — the
no-double-placement half of the failover contract. Two standbys with
split membership views can claim the same epoch for up to one heartbeat;
the tie-break demotes the higher instance within the next heartbeat, and
fencing makes the overlap harmless for double-execution (equal-epoch
messages both pass, but each activation id is placed by exactly one
controller).

Active/active partitions (`ring=PartitionRing(...)`): the SAME
heartbeat stream generalizes from one global claim to a per-partition
ownership map. Each heartbeat carries `parts` — {partition: epoch} for
every partition the sender actively owns — plus a `load` hint for the
spillover plane. Every tick each controller derives the DESIRED owner of
every partition by rendezvous hashing over its live view (partitions.py)
and, for each partition it should own but doesn't, claims epoch+1 once
(a) the boot grace window has passed (an existing claim must be heard
before it can be superseded) and (b) the current claimant is either dead,
silent past the member timeout, or simply no longer the rendezvous choice
(a PLANNED ring rebalance: the join of a new controller moves partitions
to it by exactly this higher-epoch claim — rebalancing IS the failover
path, chaos-tested as one). Claim precedence per partition is the HA
rule verbatim: higher epoch wins, ties break to the LOWER instance, and
a superseded owner demotes that partition the moment it hears the better
claim. `on_partitions(gained, lost)` fires with the delta — gained
entries carry the previous owner so the assembler can absorb its journal
tail for exactly those partitions before placing into them.
"""
from __future__ import annotations

import asyncio
import json
import time
from typing import Dict, List, Optional, Set, Tuple

from ...messaging.connector import MessageFeed
from ...utils.eventlog import GLOBAL_EVENT_LOG
from ...utils.scheduler import Scheduler
from ...utils.tasks import spawn
from ...utils.transaction import TransactionId

CONTROLLERS_TOPIC = "controllers"
#: heartbeats are ephemeral like health pings — keep only a small tail
CONTROLLERS_RETENTION_BYTES = 256 * 1024
HEARTBEAT_S = 1.0
#: a controller is gone after this much heartbeat silence (the reference's
#: Akka failure detector defaults are in the same few-second range)
MEMBER_TIMEOUT_S = 5.0


class ControllerMembership:
    def __init__(self, messaging_provider, instance, balancer, logger=None,
                 heartbeat_s: float = HEARTBEAT_S,
                 member_timeout_s: float = MEMBER_TIMEOUT_S,
                 ha: bool = False, on_leadership=None,
                 ring=None, on_partitions=None, load_hint=None,
                 admin_url: Optional[str] = None):
        self.provider = messaging_provider
        self.instance = instance
        self.balancer = balancer
        self.logger = logger
        self.heartbeat_s = heartbeat_s
        self.member_timeout_s = member_timeout_s
        #: instance -> local receive time of the last heartbeat
        self._last_seen: Dict[int, float] = {}
        self._producer = None
        self._feed: Optional[MessageFeed] = None
        self._ticker: Optional[Scheduler] = None
        self._current_size = 0
        self._seed_size = 1
        self._started = 0.0
        self._last_tick = 0.0
        #: HA leadership: epoch-fenced active/standby claim (module doc)
        self.ha = ha
        self.on_leadership = on_leadership
        self._lead_epoch = 0
        self._lead_instance: Optional[int] = None
        self._lead_seen = 0.0
        self._is_active = False
        #: active/active partition ownership (module doc). ring=None is
        #: the off-switch: no partition state, no heartbeat growth.
        self.ring = ring
        self.on_partitions = on_partitions
        self.load_hint = load_hint
        self._pepoch: Dict[int, int] = {}     # highest epoch seen, per pid
        self._powner: Dict[int, Optional[int]] = {}  # claimed owner per pid
        self._owned: Set[int] = set()
        self.peer_loads: Dict[int, float] = {}
        #: fleet observatory peer directory: admin_url=None is
        #: the off-switch — heartbeats stay byte-exact with pre-16 builds.
        #: When set, every heartbeat announces it and peers fold theirs
        #: into `peer_admin`, the live map /admin/fleet/* scrapes from.
        self.admin_url = admin_url
        self.peer_admin: Dict[int, str] = {}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        # the deploy-time size seeds a grace window: until peers have had a
        # full timeout to heartbeat, never fold BELOW the seed — otherwise a
        # fresh controller booted as 1-of-2 would briefly claim the whole
        # fleet's capacity and overcommit
        self._seed_size = max(self.balancer.cluster_size, 1)
        self._current_size = self._seed_size  # update only on real change
        self._started = time.monotonic()
        self.provider.ensure_topic(CONTROLLERS_TOPIC,
                                   retention_bytes=CONTROLLERS_RETENTION_BYTES)
        self._producer = self.provider.get_producer()
        consumer = self.provider.get_consumer(
            CONTROLLERS_TOPIC, f"membership{self.instance.instance}",
            max_peek=128, from_latest=True)
        box = {}

        async def handle(payload: bytes):
            self._on_message(payload)
            box["feed"].processed()

        self._feed = MessageFeed("controllers", consumer, 128, handle,
                                 logger=self.logger)
        box["feed"] = self._feed
        self._feed.start()
        self._ticker = Scheduler(self.heartbeat_s, self._tick,
                                 name="membership-heartbeat",
                                 logger=self.logger).start()

    async def stop(self) -> None:
        if self._ticker:
            await self._ticker.stop()
        if self._producer is not None:
            try:  # planned departure: peers re-shard without the timeout
                await self._producer.send(CONTROLLERS_TOPIC, json.dumps(
                    {"kind": "leave",
                     "instance": self.instance.instance}).encode())
            except Exception:  # noqa: BLE001 — bus may already be gone
                pass
        if self._feed:
            await self._feed.stop()

    # -- protocol ----------------------------------------------------------
    def _on_message(self, payload: bytes) -> None:
        try:
            msg = json.loads(payload)
            inst = int(msg["instance"])
            kind = msg.get("kind", "heartbeat")
        except (ValueError, KeyError, TypeError):
            return
        if inst == self.instance.instance:
            return
        if kind == "leave":
            self._last_seen.pop(inst, None)
            self.peer_loads.pop(inst, None)
            self.peer_admin.pop(inst, None)
            GLOBAL_EVENT_LOG.record("member_leave",
                                    instance=self.instance.instance,
                                    peer=inst)
            if self.ha and inst == self._lead_instance:
                # a graceful active departure frees the claim immediately:
                # age its lease out so the next tick elects without the
                # full silence timeout
                self._lead_seen = 0.0
            # (ring mode needs no extra lease aging here: dropping the
            # leaver from _last_seen already removes it from the live set
            # the next _partition_tick derives ownership from)
            self._refold()
        else:
            joined = inst not in self._last_seen
            self._last_seen[inst] = time.monotonic()
            admin = msg.get("admin")
            if isinstance(admin, str) and admin:
                self.peer_admin[inst] = admin
            if joined:
                GLOBAL_EVENT_LOG.record("member_join",
                                        instance=self.instance.instance,
                                        peer=inst)
            if self.ha and msg.get("active"):
                self._observe_claim(int(msg.get("epoch", 0)), inst)
            if self.ring is not None:
                if "load" in msg:
                    try:
                        self.peer_loads[inst] = float(msg["load"])
                    except (TypeError, ValueError):
                        pass
                parts = msg.get("parts")
                if isinstance(parts, dict):
                    for pid_s, epoch in parts.items():
                        try:
                            self._observe_part_claim(int(pid_s), int(epoch),
                                                     inst)
                        except (TypeError, ValueError):
                            continue
            if joined:
                self._refold()

    def _heartbeat_msg(self) -> bytes:
        hb = {"kind": "heartbeat", "instance": self.instance.instance}
        if self.ha:
            hb["epoch"] = self._lead_epoch
            hb["active"] = self._is_active
        if self.ring is not None:
            hb["parts"] = {str(pid): self._pepoch.get(pid, 0)
                           for pid in sorted(self._owned)}
            if self.load_hint is not None:
                try:
                    hb["load"] = float(self.load_hint())
                except Exception:  # noqa: BLE001 — a hint, never a blocker
                    pass
        if self.admin_url:
            hb["admin"] = self.admin_url
        return json.dumps(hb).encode()

    async def _tick(self) -> None:
        await self._producer.send(CONTROLLERS_TOPIC, self._heartbeat_msg())
        now = time.monotonic()
        # Stall guard: if OUR OWN ticks gapped (event loop blocked — e.g. a
        # long jit compile — or host pause), peer silence is our fault, not
        # theirs. Give every peer (and the boot grace window) a fresh
        # heartbeat interval before judging, the same reason Akka's failure
        # detector forgives process pauses.
        if self._last_tick and now - self._last_tick > self.member_timeout_s:
            stall = now - self._last_tick
            self._started += stall
            floor = now - self.heartbeat_s
            self._last_seen = {i: max(ts, floor)
                               for i, ts in self._last_seen.items()}
        self._last_tick = now
        dead = [i for i, ts in self._last_seen.items()
                if now - ts > self.member_timeout_s]
        for i in dead:
            silence_s = now - self._last_seen.pop(i)
            self.peer_admin.pop(i, None)
            # silence-detect: the first named phase of the failover
            # timeline (kill -> detect -> claim -> absorb -> placement)
            GLOBAL_EVENT_LOG.record("member_silent",
                                    instance=self.instance.instance,
                                    peer=i, silence_s=round(silence_s, 4))
        # refold every tick: it no-ops when the size is unchanged, and also
        # converges the case where a seeded peer never appeared at all once
        # the boot grace window lapses
        self._refold()
        if self.ha:
            await self._leadership_tick(now)
        if self.ring is not None:
            await self._partition_tick(now)

    # -- HA leadership (module doc) ----------------------------------------
    async def _leadership_tick(self, now: float) -> None:
        if self._is_active:
            self._lead_seen = now  # our own heartbeat is the lease
            return
        leader_alive = (self._lead_instance is not None
                        and now - self._lead_seen <= self.member_timeout_s)
        if leader_alive:
            return
        # boot grace: give an already-running active one full timeout to be
        # heard before a fresh standby steals the epoch from it
        if now - self._started < self.member_timeout_s:
            return
        if self._last_seen and self.instance.instance > min(self._last_seen):
            return  # a lower-numbered live controller claims first
        await self._claim(now)

    async def _claim(self, now: float) -> None:
        self._lead_epoch += 1
        self._lead_instance = self.instance.instance
        self._lead_seen = now
        self._is_active = True
        if self.logger:
            self.logger.info(
                TransactionId.LOADBALANCER,
                f"claiming placement leadership: epoch {self._lead_epoch} "
                f"(instance {self.instance.instance})", "Membership")
        GLOBAL_EVENT_LOG.record("lead_claim",
                                instance=self.instance.instance,
                                epoch=self._lead_epoch)
        self._export_epoch()
        # announce immediately — peers demote/stand down without waiting
        # out a heartbeat interval
        try:
            await self._producer.send(CONTROLLERS_TOPIC,
                                      self._heartbeat_msg())
        except Exception:  # noqa: BLE001 — next tick re-announces
            pass
        self._fire_leadership(True)

    def _observe_claim(self, epoch: int, inst: int) -> None:
        """Fold a peer's active assertion. Precedence: higher epoch wins;
        equal epochs break to the lower instance (split-claim tie)."""
        better = (epoch > self._lead_epoch
                  or (epoch == self._lead_epoch
                      and (self._lead_instance is None
                           or inst <= self._lead_instance)))
        if not better:
            return
        now = time.monotonic()
        if inst == self._lead_instance and epoch == self._lead_epoch:
            self._lead_seen = now  # lease renewal
            return
        was_active = self._is_active
        self._lead_epoch = epoch
        self._lead_instance = inst
        self._lead_seen = now
        if was_active:
            # superseded: a peer holds a higher (or tie-winning) claim —
            # stop placing NOW; our fencing epoch is already dead at the
            # invokers for epoch > ours
            self._is_active = False
            if self.logger:
                self.logger.warn(
                    TransactionId.LOADBALANCER,
                    f"leadership superseded by instance {inst} epoch "
                    f"{epoch}; demoting to standby", "Membership")
            GLOBAL_EVENT_LOG.record("lead_superseded",
                                    instance=self.instance.instance,
                                    by=inst, epoch=epoch)
            self._fire_leadership(False)
        self._export_epoch()

    # -- active/active partition ownership (module doc) --------------------
    def _observe_part_claim(self, pid: int, epoch: int, inst: int) -> None:
        """Fold a peer's per-partition ownership assertion. Precedence is
        the global rule scoped to the partition: higher epoch wins, equal
        epochs break to the lower instance."""
        if not (0 <= pid < self.ring.n_partitions):
            return
        cur_e = self._pepoch.get(pid, 0)
        cur_o = self._powner.get(pid)
        better = (epoch > cur_e
                  or (epoch == cur_e and (cur_o is None or inst <= cur_o)))
        if not better:
            return
        if inst == cur_o and epoch == cur_e:
            return  # re-assertion of the claim we already hold folded
        self._pepoch[pid] = epoch
        self._powner[pid] = inst
        if pid in self._owned:
            # superseded for THIS partition only: stop placing into it
            # NOW; the epoch bump is already fencing our late batches at
            # the invokers — the remaining partitions we own are untouched
            self._owned.discard(pid)
            if self.logger:
                self.logger.warn(
                    TransactionId.LOADBALANCER,
                    f"partition {pid} ownership superseded by instance "
                    f"{inst} epoch {epoch}; demoting that partition",
                    "Membership")
            GLOBAL_EVENT_LOG.record("part_superseded",
                                    instance=self.instance.instance,
                                    part=pid, by=inst, epoch=epoch)
            self._fire_partitions(gained=[], lost=[(pid, epoch)])

    async def _partition_tick(self, now: float) -> None:
        """Derive desired ownership from the live view and claim every
        partition the ring says is ours whose current claim is dead,
        silent (the _tick prune drops silent members from _last_seen, so
        the ring stops assigning to them), or held by a live but
        out-ranked owner (a planned rebalance)."""
        if now - self._started < self.member_timeout_s:
            return  # boot grace: hear existing claims before superseding
        live = {self.instance.instance} | set(self._last_seen)
        desired = self.ring.ownership(live)
        me = self.instance.instance
        gained: List[Tuple[int, int, Optional[int]]] = []
        for pid, want in desired.items():
            if want != me or pid in self._owned:
                continue
            owner = self._powner.get(pid)
            # dead/silent owner: a failover. Live but out-ranked owner: a
            # planned rebalance — the same higher-epoch claim either way.
            epoch = self._pepoch.get(pid, 0) + 1
            prev = owner if (owner is not None and owner != me) else None
            self._pepoch[pid] = epoch
            self._powner[pid] = me
            self._owned.add(pid)
            gained.append((pid, epoch, prev))
        if gained:
            if self.logger:
                self.logger.info(
                    TransactionId.LOADBALANCER,
                    f"claiming partitions {[p for p, _, _ in gained]} "
                    f"(instance {me})", "Membership")
            GLOBAL_EVENT_LOG.record(
                "part_claim", instance=me,
                parts={str(p): e for p, e, _ in gained},
                prev={str(p): prev for p, _, prev in gained
                      if prev is not None})
            # announce immediately — peers demote / stop claiming without
            # waiting out a heartbeat interval
            try:
                await self._producer.send(CONTROLLERS_TOPIC,
                                          self._heartbeat_msg())
            except Exception:  # noqa: BLE001 — next tick re-announces
                pass
            self._fire_partitions(gained=gained, lost=[])

    def _fire_partitions(self, gained, lost) -> None:
        metrics = getattr(self.balancer, "metrics", None)
        if metrics is not None:
            metrics.gauge("controller_owned_partitions", len(self._owned))
        cb = self.on_partitions
        if cb is None:
            return
        res = cb(gained, lost)
        if asyncio.iscoroutine(res):
            spawn(res, logger=self.logger, name="partition-transition")

    def least_loaded_peer(self) -> Optional[int]:
        """The spillover target: the live peer with the smallest load
        hint (None without live peers)."""
        now = time.monotonic()
        live = [i for i, ts in self._last_seen.items()
                if now - ts <= self.member_timeout_s]
        if not live:
            return None
        return min(live, key=lambda i: (self.peer_loads.get(i, 0.0), i))

    def peer_directory(self) -> Dict[int, str]:
        """Live peers with a known admin address: {instance: admin_url}.
        This is the scrape map behind /admin/fleet/* — peers
        that never announced an address (observatory off on their side,
        or a pre-16 build) simply aren't scrapeable and show up in the
        federation's `members_missing` instead."""
        now = time.monotonic()
        return {i: url for i, url in sorted(self.peer_admin.items())
                if i in self._last_seen
                and now - self._last_seen[i] <= self.member_timeout_s}

    @property
    def owned_partitions(self) -> Set[int]:
        return set(self._owned)

    def _fire_leadership(self, active: bool) -> None:
        cb = self.on_leadership
        if cb is None:
            return
        res = cb(self._lead_epoch, active)
        if asyncio.iscoroutine(res):
            spawn(res, logger=self.logger, name="leadership-transition")

    def _export_epoch(self) -> None:
        metrics = getattr(self.balancer, "metrics", None)
        if metrics is not None:
            metrics.gauge("controller_leadership_epoch", self._lead_epoch)

    def _refold(self) -> None:
        n = 1 + len(self._last_seen)  # self + live peers
        if time.monotonic() - self._started < self.member_timeout_s:
            n = max(n, self._seed_size)
        if n != self._current_size:
            old = self._current_size
            self._current_size = n
            if self.logger:
                self.logger.info(
                    TransactionId.LOADBALANCER,
                    f"cluster membership {old or '?'} -> {n} "
                    f"(peers: {sorted(self._last_seen)})", "Membership")
            self.balancer.update_cluster(n)
            metrics = getattr(self.balancer, "metrics", None)
            if metrics is not None:
                metrics.gauge("loadbalancer_cluster_size", n)

    # -- views -------------------------------------------------------------
    @property
    def cluster_size(self) -> int:
        return self._current_size or 1

    @property
    def is_active(self) -> bool:
        """HA mode: does this controller currently hold the placement
        leadership? (Always False when ha is off — callers should then
        treat every controller as active.)"""
        return self._is_active

    @property
    def leadership_epoch(self) -> int:
        return self._lead_epoch
