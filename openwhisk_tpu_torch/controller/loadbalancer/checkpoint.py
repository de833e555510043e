"""Balancer checkpoint/resume (SURVEY §5.4) + the journal's restore seam.
A copy of `openwhisk_tpu/controller/loadbalancer/checkpoint.py`.

The balancer's scheduling state is soft — reconstructible from pings and
acks — so its whole durability story is a periodic host-side snapshot of
the device capacity matrix plus registry/slot bookkeeping
(TpuBalancer.snapshot()/restore()), now optionally tightened by the
write-ahead placement journal (journal.py): restore the snapshot, then
deterministically replay the journal tail so a restart forgets at most
one fsync batch instead of one snapshot interval. Reference posture: no ML
checkpointing exists; controller caches rebuild cold (SURVEY §5.4) — the
snapshot is strictly an optimization, so every failure path here degrades
to a cold start, never an abort.

Snapshot files carry `version` + `crc32` (of the canonical payload JSON)
so a torn or bit-rotted file is rejected CHEAPLY at load, instead of
relying on an arbitrary exception somewhere inside restore().
"""
from __future__ import annotations

import asyncio
import json
import os
import tempfile
import threading
import zlib
from typing import Optional

from ...utils.scheduler import Scheduler

#: current snapshot format: 2 = +version/crc32 envelope (+journal_seq via
#: TpuBalancer.snapshot_parts). Version-1 files (no crc) still restore.
SNAPSHOT_VERSION = 2


def _payload_crc(snap: dict) -> int:
    """CRC of the snapshot payload — every field except the checksum
    itself, over canonical (sorted-key) JSON."""
    payload = {k: v for k, v in snap.items() if k != "crc32"}
    return zlib.crc32(json.dumps(payload, sort_keys=True,
                                 separators=(",", ":")).encode())


def load_snapshot(balancer, path: str, logger=None,
                  cluster_size: Optional[int] = None,
                  journal=None) -> bool:
    """Restore at boot (or standby promotion); returns True on success. A
    missing, corrupt, or incompatible snapshot means a cold start — never
    a boot failure. `cluster_size` is the OPERATOR's current topology: a
    stale snapshot from a different cluster size must not override it
    (re-sharding resets in-flight holds, exactly as a live membership
    change would). With `journal`, the journal tail past the snapshot's
    `journal_seq` is replayed on top of the restored books (and a FULL
    journal — first record seq 1 — can even replay without any snapshot)."""
    if not hasattr(balancer, "restore"):
        # BalancerSnapshotter.start() warns once for this condition
        return False
    try:
        with open(path) as f:
            snap = json.load(f)
    except FileNotFoundError:
        _cold_replay(balancer, journal, logger)
        return False
    except (OSError, json.JSONDecodeError) as e:
        if logger:
            logger.warn(None, f"balancer snapshot {path} unreadable "
                              f"({e}); cold start")
        _cold_replay(balancer, journal, logger)
        return False
    if "crc32" in snap and _payload_crc(snap) != int(snap["crc32"]):
        # torn write the atomic rename should prevent, or bit rot the
        # rename cannot: reject cheaply instead of restoring garbage
        if logger:
            logger.warn(None, f"balancer snapshot {path} fails its crc32; "
                              "cold start")
        _cold_replay(balancer, journal, logger)
        return False
    try:
        balancer.restore(snap)
    except Exception as e:  # noqa: BLE001 — incompatible snapshot: cold start
        if logger:
            logger.warn(None, f"balancer snapshot {path} not restorable "
                              f"({e}); cold start")
        return False
    _replay_tail(balancer, journal, int(snap.get("journal_seq", 0)), logger)
    if cluster_size is not None and \
            getattr(balancer, "cluster_size", cluster_size) != cluster_size:
        if logger:
            logger.warn(None, f"snapshot carries cluster_size="
                              f"{balancer.cluster_size}, topology says "
                              f"{cluster_size}: re-sharding (holds reset)")
        balancer.update_cluster(cluster_size)
    if logger:
        logger.info(None, f"balancer state restored from {path} "
                          f"({len(snap.get('registry', []))} invokers)")
    return True


def _replay_tail(balancer, journal, from_seq: int, logger) -> None:
    """Replay journal records past `from_seq`; replay failure degrades to
    the snapshot-only books (already restored), never an abort."""
    if journal is None or not hasattr(balancer, "replay_journal"):
        return
    try:
        stats = balancer.replay_journal(journal.records(from_seq),
                                        logger=logger, from_seq=from_seq)
        if logger and stats.get("replayed"):
            logger.info(None, f"placement journal replayed "
                              f"{stats['replayed']} records "
                              f"({stats['batches']} batches, "
                              f"{stats['parity_mismatches']} parity "
                              f"mismatches) to seq {stats['last_seq']}")
    except Exception as e:  # noqa: BLE001 — degrade, never abort boot
        if logger:
            logger.warn(None, f"placement journal replay failed ({e!r}); "
                              "continuing with snapshot-only books")


def _cold_replay(balancer, journal, logger) -> None:
    """No usable snapshot: a journal that holds FULL history (first record
    is seq 1) can still rebuild the books from nothing; a pruned tail
    without its base snapshot cannot — cold start, and say so."""
    if journal is None or not hasattr(balancer, "replay_journal"):
        return
    first = next(iter(journal.records(0)), None)
    if first is None:
        return
    if int(first.get("seq", 0)) > 1:
        if logger:
            logger.warn(None, "placement journal tail present but its base "
                              "snapshot is missing; cold start")
        return
    _replay_tail(balancer, journal, 0, logger)


def write_snapshot(balancer, path: str, parts: Optional[dict] = None) -> None:
    """Atomic dump: write-temp + rename, so a crash mid-write can never
    leave a torn snapshot for the next boot; `version` + `crc32` let the
    loader reject anything that slipped through anyway. With `parts`
    (captured on the event loop via snapshot_parts) this is safe to run on
    a worker thread."""
    snap = balancer.snapshot(parts) if parts is not None \
        else balancer.snapshot()
    snap["version"] = SNAPSHOT_VERSION
    snap["crc32"] = _payload_crc(snap)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".balancer-snap-", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(snap, f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class BalancerSnapshotter:
    """Periodic snapshot loop for a service process. With a `journal`,
    each successful dump also prunes journal segments the snapshot now
    fully covers (bounding replay work and disk)."""

    def __init__(self, balancer, path: str, interval: float = 10.0,
                 logger=None, journal=None):
        self.balancer = balancer
        self.path = path
        self.interval = interval
        self.logger = logger
        self.journal = journal
        self._scheduler: Optional[Scheduler] = None
        #: set when the dump thread finishes; survives task cancellation
        #: (the asyncio wrapper future dies on cancel, the thread does not)
        self._inflight_done: Optional[threading.Event] = None

    def start(self) -> "BalancerSnapshotter":
        if hasattr(self.balancer, "snapshot"):
            self._scheduler = Scheduler(
                self.interval, self._dump, logger=self.logger,
                initial_delay=self.interval,
                name="balancer-snapshotter").start()
        elif self.logger:
            self.logger.warn(None, f"balancer snapshotting requested but "
                                   f"{type(self.balancer).__name__} keeps "
                                   "no snapshotable state; ignoring")
        return self

    def _skip_standby(self) -> bool:
        """An HA standby holds cold books and shares the snapshot path
        with the active — dumping would clobber the active's snapshot
        with garbage. Single-writer, like the journal."""
        return bool(getattr(self.balancer, "ha_standby", False))

    async def _dump(self) -> None:
        # capture on the loop (consistent device-state ref + host-book
        # copies), then do the device->host transfer + serialize + write on
        # a worker thread — at the 64k north-star fleet the dump must not
        # stall the 2 ms batch-window data plane. Thread completion is
        # tracked by a threading.Event, NOT the asyncio future: cancelling
        # the awaiting task marks the future done while the thread keeps
        # running, and its late os.replace must never land on top of the
        # final shutdown snapshot.
        if self._skip_standby():
            return
        parts = self.balancer.snapshot_parts()
        done = threading.Event()
        self._inflight_done = done

        def work():
            try:
                write_snapshot(self.balancer, self.path, parts)
                self._prune(parts.get("journal_seq"))
            finally:
                done.set()

        await asyncio.to_thread(work)

    def _prune(self, journal_seq) -> None:
        if self.journal is None or journal_seq is None:
            return
        try:
            self.journal.prune(int(journal_seq))
        except Exception as e:  # noqa: BLE001 — pruning is housekeeping
            if self.logger:
                self.logger.warn(None, f"journal prune failed: {e!r}")

    async def stop(self, final_dump: bool = True) -> None:
        if self._scheduler is not None:
            await self._scheduler.stop()
        if self._inflight_done is not None and \
                not self._inflight_done.is_set():
            # drain the orphaned dump thread before the final dump
            drained = await asyncio.to_thread(self._inflight_done.wait, 30)
            if not drained:
                # the stuck thread could still os.replace AFTER our final
                # dump, silently shipping stale state to the next boot —
                # better to keep the last periodic snapshot and say so
                if self.logger:
                    self.logger.warn(
                        None, "balancer dump thread still running after "
                              "30s; skipping the final shutdown snapshot "
                              "(last periodic dump remains)")
                final_dump = False
        if final_dump and hasattr(self.balancer, "snapshot") \
                and not self._skip_standby():
            try:
                write_snapshot(self.balancer, self.path)
                snap_seq = getattr(self.balancer, "_journal_seq", None)
                self._prune(snap_seq)
            except Exception as e:  # noqa: BLE001 — shutdown must proceed;
                # a broken device during an exceptional teardown must not
                # mask the original error or skip sibling cleanup
                if self.logger:
                    self.logger.warn(None, f"final balancer snapshot "
                                           f"failed: {e}")
