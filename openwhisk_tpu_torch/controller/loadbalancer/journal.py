"""Placement journal: a write-ahead log for the device balancer's books.
A copy of `openwhisk_tpu/controller/loadbalancer/journal.py`.

The periodic snapshot (checkpoint.py) bounds cold-start amnesia to one
snapshot interval — at ~1000 activations/s that is still thousands of
forgotten in-flight holds. This module closes the gap: every committed
device-state mutation (micro-batch step, idle release/health fold,
registration, growth, cluster resize) appends ONE record here, so a
restarted — or promoted-standby — controller can restore the last snapshot
and deterministically REPLAY the journal tail back to the exact books the
dead active held (TpuBalancer.replay_journal re-executes the recorded
packed step inputs through the same kernels; ops/placement's repair kernel
is bit-deterministic, so re-derived decisions equal the journaled ones).

Durability posture inherits checkpoint.py's: the journal is an
OPTIMIZATION over forced-timeout self-healing, so every failure path
degrades — a torn or CRC-failing tail record truncates the log at the last
good frame and logs, an unwritable directory disables journaling with a
warning, and a missing journal is simply an empty replay. Never a boot
abort.

On-disk format — append-only segments `wal-<first_seq>.seg` of frames:

    b"WJ" | u32 payload_len | u32 crc32(payload) | payload (compact JSON)

Appends are buffered in memory and flushed by ONE background writer
thread that batches `fsync_batch` frames (or a short linger) per
write+fsync, so the event loop never waits on the disk; the appended-vs-
durable gap is the `loadbalancer_journal_lag_batches` gauge (what a crash
right now would forget). Segments rotate at `segment_bytes`; after each
successful snapshot the snapshotter prunes segments whose every record the
snapshot already covers.

Off-switch: `CONFIG_whisk_ha_journal_enabled=false` (journal_from_config
returns None; a balancer without an attached journal is bit-exact to
today's behavior).
"""
from __future__ import annotations

import base64
import json
import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from ...utils.config import load_config
from ...utils.eventlog import GLOBAL_EVENT_LOG

_MAGIC = b"WJ"
_HEADER = struct.Struct("<2sII")


@dataclass(frozen=True)
class JournalConfig:
    """`CONFIG_whisk_ha_journal_*` env overrides."""
    enabled: bool = True
    segment_bytes: int = 8 * 1024 * 1024
    #: frames per write+fsync batch (the amortization knob)
    fsync_batch: int = 8
    #: max seconds a buffered frame waits for batch-mates before the
    #: writer flushes anyway (bounds the durability lag under a trickle)
    linger_s: float = 0.02


@dataclass(frozen=True)
class HAFailoverConfig:
    """`CONFIG_whisk_ha_failover_*` env overrides — the off-switch for the
    epoch-fenced active/standby protocol (membership.py): false makes
    `--ha` a no-op, bit-exact to a non-HA deployment."""
    enabled: bool = True


def ha_failover_enabled() -> bool:
    return load_config(HAFailoverConfig, env_path="ha.failover").enabled


def journal_from_config(directory: str, logger=None
                        ) -> Optional["PlacementJournal"]:
    """Build a journal for `directory`, honoring the enabled off-switch."""
    cfg = load_config(JournalConfig, env_path="ha.journal")
    if not cfg.enabled or not directory:
        return None
    return PlacementJournal(directory, segment_bytes=cfg.segment_bytes,
                            fsync_batch=cfg.fsync_batch,
                            linger_s=cfg.linger_s, logger=logger)


def encode_array(arr) -> str:
    """Pack an int32 ndarray into a base64 payload field."""
    import numpy as np
    return base64.b64encode(np.ascontiguousarray(arr, np.int32).tobytes()
                            ).decode("ascii")


def decode_array(s: str):
    """Inverse of encode_array (flat int32 vector; caller reshapes)."""
    import numpy as np
    return np.frombuffer(base64.b64decode(s), np.int32)


def _frame(payload: bytes) -> bytes:
    return _HEADER.pack(_MAGIC, len(payload), zlib.crc32(payload)) + payload


def _scan_frames(data: bytes) -> Tuple[List[bytes], int, bool]:
    """Parse frames from one segment's bytes. Returns (payloads,
    good_offset, clean): `good_offset` is the byte position after the last
    intact frame — everything past it is a torn/corrupt tail (`clean` is
    False) that callers truncate rather than trust."""
    payloads: List[bytes] = []
    off = 0
    n = len(data)
    while off + _HEADER.size <= n:
        magic, length, crc = _HEADER.unpack_from(data, off)
        if magic != _MAGIC:
            return payloads, off, False
        end = off + _HEADER.size + length
        if end > n:
            return payloads, off, False  # torn mid-payload
        payload = data[off + _HEADER.size:end]
        if zlib.crc32(payload) != crc:
            return payloads, off, False  # bit rot / interrupted overwrite
        payloads.append(payload)
        off = end
    return payloads, off, off == n


class PlacementJournal:
    """Single-writer append log over `directory` (one active controller
    per epoch writes; standbys only read at promotion — the leadership
    fencing in membership.py is what upholds single-writer)."""

    def __init__(self, directory: str, segment_bytes: int = 8 * 1024 * 1024,
                 fsync_batch: int = 8, linger_s: float = 0.02, logger=None):
        self.dir = directory
        self.segment_bytes = max(256, int(segment_bytes))
        self.fsync_batch = max(1, int(fsync_batch))
        self.linger_s = max(0.0, float(linger_s))
        self.logger = logger
        self._lock = threading.Condition()
        #: (seq, frame bytes) waiting for the writer thread
        self._pending: List[Tuple[int, bytes]] = []
        self._appended = 0          # records handed to append()
        self._durable = 0           # records written + fsynced
        self._bytes = 0             # bytes across live segments (approx.)
        self._fsync_ms: List[float] = []  # last N fsync durations
        self._writer: Optional[threading.Thread] = None
        self._fh = None             # current append file handle
        self._seg_path: Optional[str] = None
        self._seg_size = 0
        self._closing = False
        self._broken = False        # disk failed: journaling disabled
        self._flush_waiters = 0

    # -- write side --------------------------------------------------------
    def append(self, rec: dict) -> None:
        """Buffer one record (must carry a monotonic `seq`). Cheap on the
        caller's thread: serialize + enqueue; durability happens on the
        writer thread in fsync batches."""
        if self._broken:
            return
        frame = _frame(json.dumps(rec, separators=(",", ":")).encode())
        with self._lock:
            self._pending.append((int(rec["seq"]), frame))
            self._appended += 1
            if self._writer is None:
                self._writer = threading.Thread(
                    target=self._drain, name="placement-journal",
                    daemon=True)
                self._writer.start()
            self._lock.notify_all()

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until everything appended so far is durable (shutdown,
        snapshot barriers, tests). Returns False on timeout/breakage.
        Waits on the DURABLE count, not buffer emptiness — a batch the
        writer has already popped but not yet fsynced is not durable."""
        deadline = time.monotonic() + timeout
        with self._lock:
            target = self._appended
            while self._durable < target and not self._broken:
                self._flush_waiters += 1
                try:
                    self._lock.notify_all()
                    if not self._lock.wait(max(0.0, deadline
                                               - time.monotonic())):
                        GLOBAL_EVENT_LOG.record(
                            "journal_stall", timeout_s=timeout,
                            lag_batches=self._appended - self._durable)
                        return False
                finally:
                    self._flush_waiters -= 1
            return not self._broken

    def abandon(self) -> None:
        """Drop every buffered frame — the DEMOTION path. A superseded
        active must not let its buffered tail drain into the log the new
        epoch's active now owns; those records are stale by definition
        (the new active replayed without them). A batch the writer thread
        already popped may still land, but only in THIS process's own open
        segment: a promoted active always appends into a FRESH segment
        (see _open_for_append), so zombie flushes can never interleave
        with — and CRC-corrupt — the new epoch's frames, and replay drops
        them by their stale epoch stamp."""
        with self._lock:
            self._durable += len(self._pending)  # account them as gone
            self._pending = []
            self._lock.notify_all()

    def close(self, timeout: float = 10.0) -> None:
        self.flush(timeout)
        with self._lock:
            self._closing = True
            self._lock.notify_all()
        if self._writer is not None:
            self._writer.join(timeout)
            if self._writer.is_alive():
                # stalled disk: the writer still owns the handle — closing
                # it under a live write would only add a second failure
                return
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None

    def _drain(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._closing:
                    self._lock.wait()
                if self._closing and not self._pending:
                    return
                # let a batch form unless a flusher is waiting on us
                if (len(self._pending) < self.fsync_batch
                        and self.linger_s and not self._flush_waiters
                        and not self._closing):
                    self._lock.wait(self.linger_s)
                batch, self._pending = self._pending, []
            if not batch:
                # a demotion's abandon() emptied the queue while the
                # writer lingered: nothing to write, keep the writer alive
                continue
            try:
                self._write_batch(batch)
            except OSError as e:
                with self._lock:
                    self._broken = True
                    self._pending = []
                    self._lock.notify_all()
                if self.logger:
                    self.logger.warn(None, f"placement journal write failed "
                                           f"({e}); journaling disabled",
                                     "Journal")
                return
            with self._lock:
                self._durable += len(batch)
                self._lock.notify_all()

    def _write_batch(self, batch: List[Tuple[int, bytes]]) -> None:
        if self._fh is None:
            self._open_for_append(batch[0][0])
        i = 0
        while i < len(batch):
            if self._seg_size >= self.segment_bytes:
                self._fh.close()
                self._start_segment(batch[i][0])
            # frames for THIS segment: stop at the rotation boundary (a
            # single oversized frame still goes somewhere — never stall)
            chunk: List[bytes] = []
            size = 0
            while i < len(batch) and (
                    not chunk
                    or self._seg_size + size < self.segment_bytes):
                chunk.append(batch[i][1])
                size += len(batch[i][1])
                i += 1
            t0 = time.monotonic()
            self._fh.write(b"".join(chunk))
            self._fh.flush()
            os.fsync(self._fh.fileno())
            dt_ms = (time.monotonic() - t0) * 1e3
            self._seg_size += size
            self._bytes += size
            self._fsync_ms.append(dt_ms)
            if len(self._fsync_ms) > 256:
                del self._fsync_ms[:128]

    def _open_for_append(self, first_seq: int) -> None:
        """First append of this process: truncate any torn tail a crashed
        writer left on the newest segment, then start a FRESH segment —
        never append into an existing one. Single-writer per epoch is
        upheld by membership fencing, but a paused-then-resumed zombie
        active can still flush its already-popped batch after demotion;
        with per-process segments that late write lands in the ZOMBIE's
        own old segment (where replay drops it by seq/epoch) instead of
        interleaving with — and CRC-corrupting — the new epoch's frames.
        (Residual risk: a zombie that also ROTATES post-demotion could
        collide on a segment name; rotation requires segment_bytes of
        stale buffered frames, orders of magnitude past one fsync batch.)"""
        os.makedirs(self.dir, exist_ok=True)
        segs = self._segments()
        self._bytes = sum(size for _, _, size in segs)
        if segs:
            path = segs[-1][1]
            with open(path, "rb") as f:
                data = f.read()
            _, good, clean = _scan_frames(data)
            if not clean:
                if self.logger:
                    self.logger.warn(None, f"placement journal {path}: "
                                           f"torn tail truncated at byte "
                                           f"{good} (was {len(data)})",
                                     "Journal")
                with open(path, "r+b") as f:
                    f.truncate(good)
                GLOBAL_EVENT_LOG.record("journal_truncate",
                                        bytes_dropped=len(data) - good)
                self._bytes -= len(data) - good
        self._start_segment(first_seq)

    def _start_segment(self, first_seq: int) -> None:
        path = os.path.join(self.dir, f"wal-{first_seq:016d}.seg")
        self._fh = open(path, "ab")
        self._seg_path = path
        # a crash between write and fsync can leave a truncated-but-live
        # segment whose first seq we now re-claim: append continues at its
        # (repaired) end, so size accounting must start there too
        self._seg_size = self._fh.tell()

    # -- read side ---------------------------------------------------------
    def _segments(self) -> List[Tuple[int, str, int]]:
        """Sorted (first_seq, path, size) for every live segment."""
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        for name in names:
            if not (name.startswith("wal-") and name.endswith(".seg")):
                continue
            try:
                first = int(name[4:-4])
            except ValueError:
                continue
            path = os.path.join(self.dir, name)
            try:
                out.append((first, path, os.path.getsize(path)))
            except OSError:
                continue
        return sorted(out)

    def _segment_records(self, path: str) -> Tuple[List[dict], bool]:
        """(decoded records, clean) for one segment; a CRC/torn/non-JSON
        frame ends the list and flips clean False."""
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            if self.logger:
                self.logger.warn(None, f"placement journal {path} "
                                       f"unreadable ({e})", "Journal")
            return [], False
        payloads, good, clean = _scan_frames(data)
        out: List[dict] = []
        for payload in payloads:
            try:
                out.append(json.loads(payload))
            except ValueError:
                return out, False  # crc passed but not JSON
        if not clean and self.logger:
            self.logger.warn(None, f"placement journal {path}: corrupt "
                                   f"tail past byte {good}; keeping "
                                   f"{len(out)} good frames and "
                                   "truncating the rest", "Journal")
        return out, clean

    def records(self, after_seq: int = 0) -> Iterator[dict]:
        """Replay iterator: every intact record with seq > after_seq, in
        append order. A corrupt or torn frame ends THAT SEGMENT at the
        last good frame (logged, never an abort); later segments are
        still replayed only when they open a strictly HIGHER epoch — a
        promoted active starts a fresh segment after reading exactly this
        prefix, so its records compose with it, whereas a same-epoch gap
        means mid-history rot and everything after it is untrustworthy."""
        segs = self._segments()
        for i, (first, path, _size) in enumerate(segs):
            if i + 1 < len(segs) and segs[i + 1][0] <= after_seq + 1:
                continue  # the whole segment predates the snapshot
            recs, clean = self._segment_records(path)
            for rec in recs:
                if int(rec.get("seq", 0)) > after_seq:
                    yield rec
            if not clean:
                max_epoch = max((int(r.get("epoch", 0)) for r in recs),
                                default=0)
                nxt = (self._segment_records(segs[i + 1][1])[0]
                       if i + 1 < len(segs) else [])
                if not (nxt and int(nxt[0].get("epoch", 0)) > max_epoch):
                    return  # same-epoch gap: stop at the last good frame

    def last_seq(self) -> int:
        """Highest intact seq on disk (0 when empty). Seqs are
        append-monotonic, so only the newest non-empty segment needs
        scanning — not the whole log (boot/promotion latency)."""
        for _first, path, _size in reversed(self._segments()):
            recs, _clean = self._segment_records(path)
            if recs:
                return max(int(r.get("seq", 0)) for r in recs)
        return 0

    def prune(self, upto_seq: int) -> int:
        """Drop whole segments every record of which is <= upto_seq (the
        snapshot already covers them). Returns segments removed. Never
        touches the segment currently open for append."""
        segs = self._segments()
        removed = 0
        for i, (first, path, size) in enumerate(segs):
            nxt = segs[i + 1][0] if i + 1 < len(segs) else None
            if nxt is None or nxt > upto_seq + 1 or path == self._seg_path:
                break
            try:
                os.unlink(path)
                self._bytes = max(0, self._bytes - size)
                removed += 1
            except OSError:
                break
        if removed:
            GLOBAL_EVENT_LOG.record("journal_prune", segments=removed,
                                    upto_seq=int(upto_seq))
        return removed

    # -- observability -----------------------------------------------------
    @property
    def lag_batches(self) -> int:
        with self._lock:
            return self._appended - self._durable

    def fsync_p99_ms(self) -> float:
        with self._lock:
            if not self._fsync_ms:
                return 0.0
            s = sorted(self._fsync_ms)
            return round(s[min(len(s) - 1, int(0.99 * len(s)))], 3)

    def export_gauges(self, metrics) -> None:
        """The supervision-tick families (docs/metrics.md)."""
        metrics.gauge("loadbalancer_journal_lag_batches", self.lag_batches)
        metrics.gauge("loadbalancer_journal_bytes", self._bytes)
        metrics.gauge("loadbalancer_journal_fsync_p99_ms",
                      self.fsync_p99_ms())
