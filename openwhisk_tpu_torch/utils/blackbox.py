"""Incident forensics observatory: alert-triggered black-box capture.
A copy of `openwhisk_tpu/utils/blackbox.py`.

Nine observability planes answer "what is happening" — flight recorder,
telemetry/SLO, anomaly/alerts, waterfall, host observatory, placement
quality, tail traces, the fleet federation, the event log — but every one
of them is a live ring: by the time an operator queries `/admin/*` after
an SLO burn or a partition failover, the evidence has aged out, and
nothing ever JOINS the planes around one event. This module is the
flight-data-recorder answer: when an alert fires (or a
structural distress event lands in the EventLog), freeze a cross-plane
forensic bundle to disk — automatically, exactly once per incident.

Triggers
  * AlertEngine FSM transitions into `firing` (AlertEngine.listeners) —
    stragglers, error/timeout spikes, SLO burn, recompile churn,
    journal stall all arrive through this one choke point.
  * Structural distress events already in GLOBAL_EVENT_LOG:
    `journal_stall`, `part_superseded`, `spill_burst` directly, and
    `fence_discard` as a burst (>= `fence_burst_n` discards within
    `fence_burst_window_s` — a single late frame after a clean handoff
    is routine, a burst is a fencing incident).
  * A debounce window (`debounce_s`) coalesces the storm: the straggler
    alert, its SLO-burn cousin and the spillover burst they cause are ONE
    incident and produce ONE bundle (`coalesced` counts the suppressed
    triggers, stamped into the bundle on the way out).

The bundle (one CRC-framed, versioned file per incident; bounded
retention ring of `retention` files):
  * trigger context + the alert transition log + active alerts,
  * the anomaly score matrix with evidence,
  * telemetry SLO report (burn rates, windows),
  * waterfall percentiles + slowest exemplar rows,
  * flight-recorder recent ring with decisions + quality digests,
  * host-observatory snapshot (+ a bounded profiler capture when
    `profiler_capture_s` > 0),
  * every kept trace overlapping the window,
  * the EventLog timeline slice,
  * the journal seq window (mark -> now) WITH the records themselves, so
    the bundle replays standalone via tools/owdebug.py even after the
    journal prunes, and the balancer books captured at freeze time — the
    time-travel debugger diffs re-derived state against them and replay
    divergence becomes incident evidence.

Threading: triggers arrive on the event loop (alert evaluation tick) or
arbitrary threads (EventLog taps); the capture itself runs on a dedicated
daemon worker thread, so the device syncs some plane reads imply NEVER
happen on the event loop. The two reads that must run on the loop — the
balancer's `snapshot_parts()` (journal-seq-consistent books) and arming
the host profiler capture — are marshalled back via the loop handle
stashed at trigger time; everything else (telemetry/anomaly device pulls,
journal file reads, the bundle write) stays on the worker. Every plane
read is individually guarded: a broken plane yields an `error` entry in
the bundle, never a lost incident.

Off-switch: `CONFIG_whisk_incidents_enabled` defaults to **False** —
unlike the read-only planes this one writes files on trigger, so it is
explicitly armed per deployment (the runbook's first step). Disabled,
`install()` refuses (GLOBAL_HOST_OBSERVATORY pattern), no listener
attaches, no thread starts, no family renders, and the admin endpoints
404.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import struct
import threading
import time
import zlib
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from .config import load_config
from .eventlog import GLOBAL_EVENT_LOG, identity

#: bundle frame: magic | u32 payload len | u32 crc32(payload) | payload
#: (the journal's torn/corrupt-tolerant framing, one frame per file)
BUNDLE_MAGIC = b"WBB1"
#: bumped on any payload schema change; readers refuse newer majors
BUNDLE_VERSION = 1

#: EventLog kinds that are themselves incidents (one record = trigger)
DISTRESS_KINDS = frozenset({"journal_stall", "part_superseded",
                            "spill_burst"})


@dataclasses.dataclass(frozen=True)
class IncidentConfig:
    """`CONFIG_whisk_incidents_*` env overrides (config.py convention)."""

    #: master switch. Default OFF: this plane writes disk bundles on
    #: trigger — it is armed per deployment, not ambient (module doc).
    enabled: bool = False
    #: bundle directory ("" = `<tmp>/whisk-incidents-<pid>`)
    directory: str = ""
    #: retention ring: newest N bundles kept, older pruned after a write
    retention: int = 16
    #: one bundle per storm: triggers within this window coalesce
    debounce_s: float = 30.0
    #: evidence look-back: traces/events older than this are out of scope
    window_s: float = 120.0
    #: bounded host-profiler capture folded into the bundle (0 = skip —
    #: the capture holds the worker for its full duration)
    profiler_capture_s: float = 0.0
    #: flight-recorder batches frozen into the bundle
    recent_batches: int = 64
    #: EventLog records frozen into the bundle (window-filtered)
    recent_events: int = 256
    #: kept traces frozen into the bundle (newest overlapping first)
    recent_traces: int = 16
    #: journal records embedded (newest window records; a bundle must
    #: stay a bundle, not a journal mirror)
    max_journal_records: int = 4096
    #: fence_discard burst trigger: >= n discards within window_s seconds
    fence_burst_n: int = 8
    fence_burst_window_s: float = 5.0


def incidents_config(data: Optional[dict] = None) -> IncidentConfig:
    return load_config(IncidentConfig, data, env_path="incidents")


# -- bundle file format ----------------------------------------------------
def write_bundle(path: str, payload: dict) -> int:
    """Serialize + CRC-frame `payload` to `path` atomically (tmp +
    os.replace — a crashed capture never leaves a torn bundle behind).
    Returns the byte size written."""
    body = json.dumps(payload, separators=(",", ":"),
                      default=str).encode("utf-8")
    frame = (BUNDLE_MAGIC + struct.pack("<II", len(body),
                                        zlib.crc32(body) & 0xFFFFFFFF)
             + body)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(frame)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return len(frame)


def read_bundle(path: str) -> Optional[dict]:
    """Parse one bundle file. Returns None (never raises) on a missing,
    torn, corrupt or future-versioned file — forensic reads must degrade,
    not 500."""
    try:
        with open(path, "rb") as f:
            head = f.read(len(BUNDLE_MAGIC) + 8)
            if (len(head) != len(BUNDLE_MAGIC) + 8
                    or head[:len(BUNDLE_MAGIC)] != BUNDLE_MAGIC):
                return None
            length, crc = struct.unpack("<II", head[len(BUNDLE_MAGIC):])
            body = f.read(length)
        if len(body) != length or (zlib.crc32(body) & 0xFFFFFFFF) != crc:
            return None
        payload = json.loads(body.decode("utf-8"))
        if int(payload.get("version", 0)) > BUNDLE_VERSION:
            return None
        return payload
    except (OSError, ValueError):
        return None


def _summary(payload: dict) -> dict:
    """The `/admin/incidents` row: everything an operator needs to pick a
    bundle, nothing heavy."""
    planes = payload.get("planes") or {}
    j = planes.get("journal") or {}
    return {
        "id": payload.get("id"),
        "ts": payload.get("ts"),
        "reason": payload.get("reason"),
        "severity": payload.get("severity"),
        "labels": payload.get("labels") or {},
        "coalesced": payload.get("coalesced", 0),
        # only planes that actually landed: a None value means the grab
        # failed (its error is in plane_errors) and must not read as
        # captured from the list row
        "planes": sorted(k for k, v in planes.items() if v is not None),
        "plane_errors": payload.get("plane_errors") or {},
        "journal_from_seq": j.get("from_seq"),
        "journal_to_seq": j.get("to_seq"),
        "journal_records": len(j.get("records") or ()),
        "activation_ids": len(payload.get("activation_ids") or ()),
        "instance": (payload.get("identity") or {}).get("instance"),
    }


class IncidentRecorder:
    """Alert-triggered cross-plane black-box capture (module doc)."""

    def __init__(self, config: Optional[IncidentConfig] = None, logger=None):
        #: env-built recorders re-read `CONFIG_whisk_incidents_*` at every
        #: un-owned install(): the plane is armed per deployment, and the
        #: process-global instance predates any test/bench env override
        self._from_env = config is None
        self.config = config or incidents_config()
        self.logger = logger
        self.enabled = bool(self.config.enabled)
        self._lock = threading.Lock()
        self._owner: Optional[object] = None
        self._balancer = None
        self._loop = None
        self._seq_mark = 0
        self._last_trigger_mono: Optional[float] = None
        self._fence_marks: Optional[deque] = None
        self._queue: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._prior_eventlog_enabled: Optional[bool] = None
        self._counter = 0
        #: id -> summary row, newest-last (mirrors the retention ring)
        self._index: "Dict[str, dict]" = {}
        self.captured = 0
        self.coalesced = 0
        self.dropped = 0
        self.plane_errors = 0

    # -- ownership ---------------------------------------------------------
    def install(self, balancer=None, owner: Optional[object] = None) -> bool:
        """Arm the recorder for `balancer` (its alert engine, journal and
        books are the per-process evidence sources). Refused no-op when
        disabled or already owned — the host-observatory contract: first
        balancer in a shared test process wins, the rest piggyback."""
        with self._lock:
            if self._owner is not None:
                return False
            if self._from_env:
                self.config = incidents_config()
                self.enabled = bool(self.config.enabled)
        if not self.enabled:
            return False
        with self._lock:
            if self._owner is not None:
                return False
            self._owner = owner if owner is not None else object()
            self._balancer = balancer
            self._fence_marks = deque(
                maxlen=max(1, int(self.config.fence_burst_n)))
            self._queue = queue.Queue(maxsize=4)
            self._worker = threading.Thread(
                target=self._worker_loop, name="incident-recorder",
                daemon=True)
            self._worker.start()
        if balancer is not None:
            seq = getattr(balancer, "_journal_seq", 0)
            self._seq_mark = int(seq or 0)
            engine = getattr(getattr(balancer, "anomaly", None),
                             "engine", None)
            if engine is not None and self._on_alert not in engine.listeners:
                engine.listeners.append(self._on_alert)
        # structural distress arrives through the event log; incidents
        # being armed forces it on (remembering the prior state so
        # uninstall restores a fleet-observatory-off process exactly)
        self._prior_eventlog_enabled = GLOBAL_EVENT_LOG.enabled
        GLOBAL_EVENT_LOG.enabled = True
        GLOBAL_EVENT_LOG.add_listener(self._on_event)
        os.makedirs(self.directory, exist_ok=True)
        # the index mirrors THIS directory's retention ring: a re-arm
        # (possibly pointed elsewhere by a config refresh) must not serve
        # rows for bundles a previous installation wrote somewhere else
        with self._lock:
            self._index.clear()
        self._load_index()
        return True

    def uninstall(self, owner: Optional[object] = None) -> None:
        with self._lock:
            if self._owner is None:
                return
            if owner is not None and owner is not self._owner:
                return
            self._owner = None
            balancer, self._balancer = self._balancer, None
            q, self._queue = self._queue, None
            worker, self._worker = self._worker, None
            prior = self._prior_eventlog_enabled
            self._prior_eventlog_enabled = None
            self._last_trigger_mono = None
        GLOBAL_EVENT_LOG.remove_listener(self._on_event)
        if prior is not None:
            GLOBAL_EVENT_LOG.enabled = prior
        engine = getattr(getattr(balancer, "anomaly", None), "engine", None)
        if engine is not None and self._on_alert in engine.listeners:
            engine.listeners.remove(self._on_alert)
        if q is not None:
            try:
                q.put_nowait(None)  # wake + stop the worker
            except queue.Full:
                pass
        if worker is not None:
            worker.join(timeout=5.0)

    @property
    def directory(self) -> str:
        d = self.config.directory
        if d:
            return d
        import tempfile
        return os.path.join(tempfile.gettempdir(),
                            f"whisk-incidents-{os.getpid()}")

    # -- triggers ----------------------------------------------------------
    def _on_alert(self, now, rule, labels, old, new, value) -> None:
        # owner check before building the trigger payload: the disabled /
        # uninstalled path must allocate nothing (tracemalloc-asserted)
        if new != "firing" or self._owner is None:
            return
        self._trigger(f"alert:{rule.name}", severity=rule.severity,
                      labels=dict(labels),
                      value=None if value is None else float(value))

    def _on_event(self, rec: dict) -> None:
        if self._owner is None:
            return
        kind = rec.get("kind")
        if kind in DISTRESS_KINDS:
            self._trigger(f"event:{kind}", severity="warning",
                          labels={k: v for k, v in rec.items()
                                  if k not in ("kind", "mono", "ts", "seq")})
        elif kind == "fence_discard":
            now = time.monotonic()
            with self._lock:
                marks = self._fence_marks
                if marks is None:
                    return
                marks.append(now)
                burst = (len(marks) == marks.maxlen
                         and now - marks[0]
                         <= self.config.fence_burst_window_s)
                if burst:
                    marks.clear()
            if burst:
                self._trigger("event:fence_discard_burst",
                              severity="warning",
                              labels={"n": self.config.fence_burst_n,
                                      "window_s":
                                      self.config.fence_burst_window_s})

    def _trigger(self, reason: str, severity: str = "warning",
                 labels: Optional[dict] = None,
                 value: Optional[float] = None) -> None:
        now = time.monotonic()
        with self._lock:
            if self._owner is None:
                return
            if (self._last_trigger_mono is not None
                    and now - self._last_trigger_mono
                    < self.config.debounce_s):
                self.coalesced += 1
                return
            self._last_trigger_mono = now
            self._counter += 1
            q = self._queue
            coalesced_before = self.coalesced
        # the loop handle for the two loop-only reads; alert triggers fire
        # on the evaluation tick so this almost always succeeds
        try:
            import asyncio
            self._loop = asyncio.get_running_loop()
        except RuntimeError:
            pass
        job = {"reason": reason, "severity": severity,
               "labels": labels or {}, "value": value,
               "ts": time.time(), "mono": now,
               "counter": self._counter,
               "coalesced_mark": coalesced_before}
        if q is None:
            return
        try:
            q.put_nowait(job)
        except queue.Full:
            with self._lock:
                self.dropped += 1

    # -- capture (worker thread) -------------------------------------------
    def _worker_loop(self) -> None:
        while True:
            q = self._queue
            if q is None:
                return
            try:
                job = q.get(timeout=1.0)
            except queue.Empty:
                continue
            if job is None:
                return
            try:
                self._capture(job)
            except Exception as e:  # noqa: BLE001 — the recorder degrades,
                # it never takes the process down with the incident
                if self.logger is not None:
                    self.logger.warn(None, f"incident capture failed: "
                                           f"{e!r}", "IncidentRecorder")

    def _on_loop(self, fn: Callable[[], Any], timeout: float = 5.0):
        """Run `fn` on the event loop thread and wait for the result —
        for the reads that must be journal-seq-consistent with the loop's
        state mutations."""
        loop = self._loop
        if loop is None or loop.is_closed():
            raise RuntimeError("no event loop handle")
        import concurrent.futures
        fut: "concurrent.futures.Future" = concurrent.futures.Future()

        def run():
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)
        loop.call_soon_threadsafe(run)
        return fut.result(timeout)

    def _capture(self, job: dict) -> None:
        cfg = self.config
        bal = self._balancer
        planes: Dict[str, Any] = {}
        errors: Dict[str, str] = {}

        def grab(name: str, fn: Callable[[], Any]) -> None:
            try:
                planes[name] = fn()
            except Exception as e:  # noqa: BLE001 — per-plane guard
                errors[name] = repr(e)
                with self._lock:
                    self.plane_errors += 1

        anomaly = getattr(bal, "anomaly", None)
        if anomaly is not None:
            grab("alerts", lambda: anomaly.alerts_report(limit=50))
            # device pull ok: we are on the worker thread, not the loop
            grab("anomaly_scores", lambda: anomaly.anomalies_report())
        telemetry = getattr(bal, "telemetry", None)
        if telemetry is not None:
            names = getattr(bal, "_telemetry_invoker_names", None)
            grab("telemetry_slo",
                 lambda: telemetry.slo_report(names() if callable(names)
                                              else None))
        waterfall = getattr(bal, "waterfall", None)
        if waterfall is not None:
            grab("waterfall", lambda: waterfall.report(recent=8))
        fr = getattr(bal, "flight_recorder", None)
        if fr is not None:
            grab("flight_recorder",
                 lambda: fr.recent(cfg.recent_batches, with_decisions=True))
        from .hostprof import GLOBAL_HOST_OBSERVATORY as obs
        grab("host", obs.snapshot)
        if cfg.profiler_capture_s > 0 and self._loop is not None:
            def _prof():
                import asyncio
                return asyncio.run_coroutine_threadsafe(
                    obs.capture(cfg.profiler_capture_s),
                    self._loop).result(cfg.profiler_capture_s + 5.0)
            grab("host_profile", _prof)
        grab("traces", lambda: self._traces_in_window(job))
        grab("events", lambda: self._events_in_window(job))
        if bal is not None and hasattr(bal, "snapshot_parts"):
            def _books():
                parts = self._on_loop(bal.snapshot_parts)
                # heavy device->host conversion stays on THIS thread
                return bal.snapshot(parts)
            grab("books", _books)
        # books FIRST, then the journal window bounded at the books'
        # journal_seq: the time-travel debugger replays the window and
        # diffs against the captured books, so the two must describe the
        # same instant even while traffic keeps flowing
        books = planes.get("books")
        to_seq = (books or {}).get("journal_seq")
        grab("journal", lambda: self._journal_window(bal, to_seq=to_seq))

        aids = self._collect_aids(planes)
        with self._lock:
            coalesced = self.coalesced - job["coalesced_mark"]
        payload = {
            "version": BUNDLE_VERSION,
            "id": f"inc-{int(job['ts'] * 1000):013x}-{job['counter']:04d}",
            "ts": job["ts"],
            "reason": job["reason"],
            "severity": job["severity"],
            "labels": job["labels"],
            "value": job["value"],
            "coalesced": coalesced,
            "window_s": cfg.window_s,
            "identity": identity(),
            "planes": planes,
            "plane_errors": errors,
            "activation_ids": sorted(aids),
        }
        path = os.path.join(self.directory, f"{payload['id']}.wbb")
        write_bundle(path, payload)
        with self._lock:
            self.captured += 1
            self._index[payload["id"]] = _summary(payload)
        self._prune()
        if self.logger is not None:
            self.logger.warn(
                None, f"incident {payload['id']} captured "
                f"({job['reason']}, {len(planes)} planes, "
                f"coalesced={coalesced}) -> {path}", "IncidentRecorder")

    def _traces_in_window(self, job: dict) -> List[dict]:
        from .tracestore import GLOBAL_TRACE_STORE
        cutoff = job["ts"] - self.config.window_s
        out = [e for e in GLOBAL_TRACE_STORE.entries()
               if float(e.get("ts", 0.0)) >= cutoff]
        return out[-self.config.recent_traces:]

    def _events_in_window(self, job: dict) -> List[dict]:
        cutoff = job["mono"] - self.config.window_s
        out = [r for r in GLOBAL_EVENT_LOG.recent(self.config.recent_events)
               if float(r.get("mono", 0.0)) >= cutoff]
        return out

    def _journal_window(self, bal, to_seq: Optional[int] = None) -> dict:
        """The journal seq range covering the window, records embedded so
        owdebug replays the bundle standalone. `from_seq` is the mark laid
        at install / the previous capture — the honest 'everything since
        we last looked' window; `to_seq` is the captured books' seq when
        books were captured (replay-parity anchor), the live seq
        otherwise."""
        journal = getattr(bal, "journal", None)
        from_seq = self._seq_mark
        if to_seq is None:
            to_seq = int(getattr(bal, "_journal_seq", 0) or 0)
        to_seq = int(to_seq)
        out: Dict[str, Any] = {"from_seq": from_seq, "to_seq": to_seq,
                               "directory": None, "records": []}
        if journal is None:
            return out
        out["directory"] = getattr(journal, "dir", None)
        try:
            journal.flush(timeout=2.0)
        except Exception:  # noqa: BLE001 — a stalled journal is itself
            pass           # the incident; capture what is durable
        recs = [r for r in journal.records(after_seq=from_seq)
                if int(r.get("seq", 0)) <= to_seq or to_seq == 0]
        if len(recs) > self.config.max_journal_records:
            out["truncated"] = len(recs) - self.config.max_journal_records
            recs = recs[-self.config.max_journal_records:]
        out["records"] = recs
        self._seq_mark = max(from_seq, to_seq)
        return out

    @staticmethod
    def _collect_aids(planes: dict) -> set:
        """Activation ids referenced by the bundle — the flight recorder's
        decision rows plus the journal batch records' `aids` — so one
        activation id walks recorder -> trace -> bundle (explain
        cross-links)."""
        aids = set()
        for rec in planes.get("flight_recorder") or ():
            for d in rec.get("decisions") or ():
                a = d.get("activation_id")
                if a:
                    aids.add(str(a))
        j = planes.get("journal") or {}
        for rec in j.get("records") or ():
            for a in rec.get("aids") or ():
                if a:
                    aids.add(str(a))
        for e in planes.get("traces") or ():
            a = e.get("activation_id")
            if a:
                aids.add(str(a))
        return aids

    # -- retention + read side ---------------------------------------------
    def _bundle_files(self) -> List[str]:
        try:
            names = [n for n in os.listdir(self.directory)
                     if n.startswith("inc-") and n.endswith(".wbb")]
        except OSError:
            return []
        return sorted(names)  # ids embed a ms timestamp: sorted == oldest

    def _prune(self) -> None:
        keep = max(1, int(self.config.retention))
        files = self._bundle_files()
        for name in files[:-keep] if len(files) > keep else []:
            try:
                os.unlink(os.path.join(self.directory, name))
            except OSError:
                pass
            with self._lock:
                self._index.pop(name[:-len(".wbb")], None)

    def _load_index(self) -> None:
        """Adopt bundles already on disk (a restarted controller keeps its
        forensic history)."""
        for name in self._bundle_files()[-int(self.config.retention):]:
            iid = name[:-len(".wbb")]
            with self._lock:
                if iid in self._index:
                    continue
            payload = read_bundle(os.path.join(self.directory, name))
            if payload is not None:
                with self._lock:
                    self._index[payload["id"]] = _summary(payload)

    def list_incidents(self) -> List[dict]:
        """Newest-first summary rows (the `/admin/incidents` body)."""
        with self._lock:
            rows = list(self._index.values())
        rows.sort(key=lambda r: r.get("ts") or 0.0, reverse=True)
        return rows

    def get(self, incident_id: str) -> Optional[dict]:
        """Full bundle payload by id; None when unknown/corrupt."""
        if ("/" in incident_id or "\\" in incident_id
                or not incident_id.startswith("inc-")):
            return None
        return read_bundle(os.path.join(self.directory,
                                        f"{incident_id}.wbb"))

    def incidents_for_activation(self, activation_id: str) -> List[str]:
        """Incident ids whose bundles reference `activation_id` — the
        explain cross-link. Summary rows only carry the COUNT, so this
        reads the (retention-bounded) bundles; explain is a cold path."""
        out = []
        for row in self.list_incidents():
            if not row.get("activation_ids"):
                continue
            payload = self.get(row["id"])
            if payload and activation_id in (payload.get("activation_ids")
                                             or ()):
                out.append(row["id"])
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled,
                    "installed": self._owner is not None,
                    "directory": self.directory,
                    "captured": self.captured,
                    "coalesced": self.coalesced,
                    "dropped": self.dropped,
                    "plane_errors": self.plane_errors,
                    "bundles": len(self._index),
                    "seq_mark": self._seq_mark}

    # -- exposition --------------------------------------------------------
    def prometheus_text(self, openmetrics: bool = False) -> str:
        if not self.enabled:
            return ""
        with self._lock:
            counters = [
                ("openwhisk_incidents_captured_total", self.captured),
                ("openwhisk_incidents_coalesced_total", self.coalesced),
                ("openwhisk_incidents_dropped_total", self.dropped),
                ("openwhisk_incidents_plane_errors_total",
                 self.plane_errors),
            ]
            bundles = len(self._index)
        out: List[str] = []
        for name, value in counters:
            # unlabeled counter, tracestore idiom: OM types the base name,
            # samples keep the _total suffix in both formats
            base = name[:-len("_total")] if openmetrics else name
            out += [f"# TYPE {base} counter", f"{name} {int(value)}"]
        out += ["# TYPE openwhisk_incidents_bundles gauge",
                f"openwhisk_incidents_bundles {bundles}"]
        return "\n".join(out)


#: the process-global recorder (GLOBAL_HOST_OBSERVATORY pattern: triggers
#: span layers — invoker fence discards, journal flush stalls — so the
#: instance must too). Rebuilt-from-env on import; tests construct their
#: own `IncidentRecorder(IncidentConfig(...))` instead of mutating this.
GLOBAL_INCIDENTS = IncidentRecorder()
