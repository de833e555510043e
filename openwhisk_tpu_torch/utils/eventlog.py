"""Fleet observatory primitives: config, process identity, event log.

Every observability plane of the JAX package — waterfall, host observatory,
telemetry/SLO, flight recorder — is process-local. The fleet observatory
federates them across processes, and the three primitives it
needs everywhere live here, in utils, below every layer that uses them:

  * `FleetObservatoryConfig` / `fleet_config()` — the off-switch.
    `CONFIG_whisk_fleetObservatory_enabled=false` must be a TRUE no-op:
    heartbeats byte-exact, no `ctrlevents` topic, fleet endpoints 404.
    Components therefore gate on the config at WIRING time (the
    controller simply never passes its admin address / never builds the
    event publisher), not per call.

  * `set_identity()` / `identity()` — the `{instance, pid, role,
    partitions}` block every snapshot carries so the federation can merge
    by member and multi-process loadgen's per-worker `host` snapshots
    stop being indistinguishable. `pid` is read at call time, never
    cached: a forked worker must not inherit the parent's pid.

  * `EventLog` — a process-global SeqRingBuffer of structural events
    (leadership/partition epoch claims, fenced handoff and absorb
    start+end, spillover bursts, invoker fence discards, journal
    truncation/stall, kernel swaps), each stamped with BOTH clocks:
    `mono` (time.monotonic, exact deltas within a process — the chaos
    rider's phase decomposition) and `ts` (wall, the only clock
    comparable across hosts — the merged fleet timeline's sort key).
    Recording is one dict build + ring append behind a single bool — the
    events are structural (rare), so steady-state overhead is ~0 and the
    scrape-pull-only contract holds.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .config import load_config
from .ring_buffer import SeqRingBuffer


@dataclasses.dataclass(frozen=True)
class FleetObservatoryConfig:
    """`CONFIG_whisk_fleetObservatory_*` (config.py env convention)."""

    #: master switch: False = no heartbeat fields, no ctrlevents topic,
    #: fleet endpoints 404 — byte-exact with a build without the observatory
    enabled: bool = True
    #: EventLog ring slots (structural events are rare; 512 covers hours)
    events_ring: int = 512
    #: per-peer scrape budget for /admin/fleet/* federation
    scrape_timeout_s: float = 2.0
    #: how often queued events flush to the ctrlevents topic
    publish_interval_s: float = 0.25
    #: static edge-proxy stats URL folded in as one more fleet member
    #: (the edge doesn't heartbeat; it is deploy-time config)
    edge_url: str = ""


def fleet_config(data: Optional[dict] = None) -> FleetObservatoryConfig:
    return load_config(FleetObservatoryConfig, data,
                       env_path="fleet_observatory")


# -- process identity ------------------------------------------------------
_ident_lock = threading.Lock()
_ident: Dict[str, Any] = {"instance": None, "role": None}
_parts_fn: Optional[Callable[[], List[int]]] = None


def set_identity(instance: Optional[int] = None, role: Optional[str] = None,
                 partitions_fn: Optional[Callable[[], List[int]]] = None
                 ) -> None:
    """Declare who this process is. Controllers call it at start() with
    their instance and a live owned-partitions provider; invokers,
    loadgen workers and the edge set a role (and worker index)."""
    global _parts_fn
    with _ident_lock:
        if instance is not None:
            _ident["instance"] = int(instance)
        if role is not None:
            _ident["role"] = str(role)
        if partitions_fn is not None:
            _parts_fn = partitions_fn


def identity() -> Dict[str, Any]:
    """The `{instance, pid, role, partitions}` merge key. Cheap enough to
    attach to every snapshot; `pid` is read live (fork safety)."""
    with _ident_lock:
        fn = _parts_fn
        out: Dict[str, Any] = {"instance": _ident["instance"],
                               "pid": os.getpid(),
                               "role": _ident["role"]}
    parts: List[int] = []
    if fn is not None:
        try:
            parts = sorted(int(p) for p in fn())
        except Exception:  # noqa: BLE001 — identity must never raise
            parts = []
    out["partitions"] = parts
    return out


def reset_identity() -> None:
    """Test hook: forget the declared identity."""
    global _parts_fn
    with _ident_lock:
        _ident["instance"] = None
        _ident["role"] = None
        _parts_fn = None


# -- event log -------------------------------------------------------------
class EventLog:
    """Process-global causal event log (module doc).

    Records are plain dicts `{seq, kind, mono, ts, instance, **fields}`;
    `instance` is whatever identity() knows at record time, so three
    in-process controllers (tests, the chaos rider) disambiguate by
    passing `instance=` explicitly at the call site. An attached
    publisher (controller/fleet.py) sees every record and forwards it to
    the `ctrlevents` topic at low rate; detached (the default, and the
    whole story when the observatory is disabled) recording is just a
    ring append."""

    def __init__(self, size: int = 512, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._ring: SeqRingBuffer[dict] = SeqRingBuffer(max(1, size))
        self._publisher: Optional[Callable[[dict], None]] = None
        #: in-process observers beside the (single) bus publisher slot —
        #: the incident recorder's structural-distress tap
        #: lives here so it never competes with FleetEvents for the
        #: publisher. Same contract: synchronous, must never block or
        #: raise into a recording call site.
        self._listeners: List[Callable[[dict], None]] = []

    def record(self, kind: str, **fields) -> Optional[dict]:
        if not self.enabled:
            return None
        rec = {"kind": kind, "mono": time.monotonic(), "ts": time.time()}
        if "instance" not in fields:
            with _ident_lock:
                rec["instance"] = _ident["instance"]
        rec.update(fields)
        with self._lock:
            rec["seq"], _ = self._ring.append(rec)
            pub = self._publisher
            listeners = tuple(self._listeners)
        if pub is not None:
            try:
                pub(rec)
            except Exception:  # noqa: BLE001 — observability never blocks
                pass
        for fn in listeners:
            try:
                fn(rec)
            except Exception:  # noqa: BLE001 — observability never blocks
                pass
        return rec

    def attach_publisher(self, fn: Optional[Callable[[dict], None]]) -> None:
        with self._lock:
            self._publisher = fn

    def add_listener(self, fn: Callable[[dict], None]) -> None:
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[dict], None]) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def recent(self, n: int = 512) -> List[dict]:
        with self._lock:
            return list(self._ring.last(n))

    @property
    def evicted(self) -> int:
        with self._lock:
            return self._ring.evicted

    def reset(self, size: Optional[int] = None) -> None:
        with self._lock:
            self._ring = SeqRingBuffer(max(1, size or self._ring.size))


#: the process-global log every call site records into (GLOBAL_WATERFALL
#: pattern: the events span layers, so the instance must too)
GLOBAL_EVENT_LOG = EventLog()
