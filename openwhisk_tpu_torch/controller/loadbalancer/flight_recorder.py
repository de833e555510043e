"""Placement flight recorder: the last N placement decisions, explained.
A copy of `openwhisk_tpu/controller/loadbalancer/flight_recorder.py`.

The aggregate `loadbalancer_tpu_*` histograms say *how fast* the balancer
places; they cannot answer "why did activation X land on invoker Y?" or
"what did the fleet look like at that device step?". The flight recorder
keeps the last N micro-batch records in a pre-sized ring
(utils.ring_buffer.SeqRingBuffer) — per batch: an input digest (kernel,
healthy-invoker count, queue depth, oldest-request age, free-slot histogram
of the packed books), the per-request decision rows (activation id, action,
chosen invoker, forced/throttled flags, requested slot-MB), and the phase
timings (assembly/dispatch/readback/fanout) — plus an activation-id index so
`explain(activation_id)` answers with the exact batch record and decision
row, or None once the ring has wrapped past it.

Every balancer reports through the same recorder (the base-class hook in
loadbalancer/base.py): the TPU balancer records whole micro-batches with a
device digest, the CPU balancers (sharding, lean) record one-decision
batches with a `kernel: "cpu"` digest — so the introspection plane
(`/admin/placement/*` on the controller) is backend-agnostic.

Hot-path budget: one BatchRecord and one decisions list per micro-batch,
appended into the pre-sized ring — no per-request dict churn, no growth.
Switch it off with `CONFIG_whisk_loadBalancer_flightRecorder_enabled=false`
(size via `..._flightRecorder_size`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ...utils.config import load_config
from ...utils.ring_buffer import SeqRingBuffer

#: decision-row tuple layout (kept a tuple, not a dict, on the hot path)
D_AID, D_ACTION, D_CHOSEN, D_INVOKER, D_FORCED, D_THROTTLED, D_SLOT_MB = \
    range(7)

DecisionRow = Tuple[str, str, int, Optional[str], bool, bool, int]


@dataclass(frozen=True)
class FlightRecorderConfig:
    """`CONFIG_whisk_loadBalancer_flightRecorder_*` env overrides."""
    enabled: bool = True
    size: int = 256


class BatchRecord:
    """One recorded placement step (a micro-batch for the TPU balancer, a
    single decision for the CPU balancers)."""

    __slots__ = ("seq", "ts", "digest", "decisions", "timings")

    def __init__(self, digest: dict,
                 decisions: Optional[List[DecisionRow]] = None,
                 timings: Optional[dict] = None):
        self.seq = -1          # assigned by FlightRecorder.record
        self.ts = time.time()
        #: input digest: kernel, healthy_invokers, queue_depth,
        #: oldest_age_ms, free_slot_hist, occupancy (keys vary by backend)
        self.digest = digest
        self.decisions: List[DecisionRow] = decisions if decisions is not None else []
        self.timings = timings or {}

    @staticmethod
    def decision_json(row: DecisionRow) -> dict:
        return {
            "activation_id": row[D_AID],
            "action": row[D_ACTION],
            "invoker_index": row[D_CHOSEN],
            "invoker": row[D_INVOKER],
            "forced": row[D_FORCED],
            "throttled": row[D_THROTTLED],
            "slot_mb": row[D_SLOT_MB],
        }

    def to_json(self, with_decisions: bool = True) -> dict:
        out = {
            "seq": self.seq,
            "ts": self.ts,
            "digest": self.digest,
            "timings": self.timings,
            "batch_size": len(self.decisions),
        }
        if with_decisions:
            out["decisions"] = [self.decision_json(r) for r in self.decisions]
        return out


class FlightRecorder:
    """Ring of BatchRecords + an activation-id -> seq index.

    The index is bounded by construction: entries are removed when their
    batch record is evicted from the ring, so it never outgrows
    size * max_batch activation ids.
    """

    def __init__(self, size: int = 256, enabled: bool = True):
        self.enabled = enabled
        self._ring: SeqRingBuffer[BatchRecord] = SeqRingBuffer(max(1, size))
        self._index: Dict[str, int] = {}

    @property
    def size(self) -> int:
        return self._ring.size

    @property
    def dropped(self) -> int:
        """Batch records the ring has wrapped past."""
        return self._ring.evicted

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, rec: BatchRecord) -> int:
        """Append one batch record; index its decisions by activation id."""
        seq, evicted = self._ring.append(rec)
        rec.seq = seq
        if evicted is not None:
            old_seq = evicted.seq
            for row in evicted.decisions:
                if self._index.get(row[D_AID]) == old_seq:
                    del self._index[row[D_AID]]
        for row in rec.decisions:
            self._index[row[D_AID]] = seq
        return seq

    def explain(self, activation_id: str) -> Optional[dict]:
        """The batch record + decision row for one activation, or None if it
        was never recorded here or the ring has wrapped past it."""
        seq = self._index.get(activation_id)
        if seq is None:
            return None
        rec = self._ring.get(seq)
        if rec is None:  # wrapped between index cleanup and lookup
            self._index.pop(activation_id, None)
            return None
        for row in rec.decisions:
            if row[D_AID] == activation_id:
                return {"decision": BatchRecord.decision_json(row),
                        "batch": rec.to_json()}
        return None

    def recent(self, n: int = 20, with_decisions: bool = True) -> List[dict]:
        """The last min(n, size) batch records, oldest first."""
        return [r.to_json(with_decisions=with_decisions)
                for r in self._ring.last(n)]

    @classmethod
    def from_config(cls) -> "FlightRecorder":
        cfg = load_config(FlightRecorderConfig,
                          env_path="load_balancer.flight_recorder")
        return cls(size=cfg.size, enabled=cfg.enabled)


def occupancy_json(kernel: Optional[str], rows) -> dict:
    """Assemble the `/admin/placement/occupancy` payload from per-invoker
    (name, healthy, capacity_mb, free_mb, used_mb) tuples — ONE place for
    the documented shape, shared by all balancers. `used` may exceed `cap`
    (forced over-commit): the ratio then deliberately exceeds 1."""
    invokers = []
    cap_total = used_total = 0
    for name, healthy, cap, free, used in rows:
        invokers.append({
            "invoker": name,
            "healthy": bool(healthy),
            "capacity_mb": cap,
            "free_mb": free,
            "used_mb": used,
            "occupancy": round(used / cap, 4) if cap else 0.0,
        })
        cap_total += cap
        used_total += used
    return {
        "kernel": kernel,
        "invokers": invokers,
        "fleet": {
            "capacity_mb": cap_total,
            "used_mb": used_total,
            "occupancy": (round(used_total / cap_total, 4)
                          if cap_total else 0.0),
        },
    }


#: free_slot_histogram bucket upper bounds, in action slots: 0, 1-2, 3-4,
#: 5-8, 9-16, 17-32, 33-64, >64
_HIST_EDGES = None


def free_slot_histogram(free_mb: Sequence[int], slot_mb: int = 128
                        ) -> List[int]:
    """Compact fleet-shape digest: count of invokers whose free capacity is
    0, 1-2, 3-4, 5-8, 9-16, 17-32, 33-64, or >64 action slots of `slot_mb`
    MB each. Eight ints regardless of fleet size."""
    import numpy as np
    global _HIST_EDGES
    if _HIST_EDGES is None:
        _HIST_EDGES = np.asarray([1, 3, 5, 9, 17, 33, 65], np.int64)
    slots = np.asarray(free_mb, np.int64) // max(1, int(slot_mb))
    idx = np.searchsorted(_HIST_EDGES, slots, side="right")
    return np.bincount(idx, minlength=8).tolist()
