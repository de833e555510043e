"""Active/active partitioned control: the namespace partition ring.
A copy of `openwhisk_tpu/utils/partitions.py`.

Active/standby HA makes the stateful balancer highly available with ONE
controller placing while the rest idle, so controller capacity cannot
scale horizontally and every failover parks the whole fleet behind one
promote+replay. This module is the ownership half of the active/active
generalization: the namespace space is hashed into a
fixed power-of-two number of VIRTUAL PARTITIONS, and each partition is
mapped to one of the N live controllers by rendezvous (highest-random-
weight) hashing — removing a member moves ONLY that member's partitions,
adding one steals only the partitions it now wins, and every observer
with the same live set derives the SAME ownership map with no
coordination round.

Three layers share this ring and must agree, so it lives in one place:

  * the EDGE PROXY ranks upstreams by `rank(pid)` so a request's first
    hop is its partition's owner (a miss is a 503 the bounded retry
    walks to the next candidate — routing is an optimization, the
    owner-side refusal is the correctness gate);
  * CONTROLLER MEMBERSHIP (membership.py) folds per-partition epoch
    claims over the same heartbeats that carry the global leadership
    claim of the active/standby mode — higher epoch wins, ties break
    to the lower instance, PER PARTITION;
  * each BALANCER refuses placement for partitions it does not own and
    stamps `(fence_part, fence_epoch)` on every dispatch so invokers
    discard a superseded owner's late batches per partition.

Partition handoff (member death OR planned ring rebalance) reuses the
snapshot + journal replay machinery per partition: the new owner bumps
the partition's epoch and replays the previous owner's journal tail
FILTERED to exactly the partitions it absorbed (journal records carry
the partition ids of their rows; see TpuBalancer.replay_journal's
`parts_filter`).

Off-switch: `CONFIG_whisk_ha_activeActive=false` (the default) — no
ring is built anywhere and every path is bit-exact with the
single-active behavior.

This module lives in utils (not controller/loadbalancer, which
re-exports it) because the EDGE proxy imports the ring too, and the
loadbalancer package init pulls the full balancer stack (torch) —
seconds of import and hundreds of MB a reverse proxy must never pay.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

from .config import load_config


@dataclass(frozen=True)
class ActiveActiveConfig:
    """`CONFIG_whisk_ha_activeActive[_*]` env overrides. The bare scalar
    form (`CONFIG_whisk_ha_activeActive=true`) toggles `enabled`; the
    nested form (`CONFIG_whisk_ha_activeActive_partitions=32`) sets the
    knobs. `partitions` is rounded up to a power of two."""
    enabled: bool = False
    #: virtual partitions on the ring (pow2): many more than controllers,
    #: so ownership moves in small slices on a membership change
    partitions: int = 16
    #: cross-partition spillover for hot namespaces (spillover.py): an
    #: overloaded owner forwards its overflow admission batch to the
    #: least-loaded peer. Separate switch — spillover is an optimization
    #: on top of the ownership protocol, not part of it.
    spillover: bool = False
    #: pending-queue depth past which publish_many diverts its overflow
    spillover_depth: int = 256


def _next_pow2(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def active_active_config() -> ActiveActiveConfig:
    """Read the config, accepting the scalar form AND the nested knobs
    TOGETHER (`CONFIG_whisk_ha_activeActive=true` beside
    `CONFIG_whisk_ha_activeActive_partitions=8` — the generic nested
    env parser can't hold a scalar and a subtree under one key, so this
    reads the raw environment directly)."""
    import os
    data = {}
    scalar = os.environ.get("CONFIG_whisk_ha_activeActive")
    if scalar is not None:
        data["enabled"] = scalar
    prefix = "CONFIG_whisk_ha_activeActive_"
    for k, v in os.environ.items():
        if k.startswith(prefix) and k != prefix.rstrip("_"):
            data[_snake_key(k[len(prefix):])] = v
    return load_config(ActiveActiveConfig, data)


def _snake_key(name: str) -> str:
    import re
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


def ring_from_config(cfg: Optional[ActiveActiveConfig] = None
                     ) -> Optional["PartitionRing"]:
    """A ring when active/active is on, else None (the off-switch: every
    caller treats a None ring as the single-active path)."""
    cfg = cfg if cfg is not None else active_active_config()
    if not cfg.enabled:
        return None
    return PartitionRing(cfg.partitions)


def _h64(key: str) -> int:
    """Stable 64-bit hash — deterministic across processes and Python
    builds (never the salted builtin hash): the edge, every controller
    and every replayer must derive identical ownership."""
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")


class PartitionRing:
    """pow2 virtual partitions + rendezvous partition->member mapping."""

    def __init__(self, n_partitions: int = 16):
        self.n_partitions = _next_pow2(n_partitions)
        self._mask = self.n_partitions - 1

    # -- namespace -> partition -------------------------------------------
    def partition_of(self, namespace: str) -> int:
        return _h64(str(namespace)) & self._mask

    # -- partition -> member (rendezvous) ---------------------------------
    @staticmethod
    def _score(pid: int, member: int) -> int:
        return _h64(f"p{pid}@c{member}")

    def rank(self, pid: int, members: Iterable[int]) -> List[int]:
        """Members ordered by descending rendezvous weight for `pid`
        (ties break to the LOWER instance, matching the membership
        protocol's claim tie-break). rank()[0] is the owner; the edge
        walks the rest on a 503."""
        return sorted(set(int(m) for m in members),
                      key=lambda m: (-self._score(pid, m), m))

    def owner_of(self, pid: int, members: Iterable[int]) -> Optional[int]:
        ranked = self.rank(pid, members)
        return ranked[0] if ranked else None

    def ownership(self, members: Iterable[int]) -> Dict[int, int]:
        """The full partition->owner map for a live set. Every observer
        with the same `members` derives the same map."""
        ms = sorted(set(int(m) for m in members))
        if not ms:
            return {}
        return {pid: self.rank(pid, ms)[0]
                for pid in range(self.n_partitions)}

    def partitions_of(self, member: int, members: Iterable[int]) -> List[int]:
        own = self.ownership(members)
        return [pid for pid, m in own.items() if m == int(member)]
