"""Sharded front end: N admission worker loops partitioned by namespace.

The API layer stops being one Python loop. The controller's front
door — entitlement throttles, admission batching — ran entirely on the
single controller event loop: every arrival paid its admission Python
there, serialized with the balancer's dispatch/readback work. This plane
spreads the ADMISSION state over N worker event loops (one thread each),
partitioned by namespace hash:

  * each shard OWNS its namespace slice's throttle state — its own
    rolling-minute `RateThrottler` deques and its own `AdmissionPlane`
    micro-batcher (the vectorized admission, unchanged) — so there
    is no cross-shard locking and no shared mutable admission state;
  * a namespace's every request lands on the same shard (crc32 hash), so
    per-namespace decisions are EXACTLY the single-loop decisions: the
    rolling window, the override replay rule and the intra-batch
    concurrency accounting all see the same per-namespace arrival order
    the serial path would (only unrelated namespaces decide in
    parallel, and they never shared state to begin with);
  * admitted requests return to the caller's loop and feed the single
    device balancer through the existing coalescers — the balancer, its
    micro-batcher and the bus stay one plane.
  * the CONCURRENCY throttle reads the balancer's in-flight counters
    cross-thread (GIL-atomic dict reads — the same already-racy
    read-then-admit the serial path does) and keeps the intra-batch
    accounting per shard flush.

Partition count is the `CONFIG_whisk_frontend_shards` knob. `shards=1`
(the default) builds NOTHING: `LocalEntitlementProvider` keeps its
single `AdmissionPlane` on the controller loop — bit-exact with today's
behavior (the off-switch contract; parity-fuzzed in
tests/test_columnar_batch.py).
"""
from __future__ import annotations

import asyncio
import threading
import zlib
from dataclasses import dataclass
from typing import List, Optional

from ..utils.config import load_config


@dataclass(frozen=True)
class FrontendConfig:
    """`CONFIG_whisk_frontend_*` env overrides."""
    #: admission worker loops; 1 = single-loop (today's exact behavior)
    shards: int = 1

    @classmethod
    def from_env(cls) -> "FrontendConfig":
        return load_config(cls, env_path="frontend")


class _ShardFacade:
    """The provider facade one shard's AdmissionPlane flushes against:
    shard-LOCAL rate throttlers (this shard's namespace slice), the
    SHARED balancer counters for the concurrency throttle, and throttle
    events forwarded threadsafe to the owning provider's loop."""

    def __init__(self, provider, plane: "FrontendShardPlane"):
        from .entitlement import RateThrottler
        self._provider = provider
        self._plane = plane
        self.invoke_rate = RateThrottler(provider.invoke_rate.description,
                                         provider.invoke_rate.default_per_minute)
        self.fire_rate = RateThrottler(provider.fire_rate.description,
                                       provider.fire_rate.default_per_minute)
        self.load_balancer = provider.load_balancer
        self.concurrent = provider.concurrent

    def _throttle_event(self, which: str, identity) -> None:
        """Shard threads must not touch the main loop's producer/tasks:
        hop the event back to the loop that owns them."""
        main = self._plane.main_loop
        if main is None or main.is_closed():
            return
        main.call_soon_threadsafe(self._provider._throttle_event, which,
                                  identity)


class _Shard:
    """One admission worker: a daemon thread running an event loop that
    owns one namespace slice's throttle state + admission micro-batcher."""

    def __init__(self, index: int, provider, plane: "FrontendShardPlane",
                 admission_config=None):
        from .admission import AdmissionPlane
        self.index = index
        self.facade = _ShardFacade(provider, plane)
        self.loop = asyncio.new_event_loop()
        self.admission = AdmissionPlane(self.facade, admission_config)
        self._thread = threading.Thread(
            target=self._run, name=f"frontend-shard-{index}", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def signal_stop(self) -> None:
        if self.loop.is_running():
            self.loop.call_soon_threadsafe(self.loop.stop)

    def join(self, timeout: float = 5.0) -> None:
        self._thread.join(timeout=timeout)
        if not self.loop.is_closed():
            self.loop.close()

    def stop(self) -> None:
        self.signal_stop()
        self.join()


class FrontendShardPlane:
    """Routes ACTIVATE throttle checks to the shard owning the caller's
    namespace (see module doc). Constructed ONLY for shards >= 2 —
    `maybe_shard_frontend` returns None otherwise, leaving the serial
    single-loop admission path in place bit-exactly."""

    def __init__(self, provider, shards: int, admission_config=None):
        self.shards_n = max(2, int(shards))
        #: the loop that owns the provider's producer/event side effects;
        #: captured at the first check (the provider may be constructed
        #: before any loop runs)
        self.main_loop: Optional[asyncio.AbstractEventLoop] = None
        self._shards: List[_Shard] = [
            _Shard(i, provider, self, admission_config)
            for i in range(self.shards_n)]
        self.routed = 0

    def shard_of(self, namespace_id: str) -> int:
        """Deterministic namespace -> shard map (crc32, not hash():
        stable across processes and PYTHONHASHSEED)."""
        return zlib.crc32(namespace_id.encode()) % self.shards_n

    async def check_throttles(self, identity, is_trigger_fire: bool) -> None:
        """The sharded stand-in for the single-loop admission check:
        returns on admit, raises the serial path's exact throttle
        exceptions on reject (they propagate through the cross-thread
        future untouched)."""
        if self.main_loop is None:
            self.main_loop = asyncio.get_running_loop()
        shard = self._shards[self.shard_of(identity.namespace.uuid.asString)]
        self.routed += 1
        cf = asyncio.run_coroutine_threadsafe(
            shard.admission.check_throttles(identity, is_trigger_fire),
            shard.loop)
        await asyncio.wrap_future(cf)

    def stats(self) -> dict:
        return {
            "shards": self.shards_n,
            "routed": self.routed,
            "per_shard_checked": [s.admission.checked for s in self._shards],
            "per_shard_batches": [s.admission.batches for s in self._shards],
        }

    def close(self) -> None:
        """Stage the shutdown: signal every shard loop first, then join —
        total wall is bounded by the slowest shard, not the sum. Blocking
        (thread joins): async callers run it on the executor
        (LocalEntitlementProvider.close does)."""
        for s in self._shards:
            s.signal_stop()
        for s in self._shards:
            s.join()


def maybe_shard_frontend(provider, config: Optional[FrontendConfig] = None,
                         admission_config=None
                         ) -> Optional[FrontendShardPlane]:
    """The wiring hook (the `maybe_coalesce` pattern): a plane when
    `CONFIG_whisk_frontend_shards` >= 2, None — today's exact single-loop
    behavior — otherwise."""
    cfg = config if config is not None else FrontendConfig.from_env()
    if cfg.shards <= 1:
        return None
    return FrontendShardPlane(provider, cfg.shards, admission_config)
