"""Entitlement: privileges, rate throttling, concurrency throttling.

Rebuild of core/controller/.../entitlement/Entitlement.scala (:86-153 rate
throttler wiring, :197-211 kind restriction, :280-317 check pipeline) +
RateThrottler.scala + ActivationThrottler.scala:
  - privilege model READ/PUT/DELETE/ACTIVATE + implicit rights in the
    subject's own namespace,
  - per-minute rate throttle (invocations and trigger fires) with per-user
    overrides from Identity.limits,
  - concurrent-activation throttle backed by the load balancer's live
    in-flight counters,
  - per-cluster division: each controller enforces limit/clusterSize with
    the reference's 20% overcommit (:94-99,123-133),
  - kind whitelist (KindRestrictor).
Device-side note: the vectorized token-bucket equivalent for bulk admission
lives in openwhisk_tpu/ops/throttle.py; the TPU balancer fuses it into its
placement step when constructed with rate_limit_per_minute (controller flag
--balancer-rate-limit) as a bus-boundary backstop behind this front-door
throttler. Semantics differ deliberately: this class is the reference's
rolling-minute window with per-user overrides; the device bucket is a
continuous-refill token bucket at the platform default rate.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional

from ..core.entity import Identity

READ = "READ"
PUT = "PUT"
DELETE = "DELETE"
ACTIVATE = "ACTIVATE"
REJECT = "REJECT"


class EntitlementException(Exception):
    status = 403

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


class RejectRequest(EntitlementException):
    pass


class ThrottleRejectRequest(EntitlementException):
    status = 429


def rate_limit_message(description: str) -> str:
    """The 429 body for a rate rejection — ONE copy shared by the serial
    path and the batched AdmissionPlane (clients key on this text, and the
    batched path's parity contract includes it verbatim)."""
    return ("Too many requests in the last minute (count: exceeded, "
            f"allowed: {description}).")


CONCURRENT_LIMIT_MESSAGE = ("Too many concurrent requests in flight "
                            "(count: exceeded, allowed: concurrent "
                            "invocations).")


class RateThrottler:
    """Sliding one-minute window counter per namespace (ref
    RateThrottler.scala — the reference uses a rolling minute bucket)."""

    def __init__(self, description: str, default_per_minute: int):
        self.description = description
        self.default_per_minute = default_per_minute
        self._events: Dict[str, deque] = {}

    def check(self, namespace_id: str, limit_override: Optional[int] = None,
              now: Optional[float] = None) -> bool:
        """`now` (monotonic seconds) defaults to the call time; the batched
        admission plane's parity fuzz pins it so serial and vectorized
        decisions are compared at identical clocks."""
        limit = limit_override if limit_override is not None else self.default_per_minute
        now = time.monotonic() if now is None else now
        q = self._events.setdefault(namespace_id, deque())
        while q and q[0] <= now - 60.0:
            q.popleft()
        if len(q) >= limit:
            return False
        q.append(now)
        return True


class ActivationThrottler:
    """Concurrent-activation limit backed by LB in-flight counters
    (ref ActivationThrottler.scala)."""

    def __init__(self, load_balancer, default_concurrent: int):
        self.load_balancer = load_balancer
        self.default_concurrent = default_concurrent

    def check(self, namespace_id: str, limit_override: Optional[int] = None) -> bool:
        limit = limit_override if limit_override is not None else self.default_concurrent
        return self.load_balancer.active_activations_for(namespace_id) < limit


class LocalEntitlementProvider:
    """Grants + throttles (ref EntitlementProvider.check:280-317 and
    LocalEntitlement explicit-grant map)."""

    OVERCOMMIT = 1.2  # ref Entitlement.scala:94-99

    def __init__(self, load_balancer=None,
                 invocations_per_minute: int = 60,
                 concurrent_invocations: int = 30,
                 fires_per_minute: int = 60,
                 allowed_kinds: Optional[set] = None,
                 metrics=None, event_producer=None,
                 admission_config=None, frontend_config=None):
        self.load_balancer = load_balancer
        self.metrics = metrics
        self.event_producer = event_producer  # `events` topic (throttle events)
        self._grants: Dict[str, set] = {}
        # batched admission: concurrent ACTIVATE throttle checks coalesce
        # into one vectorized pass (controller/admission.py). Off
        # (CONFIG_whisk_admission_batch_enabled=false) keeps the serial
        # _check_throttles path bit-exact with the pre-batching behavior.
        from .admission import AdmissionBatchConfig, AdmissionPlane
        from .frontend import FrontendConfig
        adm_cfg = (admission_config if admission_config is not None
                   else AdmissionBatchConfig.from_env())
        fe_cfg = (frontend_config if frontend_config is not None
                  else FrontendConfig.from_env())
        # when the sharded front end will own admission (shards >= 2),
        # the single-loop plane is never reachable from check() — don't
        # build dead state whose stats would read 0 beside the real work
        self.admission: Optional[AdmissionPlane] = (
            AdmissionPlane(self, adm_cfg)
            if adm_cfg.enabled and fe_cfg.shards <= 1 else None)
        cluster = max(1, getattr(load_balancer, "cluster_size", 1) or 1)
        per_instance = lambda n: max(1, int(n / cluster * self.OVERCOMMIT)) \
            if cluster > 1 else n
        self.invoke_rate = RateThrottler("invocations per minute",
                                         per_instance(invocations_per_minute))
        self.fire_rate = RateThrottler("trigger fires per minute",
                                       per_instance(fires_per_minute))
        self.concurrent = ActivationThrottler(load_balancer,
                                              per_instance(concurrent_invocations))
        self.allowed_kinds = allowed_kinds  # None = all kinds allowed
        # sharded front end (controller/frontend.py): with
        # CONFIG_whisk_frontend_shards >= 2, ACTIVATE throttle checks
        # route to N admission worker loops partitioned by namespace
        # hash, each owning its slice of throttle state (built LAST: the
        # shard facades snapshot the throttler descriptions/limits
        # above). None (shards=1, the default) keeps the single-loop
        # admission path bit-exact. With admission BATCHING disabled the
        # shards still own their namespace slices but flush one check at
        # a time (max_batch=1) — a 1-deep rate_admit_batch is exactly the
        # serial check, so the admission off-switch keeps its serial
        # semantics under sharding instead of being silently bypassed.
        from .frontend import maybe_shard_frontend
        shard_adm = (adm_cfg if adm_cfg.enabled
                     else AdmissionBatchConfig(enabled=False, window_ms=0.0,
                                               max_batch=1))
        self.frontend = maybe_shard_frontend(self, config=fe_cfg,
                                             admission_config=shard_adm)

    # -- explicit grants (LocalEntitlement) --------------------------------
    def grant(self, subject: str, right: str, resource: str) -> None:
        self._grants.setdefault(f"{subject}/{resource}", set()).add(right)

    def revoke(self, subject: str, right: str, resource: str) -> None:
        self._grants.get(f"{subject}/{resource}", set()).discard(right)

    def _entitled(self, identity: Identity, right: str, namespace: str) -> bool:
        if right in identity.rights and namespace == str(identity.namespace.name):
            return True  # implicit rights in own namespace
        return right in self._grants.get(f"{identity.subject}/{namespace}", set())

    # -- the check pipeline ------------------------------------------------
    async def check(self, identity: Identity, right: str, namespace: str,
                    throttle: bool = False, is_trigger_fire: bool = False,
                    waterfall_ctx=None) -> None:
        """`waterfall_ctx` (an un-adopted stage vector from the latency
        waterfall plane) gets the entitle/throttle stages stamped between
        the pipeline's two halves, so the end-to-end budget can tell an
        entitlement-bound tail from a throttle-bound one."""
        from ..utils.waterfall import (STAGE_ENTITLE, STAGE_THROTTLE,
                                       ActivationWaterfall)
        if REJECT in identity.rights:
            raise RejectRequest("The subject is not entitled to access this API.")
        if not self._entitled(identity, right, namespace):
            raise RejectRequest(
                f"The supplied authentication is not authorized to access "
                f"'{namespace}' with {right} right.")
        if waterfall_ctx is not None:
            ActivationWaterfall.stamp_ctx(waterfall_ctx, STAGE_ENTITLE)
        if throttle and right == ACTIVATE:
            if self.frontend is not None:
                # sharded front end: the check runs on the worker loop
                # owning this namespace's slice of admission state (same
                # decisions, same exceptions — per-namespace arrival
                # order is preserved by the hash partition)
                await self.frontend.check_throttles(identity, is_trigger_fire)
            elif self.admission is not None:
                # batched path: this check coalesces with concurrent
                # arrivals and resolves from one vectorized flush (same
                # decisions, same exceptions as the serial path)
                await self.admission.check_throttles(identity, is_trigger_fire)
            else:
                self._check_throttles(identity, is_trigger_fire)
            if waterfall_ctx is not None:
                ActivationWaterfall.stamp_ctx(waterfall_ctx, STAGE_THROTTLE)

    def _check_throttles(self, identity: Identity, is_trigger_fire: bool) -> None:
        ns_id = identity.namespace.uuid.asString
        limits = identity.limits
        if is_trigger_fire:
            if not self.fire_rate.check(ns_id, limits.fires_per_minute):
                self._throttle_event("TimedRateLimit", identity)
                raise ThrottleRejectRequest(
                    rate_limit_message(self.fire_rate.description))
        else:
            if not self.invoke_rate.check(ns_id, limits.invocations_per_minute):
                self._throttle_event("TimedRateLimit", identity)
                raise ThrottleRejectRequest(
                    rate_limit_message(self.invoke_rate.description))
            if self.load_balancer is not None and \
                    not self.concurrent.check(ns_id, limits.concurrent_invocations):
                self._throttle_event("ConcurrentRateLimit", identity)
                raise ThrottleRejectRequest(CONCURRENT_LIMIT_MESSAGE)

    async def close(self) -> None:
        """Stop the sharded front end's worker loops (no-op at shards=1).
        The thread joins run on the executor — a slow shard must not
        stall the controller loop mid-shutdown."""
        if self.frontend is not None:
            import asyncio
            await asyncio.get_event_loop().run_in_executor(
                None, self.frontend.close)

    def check_kind(self, identity: Identity, kind: str) -> None:
        """Kind whitelist (ref KindRestrictor, Entitlement.scala:197-211)."""
        allowed = identity.limits.allowed_kinds or self.allowed_kinds
        if allowed is not None and kind not in allowed:
            raise RejectRequest(f"action kind '{kind}' not allowed for this subject")

    def _throttle_event(self, which: str, identity: Identity) -> None:
        """Count + publish the user-facing throttle event
        (ref Entitlement.scala:383-399 -> `events` topic)."""
        if self.metrics:
            self.metrics.counter(f"controller_throttle_{which}")
        if self.event_producer is not None:
            from ..messaging.message import EventMessage
            from ..utils.tasks import spawn
            spawn(self.event_producer.send(
                "events", EventMessage.for_metric(
                    "controller", which, 1, str(identity.subject),
                    str(identity.namespace.name),
                    identity.namespace.uuid.asString)), name="throttle-event")
