"""LeanBalancer: single-process mode — controller and invoker share one
A copy of `openwhisk_tpu/controller/loadbalancer/lean.py`.
process and one in-memory bus.

Rebuild of core/controller/.../loadBalancer/LeanBalancer.scala:44-88: no
broker, no remote invokers; an in-process InvokerReactive consumes the
`invoker0` topic of the shared MemoryMessagingProvider. Capacity pressure is
handled entirely by the invoker's own pool/buffering, exactly like the
reference (the lean balancer does no slot bookkeeping of its own beyond the
common activation-slot map).
"""
from __future__ import annotations

import asyncio
import time
from typing import List, Optional

from ...core.entity import ExecutableWhiskAction, InvokerInstanceId
from ...messaging.message import ActivationMessage
from ...utils.tracing import trace_id_of
from .base import HEALTHY, CommonLoadBalancer, InvokerHealth, LoadBalancer


class LeanBalancer(CommonLoadBalancer):
    def __init__(self, messaging_provider, controller_instance,
                 invoker_factory, logger=None, metrics=None,
                 user_memory=None):
        super().__init__(messaging_provider, controller_instance, logger, metrics)
        from ...core.entity import MB
        self.invoker_id = InvokerInstanceId(0, unique_name="lean",
                                            user_memory=user_memory or MB(2048))
        self._invoker_factory = invoker_factory  # async (instance, provider) -> InvokerReactive
        self.invoker = None

    async def start(self) -> None:
        self.provider.ensure_topic(self.invoker_id.as_string)
        self.start_ack_feed()
        self.invoker = await self._invoker_factory(self.invoker_id, self.provider)

    async def publish(self, action: ExecutableWhiskAction, msg: ActivationMessage
                      ) -> asyncio.Future:
        from ...utils.waterfall import STAGE_PUBLISH_ENQUEUE
        self.waterfall.stamp(msg.activation_id.asString,
                             STAGE_PUBLISH_ENQUEUE)
        self.record_placement(msg, action, 0, self.invoker_id,
                              digest={"healthy_invokers": 1})
        promise = self.setup_activation(msg, action, self.invoker_id)
        t0 = time.monotonic()
        await self.send_activation_to_invoker(msg, self.invoker_id)
        dispatch_ms = (time.monotonic() - t0) * 1e3
        # lean mode's only data-plane hop: the in-process bus send, reported
        # as a dispatch phase so /admin/profile/kernel answers here too
        # (traced publishes leave an exemplar on the bucket line)
        prof = self.profiler
        prof.observe_phase("dispatch", dispatch_ms,
                           trace_id=trace_id_of(msg.trace_context))
        if prof.capture_armed:
            # each publish is one dispatch step here, so the capture
            # window drains (and stops any live trace) on lean too
            prof.capture_step({
                "ts": time.time(), "kernel": "cpu",
                "action": str(action.fully_qualified_name),
                "invoker": self.invoker_id.as_string,
                "total_ms": round(dispatch_ms, 3)})
        # no supervision scheduler to ride: HBM gauges refresh off the
        # dispatch stream instead (1 Hz-capped, like telemetry maybe_tick)
        prof.maybe_refresh_memory(self.metrics)
        return promise

    async def invoker_health(self) -> List[InvokerHealth]:
        return [InvokerHealth(self.invoker_id, HEALTHY)]

    def _telemetry_invoker_names(self) -> List[str]:
        # no registry in lean mode: the single in-process invoker. Burn-rate
        # gauges refresh off the completion stream (base maybe_tick) since
        # there is no supervision watchdog to ride.
        return [self.invoker_id.as_string]

    def occupancy(self) -> dict:
        """Lean mode has no capacity books (the in-process invoker's pool
        buffers pressure): report in-flight activation memory against the
        invoker's configured memory as a best-effort occupancy view. Runs
        on the event loop (OCCUPANCY_SYNCS_DEVICE stays False), so the
        activation_slots iteration cannot race loop-side mutation."""
        from .flight_recorder import occupancy_json
        cap = self.invoker_id.user_memory.to_mb
        used = min(cap, sum(e.memory_mb
                            for e in self.activation_slots.values()))
        return occupancy_json("cpu", [(self.invoker_id.as_string, True, cap,
                                       cap - used, used)])

    async def close(self) -> None:
        await super().close()
        if self.invoker is not None:
            await self.invoker.stop()


class LeanBalancerProvider:
    @staticmethod
    def instance(**kwargs) -> LeanBalancer:
        return LeanBalancer(**kwargs)
