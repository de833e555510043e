"""ShardingBalancer: the CPU production balancer.
A copy of `openwhisk_tpu/controller/loadbalancer/sharding_balancer.py`.

The distributed-mode counterpart of the reference's default
ShardingContainerPoolBalancer (SURVEY §2.1): scheduling math from
models.sharding_policy, health from InvokerPool supervision, dispatch over
the bus, slot release on completion acks. This is the drop-in CPU
alternative to the TPU balancer behind the same LoadBalancerProvider SPI.
"""
from __future__ import annotations

import asyncio
import time
from typing import List, Optional

from ...core.entity import ExecutableWhiskAction, InvokerInstanceId
from ...messaging.message import ActivationMessage
from ...models.sharding_policy import ShardingPolicyState, release, schedule
from ...messaging.coalesce import export_coalesce_gauges
from ...messaging.tcp import export_bus_gauges
from ...utils.tracing import export_tracing_gauges, trace_id_of
from .base import (HEALTHY, CommonLoadBalancer, InvokerHealth, LoadBalancerException)
from .flight_recorder import occupancy_json
from .supervision import InvokerPool


class ShardingBalancer(CommonLoadBalancer):
    def __init__(self, messaging_provider, controller_instance, logger=None,
                 metrics=None, cluster_size: int = 1,
                 managed_fraction: float = 0.9, blackbox_fraction: float = 0.1,
                 anomaly=None):
        super().__init__(messaging_provider, controller_instance, logger,
                         metrics, anomaly=anomaly)
        self.policy = ShardingPolicyState.build(
            [], cluster_size=cluster_size, managed_fraction=managed_fraction,
            blackbox_fraction=blackbox_fraction)
        # per-controller group: each controller keeps its own full ping view
        # (on_tick refreshes the telemetry plane's SLO burn-rate gauges on
        # the same 1 Hz watchdog the TPU balancer uses)
        self.supervision = InvokerPool(
            messaging_provider, on_status_change=self._status_change,
            logger=logger, group=f"health-{controller_instance.as_string}",
            on_tick=self._plane_tick)
        # advisory unhealthy hints from the anomaly plane land on the
        # supervision pool (pushed only when hintUnhealthy is configured)
        self.anomaly.hint_sink = self.supervision.set_unhealthy_hints
        self._registry: List[InvokerInstanceId] = []
        self._usable: List[bool] = []

    def _plane_tick(self) -> None:
        self.telemetry.tick(self.metrics)
        # anomaly detection over the NumPy twin rides the same 1 Hz tick
        self.anomaly.tick(self.metrics)
        # guarded no-op on CPU backends — present so the profiling plane
        # behaves identically should this balancer run beside a device
        self.profiler.refresh_memory(self.metrics)
        export_tracing_gauges(self.metrics)
        # bus-client health rides the same cadence (messaging/{coalesce,tcp})
        export_coalesce_gauges(self.metrics)
        export_bus_gauges(self.metrics)

    async def start(self) -> None:
        self.start_ack_feed()
        self.supervision.start()

    def update_cluster(self, cluster_size: int) -> None:
        """Controller joined/left: divide every invoker's memory by the new
        cluster size (ref updateCluster :561-584)."""
        self.policy.update_cluster(cluster_size)

    def _status_change(self, instance: InvokerInstanceId, status: str) -> None:
        # backfill gaps as UNUSABLE placeholders: invoker N's ping may arrive
        # before 0..N-1's (bus ordering race) and never-seen invokers must
        # not receive traffic (their registry entries would misdispatch)
        idx = instance.instance
        while idx >= len(self._registry):
            self._registry.append(InvokerInstanceId(
                len(self._registry), user_memory=instance.user_memory))
            self._usable.append(False)
        self._registry[idx] = instance
        self._usable[idx] = status == HEALTHY
        self.policy.update_invokers(
            [i.user_memory.to_mb for i in self._registry],
            usable=list(self._usable))

    async def publish(self, action: ExecutableWhiskAction, msg: ActivationMessage
                      ) -> asyncio.Future:
        from ...utils.waterfall import STAGE_PUBLISH_ENQUEUE
        self.waterfall.stamp(msg.activation_id.asString,
                             STAGE_PUBLISH_ENQUEUE)
        meta = action.exec_metadata()
        t0 = time.monotonic()
        chosen, forced = schedule(
            self.policy, str(msg.user.namespace.name),
            str(action.fully_qualified_name),
            action.limits.memory.megabytes,
            action.limits.concurrency.max_concurrent,
            blackbox=meta.is_blackbox)
        schedule_ms = (time.monotonic() - t0) * 1e3
        # the CPU twin's "device step": the probe walk itself, reported as
        # a schedule phase so /admin/profile/kernel answers p50/p99 here
        # too (traced publishes leave an exemplar on the bucket line)
        self.profiler.observe_phase("schedule", schedule_ms,
                                    trace_id=trace_id_of(msg.trace_context))
        if self.profiler.capture_armed:
            # each publish is one "dispatch step" for the CPU twin, so an
            # armed capture window drains (and stops any live trace) here
            self.profiler.capture_step({
                "ts": time.time(), "kernel": "cpu",
                "action": str(action.fully_qualified_name),
                "invoker_index": None if chosen is None else int(chosen),
                "forced": bool(forced),
                "total_ms": round(schedule_ms, 3)})
        if chosen is None:
            raise LoadBalancerException(
                "No invokers available to schedule the activation.")
        if forced:
            self.metrics.counter("loadbalancer_forced_placements")
        invoker = self._registry[chosen]
        self.record_placement(msg, action, chosen, invoker, forced=forced,
                              digest={"healthy_invokers": sum(self._usable)})
        promise = self.setup_activation(msg, action, invoker)
        await self.send_activation_to_invoker(msg, invoker)
        return promise

    def release_invoker(self, invoker: InvokerInstanceId, entry) -> None:
        action_name = entry.action_key.rsplit("@", 1)[0]
        release(self.policy, invoker.instance, action_name, entry.memory_mb,
                entry.max_concurrent)

    def occupancy(self) -> dict:
        """Per-invoker slots-in-use/capacity from the host-side semaphore
        books (same JSON shape as the TPU balancer's device books).
        Permits go negative under forced over-commit: used (and the ratio)
        deliberately exceed capacity then."""
        def rows():
            for i, s in enumerate(self.policy.invokers):
                cap = self.policy.invoker_slot_mb(s.user_memory_mb)
                permits = s.semaphore.available_permits
                name = (self._registry[i].as_string
                        if i < len(self._registry) else f"invoker{i}")
                yield (name, s.usable, cap, max(0, min(cap, permits)),
                       cap - permits)

        return occupancy_json("cpu", rows())

    def on_invocation_finished(self, invoker, is_system_error, forced) -> None:
        self.supervision.on_invocation_finished(invoker, is_system_error, forced)

    async def invoker_health(self) -> List[InvokerHealth]:
        return self.supervision.health()

    @property
    def cluster_size(self) -> int:
        return self.policy.cluster_size

    async def close(self) -> None:
        await self.supervision.stop()
        await super().close()


class ShardingBalancerProvider:
    @staticmethod
    def instance(**kwargs) -> ShardingBalancer:
        return ShardingBalancer(**kwargs)
