"""LoadBalancer SPI + shared bookkeeping.

The counterpart of `openwhisk_tpu/controller/loadbalancer/base.py`
(rebuild of core/controller/.../loadBalancer/LoadBalancer.scala:46-112 and
CommonLoadBalancer.scala), with the parts the TPU balancer's front needs:

  - `publish(action, msg)` returns a future that resolves to the *completion*
    of the activation (the inner future of the reference's
    Future[Future[Either[ActivationId, WhiskActivation]]]).
  - per-activation `ActivationEntry` in `activation_slots` with a
    completion-ack timeout of max(action timeout, 1 min) * timeout_factor
    + timeout_addon (CommonLoadBalancer.scala:103-105); firing the timeout
    force-releases the slot so leaked capacity self-heals.
  - the completion-ack feed (`completed<controller>` topic) disambiguates
    4 ways (:260-346): regular completion, forced-timeout completion, late
    ack after forced completion (only counts toward invoker health), and
    healthcheck acks from system test actions.

The observability planes of the JAX package's balancer (flight recorder,
telemetry, profiler, anomaly, waterfall, quality, trace store, incidents)
and its HA / partition fencing are not here: none of them changes a
decision. Events are counted in `counters` instead of a metric emitter.
"""
from __future__ import annotations

import asyncio
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

from ...core.entity import (ActivationId, ExecutableWhiskAction,
                            InvokerInstanceId, WhiskAction, WhiskActivation)
from ...messaging.connector import MessageFeed, decode_message
from ...messaging.message import (AcknowledgementMessage, ActivationMessage,
                                  parse_ack)
from ...utils.transaction import TransactionId

# invoker states (ref InvokerState in InvokerSupervision.scala)
HEALTHY = "up"
UNHEALTHY = "unhealthy"
UNRESPONSIVE = "unresponsive"
OFFLINE = "down"


@dataclass
class InvokerHealth:
    id: InvokerInstanceId
    status: str = HEALTHY


class LoadBalancerException(Exception):
    pass


class LoadBalancerThrottleException(LoadBalancerException):
    """The balancer's device rate admission rejected the activation (maps
    to 429 at the API surface, like an entitlement throttle)."""


class ActiveAckTimeout(LoadBalancerException):
    def __init__(self, activation_id: ActivationId):
        super().__init__(f"no completion or active ack received yet for {activation_id}")
        self.activation_id = activation_id


@dataclass
class ActivationEntry:
    id: ActivationId
    namespace_id: str
    invoker: Optional[InvokerInstanceId]
    memory_mb: int
    max_concurrent: int
    action_key: str
    is_blackbox: bool
    is_blocking: bool
    #: forced-timeout timer (a TimerHandle; .cancel() like a Task)
    timeout_task: Optional[asyncio.TimerHandle] = None
    promise: Optional[asyncio.Future] = None
    forced: bool = False
    #: TPU balancer only: the device concurrency slot this activation's
    #: acquire returned, so its release lands on exactly that slot even if
    #: the action's key->slot mapping migrates while it is in flight
    conc_slot: Optional[int] = None


def occupancy_json(kernel: Optional[str], rows) -> dict:
    """The occupancy payload from per-invoker (name, healthy, capacity_mb,
    free_mb, used_mb) tuples — the JAX package's documented shape. `used`
    may exceed `cap` (forced over-commit): the ratio then exceeds 1."""
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


class LoadBalancer:
    """SPI surface (ref LoadBalancer.scala:46-78)."""

    async def publish(self, action: ExecutableWhiskAction, msg: ActivationMessage
                      ) -> asyncio.Future:
        """Schedule the activation; returns a future resolving to
        WhiskActivation (completion) or raising ActiveAckTimeout."""
        raise NotImplementedError

    def publish_many(self, pairs: List[tuple]) -> List[asyncio.Future]:
        """The batch-shaped publish SPI: schedule a whole admission batch
        of `(action, msg)` pairs in one call. Returns one future per pair,
        each resolving to what `publish` would have returned (the
        completion promise) or raising what `publish` would have raised.
        This default keeps serial semantics — one `publish` task per pair;
        the TpuBalancer overrides it."""
        return [asyncio.ensure_future(self.publish(action, msg))
                for action, msg in pairs]

    def active_activations_for(self, namespace_id: str) -> int:
        raise NotImplementedError

    @property
    def total_active_activations(self) -> int:
        raise NotImplementedError

    @property
    def cluster_size(self) -> int:
        return 1

    def update_cluster(self, cluster_size: int) -> None:
        """Re-shard capacity on controller join/leave (ref updateCluster,
        ShardingContainerPoolBalancer.scala:561-584)."""

    async def invoker_health(self) -> List[InvokerHealth]:
        raise NotImplementedError

    def occupancy(self) -> dict:
        """Per-invoker memory in use against capacity from the balancer's
        books. Balancers without capacity books answer an empty fleet."""
        return occupancy_json(None, [])

    async def close(self) -> None:
        pass


class CommonLoadBalancer(LoadBalancer):
    TIMEOUT_FACTOR = 2
    TIMEOUT_ADDON = 60.0
    STD_TIMEOUT = 60.0

    def __init__(self, messaging_provider, controller_instance, logger=None):
        self.provider = messaging_provider
        self.controller = controller_instance
        self.logger = logger
        #: the raw bus producer: one send per dispatch
        self.producer = messaging_provider.get_producer()
        self.activation_slots: Dict[str, ActivationEntry] = {}
        self.activations_per_namespace: Dict[str, int] = {}
        self._total = 0
        self._ack_feed: Optional[MessageFeed] = None
        #: ids of system test activations, so their acks disambiguate as
        #: healthchecks
        self._health_probe_ids: set = set()
        #: event counts (the JAX package's `loadbalancer_*` counters)
        self.counters: Counter = Counter()

    # -- counters (ref :60-99) --------------------------------------------
    def active_activations_for(self, namespace_id: str) -> int:
        return self.activations_per_namespace.get(namespace_id, 0)

    @property
    def total_active_activations(self) -> int:
        return self._total

    def _incr(self, entry: ActivationEntry) -> None:
        self._total += 1
        self.activations_per_namespace[entry.namespace_id] = \
            self.activations_per_namespace.get(entry.namespace_id, 0) + 1

    def _decr(self, entry: ActivationEntry) -> None:
        self._total -= 1
        n = self.activations_per_namespace.get(entry.namespace_id, 1) - 1
        if n <= 0:
            self.activations_per_namespace.pop(entry.namespace_id, None)
        else:
            self.activations_per_namespace[entry.namespace_id] = n

    # -- activation setup (ref :116-169) -----------------------------------
    def setup_activation(self, msg: ActivationMessage,
                         action: Union[WhiskAction, ExecutableWhiskAction],
                         invoker: Optional[InvokerInstanceId]) -> asyncio.Future:
        timeout = (max(action.limits.timeout.seconds, self.STD_TIMEOUT)
                   * self.TIMEOUT_FACTOR + self.TIMEOUT_ADDON)
        loop = asyncio.get_event_loop()
        promise: asyncio.Future = loop.create_future()
        # some promises are never awaited (non-blocking invokes) — retrieve
        # the exception so a forced timeout doesn't log "Future exception
        # was never retrieved"
        promise.add_done_callback(
            lambda f: f.exception() if not f.cancelled() else None)
        entry = ActivationEntry(
            id=msg.activation_id,
            namespace_id=msg.user.namespace.uuid.asString,
            invoker=invoker,
            memory_mb=action.limits.memory.megabytes,
            max_concurrent=action.limits.concurrency.max_concurrent,
            action_key=f"{action.fully_qualified_name}@{action.rev.rev or ''}",
            is_blackbox=action.exec_metadata().is_blackbox,
            is_blocking=msg.blocking,
            promise=promise,
        )
        # call_later, not a task per activation: a TimerHandle is one heap
        # entry with O(1) lazy cancellation
        entry.timeout_task = loop.call_later(timeout, self._timeout_fire,
                                             entry)
        self.activation_slots[msg.activation_id.asString] = entry
        self._incr(entry)
        return promise

    def _timeout_fire(self, entry: ActivationEntry) -> None:
        self.process_completion(entry.id, forced=True, is_system_error=False,
                                invoker=entry.invoker)

    # -- dispatch (ref :175-198) -------------------------------------------
    def prepare_dispatch(self, msg: ActivationMessage,
                         invoker: InvokerInstanceId) -> str:
        """The synchronous half of a dispatch: counts it and returns the
        invoker topic."""
        self.counters["activations_published"] += 1
        return invoker.as_string  # "invoker<N>"

    async def send_activation_to_invoker(self, msg: ActivationMessage,
                                         invoker: InvokerInstanceId) -> None:
        await self.producer.send(self.prepare_dispatch(msg, invoker), msg)

    # -- completion-ack feed (ref :205-346) --------------------------------
    def start_ack_feed(self) -> None:
        topic = f"completed{self.controller.as_string}"
        self.provider.ensure_topic(topic)
        consumer = self.provider.get_consumer(
            topic, f"completions-{self.controller.as_string}", max_peek=128)
        feed_box = {}

        async def handle(payload: bytes):
            try:
                self.process_acknowledgement(payload)
            finally:
                feed_box["feed"].processed()

        self._ack_feed = MessageFeed("activeack", consumer, 128, handle,
                                     logger=self.logger)
        feed_box["feed"] = self._ack_feed
        self._ack_feed.start()

    def process_acknowledgement(self, raw: bytes) -> None:
        try:
            ack: AcknowledgementMessage = decode_message(parse_ack, raw)
        except (ValueError, KeyError) as e:
            if self.logger:
                self.logger.error(TransactionId.LOADBALANCER,
                                  f"corrupt completion ack: {e!r}")
            return
        self._process_ack(ack)

    def _process_ack(self, ack: AcknowledgementMessage) -> None:
        """One decoded ack through the serial completion path."""
        if ack.activation is not None:
            self.process_result(ack.activation_id, ack.activation)
        if ack.is_slot_free:
            self.process_completion(ack.activation_id,
                                    forced=False,
                                    is_system_error=ack.is_system_error,
                                    invoker=ack.invoker)

    def process_acknowledgements(self, acks: List[AcknowledgementMessage]
                                 ) -> None:
        """The batch-shaped completion pipeline: N decoded acks in ONE
        pass — each ack's result resolves first, then its slot release
        updates the entry books directly, and the regular-ack counter moves
        once with the batch count. Decision-for-decision identical to
        `process_completion`; acks off the wire are never `forced` (only
        the timeout timer forces). One ack's failure does not strand the
        rest."""
        regular = 0
        for ack in acks:
            try:
                regular += self._process_ack_batched(ack)
            except Exception as e:  # noqa: BLE001 — per-ack isolation
                if self.logger:
                    self.logger.error(TransactionId.LOADBALANCER,
                                      f"batched ack failed: {e!r}")
        self.counters["completion_ack_regular"] += regular

    def _process_ack_batched(self, ack: AcknowledgementMessage) -> int:
        """One ack's share of the batched pass; returns 1 when it released
        a tracked (regular) slot, 0 otherwise."""
        if ack.activation is not None:
            self.process_result(ack.activation_id, ack.activation)
        if not ack.is_slot_free:
            return 0
        aid = ack.activation_id
        entry = self.activation_slots.pop(aid.asString, None)
        if entry is None:
            # untracked ack: healthcheck or late-after-forced — the
            # 4-way disambiguation, same counters as the serial path
            if aid.asString in self._health_probe_ids:
                self._health_probe_ids.discard(aid.asString)
                self.counters["completion_ack_healthcheck"] += 1
            else:
                self.counters["completion_ack_regularAfterForced"] += 1
            self.on_invocation_finished(
                ack.invoker, is_system_error=ack.is_system_error,
                forced=False)
            return 0
        if entry.timeout_task:
            entry.timeout_task.cancel()
        self._decr(entry)
        if entry.invoker is not None:
            self.release_invoker(entry.invoker, entry)
        self.on_invocation_finished(ack.invoker or entry.invoker,
                                    is_system_error=ack.is_system_error,
                                    forced=False)
        return 1

    def process_result(self, aid: ActivationId, activation: WhiskActivation) -> None:
        """Complete the blocking client's promise (ref :235-243)."""
        entry = self.activation_slots.get(aid.asString)
        if entry is not None and entry.promise is not None and not entry.promise.done():
            entry.promise.set_result(activation)

    def process_completion(self, aid: ActivationId, forced: bool,
                           is_system_error: bool,
                           invoker: Optional[InvokerInstanceId]) -> None:
        """Slot release with 4-way disambiguation (ref :260-346)."""
        entry = self.activation_slots.pop(aid.asString, None)
        if entry is not None:
            if entry.timeout_task and not forced:
                entry.timeout_task.cancel()
            entry.forced = forced
            self._decr(entry)
            if entry.invoker is not None:
                self.release_invoker(entry.invoker, entry)
            if forced:
                self.counters["completion_ack_forced"] += 1
                if entry.promise is not None and not entry.promise.done():
                    entry.promise.set_exception(ActiveAckTimeout(aid))
            else:
                self.counters["completion_ack_regular"] += 1
            self.on_invocation_finished(invoker or entry.invoker,
                                        is_system_error=is_system_error,
                                        forced=forced)
        elif aid.asString in self._health_probe_ids:
            # untracked ack: a test-action probe we sent
            self._health_probe_ids.discard(aid.asString)
            self.counters["completion_ack_healthcheck"] += 1
            self.on_invocation_finished(invoker, is_system_error=is_system_error,
                                        forced=forced)
        elif not forced:
            # a late ack after a forced completion
            self.counters["completion_ack_regularAfterForced"] += 1
            self.on_invocation_finished(invoker, is_system_error=is_system_error,
                                        forced=False)
        else:
            self.counters["completion_ack_forcedAfterRegular"] += 1

    # -- subclass hooks ----------------------------------------------------
    def release_invoker(self, invoker: InvokerInstanceId, entry: ActivationEntry) -> None:
        """Return the capacity slot taken for this activation."""

    def on_invocation_finished(self, invoker: Optional[InvokerInstanceId],
                               is_system_error: bool, forced: bool) -> None:
        """Feed the invoker-health supervision (ref InvocationFinishedMessage)."""

    async def close(self) -> None:
        if self._ack_feed:
            await self._ack_feed.stop()
        await self.producer.close()
        for entry in list(self.activation_slots.values()):
            if entry.timeout_task:
                entry.timeout_task.cancel()
        self.activation_slots.clear()
