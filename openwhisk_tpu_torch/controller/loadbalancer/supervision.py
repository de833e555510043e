"""Invoker supervision: the health protocol.

A copy of `openwhisk_tpu/controller/loadbalancer/supervision.py` without
its fleet-observatory addresses (rebuild of
core/controller/.../loadBalancer/InvokerSupervision.scala):
  - invokers ping the `health` topic at 1 Hz (InvokerReactive.scala:337-342);
  - one FSM per invoker with states Healthy('up') / Unhealthy / Unresponsive
    / Offline('down') (:47-66);
  - a ring buffer of the last 10 invocation outcomes; > 3 system errors ->
    Unhealthy, > 3 timeouts -> Unresponsive (:435-443);
  - Offline after 10 s of ping silence (:294);
  - new invokers register lazily on their first ping (:191-207) and the
    balancer state grows in place — shrinking is by marking Offline only;
  - unhealthy invokers recover via test traffic: with `send_test_action`
    set (the balancer's `prepare_health_test_action` sets it) a ping after
    the cooldown posts one system test activation, whose successful ack
    heals the window; without it the FSM re-opens the error window.
Status changes are pushed to the balancer through `on_status_change`, which
feeds the device health mask in the TPU balancer.
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ...core.entity import InvokerInstanceId
from ...messaging.connector import (HEALTH_RETENTION_BYTES, HEALTH_TOPIC,
                                    MessageFeed)
from ...messaging.message import PingMessage
from ...utils.ring_buffer import RingBuffer
from ...utils.scheduler import Scheduler
from ...utils.transaction import TransactionId
from .base import HEALTHY, OFFLINE, UNHEALTHY, UNRESPONSIVE, InvokerHealth

SUCCESS = "success"
SYSTEM_ERROR = "system_error"
TIMEOUT = "timeout"

BUFFER_SIZE = 10
ERROR_TOLERANCE = 3
PING_TIMEOUT_S = 10.0
RECOVERY_COOLDOWN_S = 60.0


@dataclass
class InvokerActorState:
    id: InvokerInstanceId
    status: str = OFFLINE
    last_ping: float = 0.0
    buffer: RingBuffer = field(default_factory=lambda: RingBuffer(BUFFER_SIZE))
    # seed one cooldown in the past: the FIRST probe of an unhealthy invoker
    # must fire immediately (time.monotonic() is host uptime — a bare 0.0
    # default would suppress probes on freshly-booted hosts)
    last_recovery_attempt: float = field(
        default_factory=lambda: time.monotonic() - RECOVERY_COOLDOWN_S)

    def classify(self) -> str:
        """Derive the health status from the outcome window (:435-443)."""
        if self.buffer.count(lambda r: r == SYSTEM_ERROR) > ERROR_TOLERANCE:
            return UNHEALTHY
        if self.buffer.count(lambda r: r == TIMEOUT) > ERROR_TOLERANCE:
            return UNRESPONSIVE
        return HEALTHY


class InvokerPool:
    def __init__(self, messaging_provider,
                 on_status_change: Optional[Callable] = None,
                 logger=None, ping_timeout: float = PING_TIMEOUT_S,
                 group: str = "health",
                 send_test_action: Optional[Callable] = None,
                 on_tick: Optional[Callable] = None):
        self.provider = messaging_provider
        self.on_status_change = on_status_change or (lambda inv, status: None)
        self.send_test_action = send_test_action
        #: optional 1 Hz callback riding the watchdog — the balancer hangs
        #: its telemetry burn-rate gauge refresh here so dashboards stay
        #: fresh without a scheduler of their own
        self.on_tick = on_tick
        #: advisory hints from the anomaly plane (invoker index -> firing
        #: alert name). Observability only: the FSM's status derivation
        #: never reads them — a flagged invoker still takes traffic until
        #: real outcome evidence (the ring buffer) demotes it.
        self.unhealthy_hints: Dict[int, str] = {}
        self.logger = logger
        self.ping_timeout = ping_timeout
        self.group = group
        self.invokers: Dict[int, InvokerActorState] = {}
        self._feed: Optional[MessageFeed] = None
        self._watchdog: Optional[Scheduler] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        # pings are ephemeral: tight retention, and never replay a backlog
        # into a new per-controller group
        self.provider.ensure_topic(HEALTH_TOPIC,
                                   retention_bytes=HEALTH_RETENTION_BYTES)
        consumer = self.provider.get_consumer(HEALTH_TOPIC, self.group,
                                              max_peek=128, from_latest=True)
        box = {}

        async def handle(payload: bytes):
            try:
                self.on_ping(PingMessage.parse(payload).instance)
            except (ValueError, KeyError):
                pass
            box["feed"].processed()

        self._feed = MessageFeed("health", consumer, 128, handle, logger=self.logger)
        box["feed"] = self._feed
        self._feed.start()
        self._watchdog = Scheduler(1.0, self._check_offline, name="invoker-watchdog",
                                   logger=self.logger).start()

    async def stop(self) -> None:
        if self._watchdog:
            await self._watchdog.stop()
        if self._feed:
            await self._feed.stop()

    # -- events ------------------------------------------------------------
    def on_ping(self, instance: InvokerInstanceId) -> None:
        st = self.invokers.get(instance.instance)
        if st is None:
            # lazy registration on first ping (:191-207)
            st = InvokerActorState(instance, status=OFFLINE)
            self.invokers[instance.instance] = st
        st.id = instance  # refresh user_memory etc.
        st.last_ping = time.monotonic()
        if st.status == OFFLINE:
            self._transition(st, HEALTHY if st.classify() == HEALTHY else st.classify())
        elif st.status in (UNHEALTHY, UNRESPONSIVE):
            self._maybe_recover(st)

    def on_invocation_finished(self, instance: Optional[InvokerInstanceId],
                               is_system_error: bool, forced: bool) -> None:
        """Fold an invocation outcome into the window (LB feeds this from
        completion acks; forced timeouts count as timeouts)."""
        if instance is None:
            return
        st = self.invokers.get(instance.instance)
        if st is None:
            return
        outcome = SYSTEM_ERROR if is_system_error else (TIMEOUT if forced else SUCCESS)
        st.buffer.add(outcome)
        if st.status != OFFLINE:
            self._transition(st, st.classify())

    async def _check_offline(self) -> None:
        now = time.monotonic()
        for st in self.invokers.values():
            if st.status != OFFLINE and now - st.last_ping > self.ping_timeout:
                self._transition(st, OFFLINE)
        if self.on_tick is not None:
            try:
                self.on_tick()
            except Exception:  # noqa: BLE001 — a gauge refresh must never
                pass           # kill the health watchdog

    def _maybe_recover(self, st: InvokerActorState) -> None:
        now = time.monotonic()
        if now - st.last_recovery_attempt < RECOVERY_COOLDOWN_S:
            return
        st.last_recovery_attempt = now
        if self.send_test_action is not None:
            asyncio.get_event_loop().create_task(self.send_test_action(st.id))
        else:
            # no test-action channel: re-open the window for organic traffic
            st.buffer = RingBuffer(BUFFER_SIZE)
            self._transition(st, HEALTHY)

    def _transition(self, st: InvokerActorState, new_status: str) -> None:
        if new_status != st.status:
            old = st.status
            st.status = new_status
            if self.logger:
                self.logger.info(TransactionId.INVOKER_HEALTH,
                                 f"invoker{st.id.instance} {old} -> {new_status}",
                                 "InvokerPool")
            self.on_status_change(st.id, new_status)

    # -- views -------------------------------------------------------------
    def set_unhealthy_hints(self, hints: Dict[int, str]) -> None:
        """Replace the advisory hint set (the anomaly plane pushes the full
        current dict every tick when CONFIG_whisk_anomaly_hintUnhealthy is
        on, so recovered invokers shed their hint automatically)."""
        self.unhealthy_hints = dict(hints)

    def health(self) -> List[InvokerHealth]:
        return [InvokerHealth(st.id, st.status,
                              hint=self.unhealthy_hints.get(idx))
                for idx, st in sorted(self.invokers.items())]
