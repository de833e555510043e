"""The primitive invoke path: entity resolution -> ActivationMessage ->
load balancer -> wait for the active ack (with DB-poll fallback).

Rebuild of core/controller/.../actions/PrimitiveActions.scala:152-206
(invokeSimpleAction: message construction, publish, blocking wait) and
:592-658 (waitForActivationResponse: promise first, activation-store poll as
the fallback when acks are lost, 202 on timeout), plus the package/binding
parameter resolution of Packages.scala (`mergePackageWithBinding`).
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from ..core.entity import (ActivationId, Identity, Parameters, WhiskAction,
                           WhiskActivation, WhiskPackage)
from ..core.entity.names import FullyQualifiedEntityName
from ..database import EntityStore, NoDocumentException
from ..messaging.message import ActivationMessage
from ..utils.transaction import TransactionId

MAX_BLOCKING_WAIT = 65.0  # ref controller maxWaitForBlockingActivation ~ 60 s

#: activation-store poll cadence while a blocking invoke waits: start fast
#: (acks are usually only *slightly* late), back off exponentially to the cap
#: (ref pollActivation schedules polls until the deadline,
#: PrimitiveActions.scala:592-658). The cap bounds read amplification on the
#: healthy-ack path: a 60 s blocking invoke issues ~15 polls total, not one
#: per second.
POLL_INTERVAL_MIN = 0.1
POLL_INTERVAL_MAX = 5.0


@dataclass
class InvokeOutcome:
    activation: Optional[WhiskActivation]
    activation_id: ActivationId
    accepted: bool  # True -> 202 (no result within the wait window)


async def resolve_action(entity_store: EntityStore, fqn: FullyQualifiedEntityName,
                         identity: Identity) -> Tuple[WhiskAction, Parameters]:
    """Resolve an action reference through packages/bindings, returning the
    action and the merged package-level parameters (provider < binding).
    Ref: WhiskPackage.mergePackageWithBinding + Actions resolution."""
    segments = fqn.path.segments
    if len(segments) <= 1:
        action = await entity_store.get_action(str(fqn))
        return action, Parameters()
    pkg_id = f"{segments[0]}/{segments[1]}"
    package = await entity_store.get_package(pkg_id)
    params = package.parameters
    provider_path = package.namespace.add(package.name)
    if package.binding is not None:
        provider = await entity_store.get_package(str(package.binding.fqn))
        params = provider.parameters.merge(package.parameters)
        provider_path = provider.namespace.add(provider.name)
    action = await entity_store.get_action(f"{provider_path}/{fqn.name}")
    return action, params


class ActionInvoker:
    def __init__(self, entity_store: EntityStore, activation_store,
                 load_balancer, controller_instance, logger=None):
        self.entity_store = entity_store
        self.activation_store = activation_store
        self.load_balancer = load_balancer
        self.controller = controller_instance
        self.logger = logger
        # batch-shaped publish: when the balancer runs the
        # batched SPI, concurrent invokes in one event-loop sweep hand
        # the balancer ONE publish_many batch instead of N publish
        # coroutines. None (knob off / CPU balancers without the SPI)
        # keeps the serial publish call bit-exact.
        from .loadbalancer.base import maybe_batch_publish
        self._publish_batcher = maybe_batch_publish(load_balancer)

    async def invoke(self, identity: Identity, action: WhiskAction,
                     package_params: Parameters, payload: Optional[Dict[str, Any]],
                     blocking: bool, transid: Optional[TransactionId] = None,
                     wait_override: Optional[float] = None,
                     cause: Optional[ActivationId] = None,
                     waterfall_ctx: Optional[list] = None) -> InvokeOutcome:
        """invokeSimpleAction (:152-206): parameters merge left-to-right as
        package < action < payload; the message carries only the payload-
        merged arguments. `waterfall_ctx` is the REST handler's stage
        vector (api_accept/entitle/throttle already stamped); direct
        callers (triggers, sequences) get a fresh vector anchored here so
        every activation carries a waterfall regardless of entry path."""
        transid = transid or TransactionId()
        from ..utils.tracing import GLOBAL_TRACER, trace_id_of
        from ..utils.waterfall import GLOBAL_WATERFALL
        span = GLOBAL_TRACER.start_span("controller_activation", transid)
        args = package_params.merge(action.parameters).merge(
            Parameters.from_arguments(payload or {}))
        msg = ActivationMessage(
            transid=transid,
            action=FullyQualifiedEntityName(action.namespace, action.name),
            revision=action.rev.rev,
            user=identity,
            activation_id=ActivationId.generate(),
            root_controller_index=self.controller,
            blocking=blocking,
            content=args.to_arguments(),
            cause=cause,
            trace_context=GLOBAL_TRACER.get_trace_context(transid),
        )
        # the activation id exists now: the stage vector becomes reachable
        # for every later layer (balancer, bus, invoker, pool, batcher)
        if waterfall_ctx is None:
            waterfall_ctx = GLOBAL_WATERFALL.open()
        GLOBAL_WATERFALL.adopt(msg.activation_id.asString, waterfall_ctx,
                               trace_id=trace_id_of(msg.trace_context))
        try:
            try:
                if self._publish_batcher is not None:
                    promise = await self._publish_batcher.publish(action, msg)
                else:
                    promise = await self.load_balancer.publish(action, msg)
            except (Exception, asyncio.CancelledError):
                # rejected before entering the pipeline (throttle, no
                # invokers) or the client went away mid-publish
                # (CancelledError is BaseException, a bare `except
                # Exception` would miss it): never completes, so never
                # finishes — drop the vector instead of leaking it until
                # eviction pushes out a live activation's
                GLOBAL_WATERFALL.discard(msg.activation_id.asString)
                raise
            if not blocking:
                return InvokeOutcome(None, msg.activation_id, accepted=True)
            wait = min(wait_override or MAX_BLOCKING_WAIT,
                       action.limits.timeout.seconds + 60.0)
            return await self._wait_for_response(identity, msg, promise, wait)
        finally:
            GLOBAL_TRACER.finish_span(
                transid, {"action": str(action.fully_qualified_name),
                          "activationId": msg.activation_id.asString,
                          "proc": f"controller{self.controller.name}"},
                span=span)

    async def _wait_for_response(self, identity: Identity, msg: ActivationMessage,
                                 promise: asyncio.Future, wait: float
                                 ) -> InvokeOutcome:
        """waitForActivationResponse (:592-658): the result promise raced
        against repeated activation-store polls until the wait window closes.
        Acks travel at-most-once, so a lost ack plus a slow activation write
        must still produce a 200 as long as the record lands in time — a
        single poll (the reference explicitly schedules polls to the
        deadline) would return 202 for that case."""
        deadline = time.monotonic() + wait
        interval = POLL_INTERVAL_MIN
        promise_live = True
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            if promise_live:
                try:
                    activation = await asyncio.wait_for(
                        asyncio.shield(promise), min(interval, remaining))
                    return InvokeOutcome(activation, msg.activation_id,
                                         accepted=False)
                except asyncio.TimeoutError:
                    pass
                except Exception:  # noqa: BLE001 — forced timeout etc: polls remain
                    promise_live = False
            else:
                await asyncio.sleep(min(interval, remaining))
            if time.monotonic() >= deadline:
                break  # the post-loop poll is the single final one
            try:
                activation = await self.activation_store.get(
                    str(identity.namespace.name), msg.activation_id)
                return InvokeOutcome(activation, msg.activation_id,
                                     accepted=False)
            except NoDocumentException:
                pass
            interval = min(interval * 2, POLL_INTERVAL_MAX)
        # window closed: one last poll, then hand back the activation id (202)
        try:
            activation = await self.activation_store.get(
                str(identity.namespace.name), msg.activation_id)
            return InvokeOutcome(activation, msg.activation_id, accepted=False)
        except NoDocumentException:
            return InvokeOutcome(None, msg.activation_id, accepted=True)
