"""Conductor compositions: programmable orchestration actions.

Rebuild of core/controller/.../actions/PrimitiveActions.scala:208-360
(invokeComposition / invokeConductor / invokeComponent): an action annotated
`conductor: true` directs a composition. The controller repeatedly invokes
the conductor; each conductor activation returns
    {"action": <next action to run>, "params": {...}, "state": {...}}
and the controller then runs that component with `params`, feeding its
result (plus the saved `state`) back into the conductor, until the
conductor responds without an `action` field — that response is the
composition's result. Limits (:222-231): at most 2n+1 conductor/component
invocations for a composition of n components (`action_sequence_limit`
bounds n); nesting compositions consumes from the same budget.

The composition's own activation record carries the component activation
ids in its logs and annotations conductor=true, exactly like a sequence.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

from ..core.entity import (ActivationId, ActivationResponse, Identity,
                           Parameters, WhiskAction, WhiskActivation)
from ..core.entity.names import FullyQualifiedEntityName
from ..core.entity.parameters import ParameterValue
from ..database import NoDocumentException
from ..utils.transaction import TransactionId
from .invoke import ActionInvoker, InvokeOutcome, resolve_action


def is_conductor(action: WhiskAction) -> bool:
    return action.annotations.get("conductor") is True


class ConductorInvoker:
    def __init__(self, entity_store, activation_store, action_invoker: ActionInvoker,
                 sequence_limit: int = 50):
        self.entity_store = entity_store
        self.activation_store = activation_store
        self.invoker = action_invoker
        self.sequence_limit = sequence_limit

    async def invoke_composition(self, identity: Identity, conductor: WhiskAction,
                                 payload: Optional[Dict[str, Any]], blocking: bool,
                                 transid: Optional[TransactionId] = None,
                                 cause: Optional[ActivationId] = None,
                                 package_params: Optional[Parameters] = None,
                                 budget: Optional[Dict[str, int]] = None
                                 ) -> InvokeOutcome:
        transid = transid or TransactionId()
        session_aid = ActivationId.generate()
        # 2n+1 invocations max (ref :222-231); `budget` is a SHARED mutable
        # {"left": n} so nested compositions consume from the same allowance
        # (mutually-recursive conductors must not loop forever)
        if budget is None:
            budget = {"left": 2 * self.sequence_limit + 1}
        conductor_params = package_params or Parameters()
        start = time.time()
        logs = []
        duration = 0
        state: Optional[Dict[str, Any]] = None
        params: Dict[str, Any] = dict(payload or {})
        response = ActivationResponse.whisk_error("conductor did not respond")
        current_conductor = conductor

        while budget["left"] > 0:
            budget["left"] -= 1
            # 1. invoke the conductor with (params + saved state)
            cond_payload = dict(params)
            if state is not None:
                cond_payload["$composer"] = state
            outcome = await self.invoker.invoke(
                identity, current_conductor, conductor_params, cond_payload,
                blocking=True, transid=transid, cause=session_aid)
            if outcome.accepted or outcome.activation is None:
                response = ActivationResponse.whisk_error(
                    "conductor activation did not complete in time")
                break
            logs.append(outcome.activation.activation_id.asString)
            duration += outcome.activation.duration or 0
            result = outcome.activation.response.result or {}
            if not outcome.activation.response.is_success:
                response = outcome.activation.response
                break
            next_action = result.get("action")
            state = result.get("state")
            params = result.get("params", {k: v for k, v in result.items()
                                           if k not in ("action", "state", "params")})
            # malformed conductor protocol fields are an APPLICATION error on
            # the composition, never a crash (ref PrimitiveActions rejects
            # non-object params/state with "invalid response")
            if (not isinstance(params, dict)
                    or (state is not None and not isinstance(state, dict))
                    or (next_action is not None
                        and not isinstance(next_action, str))):
                response = ActivationResponse.application_error(
                    "conductor returned an invalid response")
                break
            if not next_action:
                # composition finished: result is params (ref :300-316)
                response = ActivationResponse.success(params)
                break
            if budget["left"] <= 0:
                response = ActivationResponse.application_error(
                    "composition is too long")
                break
            budget["left"] -= 1
            # 2. invoke the chosen component
            try:
                comp_fqn = FullyQualifiedEntityName.parse(next_action).resolve(
                    str(identity.namespace.name))
                comp_action, pkg_params = await resolve_action(
                    self.entity_store, comp_fqn, identity)
            except (NoDocumentException, ValueError):
                response = ActivationResponse.application_error(
                    f"Failed to resolve action with name '{next_action}' during composition")
                break
            if is_conductor(comp_action):
                comp_outcome = await self.invoke_composition(
                    identity, comp_action, params, blocking=True,
                    transid=transid, cause=session_aid,
                    package_params=pkg_params, budget=budget)
            elif comp_action.is_sequence:
                response = ActivationResponse.application_error(
                    "sequences cannot be composition components")
                break
            else:
                comp_outcome = await self.invoker.invoke(
                    identity, comp_action, pkg_params, params, blocking=True,
                    transid=transid, cause=session_aid)
            if comp_outcome.accepted or comp_outcome.activation is None:
                response = ActivationResponse.whisk_error(
                    "component activation did not complete in time")
                break
            logs.append(comp_outcome.activation.activation_id.asString)
            duration += comp_outcome.activation.duration or 0
            comp_result = comp_outcome.activation.response.result
            params = comp_result if isinstance(comp_result, dict) else {}
            if not comp_outcome.activation.response.is_success:
                response = comp_outcome.activation.response
                break
            # loop back into the conductor with the component result

        activation = WhiskActivation(
            namespace=identity.namespace_path, name=conductor.name,
            subject=identity.subject, activation_id=session_aid,
            start=start, end=time.time(), response=response,
            logs=logs, duration=duration, cause=cause,
            version=conductor.version,
            annotations=Parameters({
                "topmost": ParameterValue(cause is None),
                "conductor": ParameterValue(True),
                "kind": ParameterValue(conductor.exec.kind),
                "path": ParameterValue(str(conductor.fully_qualified_name)),
            }))
        await self.activation_store.store(activation, context=identity)
        if blocking:
            return InvokeOutcome(activation, session_aid, accepted=False)
        return InvokeOutcome(None, session_aid, accepted=True)
