"""Action sequences: chained invocation of component actions.

Rebuild of core/controller/.../actions/SequenceActions.scala:89-249 — a
sequence executes its components in order, each component's result becoming
the next component's payload; the sequence's own activation record
accumulates the component activation ids as logs, sums durations, and adopts
the last component's response (or the first failing one's — execution stops
at the first non-success, :150-249). Components carry `cause` = the sequence
activation id. Nested sequences count against `action_sequence_limit`.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

from ..core.entity import (ActivationId, ActivationResponse, Identity,
                           Parameters, WhiskAction, WhiskActivation)
from ..core.entity.parameters import ParameterValue
from ..database import NoDocumentException
from ..utils.transaction import TransactionId
from .invoke import ActionInvoker, InvokeOutcome, resolve_action


class TooManyActionsInSequence(Exception):
    pass


class SequenceInvoker:
    def __init__(self, entity_store, activation_store, action_invoker: ActionInvoker,
                 controller_instance, sequence_limit: int = 50,
                 conductor=None):
        self.entity_store = entity_store
        self.activation_store = activation_store
        self.invoker = action_invoker
        self.controller = controller_instance
        self.sequence_limit = sequence_limit
        self.conductor = conductor  # ConductorInvoker, wired by the controller

    async def invoke_sequence(self, identity: Identity, action: WhiskAction,
                              payload: Optional[Dict[str, Any]], blocking: bool,
                              transid: Optional[TransactionId] = None,
                              cause: Optional[ActivationId] = None,
                              components_budget: Optional[Dict[str, int]] = None
                              ) -> InvokeOutcome:
        """`components_budget` is a shared mutable {"left": n} so nested
        sequences deduct from the SAME budget — the reference threads
        atomicActionCnt through SequenceAccounting (SequenceActions.scala:
        248-281) for exactly this runaway-composition guard."""
        transid = transid or TransactionId()
        seq_aid = ActivationId.generate()
        budget = components_budget if components_budget is not None \
            else {"left": self.sequence_limit}
        start = time.time()
        current: Dict[str, Any] = dict(payload or {})
        component_ids = []
        response = ActivationResponse.success({})
        total_duration = 0

        for comp_fqn in action.exec.components:
            if budget["left"] <= 0:
                response = ActivationResponse.application_error(
                    "sequence composition is too long")
                break
            budget["left"] -= 1
            resolved = comp_fqn.resolve(str(identity.namespace.name))
            try:
                comp_action, pkg_params = await resolve_action(
                    self.entity_store, resolved, identity)
            except NoDocumentException:
                response = ActivationResponse.whisk_error(
                    f"Sequence component '{resolved}' does not exist.")
                break
            from .conductors import is_conductor
            if comp_action.is_sequence:
                outcome = await self.invoke_sequence(
                    identity, comp_action, current, blocking=True,
                    transid=transid, cause=seq_aid,
                    components_budget=budget)  # shared: nested use counts
            elif self.conductor is not None and is_conductor(comp_action):
                # conductor components drive the composition loop, sharing
                # this sequence's budget so nesting stays bounded
                outcome = await self.conductor.invoke_composition(
                    identity, comp_action, current, blocking=True,
                    transid=transid, cause=seq_aid,
                    package_params=pkg_params, budget=budget)
            else:
                outcome = await self.invoker.invoke(
                    identity, comp_action, pkg_params, current, blocking=True,
                    transid=transid, cause=seq_aid)
            if outcome.accepted or outcome.activation is None:
                response = ActivationResponse.whisk_error(
                    "Sequence component did not complete in time.")
                break
            activation = outcome.activation
            component_ids.append(activation.activation_id.asString)
            total_duration += activation.duration or 0
            response = activation.response
            if not activation.response.is_success:
                break  # stop at first failure (ref :150-249)
            current = activation.response.result if isinstance(
                activation.response.result, dict) else {}

        end = time.time()
        seq_activation = WhiskActivation(
            namespace=identity.namespace_path, name=action.name,
            subject=identity.subject, activation_id=seq_aid,
            start=start, end=end, response=response,
            logs=component_ids, duration=total_duration, cause=cause,
            version=action.version,
            annotations=Parameters({
                "topmost": ParameterValue(cause is None),
                "kind": ParameterValue("sequence"),
                "path": ParameterValue(str(action.fully_qualified_name)),
            }))
        await self.activation_store.store(seq_activation, context=identity)
        if blocking:
            return InvokeOutcome(seq_activation, seq_aid, accepted=False)
        return InvokeOutcome(None, seq_aid, accepted=True)
