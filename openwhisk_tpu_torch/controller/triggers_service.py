"""Trigger firing: activate every ACTIVE rule's action.

Rebuild of core/controller/.../controller/Triggers.scala:320-412 — the
reference loops an authenticated HTTP POST back into its own actions API
(a noted TODO in its source); here rule dispatch is direct and in-process.
The trigger's activation record collects per-rule outcomes in its logs.
"""
from __future__ import annotations

import asyncio
import time
from typing import Any, Dict, Optional

from ..core.entity import (ACTIVE, ActivationId, ActivationResponse, Identity,
                           Parameters, WhiskActivation, WhiskTrigger)
from ..database import NoDocumentException
from ..utils.transaction import TransactionId
from .conductors import is_conductor
from .invoke import resolve_action


class TriggerService:
    def __init__(self, entity_store, activation_store, action_invoker,
                 sequencer=None, conductor=None):
        self.entity_store = entity_store
        self.activation_store = activation_store
        self.invoker = action_invoker
        self.sequencer = sequencer
        self.conductor = conductor

    async def fire(self, identity: Identity, trigger: WhiskTrigger,
                   payload: Optional[Dict[str, Any]],
                   transid: Optional[TransactionId] = None
                   ) -> Optional[ActivationId]:
        """Returns the trigger's activation id, or None when no rules are
        active (reference answers 204 NoContent in that case)."""
        transid = transid or TransactionId()
        active_rules = {name: r for name, r in trigger.rules.items()
                        if r.status == ACTIVE}
        if not active_rules:
            return None
        aid = ActivationId.generate()
        start = time.time()
        args = trigger.parameters.merge(
            Parameters.from_arguments(payload or {})).to_arguments()
        results = await asyncio.gather(
            *[self._fire_rule(identity, name, rule, args, aid, transid)
              for name, rule in active_rules.items()])
        activation = WhiskActivation(
            namespace=identity.namespace_path, name=trigger.name,
            subject=identity.subject, activation_id=aid,
            start=start, end=time.time(),
            response=ActivationResponse.success(args),
            logs=[r for r in results],
            version=trigger.version)
        await self.activation_store.store(activation, context=identity)
        return aid

    async def _fire_rule(self, identity, rule_name, rule, args, cause, transid) -> str:
        import json

        try:
            action, pkg_params = await resolve_action(
                self.entity_store, rule.action.resolve(str(identity.namespace.name)),
                identity)
            if action.is_sequence and self.sequencer is not None:
                outcome = await self.sequencer.invoke_sequence(
                    identity, action, args, blocking=False, transid=transid,
                    cause=cause)
            elif self.conductor is not None and is_conductor(action):
                outcome = await self.conductor.invoke_composition(
                    identity, action, args, blocking=False, transid=transid,
                    cause=cause, package_params=pkg_params)
            else:
                outcome = await self.invoker.invoke(
                    identity, action, pkg_params, args, blocking=False,
                    transid=transid, cause=cause)
            return json.dumps({"statusCode": 0, "success": True,
                               "activationId": outcome.activation_id.asString,
                               "rule": rule_name,
                               "action": str(rule.action)})
        except NoDocumentException:
            return json.dumps({"statusCode": 1, "success": False,
                               "error": f"action '{rule.action}' does not exist",
                               "rule": rule_name})
        except Exception as e:  # noqa: BLE001 — a failing rule must not fail the fire
            return json.dumps({"statusCode": 1, "success": False,
                               "error": str(e), "rule": rule_name})
