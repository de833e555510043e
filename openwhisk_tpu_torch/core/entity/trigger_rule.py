"""Triggers and rules.

Refs: WhiskTrigger.scala (a trigger doc embeds its rules as a map
rule-fqn -> ReducedRule(action, status)) and WhiskRule.scala (+ Status:
ACTIVE/INACTIVE, docs in core/controller/.../Rules.scala). Firing a trigger
activates every ACTIVE rule's action (Triggers.scala:320-381) — in this
framework via direct internal dispatch, not an HTTP loopback.
"""
from __future__ import annotations

from typing import Dict, Optional

from .entity import WhiskEntity
from .limits import LimitViolation
from .names import EntityName, EntityPath, FullyQualifiedEntityName
from .parameters import Parameters
from .semver import SemVer

ACTIVE = "active"
INACTIVE = "inactive"
_STATUSES = (ACTIVE, INACTIVE)


class Status:
    @staticmethod
    def validate(s: str) -> str:
        if s not in _STATUSES:
            raise LimitViolation(f"invalid rule status {s!r}")
        return s


class ReducedRule:
    __slots__ = ("action", "status")

    def __init__(self, action: FullyQualifiedEntityName, status: str = ACTIVE):
        self.action = action
        self.status = Status.validate(status)

    def to_json(self):
        return {"action": str(self.action), "status": self.status}

    @classmethod
    def from_json(cls, j):
        return cls(FullyQualifiedEntityName.parse(j["action"]), j.get("status", ACTIVE))


class WhiskTrigger(WhiskEntity):
    collection = "triggers"

    def __init__(self, namespace: EntityPath, name: EntityName,
                 parameters: Optional[Parameters] = None,
                 rules: Optional[Dict[str, ReducedRule]] = None,
                 version: Optional[SemVer] = None, publish: bool = False,
                 annotations: Optional[Parameters] = None,
                 updated: Optional[float] = None):
        super().__init__(namespace, name, version, publish, annotations, updated)
        self.parameters = parameters or Parameters()
        self.rules = dict(rules or {})

    def add_rule(self, rule_fqn: str, rule: ReducedRule) -> "WhiskTrigger":
        self.rules[rule_fqn] = rule
        return self

    def remove_rule(self, rule_fqn: str) -> "WhiskTrigger":
        self.rules.pop(rule_fqn, None)
        return self

    def to_json(self) -> dict:
        j = self.base_json()
        j["parameters"] = self.parameters.to_json()
        j["rules"] = {k: r.to_json() for k, r in self.rules.items()}
        return j

    @classmethod
    def from_json(cls, j: dict) -> "WhiskTrigger":
        return cls(
            EntityPath(j["namespace"]), EntityName(j["name"]),
            Parameters.from_json(j.get("parameters")),
            {k: ReducedRule.from_json(r) for k, r in j.get("rules", {}).items()},
            SemVer.from_string(j.get("version", "0.0.1")),
            bool(j.get("publish", False)),
            Parameters.from_json(j.get("annotations")),
            (j.get("updated", 0) / 1000.0) or None,
        )


class WhiskRule(WhiskEntity):
    collection = "rules"

    def __init__(self, namespace: EntityPath, name: EntityName,
                 trigger: FullyQualifiedEntityName, action: FullyQualifiedEntityName,
                 version: Optional[SemVer] = None, publish: bool = False,
                 annotations: Optional[Parameters] = None,
                 updated: Optional[float] = None):
        super().__init__(namespace, name, version, publish, annotations, updated)
        self.trigger = trigger
        self.action = action

    def to_json(self) -> dict:
        j = self.base_json()
        j["trigger"] = str(self.trigger)
        j["action"] = str(self.action)
        return j

    @classmethod
    def from_json(cls, j: dict) -> "WhiskRule":
        return cls(
            EntityPath(j["namespace"]), EntityName(j["name"]),
            FullyQualifiedEntityName.parse(j["trigger"]),
            FullyQualifiedEntityName.parse(j["action"]),
            SemVer.from_string(j.get("version", "0.0.1")),
            bool(j.get("publish", False)),
            Parameters.from_json(j.get("annotations")),
            (j.get("updated", 0) / 1000.0) or None,
        )
