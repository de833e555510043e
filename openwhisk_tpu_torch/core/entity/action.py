"""Actions: the deployable unit of compute.

Ref: common/scala/.../core/entity/WhiskAction.scala — WhiskAction carries the
exec (code), parameters, limits; ExecutableWhiskAction is the invoker-side
projection guaranteed to have runnable code (sequences excluded); the
*MetaData variants strip code bodies for the control plane.
"""
from __future__ import annotations

from typing import Optional

from .entity import WhiskEntity
from .exec import CodeExec, Exec, ExecMetaData, SequenceExec
from .limits import ActionLimits
from .names import EntityName, EntityPath
from .parameters import Parameters
from .semver import SemVer


class WhiskAction(WhiskEntity):
    collection = "actions"

    def __init__(self, namespace: EntityPath, name: EntityName, exec: Exec,
                 parameters: Optional[Parameters] = None,
                 limits: Optional[ActionLimits] = None,
                 version: Optional[SemVer] = None, publish: bool = False,
                 annotations: Optional[Parameters] = None,
                 updated: Optional[float] = None):
        super().__init__(namespace, name, version, publish, annotations, updated)
        self.exec = exec
        self.parameters = parameters or Parameters()
        self.limits = limits or ActionLimits()

    @property
    def is_sequence(self) -> bool:
        return isinstance(self.exec, SequenceExec)

    def to_executable(self) -> Optional["ExecutableWhiskAction"]:
        """Project to the invoker-side executable form; None for sequences
        (ref WhiskAction.toExecutableWhiskAction)."""
        if self.is_sequence:
            return None
        return ExecutableWhiskAction(
            self.namespace, self.name, self.exec, self.parameters, self.limits,
            self.version, self.publish, self.annotations, self.updated,
        ).revision(self.rev)

    def exec_metadata(self) -> ExecMetaData:
        return ExecMetaData.of(self.exec)

    def to_json(self) -> dict:
        j = self.base_json()
        j["exec"] = self.exec.to_json()
        j["parameters"] = self.parameters.to_json()
        j["limits"] = self.limits.to_json()
        return j

    @classmethod
    def from_json(cls, j: dict) -> "WhiskAction":
        a = cls(
            EntityPath(j["namespace"]), EntityName(j["name"]),
            Exec.from_json(j["exec"]),
            Parameters.from_json(j.get("parameters")),
            ActionLimits.from_json(j.get("limits")),
            SemVer.from_string(j.get("version", "0.0.1")),
            bool(j.get("publish", False)),
            Parameters.from_json(j.get("annotations")),
            (j.get("updated", 0) / 1000.0) or None,
        )
        return a


class ExecutableWhiskAction(WhiskAction):
    """An action guaranteed to carry runnable (non-sequence) code."""

    def __init__(self, namespace, name, exec, parameters=None, limits=None,
                 version=None, publish=False, annotations=None, updated=None):
        if isinstance(exec, SequenceExec):
            raise ValueError("sequence exec is not executable")
        super().__init__(namespace, name, exec, parameters, limits, version,
                         publish, annotations, updated)

    def container_initializer(self, env: Optional[dict] = None) -> dict:
        """The /init payload for the action container
        (ref WhiskAction.containerInitializer)."""
        e = self.exec
        payload = {
            "name": str(self.name),
            "main": getattr(e, "main", None) or "main",
            "code": getattr(e, "code", "") or "",
            "binary": getattr(e, "binary", False),
        }
        if env:
            payload["env"] = env
        return payload
