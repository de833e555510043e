"""Packages and package bindings.

Ref: WhiskPackage.scala — a package groups actions and carries parameters
that are inherited by its actions at invoke time; a *binding* is a package
document whose `binding` field references another package (possibly in
another namespace), layering its own parameters on top
(parameter precedence: provider package < binding < action < invoke payload,
ref Packages.scala `mergePackageWithBinding`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .entity import WhiskEntity
from .names import EntityName, EntityPath, FullyQualifiedEntityName
from .parameters import Parameters
from .semver import SemVer


@dataclass(frozen=True)
class Binding:
    namespace: EntityPath
    name: EntityName

    @property
    def fqn(self) -> FullyQualifiedEntityName:
        return FullyQualifiedEntityName(self.namespace, self.name)

    def to_json(self):
        return {"namespace": str(self.namespace), "name": str(self.name)}

    @classmethod
    def from_json(cls, j) -> "Binding":
        return cls(EntityPath(j["namespace"]), EntityName(j["name"]))


class WhiskPackage(WhiskEntity):
    collection = "packages"

    def __init__(self, namespace: EntityPath, name: EntityName,
                 binding: Optional[Binding] = None,
                 parameters: Optional[Parameters] = None,
                 version: Optional[SemVer] = None, publish: bool = False,
                 annotations: Optional[Parameters] = None,
                 updated: Optional[float] = None):
        super().__init__(namespace, name, version, publish, annotations, updated)
        self.binding = binding
        self.parameters = parameters or Parameters()

    @property
    def is_binding(self) -> bool:
        return self.binding is not None

    def to_json(self) -> dict:
        j = self.base_json()
        j["binding"] = self.binding.to_json() if self.binding else {}
        j["parameters"] = self.parameters.to_json()
        return j

    @classmethod
    def from_json(cls, j: dict) -> "WhiskPackage":
        b = j.get("binding") or {}
        return cls(
            EntityPath(j["namespace"]), EntityName(j["name"]),
            Binding.from_json(b) if b else None,
            Parameters.from_json(j.get("parameters")),
            SemVer.from_string(j.get("version", "0.0.1")),
            bool(j.get("publish", False)),
            Parameters.from_json(j.get("annotations")),
            (j.get("updated", 0) / 1000.0) or None,
        )
