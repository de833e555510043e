"""WhiskEntity base: common document fields + doc identity.

Ref: common/scala/.../core/entity/WhiskEntity.scala — every persisted entity
has namespace, name, version, publish, annotations, updated timestamp, and a
document id of the form "namespace/name".
"""
from __future__ import annotations

import time
from typing import Optional

from .ids import DocInfo, DocRevision
from .names import EntityName, EntityPath, FullyQualifiedEntityName
from .parameters import Parameters
from .semver import SemVer


class WhiskEntity:
    collection = "entities"

    def __init__(self, namespace: EntityPath, name: EntityName,
                 version: Optional[SemVer] = None, publish: bool = False,
                 annotations: Optional[Parameters] = None,
                 updated: Optional[float] = None):
        self.namespace = namespace
        self.name = name
        self.version = version or SemVer()
        self.publish = publish
        self.annotations = annotations or Parameters()
        self.updated = updated if updated is not None else time.time()
        self.rev = DocRevision()

    @property
    def docid(self) -> str:
        return f"{self.namespace}/{self.name}"

    @property
    def fully_qualified_name(self) -> FullyQualifiedEntityName:
        return FullyQualifiedEntityName(self.namespace, self.name)

    def docinfo(self) -> DocInfo:
        return DocInfo(self.docid, self.rev)

    def revision(self, rev: DocRevision) -> "WhiskEntity":
        self.rev = rev
        return self

    # -- serde -------------------------------------------------------------
    def base_json(self) -> dict:
        return {
            "namespace": self.namespace.to_json(),
            "name": self.name.to_json(),
            "version": self.version.to_json(),
            "publish": self.publish,
            "annotations": self.annotations.to_json(),
            "updated": int(self.updated * 1000),
        }

    def to_json(self) -> dict:
        raise NotImplementedError

    def to_document(self) -> dict:
        """JSON doc as stored, with entityType discriminator for views."""
        j = self.to_json()
        j["entityType"] = self.collection
        return j
