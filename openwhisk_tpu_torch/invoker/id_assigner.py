"""Stable invoker-id assignment without Zookeeper.
A copy of `openwhisk_tpu/invoker/id_assigner.py`.

Rebuild of core/invoker/.../InstanceIdAssigner.scala — the reference CASes a
Curator SharedCount at /invokers/idAssignment to give each `uniqueName` a
stable id across restarts. Here the same CAS loop runs against the
ArtifactStore's revisioned document semantics: the assignment map lives in
one document; concurrent assigners conflict on the revision and retry.
"""
from __future__ import annotations

import asyncio

from ..database import ArtifactStore, DocumentConflict, NoDocumentException

DOC_ID = "system/invokerIdAssignment"


class InstanceIdAssigner:
    def __init__(self, store: ArtifactStore):
        self.store = store

    async def assign(self, unique_name: str, overwrite_id: int = None) -> int:
        """Return the stable id for unique_name, allocating the next free id
        on first sight (CAS retry loop on conflicting writers)."""
        for _ in range(50):
            try:
                doc = await self.store.get(DOC_ID)
                rev = doc.get("_rev")
            except NoDocumentException:
                doc = {"entityType": "system", "namespace": "system",
                       "name": "invokerIdAssignment", "updated": 0,
                       "assignments": {}, "next": 0}
                rev = None
            assignments = doc.get("assignments", {})
            if overwrite_id is not None:
                assigned = overwrite_id
                if assignments.get(unique_name) == assigned:
                    return assigned
                assignments[unique_name] = assigned
                doc["next"] = max(doc.get("next", 0), assigned + 1)
            elif unique_name in assignments:
                return assignments[unique_name]
            else:
                assigned = doc.get("next", 0)
                assignments[unique_name] = assigned
                doc["next"] = assigned + 1
            doc["assignments"] = assignments
            doc.pop("_rev", None)
            doc.pop("_id", None)
            try:
                await self.store.put(DOC_ID, doc, rev)
                return assigned
            except DocumentConflict:
                await asyncio.sleep(0.01)  # lost the race: re-read and retry
        raise RuntimeError("could not assign an invoker id (CAS contention)")
