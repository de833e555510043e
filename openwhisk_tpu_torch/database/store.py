"""ArtifactStore: the persistence abstraction.

Rebuild of common/scala/.../core/database/ArtifactStore.scala:41-150 — an
async document CRUD + view-query + attachment interface. Concrete stores:
memory (tests/standalone, ref MemoryArtifactStore) and sqlite (durable
single-node, the CouchDB-equivalent here); the SPI seam
(`ArtifactStoreProvider`) admits remote/document-DB impls unchanged.

View queries reproduce the reference design-doc views the controller needs
(`whisks.v2.1.0/<collection>`, `activations/byDate`): list entities of a
collection in a namespace, newest first, with skip/limit/since/upto.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple


class ArtifactStoreException(Exception):
    pass


class NoDocumentException(ArtifactStoreException):
    pass


class DocumentConflict(ArtifactStoreException):
    pass


class StaleParameter(ArtifactStoreException):
    pass


class ArtifactStore:
    """Async document store. Documents are JSON dicts with `_id` and `_rev`
    managed by the store; callers hand in entity JSON + doc id."""

    # optional delegation of attachment bytes to a separate AttachmentStore
    # (ref: CouchDbRestStore takes an attachmentStore; reference.conf wires
    # S3AttachmentStoreProvider in that slot)
    attachment_store = None

    def with_attachment_store(self, attachment_store) -> "ArtifactStore":
        self.attachment_store = attachment_store
        return self

    # -- CRUD --------------------------------------------------------------
    async def put(self, doc_id: str, doc: Dict[str, Any],
                  rev: Optional[str] = None) -> str:
        """Insert or update. `rev` must match the stored revision for
        updates (None means insert-new). Returns the new revision.
        Raises DocumentConflict on mismatch (ref ArtifactStore.put)."""
        raise NotImplementedError

    async def get(self, doc_id: str) -> Dict[str, Any]:
        """Fetch a document (with _id/_rev); NoDocumentException if absent."""
        raise NotImplementedError

    async def delete(self, doc_id: str, rev: Optional[str] = None) -> bool:
        """Delete; DocumentConflict if rev given and stale; NoDocumentException
        if absent."""
        raise NotImplementedError

    # -- views -------------------------------------------------------------
    async def query(self, collection: str, namespace: Optional[str] = None,
                    name: Optional[str] = None,
                    since: Optional[float] = None, upto: Optional[float] = None,
                    skip: int = 0, limit: int = 0,
                    descending: bool = True) -> List[Dict[str, Any]]:
        """List documents of `collection` (actions/triggers/rules/packages/
        activations/subjects), filtered by namespace (exact root match) and
        optional entity name, ordered by `updated`."""
        raise NotImplementedError

    async def count(self, collection: str, namespace: Optional[str] = None,
                    name: Optional[str] = None,
                    since: Optional[float] = None, upto: Optional[float] = None
                    ) -> int:
        raise NotImplementedError

    # -- attachments (ref AttachmentStore SPI) -----------------------------
    async def attach(self, doc_id: str, name: str, content_type: str,
                     data: bytes) -> None:
        raise NotImplementedError

    async def read_attachment(self, doc_id: str, name: str) -> Tuple[str, bytes]:
        raise NotImplementedError

    async def delete_attachments(self, doc_id: str,
                                 except_name: Optional[str] = None) -> None:
        """Delete a document's attachments; `except_name` keeps the current
        one (update-time GC of superseded per-put attachment names)."""
        raise NotImplementedError

    async def close(self) -> None:
        if self.attachment_store is not None:
            await self.attachment_store.close()


def match_query(doc: Dict[str, Any], collection: str, namespace: Optional[str],
                name: Optional[str], since: Optional[float],
                upto: Optional[float]) -> bool:
    """Shared view predicate for stores that filter in process."""
    if doc.get("entityType") != collection:
        return False
    if namespace is not None:
        ns = str(doc.get("namespace", ""))
        if ns != namespace and not ns.startswith(namespace + "/"):
            return False
    if name is not None and doc.get("name") != name:
        return False
    ts = doc.get("start", doc.get("updated", 0))
    if since is not None and ts < since:
        return False
    if upto is not None and ts > upto:
        return False
    return True


def sort_key(doc: Dict[str, Any]) -> float:
    return doc.get("start", doc.get("updated", 0)) or 0
