"""In-memory ArtifactStore (ref common/scala/.../database/memory/
MemoryArtifactStore.scala) — used by tests and standalone mode."""
from __future__ import annotations

import asyncio
import copy
from typing import Any, Dict, List, Optional, Tuple

from .store import (ArtifactStore, DocumentConflict, NoDocumentException,
                    match_query, sort_key)


class MemoryArtifactStore(ArtifactStore):
    def __init__(self):
        self._docs: Dict[str, Dict[str, Any]] = {}
        self._attachments: Dict[str, Dict[str, Tuple[str, bytes]]] = {}
        self._lock = asyncio.Lock()

    def _put_locked(self, doc_id: str, doc: Dict[str, Any],
                    rev: Optional[str] = None) -> str:
        existing = self._docs.get(doc_id)
        if existing is not None:
            cur = existing["_rev"]
            if rev is None or rev != cur:
                raise DocumentConflict(f"document {doc_id!r} update conflict")
            new_rev = f"{int(cur.split('-')[0]) + 1}-mem"
        else:
            if rev is not None:
                raise DocumentConflict(f"document {doc_id!r} does not exist at rev {rev}")
            new_rev = "1-mem"
        stored = copy.deepcopy(doc)
        stored["_id"] = doc_id
        stored["_rev"] = new_rev
        self._docs[doc_id] = stored
        return new_rev

    async def put(self, doc_id: str, doc: Dict[str, Any],
                  rev: Optional[str] = None) -> str:
        async with self._lock:
            return self._put_locked(doc_id, doc, rev)

    async def put_many(self, docs: List[Tuple[str, Dict[str, Any]]]) -> List[str]:
        """Bulk insert for the activation-record batcher: one lock acquire
        for N new documents, same per-document conflict semantics as put()
        (a mid-batch conflict fails the whole batch, exactly like the
        serial loop the batcher would otherwise run)."""
        async with self._lock:
            return [self._put_locked(doc_id, doc) for doc_id, doc in docs]

    async def get(self, doc_id: str) -> Dict[str, Any]:
        doc = self._docs.get(doc_id)
        if doc is None:
            raise NoDocumentException(doc_id)
        return copy.deepcopy(doc)

    async def delete(self, doc_id: str, rev: Optional[str] = None) -> bool:
        async with self._lock:
            doc = self._docs.get(doc_id)
            if doc is None:
                raise NoDocumentException(doc_id)
            if rev is not None and doc["_rev"] != rev:
                raise DocumentConflict(f"document {doc_id!r} delete conflict")
            del self._docs[doc_id]
            self._attachments.pop(doc_id, None)
            return True

    async def query(self, collection: str, namespace: Optional[str] = None,
                    name: Optional[str] = None,
                    since: Optional[float] = None, upto: Optional[float] = None,
                    skip: int = 0, limit: int = 0,
                    descending: bool = True) -> List[Dict[str, Any]]:
        docs = [d for d in self._docs.values()
                if match_query(d, collection, namespace, name, since, upto)]
        docs.sort(key=sort_key, reverse=descending)
        if skip:
            docs = docs[skip:]
        if limit:
            docs = docs[:limit]
        return copy.deepcopy(docs)

    async def count(self, collection: str, namespace: Optional[str] = None,
                    name: Optional[str] = None,
                    since: Optional[float] = None, upto: Optional[float] = None
                    ) -> int:
        return len([d for d in self._docs.values()
                    if match_query(d, collection, namespace, name, since, upto)])

    async def attach(self, doc_id: str, name: str, content_type: str,
                     data: bytes) -> None:
        if self.attachment_store is not None:
            return await self.attachment_store.attach(doc_id, name,
                                                      content_type, data)
        self._attachments.setdefault(doc_id, {})[name] = (content_type, bytes(data))

    async def read_attachment(self, doc_id: str, name: str) -> Tuple[str, bytes]:
        if self.attachment_store is not None:
            return await self.attachment_store.read_attachment(doc_id, name)
        try:
            return self._attachments[doc_id][name]
        except KeyError:
            raise NoDocumentException(f"attachment {doc_id}/{name}") from None

    async def delete_attachments(self, doc_id: str,
                                 except_name: Optional[str] = None) -> None:
        if self.attachment_store is not None:
            return await self.attachment_store.delete_attachments(
                doc_id, except_name=except_name)
        if except_name is None:
            self._attachments.pop(doc_id, None)
        elif doc_id in self._attachments:
            self._attachments[doc_id] = {
                k: v for k, v in self._attachments[doc_id].items()
                if k == except_name}


class MemoryArtifactStoreProvider:
    """SPI factory (ref ArtifactStoreProvider)."""

    @staticmethod
    def make_store(name: str = "whisks", **kwargs) -> MemoryArtifactStore:
        return MemoryArtifactStore()
