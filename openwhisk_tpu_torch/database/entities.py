"""Typed entity store: cached CRUD over the ArtifactStore.

Rebuild of the WhiskEntityStore/WhiskAuthStore helpers
(common/scala/.../core/entity/WhiskStore.scala): typed get/put/delete with a
revision-keyed read-through cache and cross-instance invalidation hooks —
the controller's view of persistence (SURVEY §3.5).
"""
from __future__ import annotations

import uuid
from typing import Callable, List, Optional, Type

from ..core.entity import (Identity, WhiskAction, WhiskActivation, WhiskEntity,
                           WhiskAuthRecord, WhiskPackage, WhiskRule, WhiskTrigger)
from ..core.entity.ids import DocRevision
from .cache import EntityCache
from .store import ArtifactStore, NoDocumentException

_TYPES = {
    "actions": WhiskAction,
    "triggers": WhiskTrigger,
    "rules": WhiskRule,
    "packages": WhiskPackage,
}


def _rev_older_than(cached: Optional[str], routed: str) -> bool:
    """True when `cached` is an older document revision than `routed`.
    Revisions are couch-style "gen-digest" strings across all stores
    (sqlite_store.py:92, memory/couchdb alike); compare the generation.
    Unparsable revisions fall back to plain inequality — conservative: every
    mismatching message reloads, so a store with opaque revs trades the cache
    for correctness."""
    if cached == routed:
        return False
    try:
        return int((cached or "0").split("-", 1)[0]) < int(routed.split("-", 1)[0])
    except (ValueError, AttributeError):
        return True


class EntityStore:
    # action code above this inlining threshold is stored as an attachment
    # (ref WhiskAction CodeExecAsAttachment + AttachmentStore SPI)
    ATTACHMENT_THRESHOLD = 64 * 1024

    def __init__(self, store: ArtifactStore, cache: Optional[EntityCache] = None,
                 on_invalidate: Optional[Callable] = None):
        self.store = store
        self.cache = cache if cache is not None else EntityCache()
        self.on_invalidate = on_invalidate  # async (key) -> None, bus notify

    async def _notify(self, key: str) -> None:
        if self.on_invalidate is not None:
            await self.on_invalidate(key)

    async def put(self, entity: WhiskEntity) -> DocRevision:
        doc = entity.to_document()
        attachment = None
        attachment_name = None
        exec_json = doc.get("exec")
        if isinstance(exec_json, dict):
            code = exec_json.get("code")
            if isinstance(code, str) and len(code) > self.ATTACHMENT_THRESHOLD:
                attachment = code.encode()
                # unique name per put (ref: per-revision "sha-..." names): a
                # concurrent loser's attachment write must never be paired
                # with the winner's document stub. Orphans are reaped by
                # delete_attachments on entity delete.
                attachment_name = f"codefile-{uuid.uuid4().hex[:12]}"
                exec_json["code"] = {"attachmentName": attachment_name,
                                     "attachmentType": "text/plain"}
        # attachment FIRST: a reader (or crash) between the two writes must
        # never see a stub document whose attachment does not exist yet
        if attachment is not None:
            await self.store.attach(entity.docid, attachment_name,
                                    "text/plain", attachment)
        rev = await self.store.put(entity.docid, doc,
                                   entity.rev.rev if not entity.rev.empty else None)
        entity.rev = DocRevision(rev)
        if attachment is not None:
            # GC superseded per-put attachments now that this put WON the
            # revision race (losers must never delete the winner's bytes)
            await self.store.delete_attachments(entity.docid,
                                                except_name=attachment_name)
        self.cache.update(entity.docid, entity)
        await self._notify(entity.docid)
        return entity.rev

    async def get(self, cls: Type, doc_id: str, use_cache: bool = True,
                  rev: Optional[str] = None):
        """Typed read-through get. When `rev` is given and the cached entity's
        revision generation is OLDER than the routed one, the entry is
        reloaded (ref InvokerReactive.scala:244-258 / WhiskStore get-by-rev:
        the invoker must never execute an older revision than the controller
        routed; stores serve latest, which is never older than the routed
        rev). A cached entry at the SAME or a newer generation is served as-is
        — a backlog of old-rev activations draining after an update must not
        thrash the cache with one store read per message."""
        async def materialize(doc):
            exec_json = doc.get("exec")
            if isinstance(exec_json, dict) and isinstance(exec_json.get("code"), dict):
                _, data = await self.store.read_attachment(
                    doc_id, exec_json["code"].get("attachmentName", "codefile"))
                exec_json["code"] = data.decode()
            ent = cls.from_json(doc)
            ent.rev = DocRevision(doc.get("_rev"))
            return ent

        async def load():
            doc = await self.store.get(doc_id)  # missing doc: raise directly
            try:
                return await materialize(doc)
            except NoDocumentException:
                # a concurrent update GC'd the attachment our stale stub
                # named — the re-fetched doc names the current attachment
                doc = await self.store.get(doc_id)
                return await materialize(doc)

        if use_cache:
            ent = await self.cache.get_or_load(doc_id, load)
            if rev and _rev_older_than(ent.rev.rev, rev):
                self.cache.invalidate(doc_id)
                ent = await self.cache.get_or_load(doc_id, load)
            return ent
        return await load()

    async def get_action(self, doc_id: str, rev: Optional[str] = None
                         ) -> WhiskAction:
        return await self.get(WhiskAction, doc_id, rev=rev)

    async def get_trigger(self, doc_id: str) -> WhiskTrigger:
        return await self.get(WhiskTrigger, doc_id)

    async def get_rule(self, doc_id: str) -> WhiskRule:
        return await self.get(WhiskRule, doc_id)

    async def get_package(self, doc_id: str) -> WhiskPackage:
        return await self.get(WhiskPackage, doc_id)

    async def delete(self, entity: WhiskEntity) -> bool:
        ok = await self.store.delete(entity.docid,
                                     entity.rev.rev if not entity.rev.empty else None)
        self.cache.invalidate(entity.docid)
        await self.store.delete_attachments(entity.docid)
        await self._notify(entity.docid)
        return ok

    async def list(self, collection: str, namespace: str, skip: int = 0,
                   limit: int = 30, descending: bool = True) -> List[dict]:
        return await self.store.query(collection, namespace, skip=skip,
                                      limit=limit, descending=descending)

    def entity_class(self, collection: str) -> Type:
        return _TYPES[collection]


class AuthStore:
    """Subject/identity store (ref WhiskAuthStore + Identity views).

    Identities are looked up by (a) basic-auth uuid:key on every request and
    (b) namespace name for package resolution; both paths are cached.
    """

    COLLECTION = "subjects"

    def __init__(self, store: ArtifactStore, cache: Optional[EntityCache] = None):
        self.store = store
        self.cache = cache if cache is not None else EntityCache(ttl_seconds=60)

    async def put(self, record: WhiskAuthRecord) -> None:
        doc = record.to_json()
        doc["entityType"] = self.COLLECTION
        doc["namespace"] = str(record.subject)
        doc["name"] = str(record.subject)
        doc["updated"] = 0
        try:
            existing = await self.store.get(f"subject/{record.subject}")
            rev = existing.get("_rev")
        except NoDocumentException:
            rev = None
        await self.store.put(f"subject/{record.subject}", doc, rev)
        for ident in record.identities():
            self.cache.update(f"uuid/{ident.authkey.uuid.asString}", ident)
            self.cache.update(f"ns/{ident.namespace.name}", ident)

    async def identity_by_key(self, uuid: str, key: str) -> Optional[Identity]:
        ident = await self._find("uuid/" + uuid,
                                 lambda i: i.authkey.uuid.asString == uuid)
        if ident is not None and ident.authkey.key.asString == key:
            return ident
        return None

    async def identity_by_namespace(self, namespace: str) -> Optional[Identity]:
        return await self._find("ns/" + namespace,
                                lambda i: str(i.namespace.name) == namespace)

    async def _find(self, cache_key: str, pred) -> Optional[Identity]:
        async def load():
            docs = await self.store.query(self.COLLECTION)
            for d in docs:
                rec = WhiskAuthRecord.from_json(d)
                if rec.blocked:
                    continue
                for ident in rec.identities():
                    if pred(ident):
                        return ident
            return None

        try:
            return await self.cache.get_or_load(cache_key, load)
        except NoDocumentException:
            return None

    async def subjects(self) -> List[WhiskAuthRecord]:
        docs = await self.store.query(self.COLLECTION)
        return [WhiskAuthRecord.from_json(d) for d in docs]
