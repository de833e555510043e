"""Azure Cosmos DB (SQL API) REST ArtifactStore.
A copy of `openwhisk_tpu/database/cosmosdb_store.py`.

Rebuild of common/scala/.../core/database/cosmosdb/CosmosDBArtifactStore.scala
(+ its ~9 support files) as a direct REST client — no SDK dependency, the
same way the S3 attachment store speaks SigV4 from the spec. Design points
carried over from the reference rather than translated:

  - **Computed query fields, not views.** CouchDB serves list queries from
    map/reduce views; Cosmos has no views, so the reference's Cosmos store
    stamps computed properties on every document at write time and queries
    them with SQL. Same here: `_c` (the entityType/collection), `_nsroot`
    (root namespace) and `_sort` (start || updated || 0 — the view's
    timestamp key) are written with each document, and list queries are
    parameterized SQL over exactly those fields, `ORDER BY c._sort`.
  - **MVCC via _etag.** Cosmos's optimistic concurrency is the `_etag`
    system property + `If-Match`; the store surfaces it as the contract's
    opaque `_rev`. Blind create of an existing id → 409 → DocumentConflict;
    replace with a stale etag → 412 → DocumentConflict (a replace aimed at
    a vanished id is also a conflict, matching the CouchDB store).
  - **Partitioning.** The container is created with partition key
    `/_nsroot`: one tenant's entities and activations co-locate (the
    per-namespace queries every API call makes are single-partition);
    admin cross-namespace queries set the documented
    `x-ms-documentdb-query-enablecrosspartition` header.
  - **Attachments** live on base64 sidecar documents (`att|…`), same
    sidecar scheme as the CouchDB store. Cosmos caps documents at 2 MB, so
    deployments with large action code should pair this store with the S3
    AttachmentStore (`with_attachment_store`) exactly as the reference
    pairs CosmosDB with S3 — the sidecar covers the standalone/dev case.

Auth is the documented master-key scheme ("Access control in the Azure
Cosmos DB SQL API"): per request,
  sig = base64(HMAC-SHA256(base64decode(key),
        lower(verb) + "\\n" + lower(resourceType) + "\\n" + resourceLink
        + "\\n" + lower(rfc1123-date) + "\\n" + "" + "\\n"))
sent as `Authorization: type=master&ver=1.0&sig=<urlencoded sig>` with
`x-ms-date` and `x-ms-version: 2018-12-31`.

Document ids: Cosmos forbids '/', '\\', '?', '#' in ids, and entity ids
are slash-separated paths — ids are stored with '/' mapped to '|' (a
character ENTITY_NAME_RX can never produce), and `_id` is restored on
read.

Contract-tested as the fifth backend of test_database.py's store-contract
fixture against a faithful in-process emulator (tests/fake_cosmosdb.py)
that RECOMPUTES and verifies the auth signature of every request and
implements the documented status-code semantics; Cosmos-specific behavior
(signing, id mapping, continuation paging, sidecars) in
tests/test_cosmosdb_store.py.
"""
from __future__ import annotations

import base64
import hashlib
import hmac
import json
from email.utils import formatdate
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import quote

import aiohttp

from .store import (ArtifactStore, ArtifactStoreException, DocumentConflict,
                    NoDocumentException)

API_VERSION = "2018-12-31"


def _encode_id(doc_id: str) -> str:
    return doc_id.replace("/", "|")


def _decode_id(enc: str) -> str:
    return enc.replace("|", "/")


def _root_of_id(doc_id: str) -> str:
    """The partition root, derived from the id ALONE so every operation
    (write, point-read, delete) computes the same partition key without
    the document body in hand. Entity/activation ids start with their
    root namespace; attachment sidecars (`att:<parent-id>/<name>` — ':'
    cannot appear in entity ids, so the prefix can never collide with a
    user namespace, same scheme as the CouchDB store) ride in their
    parent's partition."""
    if doc_id.startswith("att:"):
        doc_id = doc_id[len("att:"):]
    return doc_id.split("/")[0]


class CosmosDbArtifactStore(ArtifactStore):
    def __init__(self, url: str, key: str, db: str = "whisks",
                 container: str = "whisks"):
        self.base = url.rstrip("/")
        self._key = base64.b64decode(key)
        self.db = db
        self.container = container
        self._session: Optional[aiohttp.ClientSession] = None
        self._ensured = False

    # -- auth (documented master-key scheme) -------------------------------
    def _headers(self, verb: str, resource_type: str, resource_link: str,
                 extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
        date = formatdate(usegmt=True)
        string_to_sign = (f"{verb.lower()}\n{resource_type.lower()}\n"
                          f"{resource_link}\n{date.lower()}\n\n")
        sig = base64.b64encode(hmac.new(
            self._key, string_to_sign.encode(), hashlib.sha256).digest()
        ).decode()
        headers = {
            "Authorization": quote(f"type=master&ver=1.0&sig={sig}", safe=""),
            "x-ms-date": date,
            "x-ms-version": API_VERSION,
        }
        headers.update(extra or {})
        return headers

    def _http(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession()
        return self._session

    @property
    def _coll_link(self) -> str:
        return f"dbs/{self.db}/colls/{self.container}"

    def _doc_link(self, enc_id: str) -> str:
        return f"{self._coll_link}/docs/{enc_id}"

    @staticmethod
    def _pk_header(nsroot: str) -> Dict[str, str]:
        return {"x-ms-documentdb-partitionkey": json.dumps([nsroot])}

    # -- bootstrap ---------------------------------------------------------
    async def ensure(self) -> None:
        """Create database + container (idempotent: 409 = exists), the
        container partitioned by /_nsroot."""
        h = self._headers("post", "dbs", "")
        async with self._http().post(f"{self.base}/dbs", headers=h,
                                     json={"id": self.db}) as r:
            if r.status not in (201, 409):
                raise ArtifactStoreException(
                    f"cannot create database {self.db}: {r.status} "
                    f"{(await r.text())[:256]}")
        h = self._headers("post", "colls", f"dbs/{self.db}")
        async with self._http().post(
                f"{self.base}/dbs/{self.db}/colls", headers=h,
                json={"id": self.container,
                      "partitionKey": {"paths": ["/_nsroot"],
                                       "kind": "Hash"}}) as r:
            if r.status not in (201, 409):
                raise ArtifactStoreException(
                    f"cannot create container {self.container}: {r.status}")
        self._ensured = True

    async def _ensure_once(self) -> None:
        if not self._ensured:
            await self.ensure()

    # -- CRUD --------------------------------------------------------------
    def _body(self, doc_id: str, doc: Dict[str, Any]) -> Dict[str, Any]:
        body = {k: v for k, v in doc.items()
                if k not in ("_id", "_rev", "_etag", "_self", "_rid",
                             "_ts", "_attachments")}
        body["id"] = _encode_id(doc_id)
        body["_nsroot"] = _root_of_id(doc_id)
        if "entityType" in doc:
            body["_c"] = doc["entityType"]
            body["_sort"] = doc.get("start") or doc.get("updated") or 0
        return body

    async def put(self, doc_id: str, doc: Dict[str, Any],
                  rev: Optional[str] = None) -> str:
        await self._ensure_once()
        body = self._body(doc_id, doc)
        pk = self._pk_header(body["_nsroot"])
        if rev is None:
            # blind create: POST without upsert — an existing id is 409
            h = self._headers("post", "docs", self._coll_link, pk)
            async with self._http().post(
                    f"{self.base}/{self._coll_link}/docs", headers=h,
                    json=body) as r:
                if r.status == 201:
                    return (await r.json())["_etag"]
                if r.status == 409:
                    raise DocumentConflict(doc_id)
                raise ArtifactStoreException(
                    f"put {doc_id} failed ({r.status}): "
                    f"{(await r.text())[:256]}")
        # replace guarded by If-Match: stale etag is 412; a replace aimed
        # at a vanished document (404) is a conflict too, like CouchDB
        link = self._doc_link(body["id"])
        h = self._headers("put", "docs", link, pk)
        h["If-Match"] = rev
        async with self._http().put(f"{self.base}/{link}", headers=h,
                                    json=body) as r:
            if r.status == 200:
                return (await r.json())["_etag"]
            if r.status in (412, 404):
                raise DocumentConflict(doc_id)
            raise ArtifactStoreException(
                f"put {doc_id} failed ({r.status}): {(await r.text())[:256]}")

    async def get(self, doc_id: str) -> Dict[str, Any]:
        await self._ensure_once()
        enc = _encode_id(doc_id)
        link = self._doc_link(enc)
        h = self._headers("get", "docs", link,
                          self._pk_header(_root_of_id(doc_id)))
        async with self._http().get(f"{self.base}/{link}", headers=h) as r:
            if r.status == 404:
                raise NoDocumentException(doc_id)
            if r.status != 200:
                raise ArtifactStoreException(
                    f"get {doc_id} failed ({r.status})")
            raw = await r.json()
        return self._restore(raw)

    @staticmethod
    def _restore(raw: Dict[str, Any]) -> Dict[str, Any]:
        doc = {k: v for k, v in raw.items()
               if k not in ("id", "_nsroot", "_c", "_sort", "_rid", "_self",
                            "_etag", "_ts", "_attachments")}
        doc["_id"] = _decode_id(raw["id"])
        doc["_rev"] = raw["_etag"]
        return doc

    async def delete(self, doc_id: str, rev: Optional[str] = None) -> bool:
        await self._ensure_once()
        if rev is None:
            rev = (await self.get(doc_id))["_rev"]
        enc = _encode_id(doc_id)
        link = self._doc_link(enc)
        h = self._headers("delete", "docs", link,
                          self._pk_header(_root_of_id(doc_id)))
        h["If-Match"] = rev
        async with self._http().delete(f"{self.base}/{link}",
                                       headers=h) as r:
            if r.status == 204:
                await self._drop_sidecar(doc_id)
                return True
            if r.status == 404:
                raise NoDocumentException(doc_id)
            if r.status == 412:
                raise DocumentConflict(doc_id)
            raise ArtifactStoreException(
                f"delete {doc_id} failed ({r.status})")

    # -- queries (parameterized SQL over the computed fields) --------------
    async def _sql(self, query: str, params: List[Dict[str, Any]],
                   nsroot: Optional[str]) -> List[Any]:
        """POST the query with the documented headers; follows
        x-ms-continuation paging to exhaustion."""
        extra = {
            "x-ms-documentdb-isquery": "true",
            "Content-Type": "application/query+json",
        }
        if nsroot is not None:
            extra.update(self._pk_header(nsroot))
        else:
            extra["x-ms-documentdb-query-enablecrosspartition"] = "true"
        out: List[Any] = []
        continuation = None
        while True:
            h = self._headers("post", "docs", self._coll_link, extra)
            if continuation:
                h["x-ms-continuation"] = continuation
            async with self._http().post(
                    f"{self.base}/{self._coll_link}/docs", headers=h,
                    data=json.dumps({"query": query, "parameters": params}),
                    ) as r:
                if r.status != 200:
                    raise ArtifactStoreException(
                        f"query failed ({r.status}): "
                        f"{(await r.text())[:256]}")
                body = await r.json(content_type=None)
                out.extend(body.get("Documents", []))
                continuation = r.headers.get("x-ms-continuation")
            if not continuation:
                return out

    def _where(self, collection: str, ns_root: Optional[str],
               since: Optional[float], upto: Optional[float]
               ) -> Tuple[str, List[Dict[str, Any]]]:
        clauses = ["c._c = @c"]
        params = [{"name": "@c", "value": collection}]
        if ns_root is not None:
            clauses.append("c._nsroot = @ns")
            params.append({"name": "@ns", "value": ns_root})
        if since is not None:
            clauses.append("c._sort >= @since")
            params.append({"name": "@since", "value": since})
        if upto is not None:
            clauses.append("c._sort <= @upto")
            params.append({"name": "@upto", "value": upto})
        return " AND ".join(clauses), params

    async def query(self, collection: str, namespace: Optional[str] = None,
                    name: Optional[str] = None,
                    since: Optional[float] = None,
                    upto: Optional[float] = None,
                    skip: int = 0, limit: int = 0,
                    descending: bool = True) -> List[Dict[str, Any]]:
        await self._ensure_once()
        ns_root = namespace.split("/")[0] if namespace is not None else None
        packaged = namespace is not None and "/" in namespace
        where, params = self._where(collection, ns_root, since, upto)
        # cross-partition ORDER BY needs query-plan + per-partition-key-
        # range execution (the SDK's job); the raw-REST gateway rejects it
        # outright — omit it and merge-sort client-side instead
        order = (f" ORDER BY c._sort {'DESC' if descending else 'ASC'}"
                 if ns_root is not None else "")
        sql = f"SELECT * FROM c WHERE {where}{order}"
        pushdown = name is None and not packaged and namespace is not None
        if pushdown and (skip or limit):
            sql += f" OFFSET {int(skip)} LIMIT {int(limit) or 2147483647}"
        rows = await self._sql(sql, params, ns_root)
        docs = [self._restore(r) for r in rows]
        if ns_root is None:
            # the gateway served unmerged per-partition-key-range streams:
            # sort client-side on the key single-partition SQL orders by
            docs.sort(key=lambda d: d.get("start") or d.get("updated") or 0,
                      reverse=descending)
        if packaged:
            docs = [d for d in docs
                    if str(d.get("namespace", "")) == namespace
                    or str(d.get("namespace", "")).startswith(namespace + "/")]
        if name is not None:
            docs = [d for d in docs if d.get("name") == name]
        if not pushdown:
            docs = docs[skip:] if skip else docs
            docs = docs[:limit] if limit else docs
        return docs

    async def count(self, collection: str, namespace: Optional[str] = None,
                    name: Optional[str] = None,
                    since: Optional[float] = None,
                    upto: Optional[float] = None) -> int:
        await self._ensure_once()
        if name is not None or (namespace is not None and "/" in namespace):
            return len(await self.query(collection, namespace, name,
                                        since, upto))
        ns_root = namespace.split("/")[0] if namespace is not None else None
        where, params = self._where(collection, ns_root, since, upto)
        if ns_root is None:
            # cross-partition aggregates need per-partition-key-range
            # execution the raw-REST gateway won't do for us — count by
            # paging ids (continuation already drains every range)
            rows = await self._sql(
                f"SELECT c.id FROM c WHERE {where}", params, None)
            return len(rows)
        rows = await self._sql(
            f"SELECT VALUE COUNT(1) FROM c WHERE {where}", params, ns_root)
        # a single-partition COUNT can still arrive as one partial per
        # served page: sum, don't take the first
        return int(sum(rows))

    # -- attachments (sidecar documents; see module docstring) -------------
    #: characters an attachment name must exclude: '/' would add a path
    #: segment to the sidecar id (read_attachment and delete_attachments'
    #: endswith("/" + name) would mismatch), '|' round-trips asymmetrically
    #: through the id encoding ('|' -> '/' on read), and '\\', '?', '#'
    #: are forbidden in Cosmos document ids outright
    _FORBIDDEN_NAME_CHARS = frozenset("/|\\?#")

    @staticmethod
    def _att_doc_id(doc_id: str, name: Optional[str] = None) -> str:
        return f"att:{doc_id}" + (f"/{name}" if name else "")

    @classmethod
    def _check_attachment_name(cls, name: str) -> None:
        if not name or any(c in cls._FORBIDDEN_NAME_CHARS for c in name):
            raise ArtifactStoreException(
                f"invalid attachment name {name!r}: must be non-empty and "
                "exclude / | \\ ? # (sidecar doc ids embed the name)")

    async def attach(self, doc_id: str, name: str, content_type: str,
                     data: bytes) -> None:
        self._check_attachment_name(name)
        if self.attachment_store is not None:
            return await self.attachment_store.attach(doc_id, name,
                                                      content_type, data)
        await self._ensure_once()
        sid = self._att_doc_id(doc_id, name)
        body = {"contentType": content_type,
                "data": base64.b64encode(data).decode()}
        for _ in range(5):  # create/replace races with concurrent attachers
            try:
                return await self.put(sid, body) and None
            except DocumentConflict:
                pass
            try:
                existing = await self.get(sid)
            except NoDocumentException:
                continue  # deleted under us: retry the blind create
            try:
                return await self.put(sid, body,
                                      rev=existing["_rev"]) and None
            except DocumentConflict:
                continue  # etag moved under us — retry
        raise DocumentConflict(f"{doc_id}/{name}")

    async def read_attachment(self, doc_id: str, name: str
                              ) -> Tuple[str, bytes]:
        if self.attachment_store is not None:
            return await self.attachment_store.read_attachment(doc_id, name)
        await self._ensure_once()
        try:
            doc = await self.get(self._att_doc_id(doc_id, name))
        except NoDocumentException:
            raise NoDocumentException(f"{doc_id}/{name}") from None
        return doc["contentType"], base64.b64decode(doc["data"])

    async def delete_attachments(self, doc_id: str,
                                 except_name: Optional[str] = None) -> None:
        if self.attachment_store is not None:
            return await self.attachment_store.delete_attachments(
                doc_id, except_name=except_name)
        await self._ensure_once()
        prefix = _encode_id(self._att_doc_id(doc_id)) + "|"
        rows = await self._sql(
            "SELECT c.id, c._etag FROM c WHERE STARTSWITH(c.id, @p)",
            [{"name": "@p", "value": prefix}], _root_of_id(doc_id))
        for row in rows:
            att_id = _decode_id(row["id"])
            if except_name is not None and \
                    att_id.endswith("/" + except_name):
                continue
            try:
                await self.delete(att_id, row["_etag"])
            except (NoDocumentException, DocumentConflict):
                pass  # racing writer: its new sidecar stands

    async def _drop_sidecar(self, doc_id: str) -> None:
        if doc_id.startswith("att:"):
            return  # sidecars have no sidecars: no GC query needed
        try:
            await self.delete_attachments(doc_id)
        except ArtifactStoreException:
            pass  # best-effort GC

    async def close(self) -> None:
        await super().close()  # closes a wired attachment_store
        if self._session is not None and not self._session.closed:
            await self._session.close()


class CosmosDbArtifactStoreProvider:
    @staticmethod
    def instance(**kwargs) -> CosmosDbArtifactStore:
        return CosmosDbArtifactStore(**kwargs)
