"""CouchDB REST ArtifactStore.
A copy of `openwhisk_tpu/database/couchdb_store.py`.

Rebuild of common/scala/.../core/database/CouchDbRestStore.scala (+
CouchDbRestClient.scala): documents live in a CouchDB database with MVCC
revisions (`_rev`), list views are served by a design document installed at
ensure() time (the reference ships `whisks.v2.1.0` design docs via
ansible/tools/db; here one `_design/openwhisk` doc with an `all` view
emitting `[entityType, rootNamespace, timestamp]`), and attachments use
CouchDB's native attachment API (the reference's default before S3 is
wired in).

Wire surface used (all standard CouchDB API):
  PUT    /{db}                      create database (412 = exists)
  PUT    /{db}/{id}[?rev]           insert/update, 409 = conflict
  GET    /{db}/{id}                 fetch, 404 = missing
  DELETE /{db}/{id}?rev=            delete, 409 = stale rev
  GET    /{db}/_design/openwhisk/_view/all?startkey&endkey&descending&...
  PUT    /{db}/{id}/{att}?rev=      attach
  GET    /{db}/{id}/{att}           read attachment
  DELETE /{db}/{id}/{att}?rev=      delete attachment

Attachments live on a SIDECAR document (`att/{doc_id}`) rather than on the
entity document itself: the entity layer writes the attachment BEFORE the
document exists (entities.py — a reader must never see a stub whose
attachment is missing) and must not have its revision chain disturbed by
attachment writes. Sidecars carry no entityType, so views never see them;
deleting the entity deletes its sidecar.

Contract-tested against a faithful in-process CouchDB fake
(tests/test_couchdb_store.py) that enforces rev MVCC, CouchDB view
collation, and PUT-without-_attachments-stubs dropping attachments, over
real HTTP.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import quote

import aiohttp

from .store import (ArtifactStore, ArtifactStoreException, DocumentConflict,
                    NoDocumentException)

#: the view map function REAL CouchDB executes; the test fake implements
#: identical semantics natively
_DESIGN_DOC = {
    "_id": "_design/openwhisk",
    "views": {
        "all": {
            "map": (
                "function (doc) {\n"
                "  if (doc.entityType) {\n"
                "    var ns = (doc.namespace || '').split('/')[0];\n"
                "    emit([doc.entityType, ns,\n"
                "          doc.start || doc.updated || 0], null);\n"
                "  }\n"
                "}")
        }
    },
}

#: CouchDB collation: {} sorts after every string/number
_MAX = {}


class CouchDbArtifactStore(ArtifactStore):
    def __init__(self, url: str = "http://127.0.0.1:5984", db: str = "whisks",
                 username: Optional[str] = None, password: Optional[str] = None):
        self.base = url.rstrip("/")
        self.db = db
        self._auth = (aiohttp.BasicAuth(username, password)
                      if username else None)
        self._session: Optional[aiohttp.ClientSession] = None
        self._ensured = False

    def _http(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(auth=self._auth)
        return self._session

    def _doc_url(self, doc_id: str, att: Optional[str] = None) -> str:
        url = f"{self.base}/{self.db}/{quote(doc_id, safe='')}"
        if att is not None:
            url += f"/{quote(att, safe='')}"
        return url

    async def ensure(self) -> None:
        """Create the database + design doc (idempotent; ref: the deploy
        step installs design docs, ansible couchdb role / tools/db)."""
        async with self._http().put(f"{self.base}/{self.db}") as resp:
            if resp.status not in (201, 202, 412):
                raise ArtifactStoreException(
                    f"cannot create database {self.db}: {resp.status}")
        async with self._http().get(
                self._doc_url("_design/openwhisk")) as resp:
            if resp.status == 200:
                self._ensured = True
                return
        async with self._http().put(
                self._doc_url("_design/openwhisk"),
                json={k: v for k, v in _DESIGN_DOC.items() if k != "_id"}
                ) as resp:
            if resp.status not in (201, 202, 409):
                raise ArtifactStoreException(
                    f"cannot install design doc: {resp.status}")
        self._ensured = True

    async def _ensure_once(self) -> None:
        if not self._ensured:
            await self.ensure()

    # -- CRUD --------------------------------------------------------------
    async def put(self, doc_id: str, doc: Dict[str, Any],
                  rev: Optional[str] = None) -> str:
        await self._ensure_once()
        body = {k: v for k, v in doc.items() if k not in ("_id", "_rev")}
        if rev is not None:
            body["_rev"] = rev
        async with self._http().put(self._doc_url(doc_id), json=body) as resp:
            if resp.status in (201, 202):
                return (await resp.json(content_type=None))["rev"]
            if resp.status == 409:
                raise DocumentConflict(doc_id)
            # a proxy/LB 5xx may carry HTML: never let a decode error mask
            # the real failure
            raise ArtifactStoreException(
                f"put {doc_id} failed ({resp.status}): "
                f"{(await resp.text())[:256]}")

    async def get(self, doc_id: str) -> Dict[str, Any]:
        await self._ensure_once()
        async with self._http().get(self._doc_url(doc_id)) as resp:
            if resp.status == 404:
                raise NoDocumentException(doc_id)
            if resp.status != 200:
                raise ArtifactStoreException(
                    f"get {doc_id} failed ({resp.status})")
            doc = await resp.json(content_type=None)
        doc["_id"] = doc_id
        return doc

    async def delete(self, doc_id: str, rev: Optional[str] = None) -> bool:
        await self._ensure_once()
        if rev is None:
            rev = (await self.get(doc_id))["_rev"]
        async with self._http().delete(self._doc_url(doc_id),
                                       params={"rev": rev}) as resp:
            if resp.status in (200, 202):
                await self._drop_sidecar(doc_id)
                return True
            if resp.status == 404:
                raise NoDocumentException(doc_id)
            if resp.status == 409:
                raise DocumentConflict(doc_id)
            raise ArtifactStoreException(
                f"delete {doc_id} failed ({resp.status})")

    async def _drop_sidecar(self, doc_id: str) -> None:
        sid = self._att_doc_id(doc_id)
        try:
            sidecar = await self.get(sid)
        except NoDocumentException:
            return
        async with self._http().delete(self._doc_url(sid),
                                       params={"rev": sidecar["_rev"]}):
            pass  # best-effort GC; a racing writer just recreates it

    # -- views -------------------------------------------------------------
    async def _view_rows(self, collection: str, ns_root: Optional[str],
                         since: Optional[float], upto: Optional[float],
                         skip: int, limit: int, descending: bool,
                         include_docs: bool,
                         pushdown_paging: bool) -> List[Dict[str, Any]]:
        """One /_view/all range read over [collection, root-namespace, ts]
        keys. When `ns_root` is None a single key range cannot bound the
        timestamp (ns varies mid-key), so the ts filter — and therefore
        paging — runs client-side over the row keys."""
        await self._ensure_once()
        cross_ns = ns_root is None
        lo = [collection, "" if cross_ns else ns_root,
              0 if cross_ns or since is None else since]
        hi = [collection, _MAX if cross_ns else ns_root,
              _MAX if cross_ns or upto is None else upto]
        params = {
            "include_docs": "true" if include_docs else "false",
            "descending": "true" if descending else "false",
            # with descending=true CouchDB walks the index backwards, so the
            # range bounds swap (CouchDbRestClient does the same)
            "startkey": json.dumps(hi if descending else lo),
            "endkey": json.dumps(lo if descending else hi),
        }
        if pushdown_paging and not cross_ns:
            if skip:
                params["skip"] = str(skip)
            if limit:
                params["limit"] = str(limit)
        url = f"{self.base}/{self.db}/_design/openwhisk/_view/all"
        async with self._http().get(url, params=params) as resp:
            if resp.status != 200:
                raise ArtifactStoreException(
                    f"view query failed ({resp.status}): "
                    f"{(await resp.text())[:256]}")
            body = await resp.json(content_type=None)
        rows = body.get("rows", [])
        if cross_ns and (since is not None or upto is not None):
            rows = [r for r in rows
                    if (since is None or r["key"][2] >= since)
                    and (upto is None or r["key"][2] <= upto)]
        return rows

    async def query(self, collection: str, namespace: Optional[str] = None,
                    name: Optional[str] = None,
                    since: Optional[float] = None, upto: Optional[float] = None,
                    skip: int = 0, limit: int = 0,
                    descending: bool = True) -> List[Dict[str, Any]]:
        # the view keys carry only the ROOT namespace, so a package-
        # qualified query ('ns/pkg') reads the root's range and narrows
        # client-side; name filtering is also client-side (the reference
        # has dedicated byName views; one view + filter keeps the design
        # doc minimal). Paging pushes down only without client-side filters.
        ns_root = namespace.split("/")[0] if namespace is not None else None
        packaged = namespace is not None and "/" in namespace
        pushdown = name is None and not packaged and namespace is not None
        rows = await self._view_rows(collection, ns_root, since, upto,
                                     skip, limit, descending,
                                     include_docs=True,
                                     pushdown_paging=pushdown)
        docs = [row["doc"] for row in rows if row.get("doc") is not None]
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
                    since: Optional[float] = None, upto: Optional[float] = None
                    ) -> int:
        if name is not None or (namespace is not None and "/" in namespace):
            # client-side filters need document bodies
            return len(await self.query(collection, namespace, name,
                                        since, upto))
        # keys alone carry the timestamp: no document bodies on the wire
        rows = await self._view_rows(collection, namespace, since, upto,
                                     0, 0, True, include_docs=False,
                                     pushdown_paging=False)
        return len(rows)

    # -- attachments (sidecar doc: see module docstring) -------------------
    @staticmethod
    def _att_doc_id(doc_id: str) -> str:
        # ':' cannot appear in entity ids (ENTITY_NAME_RX excludes it), so
        # the sidecar namespace can never collide with a real document —
        # 'att/{id}' WOULD collide with entities of a user namespace 'att'
        return f"att:{doc_id}"

    async def attach(self, doc_id: str, name: str, content_type: str,
                     data: bytes) -> None:
        await self._ensure_once()
        sid = self._att_doc_id(doc_id)
        for _ in range(5):  # create/update races with concurrent attachers
            try:
                rev = (await self.get(sid))["_rev"]
            except NoDocumentException:
                try:
                    rev = await self.put(sid, {"parent": doc_id})
                except DocumentConflict:
                    continue  # another attacher created it first
            async with self._http().put(
                    self._doc_url(sid, name), data=data,
                    params={"rev": rev},
                    headers={"Content-Type": content_type}) as resp:
                if resp.status in (201, 202):
                    return
                if resp.status != 409:  # 409: rev moved under us — retry
                    raise ArtifactStoreException(
                        f"attach {doc_id}/{name} failed ({resp.status})")
        raise DocumentConflict(f"{doc_id}/{name}")

    async def read_attachment(self, doc_id: str, name: str) -> Tuple[str, bytes]:
        await self._ensure_once()
        async with self._http().get(
                self._doc_url(self._att_doc_id(doc_id), name)) as resp:
            if resp.status == 404:
                raise NoDocumentException(f"{doc_id}/{name}")
            if resp.status != 200:
                raise ArtifactStoreException(
                    f"read attachment failed ({resp.status})")
            return (resp.headers.get("Content-Type",
                                     "application/octet-stream"),
                    await resp.read())

    async def delete_attachments(self, doc_id: str,
                                 except_name: Optional[str] = None) -> None:
        await self._ensure_once()
        sid = self._att_doc_id(doc_id)
        for _ in range(5):  # rev races with concurrent attachers: re-read
            try:
                sidecar = await self.get(sid)
            except NoDocumentException:
                return
            rev = sidecar["_rev"]
            doomed = [a for a in sidecar.get("_attachments", {})
                      if a != except_name]
            if not doomed:
                if except_name is None or not sidecar.get("_attachments"):
                    async with self._http().delete(
                            self._doc_url(sid), params={"rev": rev}) as resp:
                        if resp.status == 409:
                            continue  # a late attacher revived it — retry
                return
            for att in doomed:
                async with self._http().delete(
                        self._doc_url(sid, att), params={"rev": rev}) as resp:
                    if resp.status in (200, 202):
                        rev = (await resp.json(content_type=None))["rev"]
                    elif resp.status == 404:
                        pass  # already gone
                    elif resp.status == 409:
                        break  # rev moved under us: re-read and retry
                    else:
                        raise ArtifactStoreException(
                            f"delete attachment {doc_id}/{att} failed "
                            f"({resp.status})")
            # loop re-reads: verifies deletions stuck, retries conflicts,
            # and GCs the now-empty sidecar
        else:
            raise DocumentConflict(
                f"attachments of {doc_id}: persistent revision conflicts")

    async def close(self) -> None:
        await super().close()
        if self._session is not None and not self._session.closed:
            await self._session.close()


class CouchDbArtifactStoreProvider:
    """ArtifactStoreProvider SPI binding
    (CONFIG_whisk_spi_ArtifactStoreProvider=
     openwhisk_tpu_torch.database.couchdb_store:CouchDbArtifactStoreProvider)."""

    @staticmethod
    def instance(**kwargs) -> CouchDbArtifactStore:
        return CouchDbArtifactStore(**kwargs)
