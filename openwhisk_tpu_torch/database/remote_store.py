"""Networked ArtifactStore: a framework-native shared document store.
A copy of `openwhisk_tpu/database/remote_store.py`.

The reference's multi-host persistence is CouchDB behind an HTTP client
(common/scala/.../database/CouchDbRestStore.scala:1-564 over
ArtifactStore.scala:41-150). This module is the equivalent without an
external database: `DocStoreServer` serves any backing ArtifactStore
(sqlite for durability, memory for tests) over the same length-prefixed
JSON framing the TCP bus uses (messaging/tcp.py), and
`RemoteArtifactStore` is the client implementing the full ArtifactStore
contract — so multi-host controllers and invokers share one entity /
activation database with revision semantics intact.

Protocol (4-byte big-endian length + JSON), one request per frame:
  {"op": "put", "rid": r, "id": i, "doc": {...}, "rev": v} -> {"rev": v'}
  {"op": "get", "id": i}                                   -> {"doc": {...}}
  {"op": "delete", "rid": r, "id": i, "rev": v}            -> {"ok": true}
  {"op": "query"/"count", ...view params}                  -> {"docs"/"n"}
  {"op": "attach"/"read_attachment"/"delete_attachments"}  -> ...
  errors                                    -> {"err": kind, "msg": text}

Mutating ops carry a client request id (`rid`); the server replays the
recorded response for a rid it has already applied, so a client retry
after a dropped TCP ack cannot double-apply a revision bump (the same
effectively-once trick the bus uses for publishes, messaging/tcp.py).
The rid cache is in-memory, so a retry across a server RESTART can still
re-dispatch; the client resolves that ambiguity itself (a retried put
answered with a conflict checks whether the stored body is its own; a
retried delete answered with no-document treats the delete as applied;
attach/delete_attachments are naturally idempotent).
"""
from __future__ import annotations

import asyncio
import base64
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from ..messaging.tcp import _frame, _read_frame
from .store import (ArtifactStore, ArtifactStoreException, DocumentConflict,
                    NoDocumentException, StaleParameter)

_ERR_TYPES = {
    "no_document": NoDocumentException,
    "conflict": DocumentConflict,
    "stale": StaleParameter,
    "internal": ArtifactStoreException,
}


def _err_kind(exc: Exception) -> str:
    if isinstance(exc, NoDocumentException):
        return "no_document"
    if isinstance(exc, DocumentConflict):
        return "conflict"
    if isinstance(exc, StaleParameter):
        return "stale"
    return "internal"


class DocStoreServer:
    """Serve a backing ArtifactStore to remote clients."""

    def __init__(self, backing: ArtifactStore, host: str = "127.0.0.1",
                 port: int = 4223):
        self.backing = backing
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._client_writers: set = set()
        # rid -> recorded response for applied mutations (retry dedupe)
        self._applied: "OrderedDict[str, dict]" = OrderedDict()

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            for w in list(self._client_writers):
                w.close()
            await self._server.wait_closed()
        await self.backing.close()

    def _record(self, rid: Optional[str], resp: dict) -> dict:
        if rid is not None:
            self._applied[rid] = resp
            while len(self._applied) > 4096:
                self._applied.popitem(last=False)
        return resp

    async def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        rid = req.get("rid")
        if rid is not None and rid in self._applied:
            return self._applied[rid]
        b = self.backing
        if op == "put":
            rev = await b.put(req["id"], req["doc"], rev=req.get("rev"))
            return self._record(rid, {"rev": rev})
        if op == "get":
            return {"doc": await b.get(req["id"])}
        if op == "delete":
            ok = await b.delete(req["id"], rev=req.get("rev"))
            return self._record(rid, {"ok": bool(ok)})
        if op == "query":
            docs = await b.query(
                req["collection"], namespace=req.get("namespace"),
                name=req.get("name"), since=req.get("since"),
                upto=req.get("upto"), skip=int(req.get("skip", 0)),
                limit=int(req.get("limit", 0)),
                descending=bool(req.get("descending", True)))
            return {"docs": docs}
        if op == "count":
            n = await b.count(
                req["collection"], namespace=req.get("namespace"),
                name=req.get("name"), since=req.get("since"),
                upto=req.get("upto"))
            return {"n": n}
        if op == "attach":
            await b.attach(req["id"], req["name"], req["content_type"],
                           base64.b64decode(req["data"]))
            return self._record(rid, {"ok": True})
        if op == "read_attachment":
            ct, data = await b.read_attachment(req["id"], req["name"])
            return {"content_type": ct,
                    "data": base64.b64encode(data).decode()}
        if op == "delete_attachments":
            await b.delete_attachments(req["id"],
                                       except_name=req.get("except_name"))
            return self._record(rid, {"ok": True})
        if op == "ping":
            return {"ok": True}
        return {"err": "internal", "msg": f"unknown op {op!r}"}

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._client_writers.add(writer)
        try:
            while True:
                req = await _read_frame(reader)
                if req is None:
                    break
                try:
                    resp = await self._dispatch(req)
                except ArtifactStoreException as e:
                    resp = {"err": _err_kind(e), "msg": str(e)}
                except Exception as e:  # noqa: BLE001 — server must not die
                    resp = {"err": "internal", "msg": f"{type(e).__name__}: {e}"}
                writer.write(_frame(resp))
                await writer.drain()
        finally:
            self._client_writers.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, OSError):
                pass


class _PooledConnection:
    """One TCP connection with reconnect-and-retry (safe: mutations carry
    rids the server dedupes on)."""

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None

    async def request(self, obj: dict):
        """Returns (response, retried): `retried` means the frame may have
        been applied by the server even though the first response was lost
        — callers resolve the ambiguity for non-idempotent ops."""
        for attempt in (1, 2):
            if self.writer is None or self.writer.is_closing():
                self.reader, self.writer = await asyncio.open_connection(
                    self.host, self.port)
            try:
                self.writer.write(_frame(obj))
                await self.writer.drain()
                resp = await _read_frame(self.reader)
                if resp is not None:
                    return resp, attempt > 1
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass
            self.writer.close()  # dead transport: release the fd now
            self.writer = None
        raise ConnectionError(
            f"docstore at {self.host}:{self.port} unreachable")

    async def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
            try:
                await self.writer.wait_closed()
            except (ConnectionResetError, OSError):
                pass
            self.writer = None


class RemoteArtifactStore(ArtifactStore):
    """ArtifactStore client talking to a DocStoreServer.

    Requests multiplex over a small connection pool so concurrent control-
    plane DB ops (entity fetch on the invoke path, activation writes, list
    queries) don't serialize behind one socket."""

    def __init__(self, host: str = "127.0.0.1", port: int = 4223,
                 pool_size: int = 8):
        self.host = host
        self.port = port
        self.pool_size = pool_size
        self._free: List[_PooledConnection] = []
        self._total = 0
        self._waiter = asyncio.Condition()

    async def _acquire(self) -> _PooledConnection:
        async with self._waiter:
            while True:
                if self._free:
                    return self._free.pop()
                if self._total < self.pool_size:
                    self._total += 1
                    return _PooledConnection(self.host, self.port)
                await self._waiter.wait()

    async def _release(self, conn: _PooledConnection) -> None:
        async with self._waiter:
            self._free.append(conn)
            self._waiter.notify()

    async def _request(self, obj: dict) -> dict:
        conn = await self._acquire()
        try:
            resp, retried = await conn.request(obj)
        except BaseException:
            await conn.close()
            async with self._waiter:
                self._total -= 1
                self._waiter.notify()
            raise
        await self._release(conn)
        err = resp.get("err")
        if err is not None:
            exc = _ERR_TYPES.get(err, ArtifactStoreException)(
                resp.get("msg", err))
            # the server's in-memory rid dedupe covers same-life retries;
            # after a server RESTART a retried mutation may have applied
            # before the crash ate its ack — callers use this to resolve
            exc.retried = retried
            raise exc
        return resp

    # -- CRUD --------------------------------------------------------------
    async def put(self, doc_id: str, doc: Dict[str, Any],
                  rev: Optional[str] = None) -> str:
        try:
            resp = await self._request({"op": "put", "rid": uuid.uuid4().hex,
                                        "id": doc_id, "doc": doc, "rev": rev})
            return resp["rev"]
        except DocumentConflict as e:
            if not getattr(e, "retried", False):
                raise
            # ambiguous: our first frame may have applied before the server
            # died. If the stored body IS our body, our write won — return
            # its revision; otherwise it is a genuine conflict.
            stored = await self.get(doc_id)
            body = {k: v for k, v in stored.items() if not k.startswith("_")}
            if body == doc:
                return stored["_rev"]
            raise

    async def get(self, doc_id: str) -> Dict[str, Any]:
        return (await self._request({"op": "get", "id": doc_id}))["doc"]

    async def delete(self, doc_id: str, rev: Optional[str] = None) -> bool:
        try:
            resp = await self._request({"op": "delete",
                                        "rid": uuid.uuid4().hex,
                                        "id": doc_id, "rev": rev})
            return bool(resp["ok"])
        except NoDocumentException as e:
            # ambiguous only when the frame was retried across a server
            # restart: our first attempt likely deleted it already
            if getattr(e, "retried", False):
                return True
            raise

    # -- views -------------------------------------------------------------
    async def query(self, collection: str, namespace: Optional[str] = None,
                    name: Optional[str] = None,
                    since: Optional[float] = None, upto: Optional[float] = None,
                    skip: int = 0, limit: int = 0,
                    descending: bool = True) -> List[Dict[str, Any]]:
        resp = await self._request({
            "op": "query", "collection": collection, "namespace": namespace,
            "name": name, "since": since, "upto": upto, "skip": skip,
            "limit": limit, "descending": descending})
        return resp["docs"]

    async def count(self, collection: str, namespace: Optional[str] = None,
                    name: Optional[str] = None,
                    since: Optional[float] = None, upto: Optional[float] = None
                    ) -> int:
        resp = await self._request({
            "op": "count", "collection": collection, "namespace": namespace,
            "name": name, "since": since, "upto": upto})
        return int(resp["n"])

    # -- attachments -------------------------------------------------------
    async def attach(self, doc_id: str, name: str, content_type: str,
                     data: bytes) -> None:
        if self.attachment_store is not None:
            return await self.attachment_store.attach(doc_id, name,
                                                      content_type, data)
        await self._request({"op": "attach", "rid": uuid.uuid4().hex,
                             "id": doc_id, "name": name,
                             "content_type": content_type,
                             "data": base64.b64encode(data).decode()})

    async def read_attachment(self, doc_id: str, name: str) -> Tuple[str, bytes]:
        if self.attachment_store is not None:
            return await self.attachment_store.read_attachment(doc_id, name)
        resp = await self._request({"op": "read_attachment", "id": doc_id,
                                    "name": name})
        return resp["content_type"], base64.b64decode(resp["data"])

    async def delete_attachments(self, doc_id: str,
                                 except_name: Optional[str] = None) -> None:
        if self.attachment_store is not None:
            return await self.attachment_store.delete_attachments(
                doc_id, except_name=except_name)
        await self._request({"op": "delete_attachments",
                             "rid": uuid.uuid4().hex, "id": doc_id,
                             "except_name": except_name})

    async def ping(self) -> bool:
        try:
            return bool((await self._request({"op": "ping"})).get("ok"))
        except (ConnectionError, OSError):
            return False

    async def close(self) -> None:
        await super().close()
        async with self._waiter:
            conns, self._free, self._total = self._free, [], 0
        for c in conns:
            await c.close()


class RemoteArtifactStoreProvider:
    @staticmethod
    def make_store(host: str = "127.0.0.1", port: int = 4223, **kwargs
                   ) -> RemoteArtifactStore:
        return RemoteArtifactStore(host, port)


def open_store(db: str) -> ArtifactStore:
    """Resolve a --db argument: `docstore://host:port` connects to a shared
    DocStoreServer; `couchdb://host:port/dbname` (or couchdbs:// for TLS)
    connects to a CouchDB server; `cosmos://KEY@host:port/db/container`
    (cosmoss:// for TLS; KEY percent-encoded base64 master key) connects
    to an Azure Cosmos DB SQL-API account or emulator; anything else is a
    local sqlite path."""
    if db.startswith("docstore://"):
        hostport = db[len("docstore://"):]
        host, _, port = hostport.rpartition(":")
        return RemoteArtifactStore(host or "127.0.0.1", int(port))
    if db.startswith(("couchdb://", "couchdbs://")):
        from urllib.parse import unquote, urlsplit

        from .couchdb_store import CouchDbArtifactStore
        parts = urlsplit(db)
        scheme = "https" if parts.scheme == "couchdbs" else "http"
        host = parts.hostname or "127.0.0.1"
        port = parts.port or (6984 if scheme == "https" else 5984)
        # urlsplit does NOT percent-decode userinfo; credentials with
        # reserved chars (@ : /) arrive encoded and must be restored
        return CouchDbArtifactStore(
            f"{scheme}://{host}:{port}",
            db=(parts.path.strip("/") or "whisks"),
            username=unquote(parts.username) if parts.username else None,
            password=unquote(parts.password) if parts.password else None)
    if db.startswith(("cosmos://", "cosmoss://")):
        from urllib.parse import unquote, urlsplit

        from .cosmosdb_store import CosmosDbArtifactStore
        parts = urlsplit(db)
        scheme = "https" if parts.scheme == "cosmoss" else "http"
        if not parts.username:
            raise ValueError(
                "cosmos:// needs the master key as userinfo: "
                "cosmos://KEY@host:port/db/container")
        segs = [s for s in parts.path.split("/") if s]
        return CosmosDbArtifactStore(
            f"{scheme}://{parts.hostname or '127.0.0.1'}:{parts.port or 8081}",
            key=unquote(parts.username),
            db=segs[0] if segs else "whisks",
            container=segs[1] if len(segs) > 1 else "whisks")
    from .sqlite_store import SqliteArtifactStore
    return SqliteArtifactStore(db)


def main(argv: Optional[List[str]] = None) -> None:
    """CLI: run a doc-store server over a durable sqlite backing.

      python -m openwhisk_tpu_torch.database.remote_store \
          --db /path/whisks.db --host 0.0.0.0 --port 4223
    """
    import argparse

    parser = argparse.ArgumentParser(prog="owdocstore")
    parser.add_argument("--db", required=True, help="sqlite backing path")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=4223)
    args = parser.parse_args(argv)

    async def run() -> None:
        from .sqlite_store import SqliteArtifactStore
        server = DocStoreServer(SqliteArtifactStore(args.db),
                                host=args.host, port=args.port)
        await server.start()
        print(f"docstore up on {args.host}:{args.port} (db={args.db})",
              flush=True)
        try:
            await asyncio.Event().wait()
        finally:
            await server.stop()

    asyncio.run(run())


if __name__ == "__main__":
    main()
