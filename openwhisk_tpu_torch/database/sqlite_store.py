"""Durable ArtifactStore on sqlite3 — the single-node CouchDB-equivalent.

The reference persists entities in CouchDB via an HTTP client
(CouchDbRestStore.scala, 564 LoC); the portable durability story here is
sqlite in WAL mode with the same revisioned-document semantics
(rev "N-<hash>"; conflict on mismatched rev) and the same views (query by
collection/namespace/updated). Blocking sqlite calls run in a thread executor
so the asyncio control plane never stalls on fsync.

Unlike the JAX package's store, a put or delete on a file reads the revision
and writes inside one `BEGIN IMMEDIATE` transaction, so the revision check
holds across processes sharing the file (invokers claiming their ids at
once), and a connection retries the journal-mode switch and the schema
while another process opening the same new file holds its lock.
"""
from __future__ import annotations

import asyncio
import hashlib
import json
import sqlite3
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .store import (ArtifactStore, DocumentConflict, NoDocumentException,
                    match_query, sort_key)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS documents (
  id TEXT PRIMARY KEY,
  rev TEXT NOT NULL,
  collection TEXT NOT NULL,
  namespace TEXT NOT NULL,
  name TEXT,
  updated REAL NOT NULL,
  body TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_docs_view ON documents (collection, namespace, updated);
CREATE TABLE IF NOT EXISTS attachments (
  doc_id TEXT NOT NULL,
  name TEXT NOT NULL,
  content_type TEXT NOT NULL,
  data BLOB NOT NULL,
  PRIMARY KEY (doc_id, name)
);
"""


_memdb_counter = 0

#: how long a connection retries the journal-mode switch and the schema
#: while other processes opening the same new file hold the lock
SETUP_RETRY_S = 10.0


def _setup(conn: sqlite3.Connection) -> None:
    """WAL mode and the schema (idempotent: IF NOT EXISTS). Processes that
    open one new file at once contend for the locks these take, and sqlite
    answers "database is locked" there without waiting on its busy
    handler: retry for a bounded time."""
    deadline = time.monotonic() + SETUP_RETRY_S
    while True:
        try:
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
            conn.executescript(_SCHEMA)
            return
        except sqlite3.OperationalError as e:
            if "locked" not in str(e) or time.monotonic() > deadline:
                raise
            time.sleep(0.01)


class SqliteArtifactStore(ArtifactStore):
    def __init__(self, path: str = ":memory:"):
        global _memdb_counter
        #: a file is shared between processes; a named in-memory database
        #: lives in this one only
        self._shared_file = path != ":memory:"
        if path == ":memory:":
            # plain :memory: would give every executor thread its own empty
            # database; a named shared-cache URI makes them one database.
            _memdb_counter += 1
            path = f"file:owtpu_mem_{_memdb_counter}?mode=memory&cache=shared"
        self.path = path
        self._uri = path.startswith("file:")
        self._local = threading.local()
        self._init_lock = threading.Lock()
        self._conns: list = []
        self._anchor = self._conn()  # keeps shared in-memory DBs alive

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, check_same_thread=False, uri=self._uri)
            with self._init_lock:
                _setup(conn)
                self._conns.append(conn)
            self._local.conn = conn
        return conn

    def _begin_write(self, conn: sqlite3.Connection) -> None:
        """Take the file's write lock before reading a revision, so the
        check and the write are one transaction for every process on the
        file (the in-process lock covers this process only)."""
        if self._shared_file:
            conn.execute("BEGIN IMMEDIATE")

    async def _run(self, fn, *args):
        return await asyncio.get_event_loop().run_in_executor(None, fn, *args)

    # -- CRUD --------------------------------------------------------------
    def _put_sync(self, doc_id: str, doc: Dict[str, Any], rev: Optional[str]) -> str:
        conn = self._conn()
        body = json.dumps(doc)
        digest = hashlib.sha1(body.encode()).hexdigest()[:10]
        with self._init_lock, conn:
            self._begin_write(conn)
            row = conn.execute("SELECT rev FROM documents WHERE id=?", (doc_id,)).fetchone()
            if row is not None:
                cur = row[0]
                if rev is None or rev != cur:
                    raise DocumentConflict(f"document {doc_id!r} update conflict")
                gen = int(cur.split("-")[0]) + 1
            else:
                if rev is not None:
                    raise DocumentConflict(f"document {doc_id!r} does not exist at rev {rev}")
                gen = 1
            new_rev = f"{gen}-{digest}"
            stored = dict(doc)
            stored["_id"] = doc_id
            stored["_rev"] = new_rev
            conn.execute(
                "INSERT OR REPLACE INTO documents (id, rev, collection, namespace, name, updated, body)"
                " VALUES (?,?,?,?,?,?,?)",
                (doc_id, new_rev, doc.get("entityType", ""), str(doc.get("namespace", "")),
                 doc.get("name"), sort_key(doc), json.dumps(stored)))
            return new_rev

    async def put(self, doc_id: str, doc: Dict[str, Any],
                  rev: Optional[str] = None) -> str:
        return await self._run(self._put_sync, doc_id, doc, rev)

    def _get_sync(self, doc_id: str) -> Dict[str, Any]:
        row = self._conn().execute("SELECT body FROM documents WHERE id=?", (doc_id,)).fetchone()
        if row is None:
            raise NoDocumentException(doc_id)
        return json.loads(row[0])

    async def get(self, doc_id: str) -> Dict[str, Any]:
        return await self._run(self._get_sync, doc_id)

    def _delete_sync(self, doc_id: str, rev: Optional[str]) -> bool:
        conn = self._conn()
        with self._init_lock, conn:
            self._begin_write(conn)
            row = conn.execute("SELECT rev FROM documents WHERE id=?", (doc_id,)).fetchone()
            if row is None:
                raise NoDocumentException(doc_id)
            if rev is not None and row[0] != rev:
                raise DocumentConflict(f"document {doc_id!r} delete conflict")
            conn.execute("DELETE FROM documents WHERE id=?", (doc_id,))
            conn.execute("DELETE FROM attachments WHERE doc_id=?", (doc_id,))
            return True

    async def delete(self, doc_id: str, rev: Optional[str] = None) -> bool:
        return await self._run(self._delete_sync, doc_id, rev)

    # -- views -------------------------------------------------------------
    def _query_sync(self, collection, namespace, name, since, upto, skip, limit,
                    descending) -> List[Dict[str, Any]]:
        sql = "SELECT body FROM documents WHERE collection=?"
        args: list = [collection]
        if namespace is not None:
            # escape LIKE wildcards: '_' is a valid namespace character and
            # must not match arbitrary characters (cross-namespace leakage)
            escaped = namespace.replace("\\", "\\\\").replace("%", "\\%").replace("_", "\\_")
            sql += " AND (namespace=? OR namespace LIKE ? ESCAPE '\\')"
            args += [namespace, escaped + "/%"]
        if name is not None:
            sql += " AND name=?"
            args.append(name)
        if since is not None:
            sql += " AND updated>=?"
            args.append(since)
        if upto is not None:
            sql += " AND updated<=?"
            args.append(upto)
        sql += f" ORDER BY updated {'DESC' if descending else 'ASC'}"
        if limit:
            sql += " LIMIT ?"
            args.append(limit)
            if skip:
                sql += " OFFSET ?"
                args.append(skip)
        elif skip:
            sql += " LIMIT -1 OFFSET ?"
            args.append(skip)
        rows = self._conn().execute(sql, args).fetchall()
        return [json.loads(r[0]) for r in rows]

    async def query(self, collection: str, namespace: Optional[str] = None,
                    name: Optional[str] = None,
                    since: Optional[float] = None, upto: Optional[float] = None,
                    skip: int = 0, limit: int = 0,
                    descending: bool = True) -> List[Dict[str, Any]]:
        return await self._run(
            lambda: self._query_sync(collection, namespace, name, since, upto,
                                     skip, limit, descending))

    def _count_sync(self, collection, namespace, name, since, upto) -> int:
        sql = "SELECT COUNT(*) FROM documents WHERE collection=?"
        args: list = [collection]
        if namespace is not None:
            escaped = namespace.replace("\\", "\\\\").replace("%", "\\%").replace("_", "\\_")
            sql += " AND (namespace=? OR namespace LIKE ? ESCAPE '\\')"
            args += [namespace, escaped + "/%"]
        if name is not None:
            sql += " AND name=?"
            args.append(name)
        if since is not None:
            sql += " AND updated>=?"
            args.append(since)
        if upto is not None:
            sql += " AND updated<=?"
            args.append(upto)
        return self._conn().execute(sql, args).fetchone()[0]

    async def count(self, collection: str, namespace: Optional[str] = None,
                    name: Optional[str] = None,
                    since: Optional[float] = None, upto: Optional[float] = None
                    ) -> int:
        return await self._run(
            lambda: self._count_sync(collection, namespace, name, since, upto))

    # -- attachments -------------------------------------------------------
    async def attach(self, doc_id: str, name: str, content_type: str,
                     data: bytes) -> None:
        if self.attachment_store is not None:
            return await self.attachment_store.attach(doc_id, name,
                                                      content_type, data)
        def go():
            with self._conn() as conn:
                conn.execute(
                    "INSERT OR REPLACE INTO attachments (doc_id, name, content_type, data)"
                    " VALUES (?,?,?,?)", (doc_id, name, content_type, data))
        await self._run(go)

    async def read_attachment(self, doc_id: str, name: str) -> Tuple[str, bytes]:
        if self.attachment_store is not None:
            return await self.attachment_store.read_attachment(doc_id, name)
        def go():
            row = self._conn().execute(
                "SELECT content_type, data FROM attachments WHERE doc_id=? AND name=?",
                (doc_id, name)).fetchone()
            if row is None:
                raise NoDocumentException(f"attachment {doc_id}/{name}")
            return row[0], bytes(row[1])
        return await self._run(go)

    async def delete_attachments(self, doc_id: str,
                                 except_name: Optional[str] = None) -> None:
        if self.attachment_store is not None:
            return await self.attachment_store.delete_attachments(
                doc_id, except_name=except_name)
        def go():
            with self._conn() as conn:
                if except_name is None:
                    conn.execute("DELETE FROM attachments WHERE doc_id=?",
                                 (doc_id,))
                else:
                    conn.execute(
                        "DELETE FROM attachments WHERE doc_id=? AND name<>?",
                        (doc_id, except_name))
        await self._run(go)

    async def close(self) -> None:
        await super().close()
        with self._init_lock:
            for c in self._conns:
                try:
                    c.close()
                except sqlite3.Error:
                    pass
            self._conns.clear()


class SqliteArtifactStoreProvider:
    @staticmethod
    def make_store(name: str = "whisks", path: Optional[str] = None, **kwargs
                   ) -> SqliteArtifactStore:
        return SqliteArtifactStore(path or f"./{name}.db")
