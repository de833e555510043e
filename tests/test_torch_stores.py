"""The port's stores, run against the JAX package's.

Every case of `tests/test_remote_store.py`, `test_couchdb_store.py`,
`test_cosmosdb_store.py`, `test_s3_attachments.py` and `test_database.py`
(the artifact-store contract over every backend, docstore, CouchDB and
Cosmos DB included), and of `test_aux_subsystems.py`'s file activation
store and wskadmin classes, on both packages (`pkg`; see
`tests/torch_ported_cases.py`). Besides: a mixed docstore pair, the port's
`RemoteArtifactStore` against the JAX package's `DocStoreServer` and the
reverse, gives the same documents, revisions and conflicts as the JAX
package against itself.
"""
import asyncio
import importlib

import pytest

from tests.torch_ported_cases import ported

ported(globals(), "test_remote_store")
ported(globals(), "test_couchdb_store")
ported(globals(), "test_cosmosdb_store")
ported(globals(), "test_s3_attachments")
ported(globals(), "test_database")
ported(globals(), "test_aux_subsystems",
       only=("TestFileActivationStore", "TestAdminCli"))


# -- a mixed pair: one package's client against the other's server -----------
DOC = {"entityType": "actions", "namespace": "ns", "name": "a", "updated": 1}


async def _docstore_script(server, client):
    """One script of reads, writes, a conflict, a miss, views and an
    attachment, through two clients of package `client` against a
    `DocStoreServer` of package `server` over an in-memory store (whose
    revisions are deterministic). Returns the transcript."""
    S = importlib.import_module(f"{server}.database")
    C = importlib.import_module(f"{client}.database")
    srv = S.DocStoreServer(S.MemoryArtifactStore(), port=0)
    await srv.start()
    port = srv._server.sockets[0].getsockname()[1]
    a = C.RemoteArtifactStore("127.0.0.1", port)
    b = C.RemoteArtifactStore("127.0.0.1", port)
    out = []

    async def step(coro):
        try:
            out.append(await coro)
        except (C.DocumentConflict, C.NoDocumentException) as e:
            out.append(type(e).__name__)

    try:
        rev1 = await a.put("ns/a", DOC)
        out.append(rev1)
        await step(b.get("ns/a"))
        await step(b.put("ns/a", dict(DOC, updated=2), rev=rev1))
        await step(a.put("ns/a", dict(DOC, updated=3), rev=rev1))
        await step(b.get("ns/missing"))
        await step(a.put("ns/b", dict(DOC, name="b", updated=5)))
        await step(b.query("actions", "ns"))
        await step(b.count("actions", "ns"))
        await step(a.attach("ns/a", "code", "text/plain", b"print(1)"))
        await step(b.read_attachment("ns/a", "code"))
        await step(a.delete("ns/b", rev="1-stale"))
        await step(a.delete("ns/b"))
        await step(b.get("ns/b"))
        await step(a.ping())
    finally:
        await a.close()
        await b.close()
        await srv.stop()
    return out


@pytest.mark.parametrize("server,client", [
    ("openwhisk_tpu", "openwhisk_tpu_torch"),
    ("openwhisk_tpu_torch", "openwhisk_tpu")])
def test_a_mixed_docstore_pair_gives_the_same_answers(server, client):
    """The port's client against the JAX package's server, and the
    reverse: the same documents, revisions, conflicts and misses as the
    JAX package against itself (the wire is the TCP bus's frames)."""
    ref = asyncio.run(_docstore_script("openwhisk_tpu", "openwhisk_tpu"))
    mixed = asyncio.run(_docstore_script(server, client))
    assert mixed == ref
    assert "DocumentConflict" in ref and "NoDocumentException" in ref
    assert ref[2] == "2-mem" and ref[-1] is True
