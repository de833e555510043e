"""Entity, auth and activation stores: copies of `openwhisk_tpu/database/`'s
modules of the same names over the in-memory and sqlite artifact stores.

The remote document store, CouchDB, Cosmos DB and S3 attachment backends
are not ported yet; `open_store` names them when asked for one.
"""
from .store import (ArtifactStore, ArtifactStoreException, DocumentConflict,
                    NoDocumentException, StaleParameter)
from .attachment_store import (AttachmentStore, FileAttachmentStore,
                               FileAttachmentStoreProvider,
                               MemoryAttachmentStore,
                               MemoryAttachmentStoreProvider)
from .memory_store import MemoryArtifactStore, MemoryArtifactStoreProvider
from .sqlite_store import SqliteArtifactStore, SqliteArtifactStoreProvider
from .batcher import Batcher
from .cache import EntityCache, RemoteCacheInvalidation
from .change_feed import CacheInvalidatorService
from .entities import EntityStore, AuthStore
from .activation_store import (ActivationStore, ArtifactActivationStore,
                               ArtifactActivationStoreProvider,
                               NoopActivationStore)

_REMOTE_SCHEMES = ("docstore://", "couchdb://", "couchdbs://", "cosmos://",
                   "cosmoss://")


def open_store(db: str) -> ArtifactStore:
    """Resolve a --db argument: a local sqlite path. The remote schemes
    of the JAX package's `open_store` (docstore, CouchDB, Cosmos DB) are
    refused with a message naming the store."""
    if db.startswith(_REMOTE_SCHEMES):
        raise ValueError(f"store {db.split('://', 1)[0]!r} is not ported; "
                         "use a sqlite path")
    return SqliteArtifactStore(db)


__all__ = [n for n in dir() if not n.startswith("_")]
