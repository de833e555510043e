"""Entity, auth and activation stores over the artifact stores: in-memory,
sqlite, the networked document store (`docstore://`), CouchDB
(`couchdb://`) and Cosmos DB (`cosmos://`), which `open_store` resolves
from a --db argument. A copy of `openwhisk_tpu/database/__init__.py`.
"""
from .store import (ArtifactStore, ArtifactStoreException, DocumentConflict,
                    NoDocumentException, StaleParameter)
from .attachment_store import (AttachmentStore, FileAttachmentStore,
                               FileAttachmentStoreProvider,
                               MemoryAttachmentStore,
                               MemoryAttachmentStoreProvider)
from .memory_store import MemoryArtifactStore, MemoryArtifactStoreProvider
from .sqlite_store import SqliteArtifactStore, SqliteArtifactStoreProvider
from .remote_store import (DocStoreServer, RemoteArtifactStore,
                           RemoteArtifactStoreProvider, open_store)
from .batcher import Batcher
from .cache import EntityCache, RemoteCacheInvalidation
from .change_feed import CacheInvalidatorService
from .entities import EntityStore, AuthStore
from .activation_store import (ActivationStore, ArtifactActivationStore,
                               ArtifactActivationStoreProvider,
                               NoopActivationStore)

__all__ = [n for n in dir() if not n.startswith("_")]
