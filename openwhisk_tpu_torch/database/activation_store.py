"""ActivationStore SPI: persistence of activation records.

Rebuild of common/scala/.../core/database/ActivationStore.scala:34-159 —
store/get/delete/list activations, with `ArtifactActivationStore` writing
through a Batcher (write coalescing) and `NoopActivationStore` for
deployments that sink records elsewhere. `store_context` gates persistence on
the user's `store_activations` limit exactly as the reference's
UserContext checks.
"""
from __future__ import annotations

from typing import List, Optional

from ..core.entity import ActivationId, Identity, WhiskActivation
from .batcher import Batcher
from .store import ArtifactStore, NoDocumentException


class ActivationStore:
    async def store(self, activation: WhiskActivation,
                    context: Optional[Identity] = None) -> Optional[str]:
        raise NotImplementedError

    async def get(self, namespace: str, activation_id: ActivationId) -> WhiskActivation:
        raise NotImplementedError

    async def delete(self, namespace: str, activation_id: ActivationId) -> bool:
        raise NotImplementedError

    async def list(self, namespace: str, name: Optional[str] = None,
                   skip: int = 0, limit: int = 30,
                   since: Optional[float] = None, upto: Optional[float] = None
                   ) -> List[dict]:
        raise NotImplementedError

    async def count(self, namespace: str, name: Optional[str] = None,
                    since: Optional[float] = None, upto: Optional[float] = None
                    ) -> int:
        raise NotImplementedError


class ArtifactActivationStore(ActivationStore):
    def __init__(self, store: ArtifactStore, batch_size: int = 500):
        self.store_backend = store
        self._batcher: Batcher = Batcher(self._write_batch, batch_size=batch_size)

    async def _write_batch(self, activations: List[WhiskActivation]) -> List[str]:
        # stores with a native bulk write take the whole coalesced batch in
        # one call (one lock/round trip for N records) — without it the
        # batcher still amortizes scheduling but the backend sees N puts
        put_many = getattr(self.store_backend, "put_many", None)
        if put_many is not None:
            return await put_many([(a.docid, a.to_document())
                                   for a in activations])
        out = []
        for a in activations:
            out.append(await self.store_backend.put(a.docid, a.to_document()))
        return out

    async def store(self, activation: WhiskActivation,
                    context: Optional[Identity] = None) -> Optional[str]:
        if context is not None and context.limits.store_activations is False:
            return None
        return await self._batcher.put(activation)

    async def get(self, namespace: str, activation_id: ActivationId) -> WhiskActivation:
        doc = await self.store_backend.get(f"{namespace}/{activation_id}")
        return WhiskActivation.from_json(doc)

    async def delete(self, namespace: str, activation_id: ActivationId) -> bool:
        return await self.store_backend.delete(f"{namespace}/{activation_id}")

    async def list(self, namespace: str, name: Optional[str] = None,
                   skip: int = 0, limit: int = 30,
                   since: Optional[float] = None, upto: Optional[float] = None
                   ) -> List[dict]:
        since_ms = since * 1000 if since else None
        upto_ms = upto * 1000 if upto else None
        return await self.store_backend.query(
            "activations", namespace, name, since_ms, upto_ms, skip, limit)

    async def count(self, namespace: str, name: Optional[str] = None,
                    since: Optional[float] = None, upto: Optional[float] = None
                    ) -> int:
        since_ms = since * 1000 if since else None
        upto_ms = upto * 1000 if upto else None
        return await self.store_backend.count("activations", namespace, name,
                                              since_ms, upto_ms)


class NoopActivationStore(ActivationStore):
    """Discards records (ref NoopActivationStore — used when activations are
    sinked to logs/elsewhere)."""

    async def store(self, activation, context=None):
        return None

    async def get(self, namespace, activation_id):
        raise NoDocumentException(str(activation_id))

    async def delete(self, namespace, activation_id):
        return False

    async def list(self, namespace, name=None, skip=0, limit=30, since=None, upto=None):
        return []

    async def count(self, namespace, name=None, since=None, upto=None):
        return 0


class ArtifactActivationStoreProvider:
    @staticmethod
    def instance(store: ArtifactStore, **kwargs) -> ArtifactActivationStore:
        return ArtifactActivationStore(store, **kwargs)
