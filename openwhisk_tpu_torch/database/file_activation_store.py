"""Activation store variants with file sinks.
A copy of `openwhisk_tpu/database/file_activation_store.py`.

Rebuild of common/scala/.../core/database/ArtifactWithFileStorageActivationStore
/ ActivationFileStorage: activation records (and optionally their logs) are
appended as newline-delimited JSON to a rolling file for out-of-band log
shipping, in addition to (or instead of) the artifact store.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

from ..core.entity import ActivationId, Identity, WhiskActivation
from .activation_store import ActivationStore, ArtifactActivationStore
from .store import ArtifactStore


class ActivationFileStorage:
    def __init__(self, path: str, max_bytes: int = 100 * 1024 * 1024):
        self.path = path
        self.max_bytes = max_bytes
        self._index = 0

    def _target(self) -> str:
        return self.path if self._index == 0 else f"{self.path}.{self._index}"

    def write(self, activation: WhiskActivation, namespace: str) -> None:
        target = self._target()
        try:
            if os.path.exists(target) and os.path.getsize(target) > self.max_bytes:
                self._index += 1
                target = self._target()
        except OSError:
            pass
        record = activation.to_json()
        record["namespaceId"] = namespace
        with open(target, "a") as f:
            f.write(json.dumps(record, separators=(",", ":")) + "\n")


class ArtifactWithFileStorageActivationStore(ArtifactActivationStore):
    """Store in the artifact store AND append to the activation log file
    (optionally stripping logs from the stored record, as the reference does
    when logs ship via the file)."""

    def __init__(self, store: ArtifactStore, file_path: str,
                 write_logs_to_artifact: bool = True, batch_size: int = 500):
        super().__init__(store, batch_size=batch_size)
        self.file_storage = ActivationFileStorage(file_path)
        self.write_logs_to_artifact = write_logs_to_artifact

    async def store(self, activation: WhiskActivation,
                    context: Optional[Identity] = None) -> Optional[str]:
        import asyncio
        # file IO off the event loop: this runs on the activation hot path
        await asyncio.get_event_loop().run_in_executor(
            None, self.file_storage.write, activation, str(activation.namespace))
        to_store = activation if self.write_logs_to_artifact \
            else activation.without_logs()
        return await super().store(to_store, context)
