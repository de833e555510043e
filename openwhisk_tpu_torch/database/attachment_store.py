"""AttachmentStore SPI: out-of-band blob storage for large action code.

Rebuild of common/scala/.../core/database/AttachmentStore (SPI) with its two
reference impls — S3AttachmentStore (s3/S3AttachmentStoreProvider.scala) and
MemoryAttachmentStore (memory/MemoryAttachmentStore.scala). An ArtifactStore
can delegate attachment bytes here so entity documents stay small in the
document store while code blobs live in an object store. The file-backed
impl is the S3 equivalent for this environment: an object-store layout of
one blob per attachment under {base_dir}/{docid-sha}/{name} with a JSON
sidecar for metadata.
"""
from __future__ import annotations

import asyncio
import hashlib
import json
import os
import shutil
from typing import Dict, Optional, Tuple

from .store import NoDocumentException


class AttachmentStore:
    """Attachment byte-store contract (ref AttachmentStore.scala)."""

    async def attach(self, doc_id: str, name: str, content_type: str,
                     data: bytes) -> None:
        raise NotImplementedError

    async def read_attachment(self, doc_id: str, name: str) -> Tuple[str, bytes]:
        """Returns (content_type, bytes); NoDocumentException if absent."""
        raise NotImplementedError

    async def delete_attachments(self, doc_id: str,
                                 except_name: Optional[str] = None) -> None:
        raise NotImplementedError

    async def close(self) -> None:
        pass


class MemoryAttachmentStore(AttachmentStore):
    """In-memory impl (ref MemoryAttachmentStore.scala) for tests/standalone."""

    def __init__(self):
        self._blobs: Dict[str, Dict[str, Tuple[str, bytes]]] = {}

    async def attach(self, doc_id, name, content_type, data):
        self._blobs.setdefault(doc_id, {})[name] = (content_type, bytes(data))

    async def read_attachment(self, doc_id, name):
        try:
            return self._blobs[doc_id][name]
        except KeyError:
            raise NoDocumentException(f"attachment {doc_id}/{name}") from None

    async def delete_attachments(self, doc_id, except_name=None):
        if except_name is None:
            self._blobs.pop(doc_id, None)
        elif doc_id in self._blobs:
            self._blobs[doc_id] = {n: v for n, v in self._blobs[doc_id].items()
                                   if n == except_name}

    @property
    def attachment_count(self) -> int:
        return sum(len(v) for v in self._blobs.values())


class FileAttachmentStore(AttachmentStore):
    """Durable object-store-layout impl — the S3AttachmentStore equivalent.

    Blob key = sha256(doc_id)/name (doc ids contain '/'); a `.meta.json`
    sidecar carries the content type, as S3 object metadata would. IO hops to
    a thread so the event loop never blocks on disk.
    """

    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        os.makedirs(base_dir, exist_ok=True)

    def _dir(self, doc_id: str) -> str:
        return os.path.join(self.base_dir,
                            hashlib.sha256(doc_id.encode()).hexdigest()[:32])

    async def attach(self, doc_id, name, content_type, data):
        def write():
            d = self._dir(doc_id)
            os.makedirs(d, exist_ok=True)
            tmp = os.path.join(d, f".{name}.tmp")
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, os.path.join(d, name))  # atomic publish
            with open(os.path.join(d, f"{name}.meta.json"), "w") as f:
                json.dump({"contentType": content_type, "docId": doc_id}, f)
        await asyncio.get_event_loop().run_in_executor(None, write)

    async def read_attachment(self, doc_id, name):
        def read():
            d = self._dir(doc_id)
            try:
                with open(os.path.join(d, name), "rb") as f:
                    data = f.read()
            except OSError:
                raise NoDocumentException(f"attachment {doc_id}/{name}") from None
            try:
                with open(os.path.join(d, f"{name}.meta.json")) as f:
                    ctype = json.load(f).get("contentType", "text/plain")
            except OSError:
                ctype = "text/plain"
            return ctype, data
        return await asyncio.get_event_loop().run_in_executor(None, read)

    async def delete_attachments(self, doc_id, except_name=None):
        def delete():
            d = self._dir(doc_id)
            if not os.path.isdir(d):
                return
            if except_name is None:
                shutil.rmtree(d, ignore_errors=True)
                return
            keep = {except_name, f"{except_name}.meta.json"}
            for entry in os.listdir(d):
                if entry not in keep:
                    try:
                        os.remove(os.path.join(d, entry))
                    except OSError:
                        pass
        await asyncio.get_event_loop().run_in_executor(None, delete)


class MemoryAttachmentStoreProvider:
    @staticmethod
    def make_store(**kwargs) -> MemoryAttachmentStore:
        return MemoryAttachmentStore()


class FileAttachmentStoreProvider:
    @staticmethod
    def make_store(base_dir: str = "attachments", **kwargs) -> FileAttachmentStore:
        return FileAttachmentStore(base_dir)
