"""S3 AttachmentStore: large action code in an S3(-compatible) bucket.
A copy of `openwhisk_tpu/database/s3_attachment_store.py`.

Rebuild of common/scala/.../database/s3/S3AttachmentStore.scala — the
reference's production attachment backend. Speaks the S3 REST API directly
(no SDK in this image) with AWS Signature V4 request signing implemented
from the spec over stdlib hmac/hashlib, so it works against AWS S3, MinIO,
Ceph RGW, or any SigV4-compatible object store.

Wire surface used:
  PUT    /{bucket}/{key}                       upload (Content-Type kept)
  GET    /{bucket}/{key}                       download / 404 NoSuchKey
  DELETE /{bucket}/{key}                       delete
  GET    /{bucket}?list-type=2&prefix=...      enumerate a doc's attachments

Key layout mirrors the reference: {prefix}/{url-encoded doc id}/{name}.
Contract-tested against a fake S3 server that RE-VERIFIES every SigV4
signature server-side (tests/test_s3_attachments.py).
"""
from __future__ import annotations

import datetime
import hashlib
import hmac
import xml.etree.ElementTree as ET
from typing import List, Optional, Tuple
from urllib.parse import quote

import aiohttp

from .attachment_store import AttachmentStore
from .store import ArtifactStoreException, NoDocumentException

_ALGO = "AWS4-HMAC-SHA256"


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sign_v4(method: str, host: str, path: str, query: List[Tuple[str, str]],
            payload: bytes, access_key: str, secret_key: str,
            region: str = "us-east-1",
            now: Optional[datetime.datetime] = None) -> dict:
    """AWS SigV4 headers for one request (docs: 'Signature Version 4
    signing process'). Signed headers: host, x-amz-content-sha256,
    x-amz-date — the minimal set S3 requires."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    payload_hash = _sha256(payload)

    canonical_uri = quote(path, safe="/~")
    canonical_qs = "&".join(
        f"{quote(k, safe='~')}={quote(v, safe='~')}"
        for k, v in sorted(query))
    headers = {"host": host, "x-amz-content-sha256": payload_hash,
               "x-amz-date": amz_date}
    signed = ";".join(sorted(headers))
    canonical_headers = "".join(f"{k}:{headers[k]}\n" for k in sorted(headers))
    canonical_request = "\n".join([method, canonical_uri, canonical_qs,
                                   canonical_headers, signed, payload_hash])

    scope = f"{datestamp}/{region}/s3/aws4_request"
    string_to_sign = "\n".join([_ALGO, amz_date, scope,
                                _sha256(canonical_request.encode())])
    k = _hmac(_hmac(_hmac(_hmac(f"AWS4{secret_key}".encode(), datestamp),
                          region), "s3"), "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
    return {
        "x-amz-date": amz_date,
        "x-amz-content-sha256": payload_hash,
        "Authorization": (f"{_ALGO} Credential={access_key}/{scope}, "
                          f"SignedHeaders={signed}, Signature={signature}"),
    }


class S3AttachmentStore(AttachmentStore):
    def __init__(self, endpoint: str, bucket: str, access_key: str,
                 secret_key: str, prefix: str = "whisk-attachments",
                 region: str = "us-east-1"):
        self.endpoint = endpoint.rstrip("/")
        self.host = self.endpoint.split("://", 1)[-1]
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self._session: Optional[aiohttp.ClientSession] = None

    def _http(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession()
        return self._session

    def _key(self, doc_id: str, name: str = "") -> str:
        base = f"{self.prefix}/{quote(doc_id, safe='')}"
        return f"{base}/{name}" if name else base

    async def _request(self, method: str, path: str,
                       query: Optional[List[Tuple[str, str]]] = None,
                       payload: bytes = b"",
                       content_type: Optional[str] = None):
        query = query or []
        headers = sign_v4(method, self.host, path, query, payload,
                          self.access_key, self.secret_key, self.region)
        if content_type:
            headers["Content-Type"] = content_type
        url = self.endpoint + quote(path, safe="/~")
        if query:
            url += "?" + "&".join(f"{k}={quote(v, safe='~')}"
                                  for k, v in sorted(query))
        return self._http().request(method, url, data=payload or None,
                                    headers=headers)

    # -- AttachmentStore contract ------------------------------------------
    async def attach(self, doc_id: str, name: str, content_type: str,
                     data: bytes) -> None:
        path = f"/{self.bucket}/{self._key(doc_id, name)}"
        async with await self._request("PUT", path, payload=data,
                                       content_type=content_type) as resp:
            if resp.status != 200:
                raise ArtifactStoreException(
                    f"s3 put {path} failed ({resp.status}): "
                    f"{(await resp.text())[:256]}")

    async def read_attachment(self, doc_id: str, name: str) -> Tuple[str, bytes]:
        path = f"/{self.bucket}/{self._key(doc_id, name)}"
        async with await self._request("GET", path) as resp:
            if resp.status == 404:
                raise NoDocumentException(f"attachment {doc_id}/{name}")
            if resp.status != 200:
                raise ArtifactStoreException(
                    f"s3 get {path} failed ({resp.status})")
            return (resp.headers.get("Content-Type",
                                     "application/octet-stream"),
                    await resp.read())

    async def _list(self, doc_id: str) -> List[str]:
        path = f"/{self.bucket}"
        query = [("list-type", "2"), ("prefix", self._key(doc_id) + "/")]
        async with await self._request("GET", path, query=query) as resp:
            if resp.status != 200:
                raise ArtifactStoreException(
                    f"s3 list failed ({resp.status})")
            body = await resp.text()
        root = ET.fromstring(body)
        ns = root.tag.partition("}")[0] + "}" if root.tag.startswith("{") else ""
        return [el.text for el in root.iter(f"{ns}Key") if el.text]

    async def delete_attachments(self, doc_id: str,
                                 except_name: Optional[str] = None) -> None:
        keep = self._key(doc_id, except_name) if except_name else None
        for key in await self._list(doc_id):
            if key == keep:
                continue
            async with await self._request(
                    "DELETE", f"/{self.bucket}/{key}") as resp:
                if resp.status not in (200, 204, 404):
                    raise ArtifactStoreException(
                        f"s3 delete {key} failed ({resp.status})")

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()


class S3AttachmentStoreProvider:
    """AttachmentStoreProvider SPI binding
    (CONFIG_whisk_spi_AttachmentStoreProvider=
     openwhisk_tpu_torch.database.s3_attachment_store:S3AttachmentStoreProvider)."""

    @staticmethod
    def make_store(**kwargs) -> S3AttachmentStore:
        return S3AttachmentStore(**kwargs)
