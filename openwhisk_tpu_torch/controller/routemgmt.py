"""API-gateway route management.

Rebuild of core/routemgmt/ (reference: createApi/createApi.js, getApi/getApi.js,
deleteApi/deleteApi.js, common/apigw-utils.js) — in the reference these are
JavaScript *actions* installed into the system namespace that CRUD route
documents in an external API gateway. Here route management is a first-class
controller service instead of a loopback through the action path: API
definitions are swagger-shaped documents in the artifact store (collection
``apis``), and the edge proxy (openwhisk_tpu.edge) serves them by forwarding
matched requests to the target web action — the role the external gateway
plays in the reference deployment.

Document shape follows the gateway's generated swagger (apigw-utils.js
``generateBaseSwaggerApi``/``addEndpointToSwaggerApi``): one doc per
(namespace, basePath) holding ``paths[relPath][verb]`` operations, each
carrying an ``x-openwhisk`` block naming the backing web action.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ..database import NoDocumentException
from ..database.store import ArtifactStore

VERBS = ("get", "put", "post", "delete", "patch", "head", "options")
RESPONSE_TYPES = ("json", "http", "text", "html", "svg")


class ApiManagementException(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def _doc_id(namespace: str, base_path: str) -> str:
    return f"{namespace}/apis{base_path}"


def _normalize_base_path(base_path: str) -> str:
    if not base_path.startswith("/"):
        base_path = "/" + base_path
    return base_path.rstrip("/") or "/"


def _normalize_rel_path(rel_path: str) -> str:
    if not rel_path.startswith("/"):
        rel_path = "/" + rel_path
    return rel_path


class ApiRouteManager:
    """CRUD of API route documents + route matching for the edge proxy."""

    def __init__(self, store: ArtifactStore, api_host: str = "",
                 route_table_ttl: float = 2.0):
        self.store = store
        self.api_host = api_host
        # match() runs on the edge hot path for every non-/api request: keep a
        # short-TTL snapshot of the route table instead of querying the store
        # per request; writes through this manager invalidate it immediately.
        self.route_table_ttl = route_table_ttl
        self._route_docs: Optional[List[Dict[str, Any]]] = None
        self._route_docs_expiry = 0.0

    def _invalidate_routes(self) -> None:
        self._route_docs = None
        self._route_docs_expiry = 0.0

    # ------------------------------------------------------------- create
    async def create_api(self, namespace: str, apidoc: Dict[str, Any]
                         ) -> Dict[str, Any]:
        """createApi.js semantics: add/update one endpoint (or install a full
        swagger doc) under `namespace`."""
        if "swagger" in apidoc:
            return await self._put_swagger(namespace, apidoc["swagger"])

        for field in ("gatewayBasePath", "gatewayPath", "gatewayMethod", "action"):
            if field not in apidoc:
                raise ApiManagementException(
                    400, f"Missing required field '{field}' in apidoc")
        verb = apidoc["gatewayMethod"].lower()
        if verb not in VERBS:
            raise ApiManagementException(400, f"Invalid gatewayMethod '{verb}'")
        action = apidoc["action"]
        for field in ("name", "namespace"):
            if field not in action:
                raise ApiManagementException(
                    400, f"Missing required field 'action.{field}' in apidoc")
        response_type = apidoc.get("responsetype", "json")
        if response_type not in RESPONSE_TYPES:
            raise ApiManagementException(
                400, f"Invalid responsetype '{response_type}'")

        base_path = _normalize_base_path(apidoc["gatewayBasePath"])
        rel_path = _normalize_rel_path(apidoc["gatewayPath"])
        doc_id = _doc_id(namespace, base_path)
        try:
            doc = await self.store.get(doc_id)
        except NoDocumentException:
            doc = self._base_doc(namespace, base_path,
                                 apidoc.get("apiName") or base_path)
        if apidoc.get("apiName"):
            doc["apiName"] = apidoc["apiName"]
        op = {
            "operationId": f"{verb}{rel_path}",
            "responses": {"default": {"description": "Default response"}},
            "x-openwhisk": {
                "namespace": action["namespace"],
                "package": action.get("package", ""),
                "action": action["name"].split("/")[-1],
                "responsetype": response_type,
                "url": self._backend_url(action, response_type),
            },
        }
        doc.setdefault("swagger", {}).setdefault("paths", {}) \
           .setdefault(rel_path, {})[verb] = op
        doc["updated"] = time.time()
        rev = await self.store.put(doc_id, doc, rev=doc.get("_rev"))
        doc["_rev"] = rev
        self._invalidate_routes()
        return self._public_view(doc)

    async def _put_swagger(self, namespace: str, swagger: Dict[str, Any]
                           ) -> Dict[str, Any]:
        # validate per-operation shape up front: match() relies on every
        # operation carrying an x-openwhisk block naming the backing action
        for rel, ops in (swagger.get("paths") or {}).items():
            if not isinstance(ops, dict):
                raise ApiManagementException(
                    400, f"swagger path {rel!r} must map verbs to operations")
            for verb, op in ops.items():
                if verb not in VERBS:
                    raise ApiManagementException(
                        400, f"Invalid verb {verb!r} at swagger path {rel!r}")
                xow = op.get("x-openwhisk") if isinstance(op, dict) else None
                if not isinstance(xow, dict) or "namespace" not in xow \
                        or "action" not in xow:
                    raise ApiManagementException(
                        400, f"operation {verb} {rel} must carry an "
                             "x-openwhisk block with namespace and action")
        base_path = _normalize_base_path(swagger.get("basePath", "/"))
        doc_id = _doc_id(namespace, base_path)
        try:
            existing = await self.store.get(doc_id)
            rev = existing.get("_rev")
        except NoDocumentException:
            rev = None
        doc = self._base_doc(namespace, base_path,
                             swagger.get("info", {}).get("title") or base_path)
        doc["swagger"] = swagger
        doc["updated"] = time.time()
        doc["_rev"] = await self.store.put(doc_id, doc, rev=rev)
        self._invalidate_routes()
        return self._public_view(doc)

    # ---------------------------------------------------------------- get
    async def get_apis(self, namespace: str,
                       base_path: Optional[str] = None,
                       rel_path: Optional[str] = None,
                       verb: Optional[str] = None) -> List[Dict[str, Any]]:
        """getApi.js semantics: list APIs, optionally filtered down to one
        basePath (or apiName), relPath, and verb."""
        docs = await self.store.query("apis", namespace, limit=1000)
        out = []
        for doc in docs:
            if base_path and doc.get("basePath") != _normalize_base_path(base_path) \
                    and doc.get("apiName") != base_path:
                continue
            view = self._public_view(doc)
            if rel_path or verb:
                paths = view["swagger"].get("paths", {})
                rel = _normalize_rel_path(rel_path) if rel_path else None
                filtered = {}
                for p, ops in paths.items():
                    if rel and p != rel:
                        continue
                    ops = {v: op for v, op in ops.items()
                           if verb is None or v == verb.lower()}
                    if ops:
                        filtered[p] = ops
                if not filtered:
                    continue
                view["swagger"] = dict(view["swagger"], paths=filtered)
            out.append(view)
        return out

    # ------------------------------------------------------------- delete
    async def delete_api(self, namespace: str, base_path: str,
                         rel_path: Optional[str] = None,
                         verb: Optional[str] = None) -> None:
        """deleteApi.js semantics: delete the whole API, one path, or one
        operation; the doc disappears when its last operation does."""
        base_path = _normalize_base_path(base_path)
        doc_id = _doc_id(namespace, base_path)
        doc = await self.store.get(doc_id)  # NoDocumentException → 404 upstream
        if rel_path is None:
            await self.store.delete(doc_id, rev=doc.get("_rev"))
            self._invalidate_routes()
            return
        rel = _normalize_rel_path(rel_path)
        paths = doc.get("swagger", {}).get("paths", {})
        if rel not in paths:
            raise NoDocumentException(f"no such path {rel}")
        if verb is None:
            del paths[rel]
        else:
            v = verb.lower()
            if v not in paths[rel]:
                raise NoDocumentException(f"no such operation {v} {rel}")
            del paths[rel][v]
            if not paths[rel]:
                del paths[rel]
        if not paths:
            await self.store.delete(doc_id, rev=doc.get("_rev"))
        else:
            doc["updated"] = time.time()
            await self.store.put(doc_id, doc, rev=doc.get("_rev"))
        self._invalidate_routes()

    # ------------------------------------------------------------ routing
    async def match(self, method: str, path: str
                    ) -> Optional[Dict[str, Any]]:
        """Edge-proxy lookup: longest-basePath-prefix match of (method, path)
        over every namespace's APIs → the operation's x-openwhisk block."""
        verb = method.lower()
        now = time.monotonic()
        if self._route_docs is None or now >= self._route_docs_expiry:
            self._route_docs = await self.store.query("apis", None, limit=10_000)
            self._route_docs_expiry = now + self.route_table_ttl
        docs = self._route_docs
        best: Optional[Dict[str, Any]] = None
        best_len = -1
        for doc in docs:
            base = doc.get("basePath", "")
            if not (path == base or path.startswith(base.rstrip("/") + "/")):
                continue
            if len(base) <= best_len:
                continue
            rel = path[len(base.rstrip("/")):] or "/"
            ops = doc.get("swagger", {}).get("paths", {}).get(rel, {})
            op = ops.get(verb)
            if isinstance(op, dict) and isinstance(op.get("x-openwhisk"), dict):
                best = op["x-openwhisk"]
                best_len = len(base)
        return best

    # ------------------------------------------------------------ helpers
    def _base_doc(self, namespace: str, base_path: str, api_name: str
                  ) -> Dict[str, Any]:
        return {
            "entityType": "apis",
            "namespace": namespace,
            "name": base_path,
            "basePath": base_path,
            "apiName": api_name,
            "swagger": {
                "swagger": "2.0",
                "basePath": base_path,
                "info": {"title": api_name, "version": "1.0.0"},
                "paths": {},
            },
            "updated": time.time(),
        }

    def _backend_url(self, action: Dict[str, Any], response_type: str) -> str:
        if action.get("backendUrl"):  # caller supplied the full URL
            return action["backendUrl"]
        pkg = action.get("package") or "default"
        name = action["name"].split("/")[-1]
        return (f"{self.api_host}/api/v1/web/{action['namespace']}/{pkg}/"
                f"{name}.{response_type}")

    @staticmethod
    def _public_view(doc: Dict[str, Any]) -> Dict[str, Any]:
        return {
            "namespace": doc["namespace"],
            "basePath": doc["basePath"],
            "apiName": doc.get("apiName", doc["basePath"]),
            "swagger": doc.get("swagger", {}),
        }
