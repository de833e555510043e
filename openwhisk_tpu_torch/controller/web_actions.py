"""Web actions: anonymous HTTP endpoints per action.

Rebuild of core/controller/.../controller/WebActions.scala:375-576 — an
action annotated `web-export: true` is reachable without credentials at
/api/v1/web/{ns}/{pkg|default}/{name}.{ext}. The request context is projected
into __ow_* fields (method, headers, path, query, body), the activation runs
under the action owner's identity, and the response is negotiated by the
extension: .json (full result), .text/.html/.svg (one field rendered), .http
(result dictates statusCode/headers/body). `raw-http` passes the body
through unparsed; `final` locks exported parameters.

CORS: responses carry the web-action CORS headers and OPTIONS preflight is
answered by the platform (WebActions.scala:506-520, controller/cors.py)
unless the `web-custom-options` annotation routes OPTIONS to the action.
"""
from __future__ import annotations

import base64
import json
from typing import Optional, Tuple

from aiohttp import web

from ..core.entity import Identity
from ..core.entity.names import FullyQualifiedEntityName
from ..database import NoDocumentException
from ..utils.transaction import TransactionId
from .invoke import resolve_action

EXTENSIONS = (".json", ".html", ".http", ".text", ".svg")


def _split_extension(name: str) -> Tuple[str, str]:
    for ext in EXTENSIONS:
        if name.endswith(ext):
            return name[: -len(ext)], ext
    return name, ".http"


class WebActionsApi:
    def __init__(self, controller):
        self.c = controller

    async def handle(self, request: web.Request) -> web.Response:
        ns = request.match_info["ns"]
        pkg = request.match_info["pkg"]
        raw_name = request.match_info["name"]
        name, ext = _split_extension(raw_name)
        path = f"{ns}/{name}" if pkg == "default" else f"{ns}/{pkg}/{name}"
        try:
            fqn = FullyQualifiedEntityName.parse(path)
        except ValueError:
            return web.json_response({"error": "malformed action reference"}, status=404)

        owner = await self.c.auth_store.identity_by_namespace(ns)
        if owner is None:
            return web.json_response(
                {"error": "The requested resource does not exist."}, status=404)
        try:
            action, pkg_params = await resolve_action(self.c.entity_store, fqn, owner)
        except NoDocumentException:
            return web.json_response(
                {"error": "The requested resource does not exist."}, status=404)

        web_flag = action.annotations.get("web-export")
        if web_flag is not True:
            return web.json_response(
                {"error": "The requested resource does not exist."}, status=404)
        # require-whisk-auth (ref WebActions.scala): a secret-valued
        # annotation demands the matching X-Require-Whisk-Auth header; the
        # boolean `true` demands valid platform credentials instead
        required = action.annotations.get("require-whisk-auth")
        denied = web.json_response(
            {"error": "Authentication is possible but has failed or not "
                      "yet been provided."}, status=401)
        if required is True:
            ident = await self.c.authenticator.identity_from_header(
                request.headers.get("Authorization"))
            if ident is None:
                return denied
        elif required is not None and required is not False:
            # identity tests, not equality: the secret 0 must NOT be treated
            # as the boolean False (0 == False in Python)
            if request.headers.get("X-Require-Whisk-Auth") != str(required):
                return denied
        raw_http = action.annotations.get("raw-http") is True

        # CORS + OPTIONS preflight (ref WebActions.scala:506-520): unless
        # the action claims OPTIONS via `web-custom-options`, preflight is
        # answered here and every response carries the web CORS headers.
        # Deliberately AFTER the 404/require-whisk-auth checks above — the
        # reference evaluates requiredWhiskAuthSuccessful first and its
        # terminate(Unauthorized)/NotFound responses carry no CORS headers
        # (WebActions.scala:503-511), so a require-whisk-auth action is
        # likewise not preflightable here
        custom_options = action.annotations.get("web-custom-options") is True
        cors = None if custom_options else self.c.cors.web_headers(request.headers)
        if cors is not None and request.method == "OPTIONS":
            return web.Response(status=200, headers=cors)

        payload = await self._context_payload(request, raw_http)
        transid = TransactionId()
        outcome = await self.c.invoker.invoke(owner, action, pkg_params, payload,
                                              blocking=True, transid=transid)
        if outcome.accepted or outcome.activation is None:
            resp = web.json_response({"error": "Response not yet ready."}, status=502)
        else:
            result = outcome.activation.response.result or {}
            if not outcome.activation.response.is_success and ext != ".http":
                resp = web.json_response(
                    {"error": result.get("error", "request failed"),
                     "activationId": outcome.activation_id.asString},
                    status=502)
            else:
                resp = self._render(result, ext)
        if cors is not None:
            resp.headers.update(cors)
        return resp

    async def _context_payload(self, request: web.Request, raw_http: bool) -> dict:
        body = await request.read()
        payload = {}
        if raw_http:
            payload["__ow_body"] = base64.b64encode(body).decode() if body else ""
            payload["__ow_query"] = request.query_string
        else:
            if body:
                try:
                    parsed = json.loads(body)
                    if isinstance(parsed, dict):
                        payload.update(parsed)
                    else:
                        payload["__ow_body"] = parsed
                except json.JSONDecodeError:
                    payload["__ow_body"] = body.decode(errors="replace")
            payload.update({k: v for k, v in request.query.items()})
        payload["__ow_method"] = request.method.lower()
        payload["__ow_headers"] = dict(request.headers)
        payload["__ow_path"] = ""
        return payload

    def _render(self, result: dict, ext: str) -> web.Response:
        if ext == ".json":
            return web.json_response(result)
        if ext in (".text", ".html", ".svg"):
            field = {".text": "text"}.get(ext, ext[1:])
            content_types = {"text": "text/plain", "html": "text/html",
                             "svg": "image/svg+xml"}
            value = result.get(field, result)
            if not isinstance(value, str):
                value = json.dumps(value)
            return web.Response(text=value, content_type=content_types[field])
        # .http: the action controls the response
        status = int(result.get("statusCode", 200))
        headers = {str(k): str(v) for k, v in (result.get("headers") or {}).items()}
        body = result.get("body", "")
        if isinstance(body, (dict, list)):
            return web.json_response(body, status=status, headers=headers)
        if isinstance(body, str):
            try:
                decoded = base64.b64decode(body, validate=True)
                if headers.get("Content-Type", "").startswith(("image/", "application/octet")):
                    return web.Response(body=decoded, status=status, headers=headers)
            except Exception:  # noqa: BLE001 — not base64: plain text body
                pass
            ct = headers.pop("Content-Type", "text/html")
            return web.Response(text=body, status=status, headers=headers,
                                content_type=ct.split(";")[0])
        return web.Response(text=str(body), status=status, headers=headers)
