"""CORS settings for the REST APIs and web actions.

Rebuild of core/controller/.../controller/CorsSettings.scala: every /api/v1
response carries Access-Control-Allow-* headers (origin `*`, the standard
request-header set, the REST method list), and web actions — whose CORS is
deliberately separate (RestAPIs.scala:214) — use a wider method list, echo
the preflight's Access-Control-Request-Headers, and answer OPTIONS directly
(WebActions.scala:506-520) unless the action claims OPTIONS for itself via
the `web-custom-options` annotation.

Config-driven through the CONFIG_whisk_cors_* env channel, e.g.
CONFIG_whisk_cors_allowOrigin=https://console.example.com.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

from ..utils.config import load_config


@dataclasses.dataclass
class CorsSettings:
    allow_origin: str = "*"
    allow_headers: str = ("Authorization, Origin, X-Requested-With, "
                          "Content-Type, Accept, User-Agent")
    rest_allow_methods: str = "GET, DELETE, POST, PUT, HEAD"
    web_allow_methods: str = "OPTIONS, GET, DELETE, POST, PUT, HEAD, PATCH"

    @classmethod
    def from_env(cls) -> "CorsSettings":
        return load_config(cls, env_path="cors")

    def rest_headers(self) -> Dict[str, str]:
        return {"Access-Control-Allow-Origin": self.allow_origin,
                "Access-Control-Allow-Headers": self.allow_headers,
                "Access-Control-Allow-Methods": self.rest_allow_methods}

    def web_headers(self, request_headers: Optional[Mapping[str, str]] = None
                    ) -> Dict[str, str]:
        """Web-action response headers; a preflight's requested header list
        is echoed back verbatim (ref WebActions.scala:415-418)."""
        requested = (request_headers or {}).get(
            "Access-Control-Request-Headers")
        return {"Access-Control-Allow-Origin": self.allow_origin,
                "Access-Control-Allow-Headers": requested or self.allow_headers,
                "Access-Control-Allow-Methods": self.web_allow_methods}
