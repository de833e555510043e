"""Request authentication (ref controller RestAPIs.scala:323-349
AuthenticationDirectiveProvider + BasicAuthenticationDirective): HTTP Basic
credentials are the identity's uuid:key; lookups hit the auth store's cached
identity views."""
from __future__ import annotations

import base64
import binascii
from typing import Optional

from ..core.entity import Identity
from ..database import AuthStore


class BasicAuthenticationProvider:
    def __init__(self, auth_store: AuthStore):
        self.auth_store = auth_store

    async def identity_from_header(self, authorization: Optional[str]) -> Optional[Identity]:
        if not authorization or not authorization.lower().startswith("basic "):
            return None
        try:
            decoded = base64.b64decode(authorization[6:].strip()).decode()
        except (binascii.Error, UnicodeDecodeError):
            return None
        user, _, password = decoded.partition(":")
        if not user or not password:
            return None
        return await self.auth_store.identity_by_key(user, password)

    @staticmethod
    def instance(auth_store: AuthStore) -> "BasicAuthenticationProvider":
        return BasicAuthenticationProvider(auth_store)
