"""Namespace blacklist: invoker-side protection against abusive namespaces.

Rebuild of core/invoker/.../NamespaceBlacklist.scala + the polling wiring at
InvokerReactive.scala:156-164: the invoker periodically queries the auth
store for identities that are blocked or limited to zero concurrent
invocations, and short-circuits their activations with an error activation
instead of running containers for them.
"""
from __future__ import annotations

from typing import Set

from ..database import AuthStore


class NamespaceBlacklist:
    def __init__(self, auth_store: AuthStore):
        self.auth_store = auth_store
        self._blacklist: Set[str] = set()

    async def refresh(self) -> Set[str]:
        """Poll the store (ref: every 5 min via Scheduler)."""
        blocked: Set[str] = set()
        for record in await self.auth_store.subjects():
            limits_blocked = record.blocked
            for ident in record.identities():
                if limits_blocked or ident.limits.concurrent_invocations == 0 \
                        or ident.limits.invocations_per_minute == 0:
                    blocked.add(ident.namespace.uuid.asString)
        self._blacklist = blocked
        return blocked

    def is_blacklisted(self, identity) -> bool:
        return identity.namespace.uuid.asString in self._blacklist

    def __len__(self) -> int:
        return len(self._blacklist)
