"""Identities: authenticated subjects with namespaces, keys and limits.

Ref: Identity.scala + UserLimits in common/scala/.../core/entity — an
Identity is (subject, namespace(uuid,name), authkey, rights, limits); limits
override the system defaults per namespace (invocationsPerMinute,
concurrentInvocations, firesPerMinute, allowedKinds, storeActivations).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import FrozenSet, List, Optional

from .ids import BasicAuthenticationAuthKey, Secret, Subject, UUID
from .names import EntityName, EntityPath

# privileges (ref core/entitlement/Privilege.scala)
READ = "READ"
PUT = "PUT"
DELETE = "DELETE"
ACTIVATE = "ACTIVATE"
REJECT = "REJECT"
ALL_RIGHTS = frozenset((READ, PUT, DELETE, ACTIVATE))


@dataclass(frozen=True)
class UserLimits:
    invocations_per_minute: Optional[int] = None
    concurrent_invocations: Optional[int] = None
    fires_per_minute: Optional[int] = None
    allowed_kinds: Optional[tuple] = None
    store_activations: Optional[bool] = None

    def to_json(self):
        j = {}
        if self.invocations_per_minute is not None:
            j["invocationsPerMinute"] = self.invocations_per_minute
        if self.concurrent_invocations is not None:
            j["concurrentInvocations"] = self.concurrent_invocations
        if self.fires_per_minute is not None:
            j["firesPerMinute"] = self.fires_per_minute
        if self.allowed_kinds is not None:
            j["allowedKinds"] = list(self.allowed_kinds)
        if self.store_activations is not None:
            j["storeActivations"] = self.store_activations
        return j

    @classmethod
    def from_json(cls, j) -> "UserLimits":
        j = j or {}
        ak = j.get("allowedKinds")
        return cls(j.get("invocationsPerMinute"), j.get("concurrentInvocations"),
                   j.get("firesPerMinute"), tuple(ak) if ak is not None else None,
                   j.get("storeActivations"))


@dataclass(frozen=True)
class Namespace:
    name: EntityName
    uuid: UUID

    def to_json(self):
        return {"name": str(self.name), "uuid": self.uuid.to_json()}

    @classmethod
    def from_json(cls, j) -> "Namespace":
        return cls(EntityName(j["name"]), UUID(j["uuid"]))


@dataclass(frozen=True)
class Identity:
    subject: Subject
    namespace: Namespace
    authkey: BasicAuthenticationAuthKey
    rights: FrozenSet[str] = ALL_RIGHTS
    limits: UserLimits = field(default_factory=UserLimits)

    @classmethod
    def generate(cls, name: str) -> "Identity":
        # one uuid identifies both the namespace and the credential — the
        # reference's WhiskNamespace carries the authkey's uuid
        key = BasicAuthenticationAuthKey.generate()
        return cls(Subject(name if len(name) >= 5 else name + "-user"),
                   Namespace(EntityName(name), key.uuid), key)

    @property
    def namespace_path(self) -> EntityPath:
        return EntityPath(str(self.namespace.name))

    def to_json(self):
        return {
            "subject": self.subject.to_json(),
            "namespace": self.namespace.to_json(),
            "authkey": self.authkey.to_json(),
            "rights": sorted(self.rights),
            "limits": self.limits.to_json(),
        }

    @classmethod
    def from_json(cls, j) -> "Identity":
        return cls(
            Subject(j["subject"]),
            Namespace.from_json(j["namespace"]),
            BasicAuthenticationAuthKey.parse(j["authkey"]["api_key"]),
            frozenset(j.get("rights", ALL_RIGHTS)),
            UserLimits.from_json(j.get("limits")),
        )


@dataclass
class WhiskAuthRecord:
    """Subject document in the auth store: a subject owning one or more
    namespaces (ref WhiskAuth/WhiskNamespace in Identity.scala), each with
    optional per-namespace limit overrides (the reference stores these as
    separate `<ns>/limits` documents; here they ride on the record)."""
    subject: Subject
    namespaces: List[Namespace]
    keys: List[BasicAuthenticationAuthKey]
    blocked: bool = False
    limits: dict = field(default_factory=dict)  # namespace name -> UserLimits

    def identities(self) -> List[Identity]:
        return [Identity(self.subject, ns, k,
                         limits=self.limits.get(str(ns.name), UserLimits()))
                for ns, k in zip(self.namespaces, self.keys)]

    def to_json(self):
        return {
            "subject": self.subject.to_json(),
            "namespaces": [
                {**ns.to_json(), "key": k.key.asString, "uuid": k.uuid.asString}
                for ns, k in zip(self.namespaces, self.keys)
            ],
            "blocked": self.blocked,
            "limits": {ns: l.to_json() for ns, l in self.limits.items()},
        }

    @classmethod
    def from_json(cls, j) -> "WhiskAuthRecord":
        nss, keys = [], []
        for n in j.get("namespaces", []):
            nss.append(Namespace(EntityName(n["name"]), UUID(n["uuid"])))
            keys.append(BasicAuthenticationAuthKey(UUID(n["uuid"]), Secret(n["key"])))
        limits = {ns: UserLimits.from_json(l)
                  for ns, l in (j.get("limits") or {}).items()}
        return cls(Subject(j["subject"]), nss, keys, bool(j.get("blocked", False)),
                   limits)
