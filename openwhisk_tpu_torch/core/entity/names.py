"""Entity naming: names, paths, fully-qualified names.

Refs: EntityName/EntityPath in common/scala/.../core/entity/EntityPath.scala,
FullyQualifiedEntityName.scala. A path is /namespace[/package]; the default
namespace placeholder is "_" and resolves to the subject's own namespace.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

ENTITY_NAME_RX = re.compile(r"^[a-zA-Z0-9][a-zA-Z0-9@ _\-.]*$")
DEFAULT_NAMESPACE = "_"
MAX_NAME_LENGTH = 256


@lru_cache(maxsize=8192)
def _name_ok(name: str) -> bool:
    """Validation verdict per distinct string: entity names repeat heavily
    on the hot path (every message parse re-validates the same few action/
    namespace names), so the regex runs once per distinct name."""
    return bool(name) and len(name) <= MAX_NAME_LENGTH \
        and ENTITY_NAME_RX.match(name) is not None


@lru_cache(maxsize=8192)
def _path_segments(path: str) -> tuple:
    """Split + validate a path once per distinct string (raises on invalid,
    so the cache only ever holds valid splits). Segments are regex-checked
    only — EntityPath has never enforced MAX_NAME_LENGTH per segment, and
    stored documents may rely on that."""
    segs = tuple(s for s in path.strip("/").split("/") if s != "")
    if not segs:
        raise ValueError(f"path {path!r} is not a valid entity path")
    for s in segs:
        if s != DEFAULT_NAMESPACE and not ENTITY_NAME_RX.match(s):
            raise ValueError(f"path segment {s!r} is not valid")
    return segs


@dataclass(frozen=True)
class EntityName:
    name: str

    def __post_init__(self):
        if not _name_ok(self.name):
            raise ValueError(f"name {self.name!r} is not a valid entity name")

    def to_path(self) -> "EntityPath":
        return EntityPath(self.name)

    def to_json(self):
        return self.name

    def __str__(self):
        return self.name


@dataclass(frozen=True)
class EntityPath:
    """Slash-separated path: "namespace" or "namespace/package"."""
    path: str

    def __post_init__(self):
        _path_segments(self.path)  # raises on invalid

    @property
    def segments(self):
        return list(_path_segments(self.path))

    @property
    def root(self) -> EntityName:
        seg = self.segments[0]
        return EntityName(seg) if seg != DEFAULT_NAMESPACE else EntityName("_default_")

    @property
    def root_str(self) -> str:
        return self.segments[0]

    @property
    def default_package(self) -> bool:
        return len(self.segments) == 1

    @property
    def is_default_namespace(self) -> bool:
        return self.segments[0] == DEFAULT_NAMESPACE

    def resolve_namespace(self, namespace: str) -> "EntityPath":
        """Replace a leading "_" with the subject's namespace
        (ref EntityPath.resolveNamespace)."""
        segs = self.segments
        if segs[0] == DEFAULT_NAMESPACE:
            return EntityPath("/".join([namespace] + segs[1:]))
        return self

    def add(self, name) -> "EntityPath":
        return EntityPath(self.path.strip("/") + "/" + str(name))

    @property
    def rel_path(self) -> Optional["EntityPath"]:
        """Path without the root namespace, if any."""
        segs = self.segments
        return EntityPath("/".join(segs[1:])) if len(segs) > 1 else None

    def to_fqn(self) -> "FullyQualifiedEntityName":
        segs = self.segments
        return FullyQualifiedEntityName(EntityPath("/".join(segs[:-1])), EntityName(segs[-1]))

    def to_json(self):
        return "/".join(self.segments)

    def __str__(self):
        return "/".join(self.segments)


@dataclass(frozen=True)
class FullyQualifiedEntityName:
    """path + name, e.g. namespace/package + action."""
    path: EntityPath
    name: EntityName
    version: Optional[object] = None

    @classmethod
    def parse(cls, fqn: str) -> "FullyQualifiedEntityName":
        segs = [s for s in fqn.strip("/").split("/") if s]
        if len(segs) < 2:
            raise ValueError(f"{fqn!r} is not a fully qualified entity name")
        return cls(EntityPath("/".join(segs[:-1])), EntityName(segs[-1]))

    @property
    def fully_qualified_name(self) -> str:
        return f"{self.path}/{self.name}"

    @property
    def namespace(self) -> str:
        return self.path.root_str

    def resolve(self, namespace: str) -> "FullyQualifiedEntityName":
        return FullyQualifiedEntityName(self.path.resolve_namespace(namespace), self.name, self.version)

    def add(self, name) -> "FullyQualifiedEntityName":
        return FullyQualifiedEntityName(self.path.add(self.name), EntityName(str(name)))

    def to_doc_id(self) -> str:
        return self.fully_qualified_name

    def to_json(self):
        return {"path": self.path.to_json(), "name": self.name.to_json()}

    @classmethod
    def from_json(cls, j) -> "FullyQualifiedEntityName":
        if isinstance(j, str):
            return cls.parse(j)
        return cls(EntityPath(j["path"]), EntityName(j["name"]))

    def __str__(self):
        return self.fully_qualified_name
