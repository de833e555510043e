"""Runtimes manifest: which managed kinds exist, their images and stem cells.

Ref: common/scala/.../core/entity/ExecManifest.scala:36-199 — the manifest is
JSON of the form {"runtimes": {"python": [{"kind": "python:3", "image": {...},
"default": true, "stemCells": [{"count": 2, "memory": "256 MB"}]}]}};
`ImageName` composes registry/prefix/name/tag; `StemCell` (:141-143) drives
prewarm container pools.
"""
from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .size import ByteSize, MB


@dataclass(frozen=True)
class ImageName:
    name: str
    registry: Optional[str] = None
    prefix: Optional[str] = None
    tag: Optional[str] = None

    @property
    def localname(self) -> str:
        parts = [p for p in (self.prefix, self.name) if p]
        base = "/".join(parts)
        return f"{base}:{self.tag}" if self.tag else base

    @property
    def resolved(self) -> str:
        base = self.localname
        return f"{self.registry.rstrip('/')}/{base}" if self.registry else base

    @classmethod
    def from_string(cls, s: str) -> "ImageName":
        registry = prefix = tag = None
        rest = s
        if "/" in rest:
            first, _, remainder = rest.partition("/")
            if "." in first or ":" in first or first == "localhost":
                registry, rest = first, remainder
        if "/" in rest:
            prefix, _, rest = rest.rpartition("/")
        if ":" in rest:
            rest, _, tag = rest.partition(":")
        return cls(rest, registry, prefix, tag)

    def to_json(self):
        j = {"name": self.name}
        if self.registry:
            j["registry"] = self.registry
        if self.prefix:
            j["prefix"] = self.prefix
        if self.tag:
            j["tag"] = self.tag
        return j

    @classmethod
    def from_json(cls, j) -> "ImageName":
        if isinstance(j, str):
            return cls.from_string(j)
        return cls(j["name"], j.get("registry"), j.get("prefix"), j.get("tag"))


@dataclass(frozen=True)
class StemCell:
    """Prewarm spec: keep `count` containers of `memory` warm for a kind
    (ref ExecManifest.scala:141-143)."""
    count: int
    memory: ByteSize

    def __post_init__(self):
        if self.count < 1:
            raise ValueError("stem cell count must be positive")

    def to_json(self):
        return {"count": self.count, "memory": self.memory.to_json()}

    @classmethod
    def from_json(cls, j) -> "StemCell":
        return cls(int(j["count"]), ByteSize.from_json(j.get("memory", "256 MB")))


@dataclass
class RuntimeManifest:
    kind: str
    image: ImageName
    default: bool = False
    deprecated: bool = False
    stem_cells: List[StemCell] = field(default_factory=list)
    attached: bool = False

    def to_json(self):
        return {"kind": self.kind, "image": self.image.to_json(), "default": self.default,
                "deprecated": self.deprecated,
                "stemCells": [s.to_json() for s in self.stem_cells]}

    @classmethod
    def from_json(cls, j) -> "RuntimeManifest":
        return cls(kind=j["kind"], image=ImageName.from_json(j["image"]),
                   default=bool(j.get("default", False)),
                   deprecated=bool(j.get("deprecated", False)),
                   stem_cells=[StemCell.from_json(s) for s in j.get("stemCells", [])])


class Runtimes:
    """The full manifest (ref ExecManifest.Runtimes)."""

    def __init__(self, runtimes: Dict[str, List[RuntimeManifest]],
                 blackbox_images: Optional[List[ImageName]] = None):
        self.by_family = runtimes
        self.blackbox_images = blackbox_images or []
        self._by_kind: Dict[str, RuntimeManifest] = {}
        self._default_by_family: Dict[str, RuntimeManifest] = {}
        for family, manifests in runtimes.items():
            for m in manifests:
                self._by_kind[m.kind] = m
                if m.default:
                    self._default_by_family[family] = m

    @property
    def kinds(self) -> List[str]:
        return sorted(self._by_kind.keys())

    def resolve_default(self, kind: str) -> str:
        """Map "python:default" -> the family's default kind."""
        family, _, tag = kind.partition(":")
        if tag == "default":
            m = self._default_by_family.get(family)
            if m is None:
                raise ValueError(f"no default runtime for family {family!r}")
            return m.kind
        return kind

    def manifest_for(self, kind: str) -> Optional[RuntimeManifest]:
        return self._by_kind.get(self.resolve_default(kind) if kind.endswith(":default") else kind)

    def knows(self, kind: str) -> bool:
        return self.manifest_for(kind) is not None

    def stem_cells(self) -> List[tuple]:
        """[(RuntimeManifest, StemCell)] for all prewarm pools."""
        out = []
        for manifests in self.by_family.values():
            for m in manifests:
                for s in m.stem_cells:
                    out.append((m, s))
        return out

    def to_json(self):
        return {"runtimes": {f: [m.to_json() for m in ms] for f, ms in self.by_family.items()}}

    @classmethod
    def from_json(cls, j) -> "Runtimes":
        return cls({f: [RuntimeManifest.from_json(m) for m in ms]
                    for f, ms in j.get("runtimes", {}).items()},
                   [ImageName.from_json(b) for b in j.get("blackboxes", [])])


# Default manifest for this framework: python-first (the in-tree action proxy
# is python; node etc. slot in via deployment manifests exactly as in the
# reference's ansible/files/runtimes.json).
DEFAULT_MANIFEST_JSON = {
    "runtimes": {
        "python": [
            {"kind": "python:3", "image": {"name": "action-python-v3"}, "default": True,
             "stemCells": [{"count": 2, "memory": "256 MB"}]},
        ],
        "nodejs": [
            {"kind": "nodejs:14", "image": {"name": "action-nodejs-v14"}, "default": True},
        ],
    }
}

_lock = threading.Lock()
_runtimes: Optional[Runtimes] = None


class ExecManifest:
    """Process-wide manifest singleton (ref ExecManifest.initialize:51-56)."""

    @staticmethod
    def initialize(manifest_json: Optional[dict] = None) -> Runtimes:
        global _runtimes
        with _lock:
            _runtimes = Runtimes.from_json(manifest_json or DEFAULT_MANIFEST_JSON)
            return _runtimes

    @staticmethod
    def initialize_from_file(path: str) -> Runtimes:
        with open(path) as f:
            return ExecManifest.initialize(json.load(f))

    @staticmethod
    def runtimes() -> Runtimes:
        global _runtimes
        with _lock:
            if _runtimes is None:
                _runtimes = Runtimes.from_json(DEFAULT_MANIFEST_JSON)
            return _runtimes
