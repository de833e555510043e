"""Semantic versions (ref common/scala/.../core/entity/SemVer.scala)."""
from __future__ import annotations

from functools import total_ordering


@total_ordering
class SemVer:
    __slots__ = ("major", "minor", "patch")

    def __init__(self, major: int = 0, minor: int = 0, patch: int = 1):
        if major < 0 or minor < 0 or patch < 0 or (major, minor, patch) == (0, 0, 0):
            raise ValueError(f"bad semantic version {major}.{minor}.{patch}")
        self.major, self.minor, self.patch = major, minor, patch

    @classmethod
    def from_string(cls, s: str) -> "SemVer":
        parts = (s.split(".") + ["0", "0"])[:3]
        return cls(int(parts[0]), int(parts[1] or 0), int(parts[2] or 0))

    def up_major(self) -> "SemVer":
        return SemVer(self.major + 1, 0, 0)

    def up_minor(self) -> "SemVer":
        return SemVer(self.major, self.minor + 1, 0)

    def up_patch(self) -> "SemVer":
        return SemVer(self.major, self.minor, self.patch + 1)

    def _key(self):
        return (self.major, self.minor, self.patch)

    def __eq__(self, other):
        return isinstance(other, SemVer) and self._key() == other._key()

    def __lt__(self, other):
        return self._key() < other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"{self.major}.{self.minor}.{self.patch}"

    def to_json(self) -> str:
        return repr(self)

    @classmethod
    def from_json(cls, j) -> "SemVer":
        return cls.from_string(str(j))
