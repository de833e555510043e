"""Action/trigger/package parameters with merge + init semantics.

Ref: common/scala/.../core/entity/Parameter.scala — an ordered key->value
map; `++` merges with right-bias (used for package -> binding -> action ->
invoke-payload inheritance, Packages.scala + Actions.scala); `init` marks
parameters only passed at container /init; `locked` (encrypted at rest in the
reference) is tracked as a flag here.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, Optional


class MalformedEntity(ValueError):
    """Wrong-typed JSON in an entity body. The REST layer maps this to the
    reference's 400 "The request content was malformed" instead of letting
    a TypeError/AttributeError surface as a 500."""


class ParameterValue:
    __slots__ = ("value", "init")

    def __init__(self, value: Any, init: bool = False):
        self.value = value
        self.init = init

    def __eq__(self, other):
        return isinstance(other, ParameterValue) and \
            (self.value, self.init) == (other.value, other.init)

    def __repr__(self):
        return f"ParameterValue({self.value!r}, init={self.init})"


class Parameters:
    """Immutable-ish parameter map, JSON form: [{"key":k,"value":v,"init":b}]."""

    def __init__(self, params: Optional[Dict[str, ParameterValue]] = None):
        self._params: Dict[str, ParameterValue] = dict(params or {})

    @classmethod
    def of(cls, **kwargs) -> "Parameters":
        return cls({k: ParameterValue(v) for k, v in kwargs.items()})

    @classmethod
    def from_arguments(cls, args: Dict[str, Any]) -> "Parameters":
        return cls({k: ParameterValue(v) for k, v in (args or {}).items()})

    def merge(self, other: Optional["Parameters"]) -> "Parameters":
        """Right-biased merge: `other` wins (ref Parameters `++`)."""
        if other is None:
            return self
        merged = dict(self._params)
        merged.update(other._params)
        return Parameters(merged)

    def __add__(self, other):
        return self.merge(other)

    def keys(self):
        return self._params.keys()

    def get(self, key: str, default=None):
        pv = self._params.get(key)
        return pv.value if pv is not None else default

    def get_bool(self, key: str) -> Optional[bool]:
        v = self.get(key)
        return v if isinstance(v, bool) else None

    def is_truthy(self, key: str, value_for_non_existent: bool = False) -> bool:
        """JSON truthiness (ref Parameter.scala:119-127 isTruthy): booleans
        as-is, numbers != 0, strings nonempty, null false, other values true;
        a missing key yields `value_for_non_existent`."""
        if key not in self._params:
            return value_for_non_existent
        v = self.get(key)
        if isinstance(v, bool):
            return v
        if isinstance(v, (int, float)):
            return v != 0
        if isinstance(v, str):
            return v != ""
        if v is None:
            return False
        return True

    def __contains__(self, key):
        return key in self._params

    def __len__(self):
        return len(self._params)

    def __eq__(self, other):
        return isinstance(other, Parameters) and self._params == other._params

    def init_parameters(self) -> Dict[str, Any]:
        return {k: v.value for k, v in self._params.items() if v.init}

    def to_arguments(self) -> Dict[str, Any]:
        """Flat {key: value} dict handed to the action at /run."""
        return {k: v.value for k, v in self._params.items()}

    def definitions(self) -> Dict[str, ParameterValue]:
        return dict(self._params)

    def to_json(self):
        return [
            {"key": k, "value": v.value, **({"init": True} if v.init else {})}
            for k, v in self._params.items()
        ]

    @classmethod
    def from_json(cls, j) -> "Parameters":
        if j is None:
            return cls()
        if isinstance(j, dict):  # accept {k: v} shorthand
            return cls.from_arguments(j)
        if not isinstance(j, list):
            raise MalformedEntity(
                "parameters/annotations must be a [{key, value}] list")
        params: Dict[str, ParameterValue] = {}
        for item in j:
            if not isinstance(item, dict) or not isinstance(item.get("key"), str):
                raise MalformedEntity(
                    "parameters/annotations entries need a string 'key'")
            params[item["key"]] = ParameterValue(item.get("value"), bool(item.get("init", False)))
        return cls(params)

    def size_bytes(self) -> int:
        return len(json.dumps(self.to_json()).encode())

    def __repr__(self):
        return f"Parameters({self.to_arguments()!r})"
