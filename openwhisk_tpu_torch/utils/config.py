"""Typed configuration loading (a copy of `openwhisk_tpu/utils/config.py`
without its JAX platform hook).

Rebuild of the reference's two config systems (SURVEY §5.6):
  - WhiskConfig env-var map (common/scala/.../core/WhiskConfig.scala) —
    required properties validated at boot;
  - pureconfig case-class loading with `CONFIG_whisk_...` env overrides
    (docs/concurrency.md:28-40).

Here every component declares a frozen dataclass; `load_config` materializes
it from (defaults <- file dict <- env overrides). Env keys follow the
reference convention: CONFIG_whisk_loadBalancer_timeoutFactor=2 maps onto
key path ("load_balancer", "timeout_factor").
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, Optional, Type, TypeVar, get_args, get_origin

C = TypeVar("C")

_CAMEL = re.compile(r"(?<!^)(?=[A-Z])")


def _snake(name: str) -> str:
    return _CAMEL.sub("_", name).lower()


def config_from_env(prefix: str = "CONFIG_whisk_", environ: Optional[Dict[str, str]] = None
                    ) -> Dict[str, Any]:
    """Collect CONFIG_whisk_a_bC=v env vars into a nested {a: {b_c: v}} dict."""
    environ = environ if environ is not None else dict(os.environ)
    out: Dict[str, Any] = {}
    for k, v in environ.items():
        if not k.startswith(prefix):
            continue
        path = [_snake(p) for p in k[len(prefix):].split("_") if p]
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                break
        else:
            node[path[-1]] = v
    return out


def _coerce(tp, value):
    origin = get_origin(tp)
    if origin is not None:
        args = [a for a in get_args(tp) if a is not type(None)]
        if origin is Optional or (origin is type(None)):
            return _coerce(args[0], value) if args else value
        if str(origin) in ("typing.Union", "types.UnionType") or origin.__name__ == "UnionType":
            return _coerce(args[0], value) if args else value
        if origin in (list, tuple):
            if isinstance(value, str):
                value = json.loads(value)
            inner = args[0] if args else str
            seq = [_coerce(inner, v) for v in value]
            return tuple(seq) if origin is tuple else seq
        if origin is dict:
            if isinstance(value, str):
                value = json.loads(value)
            return dict(value)
        return value
    if dataclasses.is_dataclass(tp) and isinstance(value, dict):
        return load_config(tp, value)
    if tp is dict:
        # bare `dict` fields (no typing origin): env values arrive as JSON
        # strings, e.g. CONFIG_whisk_slo_overrides='{"ns": {...}}'
        if isinstance(value, str):
            value = json.loads(value)
        return dict(value)
    if tp is bool:
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    if tp in (int, float, str):
        return tp(value)
    return value


def load_config(cls: Type[C], data: Optional[Dict[str, Any]] = None,
                env_path: Optional[str] = None) -> C:
    """Build dataclass `cls` from defaults, overridden by `data`, overridden
    by CONFIG_whisk_<env_path>_* env vars (when env_path is given)."""
    data = dict(data or {})
    if env_path is not None:
        env = config_from_env()
        node: Any = env
        for p in env_path.split("."):
            if not isinstance(node, dict):
                node = None
                break
            node = node.get(p)
        if isinstance(node, dict):
            data = _deep_merge(data, node)
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for name, f in fields.items():
        if name in data:
            kwargs[name] = _coerce(f.type if not isinstance(f.type, str) else _resolve(cls, f), data[name])
    return cls(**kwargs)


def _resolve(cls, f):
    import typing
    hints = typing.get_type_hints(cls)
    return hints.get(f.name, str)


def _deep_merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


class RequiredPropertiesError(Exception):
    pass


def require_properties(props: Dict[str, Optional[str]]) -> Dict[str, str]:
    """WhiskConfig-style boot validation (ref WhiskConfig.scala): every key
    must have a non-None value or boot fails."""
    missing = [k for k, v in props.items() if v is None]
    if missing:
        raise RequiredPropertiesError(f"missing required properties: {', '.join(missing)}")
    return {k: v for k, v in props.items() if v is not None}
