"""JSON serde for config dataclasses.

The reference serializes configs with Jackson + a polymorphic subtype registry
(NeuralNetConfiguration.java:219-320, registerSubtypes:307-308) so stored JSON
round-trips through class hierarchies. Here every config dataclass registers
under a `@type` key; `to_dict`/`from_dict` walk nested dataclasses, enums,
lists and dicts. Custom layers register via `register_config`.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any

_TYPE_KEY = "@type"
_REGISTRY: dict[str, type] = {}


def register_config(cls=None, *, name: str | None = None):
    """Class decorator: register a dataclass for polymorphic JSON round-trip."""

    def wrap(c):
        key = name or c.__name__
        _REGISTRY[key] = c
        c._serde_name = key
        return c

    return wrap(cls) if cls is not None else wrap


def to_dict(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj.value if isinstance(obj, enum.Enum) else obj
    if isinstance(obj, enum.Enum):
        return obj.value
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {_TYPE_KEY: getattr(obj, "_serde_name", type(obj).__name__)}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            out[f.name] = to_dict(v)
        return out
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {str(k): to_dict(v) for k, v in obj.items()}
    raise TypeError(f"Cannot serialize {type(obj)!r} to config JSON")


def from_dict(data: Any) -> Any:
    if isinstance(data, dict) and _TYPE_KEY in data:
        cls = _REGISTRY.get(data[_TYPE_KEY])
        if cls is None:
            raise ValueError(f"Unknown config type '{data[_TYPE_KEY]}' — "
                             f"register custom configs with register_config")
        kwargs = {}
        field_names = {f.name for f in dataclasses.fields(cls)}
        for k, v in data.items():
            if k == _TYPE_KEY:
                continue
            if k in field_names:
                kwargs[k] = from_dict(v)
        obj = cls(**kwargs)
        return obj
    if isinstance(data, dict):
        return {k: from_dict(v) for k, v in data.items()}
    if isinstance(data, list):
        return [from_dict(v) for v in data]
    return data


def to_json(obj: Any, indent: int | None = 2) -> str:
    return json.dumps(to_dict(obj), indent=indent)


def from_json(s: str) -> Any:
    return from_dict(json.loads(s))
