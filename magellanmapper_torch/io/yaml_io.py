"""YAML load/save with enum-friendly parsing.

Copy of ``magellanmapper_tpu/io/yaml_io.py``: loads single- or
multi-document YAML, converting string values of the form
``EnumName.MEMBER`` through a given enum registry, and saves dictionaries
with numpy scalars and arrays coerced to plain Python types.
"""

from __future__ import annotations

import enum
from typing import Any, Dict, List, Optional, Type

import numpy as np
import yaml


def _parse_enums(val: Any, enums: Dict[str, Type[enum.Enum]]) -> Any:
    if isinstance(val, dict):
        return {_parse_enums(k, enums): _parse_enums(v, enums)
                for k, v in val.items()}
    if isinstance(val, list):
        return [_parse_enums(v, enums) for v in val]
    if isinstance(val, str) and "." in val:
        cls_name, _, member = val.partition(".")
        cls = enums.get(cls_name)
        if cls is not None and member in cls.__members__:
            return cls[member]
    return val


def load_yaml(
        path: str,
        enums: Optional[Dict[str, Type[enum.Enum]]] = None) -> List[dict]:
    """Load all YAML documents in ``path`` as a list of dicts."""
    with open(path, "r", encoding="utf-8") as f:
        docs = list(yaml.safe_load_all(f))
    docs = [d for d in docs if d is not None]
    if enums:
        docs = [_parse_enums(d, enums) for d in docs]
    return docs


def _coerce(val: Any) -> Any:
    if isinstance(val, enum.Enum):
        return f"{type(val).__name__}.{val.name}"
    if isinstance(val, np.generic):
        return val.item()
    if isinstance(val, np.ndarray):
        return val.tolist()
    if isinstance(val, dict):
        return {_coerce(k): _coerce(v) for k, v in val.items()}
    if isinstance(val, (list, tuple)):
        return [_coerce(v) for v in val]
    return val


def save_yaml(path: str, data: dict, use_primitives: bool = True) -> dict:
    """Save ``data`` to YAML at ``path``; returns the coerced dict."""
    out = _coerce(data) if use_primitives else data
    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump(out, f, default_flow_style=False, sort_keys=False)
    return out
