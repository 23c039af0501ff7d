"""Config system: a dot-access config tree with YAML loading and dotted
overrides (the port's own copy of ``axial_vs_tpu/config/node.py``, which
the port may not import; ``tests/test_torch_config.py`` holds the two
equal).

Programmatic defaults (``defaults.py``) + YAML leaf files of the repo's
``configs/`` with an optional ``_BASE_`` key + ``merge_from_list`` dotted
overrides, frozen after setup.
"""
from __future__ import annotations

import copy
import os
from typing import Any, Iterator

import yaml


class ConfigNode(dict):
    """A dict with attribute access, recursive merge, and freeze support."""

    _FROZEN_KEY = "__frozen__"

    def __init__(self, init: dict | None = None):
        super().__init__()
        object.__setattr__(self, ConfigNode._FROZEN_KEY, False)
        if init:
            for k, v in init.items():
                self[k] = self._to_node(v)

    @staticmethod
    def _to_node(v: Any) -> Any:
        if isinstance(v, ConfigNode):
            return v
        if isinstance(v, dict):
            return ConfigNode(v)
        if isinstance(v, (list, tuple)):
            return [ConfigNode._to_node(x) for x in v]
        return v

    # -- attribute access ----------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config has no key {name!r}. Available: {sorted(self.keys())}")

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, ConfigNode._FROZEN_KEY):
            raise AttributeError(f"Cannot set {name!r}: config is frozen")
        self[name] = self._to_node(value)

    def __setitem__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, ConfigNode._FROZEN_KEY):
            raise AttributeError(f"Cannot set {name!r}: config is frozen")
        super().__setitem__(name, self._to_node(value))

    # -- freeze --------------------------------------------------------------
    def freeze(self) -> "ConfigNode":
        object.__setattr__(self, ConfigNode._FROZEN_KEY, True)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()
        return self

    def defrost(self) -> "ConfigNode":
        object.__setattr__(self, ConfigNode._FROZEN_KEY, False)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()
        return self

    def clone(self) -> "ConfigNode":
        out = ConfigNode()
        for k, v in self.items():
            out[k] = v.clone() if isinstance(v, ConfigNode) else copy.deepcopy(v)
        return out

    # -- merging -------------------------------------------------------------
    def merge_from_dict(self, other: dict) -> "ConfigNode":
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), ConfigNode):
                self[k].merge_from_dict(v)
            else:
                self[k] = self._to_node(v)
        return self

    def merge_from_file(self, path: str) -> "ConfigNode":
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        base = data.pop("_BASE_", None)
        if base:
            base_path = os.path.join(os.path.dirname(path), base)
            self.merge_from_file(base_path)
        return self.merge_from_dict(data)

    def merge_from_list(self, opts: list) -> "ConfigNode":
        """Merge dotted overrides, e.g. ['model.backbone.name', 'resnet50']."""
        assert len(opts) % 2 == 0, f"override list must be key/value pairs, got {opts}"
        for key, value in zip(opts[::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if leaf in node and isinstance(value, str):
                value = _parse_override(value, node[leaf])
            node[leaf] = value
        return self

    # -- introspection -------------------------------------------------------
    def flatten(self, prefix: str = "") -> Iterator[tuple[str, Any]]:
        for k, v in self.items():
            key = f"{prefix}{k}"
            if isinstance(v, ConfigNode):
                yield from v.flatten(prefix=key + ".")
            else:
                yield key, v

    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, ConfigNode) else v) for k, v in self.items()
        }

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=True)


def _parse_override(value: str, old: Any) -> Any:
    """Parse a string override according to the existing value's type."""
    if isinstance(old, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(old, int) and not isinstance(old, bool):
        return int(value)
    if isinstance(old, float):
        return float(value)
    if isinstance(old, (list, tuple)):
        return yaml.safe_load(value)
    return value
