"""The port's config tree: ``get_default_config()`` and ``ConfigNode``
(YAML leafs of the repo's ``configs/``, dotted overrides), and
``load_config``, which puts the three together."""
from __future__ import annotations

from pathlib import Path

from .defaults import get_default_config
from .node import ConfigNode

#: the repo's YAML configurations
CONFIGS_DIR = Path(__file__).resolve().parents[2] / "configs"


def load_config(yaml: str | None = None, opts=()) -> ConfigNode:
    """The default config, with ``yaml`` (a path under ``configs/``, e.g.
    ``"vipseg/maxtron_wc_r50.yaml"``) merged in, then the dotted overrides
    ``opts`` (key, value, key, value, ...)."""
    cfg = get_default_config()
    if yaml:
        cfg.merge_from_file(str(CONFIGS_DIR / yaml))
    return cfg.merge_from_list(list(opts))


__all__ = ["CONFIGS_DIR", "ConfigNode", "get_default_config", "load_config"]
