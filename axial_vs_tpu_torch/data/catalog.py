"""Dataset and metadata registries, detectron2's ``DatasetCatalog`` and
``MetadataCatalog`` (counterpart of ``axial_vs_tpu/data/catalog.py``). The
port keeps its own registry: a dataset registered with the JAX package is
not seen here."""
from __future__ import annotations

from typing import Callable


class _DatasetCatalog:
    def __init__(self):
        self._registry: dict[str, Callable] = {}

    def register(self, name: str, fn: Callable):
        if name in self._registry:
            raise KeyError(f"dataset {name!r} already registered")
        self._registry[name] = fn

    def get(self, name: str):
        return self._registry[name]()


class _Metadata(dict):
    """A dict whose keys read and write as attributes."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k) from None

    def __setattr__(self, k, v):
        self[k] = v


class _MetadataCatalog:
    def __init__(self):
        self._meta: dict[str, _Metadata] = {}

    def get(self, name: str) -> _Metadata:
        return self._meta.setdefault(name, _Metadata())


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
