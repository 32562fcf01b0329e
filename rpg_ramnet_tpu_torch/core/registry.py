"""Name -> callable registries.

Counterpart of ``rpg_ramnet_tpu/core/registry.py``: the reference resolves
class and function names from config files with ``eval()`` (reference
train.py:51,204,223,226); the port looks them up in explicit registries
under the same string names.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, Any] = {}

    def register(self, name: Optional[str] = None) -> Callable:
        def deco(obj):
            key = name or obj.__name__
            if key in self._items:
                raise KeyError(f"{self.kind} '{key}' already registered")
            self._items[key] = obj
            return obj
        return deco

    def get(self, name: str):
        if name not in self._items:
            raise KeyError(
                f"Unknown {self.kind} '{name}'. Available: {sorted(self._items)}")
        return self._items[name]

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __iter__(self) -> Iterator[str]:
        return iter(self.names())

    def names(self):
        return sorted(self._items)


MODELS = Registry("model")
DATASETS = Registry("dataset")
LOSSES = Registry("loss")
METRICS = Registry("metric")
