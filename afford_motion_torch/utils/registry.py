"""Name → class registries (reference: utils/registry.py:10-92).

Four registries mirror the reference factory surface: DATASET, Model,
Evaluator, Visualizer. Registration is by decorator; lookup is by the name
stored in the task/model YAML blocks.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._map: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    def _do_register(self, name: str, obj: Any) -> None:
        if name in self._map:
            raise KeyError(f"'{name}' already registered in registry '{self._name}'")
        self._map[name] = obj

    def register(self, obj: Optional[Any] = None, name: Optional[str] = None) -> Callable:
        if obj is None:
            def deco(cls: Any) -> Any:
                self._do_register(name or cls.__name__, cls)
                return cls
            return deco
        self._do_register(name or obj.__name__, obj)
        return obj

    def get(self, name: str) -> Any:
        if name not in self._map:
            known = ", ".join(sorted(self._map))
            raise KeyError(f"'{name}' not found in registry '{self._name}'. Known: {known}")
        return self._map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._map

    def keys(self) -> Iterable[str]:
        return self._map.keys()


DATASET = Registry("dataset")
MODEL = Registry("model")
EVALUATOR = Registry("evaluator")
VISUALIZER = Registry("visualizer")
