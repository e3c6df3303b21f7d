"""Algorithm registry: maps constructor names from config files to classes
(``repro.core.registry``).  The module defaults to ``repro_torch.ann``."""

from __future__ import annotations

import importlib
from typing import Callable, Dict, Type

from repro_torch.core.interface import BaseANN

_REGISTRY: Dict[str, Type[BaseANN]] = {}


def register(name: str) -> Callable[[Type[BaseANN]], Type[BaseANN]]:
    def deco(cls: Type[BaseANN]) -> Type[BaseANN]:
        if name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(f"duplicate algorithm registration: {name}")
        _REGISTRY[name] = cls
        cls.registry_name = name
        return cls

    return deco


def resolve(constructor: str, module: str | None = None) -> Type[BaseANN]:
    """Resolve a constructor name to a BaseANN subclass: the explicit
    ``module`` attribute first, then the registry."""
    importlib.import_module("repro_torch.ann")
    if module:
        mod = importlib.import_module(module)
        cls = getattr(mod, constructor)
    else:
        cls = _REGISTRY.get(constructor)
        if cls is None:
            raise KeyError(
                f"unknown algorithm {constructor!r}; known: {sorted(_REGISTRY)}"
            )
    if not (isinstance(cls, type) and issubclass(cls, BaseANN)):
        raise TypeError(f"{constructor} does not implement BaseANN")
    return cls



def available() -> Dict[str, Type[BaseANN]]:
    """Every registered algorithm by name (``repro.core.registry.available``)."""
    importlib.import_module("repro_torch.ann")
    return dict(_REGISTRY)
