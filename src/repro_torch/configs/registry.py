"""Registry mapping --arch ids to config constructors."""
from __future__ import annotations

from typing import Callable, Dict

from .base import ArchConfig

_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs():
    return sorted(_REGISTRY)
