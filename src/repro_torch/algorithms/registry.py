"""String registry for pluggable FL algorithms.  Port of
``repro.algorithms.registry``.

``get_algorithm("vafl")`` resolves a name to an ``Algorithm`` spec.
This module is a leaf (stdlib imports only); the built-in algorithms
register on first lookup.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

_REGISTRY: Dict[str, object] = {}
_BUILTIN_OWNED: set = set()   # names whose current entry came from a builtin
_BUILTIN_MODULES = ("repro_torch.algorithms.builtin", "repro_torch.algorithms.fedasync")
_builtins_loaded = False


def _ensure_builtins() -> None:
    global _builtins_loaded
    if not _builtins_loaded:
        for mod in _BUILTIN_MODULES:
            importlib.import_module(mod)
        # only after every module imported cleanly: a failed import must
        # stay retryable
        _builtins_loaded = True


def register_algorithm(alg, *, overwrite: bool = False) -> None:
    """Register an ``Algorithm`` spec under ``alg.name``; re-registration
    is an error unless ``overwrite`` is set."""
    if not overwrite and alg.name in _REGISTRY:
        raise ValueError(f"algorithm {alg.name!r} already registered")
    _REGISTRY[alg.name] = alg
    _BUILTIN_OWNED.discard(alg.name)


def _register_builtin(alg) -> None:
    """Idempotent builtin registration that never clobbers a third-party
    entry registered under a builtin name before the lazy load."""
    if alg.name in _REGISTRY and alg.name not in _BUILTIN_OWNED:
        return
    _REGISTRY[alg.name] = alg
    _BUILTIN_OWNED.add(alg.name)


def get_algorithm(name: str):
    """Resolve an algorithm name; raises ValueError naming the registered set."""
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {name!r}; registered algorithms: "
            f"{', '.join(available_algorithms())}") from None


_PREFERRED = ("afl", "vafl", "eaflm", "fedavg")


def available_algorithms() -> Tuple[str, ...]:
    """Registered names: the built-in family first, then third-party
    registrations in registration order."""
    _ensure_builtins()
    head = [n for n in _PREFERRED if n in _REGISTRY]
    return tuple(head) + tuple(n for n in _REGISTRY if n not in _PREFERRED)
