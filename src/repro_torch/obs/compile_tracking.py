"""Compile tracking: a process-wide counter of what the port compiles.

The reference counts XLA backend compilations through a
``jax.monitoring`` listener.  The port compiles nothing per call
(eager PyTorch); what it compiles is its CUDA kernels, each built once
by ``nvcc`` (``repro_torch.kernels.build.build``), which reports every
finished build here with its seconds.  ``install()`` is kept, idempotent
and without effect, so callers of the reference's API work unchanged;
``compile_count()`` / ``compile_secs()`` read the running totals.

This is what fills the ``jit_compiles`` gauge (the reference's name, so
snapshot keys match) in every ``RunResult.metrics`` snapshot: a second
run of an identical ``Federation`` in one process builds nothing and
reads 0.
"""
from __future__ import annotations

import threading

_state = {"count": 0, "secs": 0.0}
_lock = threading.Lock()


def install() -> None:
    """Nothing to register: builds report themselves (``record``)."""


def record(secs: float) -> None:
    """Count one finished kernel build that took ``secs`` seconds."""
    with _lock:
        _state["count"] += 1
        _state["secs"] += float(secs)


def compile_count() -> int:
    """Kernel builds finished in this process."""
    return _state["count"]


def compile_secs() -> float:
    """Total seconds of the kernel builds finished in this process."""
    return _state["secs"]
