"""Collective accounting: how many collectives of each kind a process
issued, and their bytes.  Port of ``repro.distributed.hlo``'s
``collective_counts`` and ``collective_bytes``, with the reference's
dict shapes (``{"all-reduce": bytes, ..., "total": bytes}``).

The reference parses the optimised HLO text of a compiled function for
its collective ops; PyTorch runs eagerly and has no HLO, so the regex
parser (``shape_bytes`` and the op patterns) has no counterpart.  Here
the collectives are counted where they are issued: every collective of
``repro_torch.distributed.gated`` calls ``record`` with its kind and the
bytes of its result, as the reference counts a collective's result
shape.  The counts are per process (each rank counts its own) and start
at zero; ``reset`` clears them.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_lock = threading.Lock()
_counts: Dict[str, int] = defaultdict(int)
_bytes: Dict[str, int] = defaultdict(int)


def record(kind: str, nbytes: int) -> None:
    """Count one collective of ``kind`` whose result holds ``nbytes``."""
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}; known: {', '.join(COLLECTIVES)}")
    with _lock:
        _counts[kind] += 1
        _bytes[kind] += int(nbytes)


def reset() -> None:
    with _lock:
        _counts.clear()
        _bytes.clear()


def collective_bytes() -> Dict[str, int]:
    """Result bytes per collective kind issued since the last reset,
    plus 'total'."""
    with _lock:
        out = dict(_bytes)
    out["total"] = sum(out.values())
    return out


def collective_counts() -> Dict[str, int]:
    """Collectives per kind issued since the last reset."""
    with _lock:
        return dict(_counts)
