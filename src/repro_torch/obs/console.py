"""Console output for the runtimes.  Copy of ``repro.obs.console``.

``progress`` is the one console print of ``repro_torch.core.runtimes``:
their verbose lines go through it, and every other instrumentation
path flows through ``repro_torch.obs`` (docs/OBSERVABILITY.md).
"""
from __future__ import annotations

import sys


def progress(msg: str) -> None:
    """A verbose-mode progress line (``verbose=True`` runs)."""
    # the sanctioned sink itself: flcheck: ignore[print-in-core]
    print(msg, file=sys.stdout, flush=True)
