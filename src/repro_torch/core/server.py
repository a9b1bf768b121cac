"""Back-compat names of the reference's ``repro.core.server``.  Port of
that module.

The runtimes live in ``repro_torch.core.runtimes`` and the run
configuration in ``repro_torch.core.config``; the old import path keeps
working:

    from repro_torch.core.server import (ALGORITHMS, FLRunConfig,
                                         run_event_driven, run_round_based)

New code should use ``repro_torch.core`` or the ``Federation`` facade.
"""
from repro_torch.algorithms.registry import available_algorithms
from repro_torch.core.config import FLRunConfig
from repro_torch.core.runtimes import run_event_driven, run_round_based

__all__ = ["ALGORITHMS", "FLRunConfig", "run_event_driven", "run_round_based",
           "available_algorithms"]


def __getattr__(name):
    # ALGORITHMS is a live view of the registry (PEP 562): a snapshot
    # taken at import would miss algorithms registered later
    if name == "ALGORITHMS":
        return available_algorithms()
    raise AttributeError(name)
