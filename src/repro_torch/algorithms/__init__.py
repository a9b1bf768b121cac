"""Pluggable FL algorithms (port of ``repro.algorithms``): the
UploadPolicy / Aggregator protocol and the string registry behind
``FLRunConfig.algorithm``.  The built-ins register on first lookup."""
from repro_torch.algorithms.base import (Algorithm, Aggregator, RoundContext,  # noqa: F401
                                         UploadPolicy)
from repro_torch.algorithms.registry import (available_algorithms,  # noqa: F401
                                             get_algorithm, register_algorithm)
