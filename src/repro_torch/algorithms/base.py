"""The pluggable FL algorithm protocol.  Port of
``repro.algorithms.base``, round form only.

An algorithm is two small objects behind a string registry
(``get_algorithm("vafl")``):

* ``UploadPolicy``: the per-round "which clients ship their model?"
  decision (the paper's Eq. 1-3 gating), over all clients at once
  (``round_mask``).  It declares which inputs it needs (``needs_values``
  / ``needs_norms``) so the runtime computes nothing the algorithm won't
  read; AFL pays nothing for VAFL's value term.
* ``Aggregator``: how accepted uploads enter the global model, the
  masked weighted FedAvg of Algorithm 1.

The scalar per-arrival forms and the asynchronous mixes of the reference
wait for the event runtimes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np


class RoundContext:
    """What a policy may read when masking a round.

    Inputs are lazy and cached: ``values()`` (Eq. 1 V per client,
    float64 numpy) and ``norms()`` (||eff_grad||^2 per client, a device
    tensor) each cost one stacked computation on first access;
    ``server_delta()`` is theta^{k-1} - theta^{k-2} (the EAFLM Eq. 3
    numerator).  ``part`` is the round's participating set S; ``comm``
    records scalar reports.
    """

    def __init__(self, *, part: np.ndarray, comm, values_fn: Callable,
                 norms_fn: Callable, server_delta_fn: Callable):
        self.part = part
        self.comm = comm
        self._values_fn = values_fn
        self._norms_fn = norms_fn
        self._server_delta_fn = server_delta_fn
        self._values = None
        self._norms = None

    def values(self) -> np.ndarray:
        if self._values is None:
            self._values = self._values_fn().detach().cpu().double().numpy()
        return self._values

    def norms(self):
        if self._norms is None:
            self._norms = self._norms_fn()
        return self._norms

    def server_delta(self):
        return self._server_delta_fn()


class UploadPolicy:
    """Base policy: upload everything (AFL / FedAvg)."""

    needs_values: bool = False   # Eq. 1 V (needs client eval + prev grads)
    needs_norms: bool = False    # ||eff_grad||^2 per client

    def __init__(self, cfg):
        self.cfg = cfg

    def begin_run(self, num_clients: int) -> None:
        """Reset per-run state (called once by every runtime)."""

    def round_mask(self, ctx: RoundContext) -> Tuple[np.ndarray, Optional[List[float]]]:
        """Boolean upload mask over all clients for one synchronous
        round, plus the per-client values to log in the round record
        (None when the algorithm has none)."""
        return ctx.part.copy(), None


class Aggregator:
    """Default aggregation: masked weighted FedAvg."""

    def __init__(self, cfg):
        self.cfg = cfg

    def begin_run(self, num_clients: int) -> None:
        """Reset per-run state."""

    def round_aggregate(self, global_params, stacked_params, mask, counts):
        """Masked weighted FedAvg (Algorithm 1 line 16); keeps the old
        global model when the mask is empty."""
        # imported here: this module must stay a leaf, because the
        # runtimes import it while ``repro_torch.core`` is initializing
        from repro_torch.core.aggregation import aggregate_or_keep
        return aggregate_or_keep(global_params, stacked_params, mask, counts)


@dataclass(frozen=True)
class Algorithm:
    """A registered algorithm: factories for its two protocol objects
    plus how an event-driven run treats it (``"async"``, or
    ``"sync-barrier"`` for round-barrier baselines like FedAvg)."""

    name: str
    policy_factory: Callable[[object], UploadPolicy]
    aggregator_factory: Callable[[object], Aggregator] = Aggregator
    event_mode: str = "async"          # 'async' | 'sync-barrier'
    description: str = ""

    def make_policy(self, cfg) -> UploadPolicy:
        return self.policy_factory(cfg)

    def make_aggregator(self, cfg) -> Aggregator:
        return self.aggregator_factory(cfg)
