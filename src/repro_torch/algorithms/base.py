"""The pluggable FL algorithm protocol.  Port of
``repro.algorithms.base``.

An algorithm is two small objects behind a string registry
(``get_algorithm("vafl")``):

* ``UploadPolicy``: the "should this update ship?" decision (the
  paper's Eq. 1-3 gating), in two forms: a *scalar* form (``decide``)
  consumed in arrival order by the event runtime, and a *stacked* form
  (``round_mask`` over all clients) for the round and barrier runtimes,
  and a *silo* form (``gate_stacked``: tensors in, a float mask out) for
  the cross-silo training step (``repro_torch.launch.steps``).
  It declares which inputs it needs (``needs_values`` / ``needs_norms``)
  so the runtime computes nothing the algorithm won't read; AFL pays
  nothing for VAFL's value term.
* ``Aggregator``: how accepted uploads enter the global model: the
  masked weighted FedAvg of Algorithm 1 (round and barrier runtimes),
  the asynchronous mix theta <- (1-rho s) theta + rho s theta_i (event
  runtime), and the staleness weight s(tau) that scales it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

_STALE_TABLE_SIZE = 4096


def _agg():
    """repro_torch.core.aggregation, imported lazily: this module must stay
    a leaf because the runtimes import it while ``repro_torch.core`` is
    initializing."""
    from repro_torch.core import aggregation
    return aggregation


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
    reports: bool = False        # a scalar report precedes each decision

    def __init__(self, cfg):
        self.cfg = cfg

    # ---------------------------------------------------- event runtime ---
    def begin_run(self, num_clients: int) -> None:
        """Reset per-run state (called once by every runtime)."""

    def state(self):
        """Checkpointable per-run state; None for stateless policies.
        Stateful policies override both this and ``set_state``."""
        return None

    def set_state(self, state) -> None:
        """Restore ``state()``'s value after ``begin_run`` on resume."""

    def window_threshold(self, server_delta_fn: Callable) -> float:
        """Server-side threshold, evaluated once per mix point (EAFLM's
        Eq. 3 RHS).  ``server_delta_fn()`` lazily materialises
        theta^{k-1} - theta^{k-2}; the default never calls it."""
        return 0.0

    def decide(self, i: int, value: Optional[float], norm: Optional[float],
               threshold: float) -> bool:
        """Scalar per-client decision, called in arrival order.  ``value``
        / ``norm`` are only supplied when the matching ``needs_*`` flag
        is set."""
        return True

    # ----------------------------------------------------- round runtime ---
    def round_mask(self, ctx: RoundContext) -> Tuple[np.ndarray, Optional[List[float]]]:
        """Boolean upload mask over all clients for one synchronous
        round, plus the per-client values to log in the round record
        (None when the algorithm has none)."""
        return ctx.part.copy(), None

    # ------------------------------------------------ cross-silo step ---
    def gate_stacked(self, values=None, sq_norms=None, server_delta_sq=None):
        """The silo gate of ``make_fl_train_step``: a float mask over the
        leading silo axis, from device tensors (``values`` (P,) Eq. 1 V,
        ``sq_norms`` (P,), ``server_delta_sq`` a scalar).  Callers pass at
        least one stacked input; the default gate (afl, fedavg,
        fedasync: each step is a barrier, staleness 0) shapes its
        all-ones mask off whichever arrived."""
        ref = values if values is not None else sq_norms
        if ref is None:
            raise ValueError("gate_stacked needs at least one stacked input "
                             "(values or sq_norms) to shape the silo mask")
        return torch.ones_like(ref)


class Aggregator:
    """Default aggregation: masked weighted FedAvg for the synchronous
    runtimes, plain async mix with the config's staleness decay for the
    event runtime.  Algorithms override ``_stale_fn`` or the mix hooks."""

    def __init__(self, cfg):
        self.cfg = cfg
        # rho: the event runtime reads THIS attribute (not the config),
        # so an aggregator subclass can own its mixing rate
        self.mix_rate = getattr(cfg, "mix_rate", 0.5)
        self._table: Optional[np.ndarray] = None

    def begin_run(self, num_clients: int) -> None:
        """Reset per-run state (the staleness table is pure, kept)."""

    # ------------------------------------------------------- staleness ---
    def _stale_fn(self, taus: np.ndarray):
        """Vectorised s(tau), the override point for FedAsync's family."""
        return _agg().staleness_weight(taus, getattr(self.cfg, "staleness_kind", "poly"))

    def stale_weight(self, tau: int) -> float:
        """s(tau) via a lazily built lookup table of the first
        ``_STALE_TABLE_SIZE`` staleness values."""
        if self._table is None:
            self._table = np.asarray(self._stale_fn(np.arange(_STALE_TABLE_SIZE)),
                                     np.float64)
        if tau < len(self._table):
            return float(self._table[tau])
        return float(self._stale_fn(np.asarray([tau]))[0])

    # ------------------------------------------------------------ mixes ---
    def mix(self, global_params, recon, rho_s):
        """Single-arrival async mix."""
        return _agg().async_mix(global_params, recon, rho_s)

    def flush_mix(self, global_params, src, rows, coef, rho_sbar):
        """FedBuff-style buffer flush: staleness-weighted mean of the
        buffered rows of ``src``, then one async mix."""
        return _agg().flush_mix(global_params, src, rows, coef, rho_sbar)

    def round_aggregate(self, global_params, stacked_params, mask, counts):
        """Masked weighted FedAvg (Algorithm 1 line 16); keeps the old
        global model when the mask is empty."""
        return _agg().aggregate_or_keep(global_params, stacked_params, mask, counts)


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
