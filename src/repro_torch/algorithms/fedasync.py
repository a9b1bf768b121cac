"""FedAsync (Xie et al., 'Asynchronous Federated Optimization',
arXiv:1903.03934) as a registry plugin.  Port of
``repro.algorithms.fedasync``: a new algorithm with its own aggregation
semantics runs on the round-based, sequential and batched runtimes with
no runtime edit.

FedAsync is AFL's always-upload client paired with a *mixing* rule: the
server applies theta <- (1 - alpha_t) theta + alpha_t theta_i with
alpha_t = alpha * s(tau), where s is one of the paper's three staleness
families (constant; hinge: 1 until tau <= b then 1/(a(tau-b)+1); poly:
(1+tau)^-a).  Here alpha is ``FLRunConfig.mix_rate`` and s(tau) is the
aggregator's ``stale_weight``, the knobs the event runtimes already
consume, so the whole algorithm is an Aggregator subclass.  FedAsync's
periodic client-triggering (``period``) is a *scheduling* concern: it
maps onto the batched engine's window/buffer knobs (``max_batch``,
``buffer_size``), not onto the algorithm object.

Registered variants: ``fedasync`` (hinge, the paper's best performer,
a=10, b=6), ``fedasync_poly`` (a=0.5), ``fedasync_const``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.algorithms.base import Aggregator, Algorithm, UploadPolicy
from repro_torch.algorithms.registry import _register_builtin
from repro_torch.core.aggregation import staleness_weight


class FedAsyncAggregator(Aggregator):
    """Async mix under FedAsync's s(tau) family.  The flag and its
    constants are fixed per registered variant; ``FLRunConfig.
    staleness_kind`` stays the AFL/VAFL knob and is ignored here."""

    flag = "hinge"
    hinge_a = 10.0
    hinge_b = 6.0
    poly_a = 0.5

    def _stale_fn(self, taus: np.ndarray):
        if self.flag == "hinge":
            return staleness_weight(taus, "hinge", a=self.hinge_a, b=self.hinge_b)
        if self.flag == "poly":
            return staleness_weight(taus, "poly", a=self.poly_a)
        return staleness_weight(taus, "const")


class _PolyAggregator(FedAsyncAggregator):
    flag = "poly"


class _ConstAggregator(FedAsyncAggregator):
    flag = "const"


for _name, _agg in (("fedasync", FedAsyncAggregator),
                    ("fedasync_poly", _PolyAggregator),
                    ("fedasync_const", _ConstAggregator)):
    _register_builtin(Algorithm(
        name=_name, policy_factory=UploadPolicy, aggregator_factory=_agg,
        description=f"FedAsync ({_agg.flag} staleness mix)"))
