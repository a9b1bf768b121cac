"""The paper's algorithm family as protocol plugins.  Port of
``repro.algorithms.builtin``.

* ``afl``    — plain asynchronous FL: every finished client uploads.
* ``vafl``   — the paper's contribution: Eq. 1 value, Eq. 2 above-mean gate.
* ``eaflm``  — the Eq. 3 lazy-client suppression rule.
* ``fedavg`` — synchronous FedAvg; runs the round barrier in event mode.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.algorithms.base import Algorithm, RoundContext, UploadPolicy
from repro_torch.algorithms.registry import _register_builtin
from repro_torch.core import value as value_lib


class AlwaysUploadPolicy(UploadPolicy):
    """AFL / FedAvg: every participating client ships its model."""


class VAFLPolicy(UploadPolicy):
    """Eq. 1 + Eq. 2: clients report the scalar V; only above-mean
    clients upload.  Event form keeps the latest reported V per client
    and gates against the mean of everything reported so far."""

    needs_values = True
    reports = True

    def begin_run(self, num_clients: int) -> None:
        self._known_V = np.full(num_clients, np.inf)

    def state(self):
        # the fleet-wide gate state: every client's latest reported V
        return {"known_V": self._known_V.copy()}

    def set_state(self, state) -> None:
        self._known_V = np.asarray(state["known_V"], float).copy()

    def decide(self, i: int, value: Optional[float], norm: Optional[float],
               threshold: float) -> bool:
        self._known_V[i] = value
        finite = self._known_V[np.isfinite(self._known_V)]
        return value >= finite.mean() if len(finite) else True

    def round_mask(self, ctx: RoundContext) -> Tuple[np.ndarray, Optional[List[float]]]:
        ctx.comm.record_report(int(ctx.part.sum()))
        v_np = ctx.values()
        v_part = v_np[ctx.part]
        mask = ctx.part & (v_np >= v_part.mean())
        if not mask.any():   # fp32 mean can round above every element
            mask = ctx.part & (v_np >= v_part.max())
        return mask, [float(v) for v in v_np]

    def gate_stacked(self, values=None, sq_norms=None, server_delta_sq=None):
        return (values >= torch.mean(values)).float()


class EAFLMPolicy(UploadPolicy):
    """Eq. 3: suppress 'lazy' clients whose gradient norm falls at/below
    the server-delta threshold (1/(alpha^2 beta m^2)) ||Delta theta||^2."""

    needs_norms = True
    reports = True

    def __init__(self, cfg):
        super().__init__(cfg)
        self.alpha = getattr(cfg, "eaflm_alpha", 0.98)
        self.beta = getattr(cfg, "eaflm_beta", 1e-2)

    def window_threshold(self, server_delta_fn) -> float:
        return float(value_lib.eaflm_threshold([server_delta_fn()], self.alpha, self.beta, 1))

    def decide(self, i: int, value: Optional[float], norm: Optional[float],
               threshold: float) -> bool:
        return norm > threshold

    def round_mask(self, ctx: RoundContext) -> Tuple[np.ndarray, Optional[List[float]]]:
        thr = value_lib.eaflm_threshold([ctx.server_delta()], self.alpha, self.beta, 1)
        norms = ctx.norms()
        ctx.comm.record_report(int(ctx.part.sum()))
        mask = ctx.part & (norms > thr).cpu().numpy()
        return mask, [float(v) for v in norms.cpu().numpy()]

    def gate_stacked(self, values=None, sq_norms=None, server_delta_sq=None):
        den = torch.tensor(np.float32(self.alpha ** 2 * self.beta), device=sq_norms.device)
        return (sq_norms > server_delta_sq / den).float()


_register_builtin(Algorithm(
    name="afl", policy_factory=AlwaysUploadPolicy,
    description="plain async FL: every finished client uploads"))
_register_builtin(Algorithm(
    name="vafl", policy_factory=VAFLPolicy,
    description="communication-value gating (paper Eq. 1+2)"))
_register_builtin(Algorithm(
    name="eaflm", policy_factory=EAFLMPolicy,
    description="lazy-client suppression (paper Eq. 3)"))
_register_builtin(Algorithm(
    name="fedavg", policy_factory=AlwaysUploadPolicy, event_mode="sync-barrier",
    description="synchronous FedAvg (round barrier in event mode)"))
