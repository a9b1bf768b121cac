"""Compute models — per-client local-round service-time distributions.

Every model here *is* (or wraps) a ``repro_torch.core.scheduler.SpeedModel``:
a per-client base service time plus counter-based lognormal jitter, so
all of them inherit the order-invariance and snapshot story for free.
The fleet builders only differ in how the static per-client base array
is drawn (deterministically, from the ``STREAM_STATIC`` stream — the
same seed always produces the same fleet).

Registered names (see ``repro_torch.sim.registry``):

* ``paper_testbed``   — the paper's §IV-A device set (laptop + Pis)
* ``uniform_fleet``   — base ~ U[lo, hi]
* ``lognormal_fleet`` — base ~ median * LogN(0, spread)
* ``pareto_fleet``    — heavy-tailed stragglers, base ~ Pareto(alpha)
* ``device_classes``  — an explicit mixture of device classes
* ``time_varying``    — any fleet modulated by a per-client diurnal
  slowdown wave (``now``-dependent service times)
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.scheduler import SpeedModel
from repro_torch.sim.base import STREAM_STATIC, normal, u01


def paper_testbed(num_clients: int, seed: int = 0,
                  sigma: float = 0.15) -> SpeedModel:
    m = SpeedModel.paper_testbed(num_clients, seed)
    m.sigma = sigma
    return m


def uniform_fleet(num_clients: int, seed: int = 0, lo: float = 1.0,
                  hi: float = 4.0, sigma: float = 0.15) -> SpeedModel:
    base = np.array([lo + (hi - lo) * u01(seed, STREAM_STATIC, c, 0)
                     for c in range(num_clients)])
    return SpeedModel(base, sigma=sigma, seed=seed)


def lognormal_fleet(num_clients: int, seed: int = 0, median: float = 2.5,
                    spread: float = 0.5, sigma: float = 0.15) -> SpeedModel:
    base = np.array([median * math.exp(spread * normal(seed, STREAM_STATIC,
                                                       c, 0))
                     for c in range(num_clients)])
    return SpeedModel(base, sigma=sigma, seed=seed)


def pareto_fleet(num_clients: int, seed: int = 0, scale: float = 1.0,
                 alpha: float = 1.5, cap: float = 25.0,
                 sigma: float = 0.15) -> SpeedModel:
    """Heavy-tailed fleet: most clients near ``scale``, a few extreme
    stragglers (capped at ``cap`` x scale so one device cannot freeze the
    whole simulated federation)."""
    base = np.array([min(scale * u01(seed, STREAM_STATIC, c, 0)
                         ** (-1.0 / alpha), scale * cap)
                     for c in range(num_clients)])
    return SpeedModel(base, sigma=sigma, seed=seed)


def device_classes(num_clients: int, seed: int = 0,
                   classes=((0.5, 1.0), (0.3, 3.5), (0.2, 8.0)),
                   sigma: float = 0.15) -> SpeedModel:
    """An explicit device mixture: ``classes`` is a sequence of
    (population_fraction, relative_service_time) pairs; clients are
    assigned by index so the composition is exact, not sampled."""
    fracs = np.array([f for f, _ in classes], np.float64)
    mults = [m for _, m in classes]
    bounds = np.cumsum(fracs / fracs.sum()) * num_clients
    base = np.empty(num_clients)
    for c in range(num_clients):
        base[c] = mults[int(np.searchsorted(bounds, c, side="right"))
                        if c < bounds[-1] else len(mults) - 1]
    return SpeedModel(base, sigma=sigma, seed=seed)


@dataclass
class TimeVaryingSpeed(SpeedModel):
    """A fleet whose clients slow down and speed up over simulated time:
    service = fleet draw * (1 + amp * sin(2 pi (now/period + phase_c))),
    phase drawn per client.  Models diurnal load / thermal throttling —
    the one compute model whose draws depend on ``now``."""
    period: float = 600.0
    amp: float = 0.5

    def __post_init__(self):
        super().__post_init__()
        self._phase = np.array([u01(self.seed, STREAM_STATIC, c, 1)
                                for c in range(len(self.base))])

    def sample(self, client: int, now: float = 0.0) -> float:
        s = super().sample(client, now)
        mod = 1.0 + self.amp * math.sin(
            2.0 * math.pi * (now / self.period + self._phase[client]))
        return s * max(mod, 0.05)


def time_varying(num_clients: int, seed: int = 0, period: float = 600.0,
                 amp: float = 0.5, lo: float = 1.0, hi: float = 4.0,
                 sigma: float = 0.15) -> TimeVaryingSpeed:
    base = np.array([lo + (hi - lo) * u01(seed, STREAM_STATIC, c, 0)
                     for c in range(num_clients)])
    return TimeVaryingSpeed(base, sigma=sigma, seed=seed, period=period,
                            amp=amp)
