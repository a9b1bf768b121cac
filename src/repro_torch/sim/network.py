"""Network models — upload/download link delay from *actual* payload bytes.

The runtimes hand the scheduler every event's real on-the-wire byte
counts (codec payloads + scalar reports on the uplink, the broadcast the
client actually received on the downlink).  A network model turns those
bytes into simulated link time, which the scheduler inserts as idle
delay before the client's next round — so ``topk_int8`` literally makes
the simulated clock advance less than ``identity`` on the same run.

Registered names (see ``repro_torch.sim.registry``):

* ``ideal``     — zero delay (the default; scheduler stays on the
  bit-exact legacy path)
* ``bandwidth`` — per-client asymmetric bandwidth + fixed latency, with
  optional static heterogeneity across the fleet and per-transfer
  lognormal jitter
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.sim.base import (STREAM_NETWORK, STREAM_STATIC, CounterModel,
                            IdealNetwork, normal, u01)

__all__ = ["IdealNetwork", "BandwidthLatency", "ideal", "bandwidth"]

_MBPS = 1e6 / 8.0   # megabit/s -> bytes/s


def ideal(num_clients: int, seed: int = 0) -> IdealNetwork:
    return IdealNetwork(num_clients, seed)


class BandwidthLatency(CounterModel):
    """Asymmetric per-client links: delay = 2*latency + up/up_bw +
    down/down_bw, optionally scaled by per-transfer lognormal jitter.

    ``up_bw`` / ``down_bw`` are (N,) arrays in bytes/sec — build through
    ``bandwidth(...)`` which draws the fleet's static spread."""
    active = True

    def __init__(self, num_clients: int, seed: int, up_bw, down_bw,
                 latency_s: float = 0.05, jitter: float = 0.0):
        super().__init__(num_clients, seed)
        self.up_bw = np.asarray(up_bw, np.float64)
        self.down_bw = np.asarray(down_bw, np.float64)
        self.latency_s = latency_s
        self.jitter = jitter

    def delay(self, client: int, upload_bytes: int, download_bytes: int,
              now: float = 0.0) -> float:
        d = (2.0 * self.latency_s
             + upload_bytes / self.up_bw[client]
             + download_bytes / self.down_bw[client])
        if self.jitter:
            k = self._next(client)
            d *= math.exp(self.jitter
                          * normal(self.seed, STREAM_NETWORK, client, k))
        return d


def bandwidth(num_clients: int, seed: int = 0, up_mbps: float = 20.0,
              down_mbps: float = 100.0, latency_s: float = 0.02,
              het: float = 0.0, jitter: float = 0.0) -> BandwidthLatency:
    """A bandwidth+latency fleet.  ``het`` spreads the nominal rates
    across clients as a static lognormal factor (het=0.5 gives roughly a
    3x spread between the luckiest and unluckiest device); ``jitter``
    adds per-transfer lognormal noise on top."""
    def rates(nominal):
        if het <= 0.0:
            return np.full(num_clients, nominal * _MBPS)
        return np.array([nominal * _MBPS
                         * math.exp(het * normal(seed, STREAM_STATIC, c, 2))
                         for c in range(num_clients)])
    return BandwidthLatency(num_clients, seed, rates(up_mbps),
                            rates(down_mbps), latency_s=latency_s,
                            jitter=jitter)
