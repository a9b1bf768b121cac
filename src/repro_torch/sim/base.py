"""Counter-based randomness + the three scenario-model protocols.

Every stochastic quantity in the simulation subsystem is drawn from a
*counter-based* stream keyed on ``(seed, stream, client, draw_index)``
through a splitmix64 hash — no shared mutable RNG.  Two consequences the
rest of the subsystem leans on:

* **Order invariance** — client c's k-th draw is the same number no
  matter how the engines interleave pops and reschedules, so service-time
  traces agree between the sequential and batched engines by
  construction (and snapshotting is just saving the counters).
* **Coupled comparisons** — two runs that differ only in *payload bytes*
  (e.g. vafl+identity vs vafl+topk_int8 on the same scenario) consume
  the same draws per client-round, so every completion time in the
  compressed run is pointwise <= the uncompressed one and the simulated
  time-to-accuracy comparison is exact, not noisy.

The protocols are duck-typed (no ABC registration needed):

* ``ComputeModel`` — ``sample(client, now=0.0) -> float`` service time
  for the client's next local round; ``now`` lets models vary over
  simulated time.  Owns per-client draw counters; ``state()`` /
  ``set_state()`` expose them for checkpointing.
* ``NetworkModel`` — ``delay(client, upload_bytes, download_bytes,
  now=0.0) -> float``: the link time for the round's actual on-the-wire
  bytes (this is what couples codecs to the simulated clock).  A model
  with ``active = False`` is the ideal network: the scheduler skips it
  and stays on the bit-exact default path.
* ``AvailabilityModel`` — ``next_start(client, t) -> float`` (>= t;
  dropout/diurnal gaps before the next round starts) and
  ``round_fails(client) -> bool`` (mid-round failure: the attempt's
  work is discarded and the client retries).  ``active = False`` means
  always-on.
"""
from __future__ import annotations

import math

import numpy as np

_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15

# stream ids — one per kind of draw so counters never collide
STREAM_COMPUTE = 1     # service times
STREAM_NETWORK = 2     # link jitter
STREAM_AVAIL = 3       # dropout / failure coin flips
STREAM_STATIC = 4      # per-client static attributes (base speeds, bw, phase)
STREAM_FAULT = 5       # chaos-transport fault schedule (resilience)
STREAM_RETRY = 6       # retry backoff jitter (resilience)


def _splitmix64(x: int) -> int:
    x = (x + _GOLDEN) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _hash(seed: int, stream: int, client: int, k: int) -> int:
    h = _splitmix64(seed & _M64)
    h = _splitmix64(h ^ (stream & _M64))
    h = _splitmix64(h ^ (client & _M64))
    return _splitmix64(h ^ (k & _M64))


def u01(seed: int, stream: int, client: int, k: int) -> float:
    """Uniform draw in (0, 1) — strictly open so logs are safe."""
    return ((_hash(seed, stream, client, k) >> 11) + 0.5) * 2.0 ** -53


def normal(seed: int, stream: int, client: int, k: int) -> float:
    """Standard normal via Box-Muller; draw k consumes hashes 2k, 2k+1."""
    u1 = u01(seed, stream, client, 2 * k)
    u2 = u01(seed, stream, client, 2 * k + 1)
    return math.sqrt(-2.0 * math.log(u1)) * math.cos(2.0 * math.pi * u2)


def exponential(seed: int, stream: int, client: int, k: int) -> float:
    """Unit-mean exponential draw."""
    return -math.log(u01(seed, stream, client, k))


class CounterModel:
    """Shared plumbing for scenario models: one per-client draw counter
    plus ``state()``/``set_state()`` so the scheduler snapshot captures
    exactly where every stream is."""

    def __init__(self, num_clients: int, seed: int = 0):
        self.num_clients = num_clients
        self.seed = seed
        self._k = np.zeros(num_clients, np.int64)

    def _next(self, client: int) -> int:
        k = int(self._k[client])
        self._k[client] = k + 1
        return k

    def state(self) -> dict:
        return {"k": self._k.copy()}

    def set_state(self, state: dict) -> None:
        self._k = np.asarray(state["k"], np.int64).copy()


class IdealNetwork(CounterModel):
    """Zero-delay network — the default.  ``active = False`` keeps the
    scheduler on the bit-exact legacy scheduling path."""
    active = False

    def delay(self, client: int, upload_bytes: int, download_bytes: int,
              now: float = 0.0) -> float:
        return 0.0


class AlwaysOn(CounterModel):
    """Every client is always available — the default."""
    active = False

    def next_start(self, client: int, t: float) -> float:
        return t

    def round_fails(self, client: int) -> bool:
        return False
