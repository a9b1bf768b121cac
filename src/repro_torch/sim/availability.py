"""Availability models — client dropout/rejoin, mid-round failure,
diurnal participation.

The scheduler consults the availability model whenever it schedules a
client's next round: ``next_start(client, t)`` may push the start past
offline gaps (dropout, diurnal off-windows), and ``round_fails(client)``
decides whether the attempt's work is discarded mid-round — the clock
and busy time advance, but no update ever reaches the server and the
client retries.  All coin flips are counter-based per-client draws, so
traces are engine-order-invariant and two runs differing only in payload
bytes consume identical availability draws (coupled comparisons).

Registered names (see ``repro_torch.sim.registry``):

* ``always_on`` — no effect (the default; scheduler stays on the
  bit-exact legacy path)
* ``dropout``   — between rounds a client goes offline with probability
  ``p_drop`` for an exponential gap of mean ``off_mean`` seconds
* ``flaky``     — ``dropout`` plus mid-round failure with probability
  ``p_fail`` (the update is discarded, the client retries)
* ``diurnal``   — each client is only on during a duty-cycle window of a
  fixed period, phase drawn per client (day/night participation)

Round-mode runtimes (rounds / sync barrier) apply ``round_fails`` only —
a failed participant's upload is dropped from the aggregate; offline
gaps are an event-mode notion (there is no per-client clock to stretch
under a round barrier).
"""
from __future__ import annotations

from repro_torch.sim.base import (STREAM_AVAIL, STREAM_STATIC, AlwaysOn,
                            CounterModel, exponential, u01)

__all__ = ["AlwaysOn", "Intermittent", "Diurnal", "always_on", "dropout",
           "flaky", "diurnal"]


def always_on(num_clients: int, seed: int = 0) -> AlwaysOn:
    return AlwaysOn(num_clients, seed)


class Intermittent(CounterModel):
    """Dropout/rejoin plus optional mid-round failure.  One counter
    stream per client covers both kinds of draw (each call consumes the
    next counter), so the draw sequence is a pure function of how many
    rounds the client has attempted."""
    active = True

    def __init__(self, num_clients: int, seed: int = 0, p_drop: float = 0.1,
                 off_mean: float = 30.0, p_fail: float = 0.0):
        super().__init__(num_clients, seed)
        self.p_drop = p_drop
        self.off_mean = off_mean
        self.p_fail = p_fail

    def next_start(self, client: int, t: float) -> float:
        if self.p_drop <= 0.0:
            return t
        k = self._next(client)
        if u01(self.seed, STREAM_AVAIL, client, k) < self.p_drop:
            k = self._next(client)
            t += self.off_mean * exponential(self.seed, STREAM_AVAIL,
                                             client, k)
        return t

    def round_fails(self, client: int) -> bool:
        if self.p_fail <= 0.0:
            return False
        k = self._next(client)
        return u01(self.seed, STREAM_AVAIL, client, k) < self.p_fail


def dropout(num_clients: int, seed: int = 0, p_drop: float = 0.1,
            off_mean: float = 30.0) -> Intermittent:
    return Intermittent(num_clients, seed, p_drop=p_drop, off_mean=off_mean)


def flaky(num_clients: int, seed: int = 0, p_drop: float = 0.05,
          off_mean: float = 30.0, p_fail: float = 0.1) -> Intermittent:
    return Intermittent(num_clients, seed, p_drop=p_drop, off_mean=off_mean,
                        p_fail=p_fail)


class Diurnal(CounterModel):
    """Deterministic duty-cycle participation: client c is on during the
    first ``duty`` fraction of each ``period``, shifted by a per-client
    phase.  ``next_start`` is monotone in t (a round that would start in
    an off-window waits for the client's next on-window), which keeps
    byte-coupled comparisons exact."""
    active = True

    def __init__(self, num_clients: int, seed: int = 0, duty: float = 0.7,
                 period: float = 240.0):
        super().__init__(num_clients, seed)
        self.duty = duty
        self.period = period
        self._phase = [u01(seed, STREAM_STATIC, c, 3) * period
                       for c in range(num_clients)]

    def next_start(self, client: int, t: float) -> float:
        pos = (t - self._phase[client]) % self.period
        if pos < self.duty * self.period:
            return t
        return t + (self.period - pos)

    def round_fails(self, client: int) -> bool:
        return False


def diurnal(num_clients: int, seed: int = 0, duty: float = 0.7,
            period: float = 240.0) -> Diurnal:
    return Diurnal(num_clients, seed, duty=duty, period=period)
