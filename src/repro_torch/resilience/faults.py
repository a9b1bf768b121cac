"""Seeded, counter-based fault schedules for the chaos transport, and
the clients' retry policy.  Port of ``repro.resilience.faults`` (numpy
only, copied); ``repro_torch.resilience.chaos`` draws its fates here.

A :class:`FaultSpec` declares per-frame fault *rates*; a
:class:`FaultPlan` turns them into deterministic per-frame decisions
using the same splitmix64 counter streams every ``repro_torch.sim`` model
draws from (``u01(seed, STREAM_FAULT, client, k)``) — client ``c``'s
``k``-th frame gets the same fate no matter how threads interleave, so
every chaos run is reproducible from its seed alone and a retried
frame (a NEW frame, next counter) draws a fresh fate.

Each frame consumes one counter per direction and the draw is cut into
disjoint probability bands in declaration order (drop first, then
corrupt, reset, blackout, duplicate, reorder, delay), so one uniform
decides at most one fault per frame and the marginal rates are exact.

An optional ``availability`` model (any ``repro_torch.sim`` availability
model, e.g. ``Intermittent``) layers on top: a frame sent while the
model says the client's round fails is dropped: fault schedules reuse
the availability models.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.sim.base import STREAM_FAULT, STREAM_RETRY, u01

UPLINK = 0      # client -> server frames
DOWNLINK = 1    # server -> client broadcasts

# fate codes returned by FaultPlan.fate (declaration order = band order)
OK = "ok"
DROP = "drop"
CORRUPT = "corrupt"
RESET = "reset"
BLACKOUT = "blackout"
DUPLICATE = "duplicate"
REORDER = "reorder"
DELAY = "delay"

_BANDS = (DROP, CORRUPT, RESET, BLACKOUT, DUPLICATE, REORDER, DELAY)


@dataclass(frozen=True)
class FaultSpec:
    """Per-frame fault rates (uplink unless noted) plus their shape
    parameters.  All rates default to 0 — the default spec is a no-op
    wrapper, which the chaos determinism test leans on."""
    drop: float = 0.0          # frame silently lost
    corrupt: float = 0.0       # frame mangled -> receiver discards it
    #                            as a WireError (counted, stream survives)
    reset: float = 0.0         # connection reset mid-exchange: the frame
    #                            AND the client's inbound broadcasts are
    #                            lost for reset_s seconds
    reset_s: float = 0.05
    blackout: float = 0.0      # mid-exchange client kill: the client
    #                            goes completely dark (both directions)
    #                            for blackout_s — long enough to trip a
    #                            liveness deadline and get evicted
    blackout_s: float = 0.3
    duplicate: float = 0.0     # frame delivered twice
    reorder: float = 0.0       # frame held back reorder_s so later
    #                            traffic (other clients, its own retry)
    #                            passes it
    reorder_s: float = 0.02
    delay: float = 0.0         # frame delivered late by delay_s
    delay_s: float = 0.05
    bcast_drop: float = 0.0    # DOWNLINK: broadcast silently lost (the
    #                            reply-replay path's main exercise)
    seed: int = 0

    def __post_init__(self):
        total = (self.drop + self.corrupt + self.reset + self.blackout
                 + self.duplicate + self.reorder + self.delay)
        if total > 1.0:
            raise ValueError(f"uplink fault rates sum to {total} > 1")
        if not 0.0 <= self.bcast_drop <= 1.0:
            raise ValueError(f"bcast_drop {self.bcast_drop} not in [0,1]")


class FaultPlan:
    """The spec bound to per-(client, direction) frame counters."""

    def __init__(self, spec: FaultSpec, num_clients: int,
                 availability=None):
        self.spec = spec
        self.num_clients = num_clients
        self.availability = availability
        self._k = np.zeros((2, num_clients), np.int64)

    def _next(self, direction: int, client: int) -> int:
        k = int(self._k[direction, client])
        self._k[direction, client] = k + 1
        return k

    def fate(self, client: int) -> str:
        """This uplink frame's fate — one of the module fate codes."""
        if (self.availability is not None
                and getattr(self.availability, "active", True)
                and self.availability.round_fails(client)):
            return DROP
        s = self.spec
        # direction folded into the counter axis; the draw is cut into
        # disjoint bands in _BANDS order
        u = u01(s.seed, STREAM_FAULT, client, self._next(UPLINK, client))
        lo = 0.0
        for name, rate in zip(_BANDS, (s.drop, s.corrupt, s.reset,
                                       s.blackout, s.duplicate, s.reorder,
                                       s.delay)):
            if rate and lo <= u < lo + rate:
                return name
            lo += rate
        return OK

    def bcast_fate(self, client: int) -> str:
        """This downlink broadcast's fate (drop or ok)."""
        s = self.spec
        if not s.bcast_drop:
            return OK
        # downlink draws live at counter offset 2^32 so adding uplink
        # traffic never shifts them (order invariance per direction)
        k = self._next(DOWNLINK, client) + (1 << 32)
        u = u01(s.seed, STREAM_FAULT, client, k)
        return DROP if u < s.bcast_drop else OK

    def state(self) -> dict:
        st = {"k": self._k.copy()}
        if self.availability is not None and hasattr(self.availability,
                                                     "state"):
            st["availability"] = self.availability.state()
        return st

    def set_state(self, state: dict) -> None:
        self._k = np.asarray(state["k"], np.int64).copy()
        if self.availability is not None and "availability" in state:
            self.availability.set_state(state["availability"])


@dataclass(frozen=True)
class RetryPolicy:
    """Client-side retry for the stop-and-wait exchange: re-send the
    SAME frame (same ``seq``) when no reply lands within
    ``attempt_timeout_s``, backing off exponentially with seeded
    counter-based jitter.  The server dedups by ``(client, seq)`` and
    replays its cached reply, so at-least-once sending composes with
    idempotent receiving into exactly-once processing."""
    max_attempts: int = 5
    attempt_timeout_s: float = 1.0   # reply wait per attempt
    base_s: float = 0.05             # first backoff
    factor: float = 2.0
    max_backoff_s: float = 1.0
    jitter: float = 0.5              # +/- fraction of the backoff
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter {self.jitter} not in [0,1]")

    def backoff(self, attempt: int, client: int, nonce: int) -> float:
        """Sleep before re-attempt ``attempt`` (1-based) of the frame
        identified by ``nonce`` (the client's seq — each frame's jitter
        draws are its own counter slots, so retries are reproducible)."""
        b = min(self.base_s * self.factor ** (attempt - 1),
                self.max_backoff_s)
        if self.jitter == 0.0:
            return b
        u = u01(self.seed, STREAM_RETRY, client,
                nonce * 64 + min(attempt, 63))
        return b * (1.0 - self.jitter + 2.0 * self.jitter * u)
