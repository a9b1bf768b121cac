"""Deterministic event-driven scheduler for asynchronous FL simulation.
A copy of ``repro.core.scheduler`` (numpy only), the batched engine's
window API (``pop_window``, ``account_bytes``, ``reactive``) and its
obs failure hook included; the parity tests (tests/test_torch_sim.py,
tests/test_torch_batched.py, tests/test_torch_obs.py) keep it
bit-identical to the original.

The paper's asynchrony (Raspberry-Pi stragglers, network jitter) is
modelled as deterministic service-time distributions and a
discrete-event loop.  The *algorithmic* quantities (arrival order,
staleness, per-client V) are exactly what the scheduler replays; the
numeric work (local SGD, aggregation) runs on the run's device.

Service times are drawn from **counter-based per-client streams**
(``repro_torch.sim.base``: hash of (seed, client, draw-index)) — client c's
k-th draw is the same number regardless of how an engine interleaves
pops and reschedules, so traces are engine-order-invariant and the whole
scheduler state checkpoints as a handful of arrays (``snapshot`` /
``restore``, persisted by a run-state checkpoint).

The default speed model mirrors the paper's testbed: one fast laptop-class
client, the rest Raspberry-Pi-class with one slower 4 GB unit.  Scenario
heterogeneity beyond that — device fleets, byte-aware network links,
dropout/failure — plugs in through ``repro_torch.sim`` (docs/SCENARIOS.md):
``network`` turns the actual per-event payload bytes into link delay and
``availability`` injects offline gaps and mid-round failures.  With both
inactive the scheduler runs the exact legacy arithmetic, bit for bit.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.sim.base import STREAM_COMPUTE, normal

# a failing client retries its round; cap the retry loop so a pathological
# availability model (p_fail ~ 1) cannot live-lock the scheduler
_MAX_ATTEMPTS = 1000


@dataclass
class SpeedModel:
    """Per-client lognormal service times: round_time ~ base_i * LogN(0, sigma).

    Draws come from counter-based per-client streams (seed, client, k) —
    no shared RNG state — so the k-th service time of client i is
    independent of scheduling order and restores exactly from the
    counter array (``state``/``set_state``)."""
    base: np.ndarray                 # (N,) mean seconds per local round
    sigma: float = 0.15
    seed: int = 0

    def __post_init__(self):
        self._k = np.zeros(len(self.base), np.int64)

    @staticmethod
    def paper_testbed(num_clients: int, seed: int = 0) -> "SpeedModel":
        """Paper §IV-A: laptop ~x1, Pi-4B 8GB ~x3.5, Pi-4B 4GB ~x4.5
        (relative local-round service times)."""
        base = []
        for i in range(num_clients):
            if i == 0:
                base.append(1.0)      # laptop-class
            elif i == 1:
                base.append(4.5)      # the 4 GB Pi
            else:
                base.append(3.5)      # 8 GB Pis
        return SpeedModel(np.array(base, np.float64), seed=seed)

    def sample(self, client: int, now: float = 0.0) -> float:
        k = int(self._k[client])
        self._k[client] = k + 1
        z = normal(self.seed, STREAM_COMPUTE, client, k)
        return float(self.base[client] * np.exp(self.sigma * z))

    def state(self) -> dict:
        return {"k": self._k.copy()}

    def set_state(self, state: dict) -> None:
        self._k = np.asarray(state["k"], np.int64).copy()


@dataclass(order=True)
class Event:
    time: float
    seq: int
    client: int = field(compare=False)


class EventScheduler:
    """Min-heap of client-finish events with idle-time accounting.

    ``network`` / ``availability`` are optional ``repro_torch.sim`` models; a
    missing or inactive model keeps the corresponding effect out of the
    arithmetic entirely (the default scenario is bit-exact with the
    pre-scenario scheduler)."""

    def __init__(self, num_clients: int, speed: SpeedModel,
                 network=None, availability=None, obs=None):
        self.speed = speed
        self.network = network if _is_active(network) else None
        self.availability = availability if _is_active(availability) else None
        # optional repro_torch.obs Observer: mid-round failures become
        # trace events (the runtimes own every other hook site)
        self.obs = obs
        self.heap: List[Event] = []
        self._seq = 0
        self.now = 0.0
        self.busy_until = np.zeros(num_clients)
        self.client_busy_time = np.zeros(num_clients)
        self.client_net_delay = np.zeros(num_clients)
        self.client_up_bytes = np.zeros(num_clients, np.int64)
        self.client_down_bytes = np.zeros(num_clients, np.int64)
        self.client_failed_rounds = np.zeros(num_clients, np.int64)
        for c in range(num_clients):
            self.schedule(c)

    def schedule(self, client: int, extra_delay: float = 0.0,
                 start: Optional[float] = None,
                 upload_bytes: int = 0, download_bytes: int = 0):
        """Schedule the client's next completion.  ``start`` is when the
        client begins its next local round (default: the current simulated
        time — correct for the sequential engine, where ``now`` is the
        client's own completion time when its event is processed).  The
        batched engine passes each client's own completion time so that
        executing a window in one batch does not act as a simulated-clock
        barrier (early finishers restart immediately, not at window end).

        ``upload_bytes`` / ``download_bytes`` are the just-finished
        round's actual on-the-wire payload sizes: under an active network
        model they become link delay (idle, not busy) before the next
        round starts — this is how compression literally makes the
        simulated clock advance less."""
        t0 = self.now if start is None else start
        self.client_up_bytes[client] += upload_bytes
        self.client_down_bytes[client] += download_bytes
        if self.network is None and self.availability is None:
            # the default scenario: the exact legacy arithmetic
            service = self.speed.sample(client, max(t0, self.busy_until[client]))
            t = max(t0, self.busy_until[client]) + service + extra_delay
            self.busy_until[client] = t
            # only service time is busy compute — network latency
            # (extra_delay) delays the next completion but the client
            # sits idle through it
            self.client_busy_time[client] += service
        else:
            t = max(t0, self.busy_until[client])
            if self.network is not None:
                nd = float(self.network.delay(client, upload_bytes,
                                              download_bytes, t))
                self.client_net_delay[client] += nd
                t += nd
            t += extra_delay
            for _ in range(_MAX_ATTEMPTS):
                if self.availability is not None:
                    t = float(self.availability.next_start(client, t))
                service = self.speed.sample(client, t)
                self.client_busy_time[client] += service
                t += service
                if (self.availability is None
                        or not self.availability.round_fails(client)):
                    break
                # mid-round failure: the attempt's work is discarded and
                # the client goes again — clock and busy time advance,
                # but no update (and no bytes) ever reach the server
                self.client_failed_rounds[client] += 1
                if self.obs is not None:
                    self.obs.failure(client, t)
            self.busy_until[client] = t
        self._seq += 1
        heapq.heappush(self.heap, Event(t, self._seq, client))

    def account_bytes(self, client: int, upload_bytes: int, download_bytes: int):
        """Record a round's wire bytes without scheduling, for engines
        that reschedule before payload sizes are known (the batched
        engine's pipelined default path, where the network model is
        inactive and bytes carry no delay)."""
        self.client_up_bytes[client] += upload_bytes
        self.client_down_bytes[client] += download_bytes

    def pop(self) -> Tuple[float, int]:
        ev = heapq.heappop(self.heap)
        self.now = ev.time
        return ev.time, ev.client

    def pop_window(self, max_batch: int) -> Tuple[np.ndarray, np.ndarray]:
        """Pop the up-to-``max_batch`` earliest completions: the window the
        batched engine executes as ONE batched update before its next mix
        point.  Clients are returned in arrival order (each appears at most
        once per window: a client's next completion is only scheduled after
        its current one is processed).  Returns ``(times, clients)`` with
        per-event completion times (``times[-1]`` advances ``now``);
        ``pop_window(1)`` is exactly ``pop()``."""
        k = min(max_batch, len(self.heap))
        times = np.empty(k, np.float64)
        clients = np.empty(k, np.int64)
        for j in range(k):
            ev = heapq.heappop(self.heap)
            self.now = times[j] = ev.time
            clients[j] = ev.client
        return times, clients

    def __len__(self):
        return len(self.heap)

    @property
    def reactive(self) -> bool:
        """True when scheduling consumes per-event byte counts or
        availability draws: engines must then reschedule *after* the
        window's upload decisions (the batched engine defers its
        pipeline's reschedule+pop to the decision loop's end)."""
        return self.network is not None or self.availability is not None

    def idle_fraction(self) -> np.ndarray:
        """Per-client fraction of wall-clock spent idle (waiting on server
        round barriers, network transfers, offline gaps) — the quantity
        async FL reduces."""
        total = max(self.now, 1e-9)
        return np.clip(1.0 - self.client_busy_time / total, 0.0, 1.0)

    # ------------------------------------------------ snapshot / restore ---

    def snapshot(self) -> dict:
        """The scheduler's full state as a pytree of numpy arrays: heap
        events, clocks, per-client accounting and every model's RNG
        counters, as a run-state checkpoint stores it
        (``repro_torch.checkpoint``).  Restoring into a scheduler built
        with the same models resumes bit-deterministically
        (counter-based draws have no hidden RNG)."""
        ev = sorted(self.heap)
        state = {
            "heap": {
                "time": np.array([e.time for e in ev], np.float64),
                "seq": np.array([e.seq for e in ev], np.int64),
                "client": np.array([e.client for e in ev], np.int64),
            },
            "clock": np.array([self.now, float(self._seq)], np.float64),
            "busy_until": self.busy_until.copy(),
            "client_busy_time": self.client_busy_time.copy(),
            "client_net_delay": self.client_net_delay.copy(),
            "client_up_bytes": self.client_up_bytes.copy(),
            "client_down_bytes": self.client_down_bytes.copy(),
            "client_failed_rounds": self.client_failed_rounds.copy(),
            "models": {},
        }
        for name, model in (("speed", self.speed), ("network", self.network),
                            ("availability", self.availability)):
            if model is not None and hasattr(model, "state"):
                state["models"][name] = model.state()
        return state

    def restore(self, state: dict) -> "EventScheduler":
        """Restore a ``snapshot`` in place (models included).  The
        scheduler must have been constructed with the same num_clients
        and model configuration the snapshot was taken from."""
        heap = state["heap"]
        self.heap = [Event(float(t), int(s), int(c)) for t, s, c in
                     zip(np.atleast_1d(heap["time"]),
                         np.atleast_1d(heap["seq"]),
                         np.atleast_1d(heap["client"]))]
        heapq.heapify(self.heap)
        self.now = float(state["clock"][0])
        self._seq = int(state["clock"][1])
        self.busy_until = np.asarray(state["busy_until"], np.float64).copy()
        self.client_busy_time = np.asarray(state["client_busy_time"],
                                           np.float64).copy()
        self.client_net_delay = np.asarray(state["client_net_delay"],
                                           np.float64).copy()
        self.client_up_bytes = np.asarray(state["client_up_bytes"],
                                          np.int64).copy()
        self.client_down_bytes = np.asarray(state["client_down_bytes"],
                                            np.int64).copy()
        self.client_failed_rounds = np.asarray(state["client_failed_rounds"],
                                               np.int64).copy()
        models = state.get("models", {})
        for name, model in (("speed", self.speed), ("network", self.network),
                            ("availability", self.availability)):
            if name in models and model is not None:
                model.set_state(models[name])
        return self


def _is_active(model) -> bool:
    return model is not None and getattr(model, "active", True)
