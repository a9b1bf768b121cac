"""``MetricsSampler`` — a background thread turning the run-scoped
``MetricsRegistry`` into a bounded time series.  Copy of
``repro.obs.live.sampler``; the HTTP exposition and health probes that
read it in the reference are ROADMAP.md queue 1 item 9b.

Every ``interval`` seconds the sampler snapshots the registry (the same
JSON-ready dict ``RunResult.metrics`` carries) and appends it to a ring
buffer of ``capacity`` entries, each stamped with the host-monotonic
clock.  From two samples the derivations fall out: ``deltas`` (counter
movement between the oldest and newest retained sample) and ``rates``
(movement per second over the most recent pair) — what ``/metrics``
exposes as ``repro_counter_rate`` and what the probes read for trends.

The sampler holds only a reference to the registry; snapshotting reads
plain Python scalars, so the hot loop is never locked against — the
worst case is a sample landing mid-increment, which shifts one count by
one sample period.  Sampling is opt-in (``ObsConfig.sample_interval``)
and the thread is a daemon: an abandoned run never hangs interpreter
exit.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional


class MetricsSampler:
    def __init__(self, registry, interval: float = 1.0,
                 capacity: int = 512, clock=time.monotonic):
        if interval <= 0:
            raise ValueError(f"sample interval must be > 0, got {interval}")
        if capacity < 2:
            raise ValueError(f"sample capacity must be >= 2, got {capacity}")
        self.registry = registry
        self.interval = float(interval)
        self._clock = clock
        self._samples: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------- lifecycle ---

    def start(self) -> None:
        """Start the background thread (idempotent).  Takes one sample
        immediately so rates are defined as soon as the second tick
        lands."""
        if self._thread is not None:
            return
        self._stop.clear()
        self.sample_once()
        self._thread = threading.Thread(target=self._loop,
                                        name="obs-metrics-sampler",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the thread and take one final sample, so the series
        always ends at the sealed counters (idempotent)."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=max(1.0, 2 * self.interval))
            self.sample_once()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.sample_once()

    # ------------------------------------------------------- the series ---

    def sample_once(self) -> None:
        """Append one (host_time, snapshot) sample — also the direct
        entry point for tests and single-threaded drivers."""
        snap = self.registry.snapshot()
        with self._lock:
            self._samples.append((self._clock(), snap))

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def samples(self) -> list:
        """The retained (host_time, snapshot) pairs, oldest first."""
        with self._lock:
            return list(self._samples)

    def latest(self):
        """The newest (host_time, snapshot) pair, or None before the
        first tick."""
        with self._lock:
            return self._samples[-1] if self._samples else None

    def series(self, name: str) -> list:
        """One counter/gauge as [(host_time, value), ...] over the
        retained window (samples without the metric are skipped)."""
        out = []
        for t, snap in self.samples():
            if name in snap["counters"]:
                out.append((t, snap["counters"][name]))
            elif name in snap["gauges"]:
                out.append((t, snap["gauges"][name]))
        return out

    def deltas(self) -> dict:
        """Counter movement between the oldest and newest retained
        sample: {name: newest - oldest} (missing-at-start counters
        delta from 0)."""
        samples = self.samples()
        if len(samples) < 2:
            return {}
        first, last = samples[0][1]["counters"], samples[-1][1]["counters"]
        return {name: v - first.get(name, 0) for name, v in last.items()}

    def rates(self) -> dict:
        """Counter movement per second over the most recent sample pair:
        {name: (v1 - v0) / (t1 - t0)} — the live throughput numbers
        (uploads/sec, bytes/sec) `/metrics` exports."""
        samples = self.samples()
        if len(samples) < 2:
            return {}
        (t0, s0), (t1, s1) = samples[-2], samples[-1]
        dt = t1 - t0
        if dt <= 0:
            return {}
        c0 = s0["counters"]
        return {name: (v - c0.get(name, 0)) / dt
                for name, v in s1["counters"].items()}
