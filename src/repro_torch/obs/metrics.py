"""Run-scoped metrics registry: counters, gauges and histograms with a
plain-dict snapshot export.  Copy of ``repro.obs.metrics``.

Deliberately tiny and dependency-free — values are Python scalars, a
histogram keeps count/sum/min/max plus power-of-two bucket counts (the
same bucketing the engine uses for compiled-variant control), and
``snapshot()`` is JSON-ready.  Everything is get-or-create by name so
call sites never pre-register.
"""
from __future__ import annotations

import math


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v):
        self.value = v


class Histogram:
    """count / sum / min / max plus power-of-two bucket counts: bucket k
    counts observations in (2^(k-1), 2^k] (k=0 holds v <= 1, negatives
    and zeros included)."""
    __slots__ = ("count", "total", "min", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets = {}

    def observe(self, v):
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        k = 0 if v <= 1.0 else (math.ceil(v) - 1).bit_length()
        self.buckets[k] = self.buckets.get(k, 0) + 1

    @property
    def mean(self):
        return self.total / self.count if self.count else 0.0

    def percentile(self, q):
        """The q-th percentile (q in [0, 100]) estimated from the pow2
        buckets: find the bucket holding the target rank, then
        interpolate linearly inside its value range, clamped to the
        observed [min, max].  Exact at the extremes (p0 = min,
        p100 = max); elsewhere within one bucket's width — the right
        resolution for threshold probes and summary scalars.  None when
        nothing was observed."""
        return _bucket_percentile(self.count, self.min, self.max,
                                  self.buckets, q)


def _bucket_percentile(count, lo_obs, hi_obs, buckets, q):
    if not count:
        return None
    q = min(100.0, max(0.0, float(q)))
    if q <= 0.0:
        return float(lo_obs)
    if q >= 100.0:
        return float(hi_obs)
    rank = q / 100.0 * count
    seen = 0
    for k in sorted(buckets):
        n = buckets[k]
        if seen + n >= rank:
            # bucket k spans (2^(k-1), 2^k]; k=0 holds everything <= 1
            lo = float(lo_obs) if k == 0 else float(2 ** (k - 1))
            hi = 1.0 if k == 0 else float(2 ** k)
            lo = max(lo, float(lo_obs))
            hi = min(hi, float(hi_obs))
            if hi <= lo:
                return lo
            frac = (rank - seen) / n
            return lo + frac * (hi - lo)
        seen += n
    return float(hi_obs)


def snapshot_percentile(hist_snap, q):
    """``Histogram.percentile`` over a ``snapshot()`` histogram dict
    ({count, sum, min, max, buckets}) — the form BENCH writers and the
    live exposition hold after a run sealed.  None for None/empty."""
    if not hist_snap or not hist_snap.get("count"):
        return None
    return _bucket_percentile(
        hist_snap["count"], hist_snap["min"], hist_snap["max"],
        {int(k): v for k, v in hist_snap["buckets"].items()}, q)


class MetricsRegistry:
    """Name -> metric, get-or-create.  A name is one kind only — asking
    for an existing name as a different kind is a loud error."""

    def __init__(self):
        self._metrics = {}

    def _get(self, name, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls()
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already exists as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name) -> Gauge:
        return self._get(name, Gauge)

    def hist(self, name) -> Histogram:
        return self._get(name, Histogram)

    def restore(self, snapshot: dict) -> None:
        """Repopulate the registry from a ``snapshot()`` dict — the
        checkpoint-resume path, so a resumed run's final counters equal
        the uninterrupted run's.  Snapshot histograms carry count / sum
        / min / max / buckets, which is the Histogram's ENTIRE state,
        so the round trip is lossless."""
        for name, v in snapshot.get("counters", {}).items():
            self.counter(name).value = v
        for name, v in snapshot.get("gauges", {}).items():
            self.gauge(name).set(v)
        for name, h in snapshot.get("histograms", {}).items():
            m = self.hist(name)
            m.count = h["count"]
            m.total = h["sum"]
            m.min = math.inf if h["min"] is None else h["min"]
            m.max = -math.inf if h["max"] is None else h["max"]
            m.buckets = {int(k): v for k, v in h["buckets"].items()}

    def snapshot(self) -> dict:
        """JSON-ready snapshot: {"counters": {...}, "gauges": {...},
        "histograms": {name: {count,sum,mean,min,max,buckets}}}."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = {
                    "count": m.count, "sum": m.total, "mean": m.mean,
                    "min": None if m.count == 0 else m.min,
                    "max": None if m.count == 0 else m.max,
                    "buckets": {str(k): v
                                for k, v in sorted(m.buckets.items())},
                }
        return out
