"""Health probes: SLO checks over the live metrics, behind the repo's
standard string registry.  Copy of ``repro.obs.live.probes``.

A probe is a callable ``probe(ctx) -> ProbeResult`` built by a factory
``factory(**thresholds)`` registered under a name —
``get_probe("staleness-p99")()`` mirrors ``get_transport``/
``get_algorithm`` exactly: builtins resolve lazily, a pre-registration
made before the builtin load wins, and unknown names fail loudly
listing what is registered.

``ProbeContext`` is the read surface: the current metrics snapshot,
the sampler's history (trend probes), and — when the probe runs inside
a serving plane — the ``FLServer`` itself (liveness state, eval
records).  Every builtin returns OK when its signal is absent: a probe
wired against a run that never emits its metric reports healthy, not
broken.

``ProbeSet`` evaluates a list of probes and turns *transitions* into
structured alerts through ``Observer.alert`` (an "alert" trace event +
``alerts``/``alerts_warn``/``alerts_crit`` counters): entering WARN or
CRIT alerts once, recovering to OK alerts once — a flapping probe
traces every flip, a steady one stays silent.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from repro_torch.obs.metrics import snapshot_percentile

OK, WARN, CRIT = "ok", "warn", "crit"
_SEVERITY = {OK: 0, WARN: 1, CRIT: 2}


@dataclass
class ProbeResult:
    name: str
    status: str                      # "ok" | "warn" | "crit"
    value: Optional[float] = None    # the signal the verdict came from
    detail: str = ""

    def to_dict(self) -> dict:
        return {"name": self.name, "status": self.status,
                "value": self.value, "detail": self.detail}


@dataclass
class ProbeContext:
    """What a probe may read.  ``snapshot`` is always present;
    ``sampler``/``server`` are None outside a live plane."""
    snapshot: dict
    sampler: object = None
    server: object = None


def worst(statuses) -> str:
    """The most severe of a set of statuses (the /healthz verdict)."""
    return max(statuses, key=_SEVERITY.__getitem__, default=OK)


def _grade(name, value, warn, crit, detail_fmt) -> ProbeResult:
    """Shared threshold ladder: value >= crit -> CRIT, >= warn -> WARN."""
    if value is None:
        return ProbeResult(name, OK, None, "no signal yet")
    status = CRIT if value >= crit else WARN if value >= warn else OK
    return ProbeResult(name, status, round(float(value), 4),
                       detail_fmt.format(value=value, warn=warn, crit=crit))


# ------------------------------------------------------------- builtins ---

def staleness_p99(*, warn: float = 8.0, crit: float = 32.0) -> Callable:
    """p99 of the committed-update staleness distribution — the
    paper's s(tau) input drifting high means the fleet is committing
    against ancient models."""
    def probe(ctx: ProbeContext) -> ProbeResult:
        p99 = snapshot_percentile(
            ctx.snapshot.get("histograms", {}).get("staleness"), 99)
        return _grade("staleness-p99", p99, warn, crit,
                      "staleness p99 {value:.1f} (warn>={warn}, "
                      "crit>={crit})")
    return probe


def queue_depth(*, warn: float = 64.0, crit: float = 256.0) -> Callable:
    """p95 of the upload-queue depth the serve loop observed — a
    climbing queue means the hot loop can no longer drain the fleet."""
    def probe(ctx: ProbeContext) -> ProbeResult:
        p95 = snapshot_percentile(
            ctx.snapshot.get("histograms", {}).get("queue_depth"), 95)
        return _grade("queue-depth", p95, warn, crit,
                      "queue depth p95 {value:.1f} (warn>={warn}, "
                      "crit>={crit})")
    return probe


def commit_latency(*, warn_ms: float = 250.0,
                   crit_ms: float = 2000.0) -> Callable:
    """p95 of transport-arrival -> aggregation-commit latency (ms)."""
    def probe(ctx: ProbeContext) -> ProbeResult:
        p95 = snapshot_percentile(
            ctx.snapshot.get("histograms", {}).get("commit_latency_ms"),
            95)
        return _grade("commit-latency", p95, warn_ms, crit_ms,
                      "commit latency p95 {value:.1f}ms (warn>={warn}, "
                      "crit>={crit})")
    return probe


def dead_client_fraction(*, warn: float = 0.25,
                         crit: float = 0.5) -> Callable:
    """Fraction of the fleet currently evicted (liveness deadline,
    transport death, chaos blackout) — reads the server's live eviction
    set, so it recovers the moment clients re-admit."""
    def probe(ctx: ProbeContext) -> ProbeResult:
        srv = ctx.server
        if srv is None:
            return ProbeResult("dead-client-fraction", OK, None,
                               "no server attached")
        n = srv.cfg.num_clients
        frac = len(srv._evicted) / n if n else 0.0
        return _grade("dead-client-fraction", frac, warn, crit,
                      "{value:.0%} of clients evicted (warn>={warn:.0%},"
                      " crit>={crit:.0%})")
    return probe


def accuracy_stall(*, window: int = 5, min_delta: float = 1e-4) -> Callable:
    """No best-accuracy improvement across the last ``window`` eval
    records — WARN (the run may have converged or wedged; a stall is a
    look-at-me, not an outage)."""
    def probe(ctx: ProbeContext) -> ProbeResult:
        srv = ctx.server
        records = getattr(srv, "records", None) if srv is not None else None
        if not records or len(records) < window + 1:
            return ProbeResult("accuracy-stall", OK, None,
                               f"fewer than {window + 1} eval records")
        accs = [r.global_acc for r in records]
        gain = max(accs[-window:]) - max(accs[:-window])
        status = WARN if gain < min_delta else OK
        return ProbeResult(
            "accuracy-stall", status, round(float(gain), 6),
            f"best-acc gain {gain:+.5f} over last {window} evals "
            f"(warn<{min_delta})")
    return probe


# ------------------------------------------------------------- registry ---

_REGISTRY: Dict[str, Callable] = {}
_BUILTIN_OWNED: set = set()
_BUILTINS: Tuple[Tuple[str, Callable], ...] = (
    ("staleness-p99", staleness_p99),
    ("queue-depth", queue_depth),
    ("commit-latency", commit_latency),
    ("dead-client-fraction", dead_client_fraction),
    ("accuracy-stall", accuracy_stall),
)
_builtins_loaded = False


def _ensure_builtins() -> None:
    global _builtins_loaded
    if not _builtins_loaded:
        for name, factory in _BUILTINS:
            # pre-registration wins: a plugin that deliberately took a
            # builtin name before the lazy load keeps it
            if name in _REGISTRY and name not in _BUILTIN_OWNED:
                continue
            _REGISTRY[name] = factory
            _BUILTIN_OWNED.add(name)
        _builtins_loaded = True


def register_probe(name: str, factory: Callable, *,
                   overwrite: bool = False) -> None:
    """Register a probe factory ``factory(**thresholds) -> probe(ctx)``
    under ``name``.  Re-registration is an error unless ``overwrite``
    (typo'd duplicates stay loud)."""
    if not overwrite and name in _REGISTRY:
        raise ValueError(f"probe {name!r} already registered")
    _REGISTRY[name] = factory
    _BUILTIN_OWNED.discard(name)


def get_probe(name: str) -> Callable:
    """Resolve a probe name to its factory; unknown names fail loudly
    with the registered set in the message."""
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown probe {name!r}; registered probes: "
            f"{', '.join(available_probes())}") from None


def available_probes() -> Tuple[str, ...]:
    """Registered names: builtins first (stable order), then third-party
    registrations in registration order."""
    _ensure_builtins()
    head = [n for n, _ in _BUILTINS if n in _REGISTRY]
    return tuple(head) + tuple(n for n in _REGISTRY
                               if n not in dict(_BUILTINS))


DEFAULT_PROBES = tuple(n for n, _ in _BUILTINS)


class ProbeSet:
    """A configured set of probes over one federation, with
    transition-based alerting into its Observer."""

    def __init__(self, probes=None, *, obs=None):
        probes = DEFAULT_PROBES if probes is None else probes
        self.probes = [get_probe(p)() if isinstance(p, str) else p
                       for p in probes]
        self.obs = obs
        self._last: Dict[str, str] = {}

    def evaluate(self, ctx: ProbeContext) -> list:
        """Run every probe; emit one ``Observer.alert`` per status
        *transition* (ok -> warn/crit, warn <-> crit, and the recovery
        back to ok)."""
        results = []
        for probe in self.probes:
            r = probe(ctx)
            results.append(r)
            prev = self._last.get(r.name, OK)
            if r.status != prev and self.obs is not None:
                self.obs.alert(r.name, r.status, value=r.value,
                               detail=r.detail)
            self._last[r.name] = r.status
        return results

    def verdict(self, results) -> str:
        return worst([r.status for r in results])
