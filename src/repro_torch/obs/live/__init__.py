"""``repro_torch.obs.live``: the live telemetry plane.  Port of
``repro.obs.live``.

``repro_torch.obs`` seals a run's trace and metrics at the end; this
package makes the same registry observable WHILE the federation runs:

* :class:`MetricsSampler`: a background thread snapshotting the
  registry into a bounded time series with delta/rate derivation;
* :func:`render_prometheus`: Prometheus text exposition (counters,
  gauges, pow2-histogram families with derived p50/p95/p99);
* the health-probe registry (:func:`get_probe` / :func:`register_probe`
  / :func:`available_probes`) with builtin staleness, queue, latency,
  liveness and accuracy probes, and :class:`ProbeSet` turning status
  transitions into structured alerts;
* :func:`client_scoreboard`: the per-client byte, staleness and
  liveness join over a live ``FLServer``;
* :class:`ObsHttpServer`: ``/metrics``, ``/healthz``, ``/clients`` and
  ``/trace`` over any number of tenants.

All of it is host code (stdlib and numpy); nothing here touches the
device.
"""
from repro_torch.obs.live.http import LiveTarget, ObsHttpServer
from repro_torch.obs.live.probes import (CRIT, DEFAULT_PROBES, OK, WARN, ProbeContext,
                                         ProbeResult, ProbeSet, available_probes, get_probe,
                                         register_probe, worst)
from repro_torch.obs.live.prometheus import render_prometheus
from repro_torch.obs.live.sampler import MetricsSampler
from repro_torch.obs.live.scoreboard import client_scoreboard

__all__ = [
    "MetricsSampler", "ObsHttpServer", "LiveTarget", "render_prometheus",
    "client_scoreboard", "ProbeContext", "ProbeResult", "ProbeSet",
    "get_probe", "register_probe", "available_probes", "DEFAULT_PROBES",
    "OK", "WARN", "CRIT", "worst",
]
