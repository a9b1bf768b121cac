"""``repro_torch.obs.live``: the live telemetry plane.  So far only
:class:`MetricsSampler`, the background thread that
``Observer.sampler_start`` starts; the Prometheus exposition, health
probes, client scoreboard and HTTP server join a live ``FLServer`` and
come with the serving port (ROADMAP.md, queue 1 item 9).
"""
from repro_torch.obs.live.sampler import MetricsSampler

__all__ = ["MetricsSampler"]
