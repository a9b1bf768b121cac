"""Observability configuration.  Port of ``repro.obs.config``
(docs/OBSERVABILITY.md) with ``torch_profile`` in place of the
reference's ``jax_profile``.

``ObsConfig`` is the one knob surface: what to collect (trace, metrics),
where to export it (JSONL, Chrome ``trace_event`` JSON, console
summary), and the opt-in ``torch.profiler`` hook around the batched
engine's hot loop.  ``FLRunConfig.obs`` / ``Federation(obs=...)``
accept ``None`` (off — the default, zero overhead), ``True`` (in-memory
collection with defaults), an ``ObsConfig``, or a plain dict of
``ObsConfig`` fields.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ObsConfig:
    # collect structured spans/events on the dual timeline (simulated
    # clock + host monotonic).  Off leaves only the metrics registry.
    trace: bool = True
    # write the trace as JSON-lines (one record per event; first line is
    # an obs-trace/v1 header with the run metadata)
    trace_jsonl: Optional[str] = None
    # write a Chrome/Perfetto trace_event JSON — load it in
    # chrome://tracing or https://ui.perfetto.dev (two process rows: the
    # simulated clock with one thread lane per client, and the host clock)
    chrome_trace: Optional[str] = None
    # print a per-span-name + metrics run summary at run end
    summary: bool = False
    # collect counters/gauges/histograms (RunResult.metrics snapshot)
    metrics: bool = True
    # hard cap on in-memory trace events; beyond it events are dropped
    # and counted (never silently — the summary and snapshot report it)
    max_events: int = 1_000_000
    # opt-in: a directory; the batched engine's hot loop runs under
    # torch.profiler (CPU activity, and CUDA activity when a card is
    # visible) and the profile is exported there as a Chrome trace
    # (chrome://tracing or https://ui.perfetto.dev)
    torch_profile: Optional[str] = None
    # opt-in live telemetry (repro_torch.obs.live): seconds between background
    # MetricsSampler snapshots of the registry (None = no sampler thread,
    # the default — a run without it is byte-for-byte the pre-live path)
    sample_interval: Optional[float] = None
    # ring-buffer capacity of the sampler's time series (oldest dropped)
    sample_capacity: int = 512
    # free-form tags merged into the trace header / summary
    metadata: dict = field(default_factory=dict)


def resolve_obs(value):
    """Normalise a user-facing ``obs=`` value to ``ObsConfig`` or None."""
    if value is None or value is False:
        return None
    if value is True:
        return ObsConfig()
    if isinstance(value, ObsConfig):
        return value
    if isinstance(value, dict):
        return ObsConfig(**value)
    raise ValueError(
        "obs must be None/False (off), True (defaults), an ObsConfig, or "
        f"a dict of ObsConfig fields; got {value!r}")
