"""``repro_torch.obs``: always-available, off-by-default observability.
Port of ``repro.obs`` (docs/OBSERVABILITY.md).

Three layers, one config:

* **Tracer**: structured spans/events on a dual timeline (the simulated
  clock of ``repro_torch.sim`` and host monotonic seconds) for every
  upload, broadcast, local update, window, aggregation flush, eval,
  mid-round failure and checkpoint, tagged with client id, staleness,
  window size, codec and actual payload bytes.
* **Metrics registry**: counters, gauges and histograms (window size,
  staleness, wire bytes, eval-cache hits, kernel builds in the
  ``jit_compiles`` gauge) snapshot onto ``RunResult.metrics``.
* **Exporters**: JSONL trace, Chrome/Perfetto ``trace_event`` JSON, a
  console run summary, and an opt-in ``torch.profiler`` hook around the
  batched engine's hot loop.

Enable with ``FLRunConfig(obs=True)`` / ``Federation(obs=ObsConfig(
chrome_trace="run.json"))``; ``obs=None`` (the default) keeps every
hook site a dead branch, and either way the numbers are bit-exact.
"""
from repro_torch.obs.compile_tracking import compile_count, compile_secs, install
from repro_torch.obs.config import ObsConfig, resolve_obs
from repro_torch.obs.exporters import read_jsonl
from repro_torch.obs.metrics import MetricsRegistry, snapshot_percentile
from repro_torch.obs.observer import Observer
from repro_torch.obs.tracer import Tracer

__all__ = [
    "ObsConfig", "Observer", "Tracer", "MetricsRegistry", "resolve_obs",
    "snapshot_percentile", "compile_count", "compile_secs", "install",
    "read_jsonl",
]
