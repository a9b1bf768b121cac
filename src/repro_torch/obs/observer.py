"""The ``Observer`` — the one object the runtimes talk to.  Port of
``repro_torch.obs.observer``: the hooks, counters and trace records are the
reference's; the device profiler is ``torch.profiler``
(``ObsConfig.torch_profile``) and the ``jit_compiles`` gauge counts the
port's kernel builds (``compile_tracking``).

Semantic hooks (``upload`` / ``broadcast`` / ``report`` / ``window`` /
``local_update`` / ``flush`` / ``eval_event`` / ``failure``) each feed
both the dual-timeline tracer and the metrics registry in one call, so
the runtimes stay one-line-per-site and the counters are guaranteed to
agree with the trace (tests/test_torch_obs.py asserts both against
``CommStats``).

Off is *off*: ``FLRunConfig.obs=None`` means the runtimes carry a
``None`` and every hook site is behind an ``if obs is not None`` — the
disabled path costs one predictable branch per event, nothing else.
The observer never reads device values the runtime didn't already
materialise and never touches RNG, so enabling it leaves golden-seed
outputs bit-exact.  No hook calls ``.item()``, ``float(tensor)`` or a
``synchronize``: on ``cuda`` a hook adds no device work and no wait.
So the ``host_now()`` spans time *host dispatch* there: a span around
kernel launches ends when the launches are queued, not when the card
has run them (the pipelined batched engine's ``window`` span is
dispatch through commit).  Device time is what the opt-in
``torch_profile`` records.
"""
from __future__ import annotations

import os
from contextlib import contextmanager

from repro_torch.obs import compile_tracking
from repro_torch.obs.config import ObsConfig
from repro_torch.obs.exporters import (console_summary, write_chrome_trace,
                                 write_jsonl)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import Tracer


class Observer:
    def __init__(self, cfg: ObsConfig, meta: dict = None):
        self.cfg = cfg
        self.meta = dict(meta or {})
        self.meta.update(cfg.metadata)
        self.metrics = MetricsRegistry()
        self.tracer = Tracer(cfg.max_events) if cfg.trace else None
        compile_tracking.install()
        self._compiles0 = compile_tracking.compile_count()
        # pre-bound metric objects for the per-event hooks: the hooks run
        # inside the engines' decision loops, so they skip the registry
        # name lookup (get-or-create) on every call
        m = self.metrics
        self._m_uploads = m.counter("uploads")
        self._m_upload_bytes = m.counter("upload_payload_bytes")
        self._m_staleness = m.hist("staleness")
        self._m_upload_nb = m.hist("upload_nbytes")
        self._m_reports = m.counter("scalar_reports")
        self._m_bcasts = m.counter("broadcasts")
        self._m_bcast_bytes = m.counter("broadcast_bytes")
        self._m_windows = m.counter("windows")
        self._m_window_size = m.hist("window_size")
        self._m_local_updates = m.counter("local_updates")
        self._m_flushes = m.counter("flushes")
        self._m_flush_k = m.hist("flush_k")
        # serve-loop hooks (repro_torch.serve's FLServer): depth of the
        # live upload queue per drained window, and recv->commit latency
        # per committed update (both host-side, single clock domain)
        self._m_queue_depth = m.hist("queue_depth")
        self._m_commit_latency = m.hist("commit_latency_ms")
        # live telemetry (repro_torch.obs.live, docs/OBSERVABILITY.md): the
        # background MetricsSampler, created on sampler_start when
        # cfg.sample_interval is set
        self.sampler = None
        # the opt-in torch.profiler session (cfg.torch_profile) and the
        # Chrome trace files it exported
        self._profiler = None
        self.profile_paths: list = []

    # ------------------------------------------------------ time access ---

    def host_now(self) -> float:
        """Host-monotonic seconds since run start — the runtimes' one
        clock (on ``cuda``, the time of host dispatch)."""
        return self.tracer.host_now() if self.tracer else 0.0

    # -------------------------------------------------- semantic hooks ---
    # every hook: metrics always; trace record when tracing is on

    def upload(self, client, sim, *, staleness=0, nbytes=0,
               codec="identity"):
        """One accepted model upload (sim = the event's completion time,
        nbytes = actual on-the-wire payload bytes)."""
        self._m_uploads.inc()
        self._m_upload_bytes.inc(nbytes)
        self._m_staleness.observe(staleness)
        self._m_upload_nb.observe(nbytes)
        if self.tracer:
            self.tracer.event("upload", sim, client, staleness=staleness,
                              nbytes=nbytes, codec=codec)

    def report(self, client, sim, n=1):
        """Scalar V report(s) — client=None with n>1 for a whole round's
        reports at once (round-based runtimes)."""
        self._m_reports.inc(n)
        if self.tracer:
            self.tracer.event("report", sim, client, n=n)

    def broadcast(self, client, sim, *, nbytes=0, n=1, codec=None):
        """Model broadcast(s): n receivers, nbytes TOTAL wire bytes."""
        self._m_bcasts.inc(n)
        self._m_bcast_bytes.inc(nbytes)
        if self.tracer:
            self.tracer.event("broadcast", sim, client, nbytes=nbytes, n=n,
                              **({"codec": codec} if codec else {}))

    def window(self, size, sim0, sim1, host_start):
        """One batched-engine window: size completions executed as one
        vmapped update; sim bounds are the window's first/last completion
        times, host duration covers dispatch through commit."""
        self._m_windows.inc()
        self._m_window_size.observe(size)
        if self.tracer:
            self.tracer.span("window", sim0, sim1, host_start, size=size)

    def local_update(self, sim0, sim1, host_start, *, client=None,
                     clients=None):
        """A local-update dispatch: per event (sequential loop, client=)
        or per window/round (batched & round runtimes, clients=count)."""
        self._m_local_updates.inc()
        if self.tracer:
            tags = {} if clients is None else {"clients": clients}
            self.tracer.span("local_update", sim0, sim1, host_start,
                             client=client, **tags)

    def flush(self, k, sim, *, folded=False):
        """A buffered-aggregation flush of k reconstructions (the batched
        engine's mix point; folded=True when it rode the commit call)."""
        self._m_flushes.inc()
        self._m_flush_k.observe(k)
        if self.tracer:
            self.tracer.event("flush", sim, None, k=k, folded=folded)

    def aggregate(self, sim, *, n):
        """A synchronous round aggregation folding n uploads."""
        self.metrics.counter("aggregations").inc()
        if self.tracer:
            self.tracer.event("aggregate", sim, None, n=n)

    def eval_event(self, round_, sim, host_start, *, boundaries=1,
                   reused=False):
        """One RoundRecord eval.  ``reused`` marks the batched engine's
        exact bit-identical-model reuse (no device work dispatched)."""
        self.metrics.counter("evals").inc()
        self.metrics.counter("eval_boundaries").inc(boundaries)
        if reused:
            self.metrics.counter("eval_reused").inc()
        if self.tracer:
            self.tracer.span("eval", sim, sim, host_start, round=round_,
                             boundaries=boundaries, reused=reused)

    def eval_cache(self, hits, misses):
        """Per-client Eq. 1 accuracy cache traffic (eval_cache > 0)."""
        self.metrics.counter("eval_cache_hits").inc(hits)
        self.metrics.counter("eval_cache_misses").inc(misses)

    def queue_depth(self, depth):
        """Upload-queue depth observed by the serve loop as it drains a
        window (the serve loop) — metrics only; the per-window trace span
        already carries the window size."""
        self._m_queue_depth.observe(depth)

    def commit_latency(self, seconds):
        """One committed update's transport-arrival -> aggregation-commit
        latency (host-monotonic, stamped and read server-side so the two
        ends share a clock domain)."""
        self._m_commit_latency.observe(seconds * 1e3)

    def failure(self, client, sim, *, kind=None):
        """A mid-round failure: the attempt's work was discarded before
        committing (availability model, dead client, expired exchange).
        ``kind`` sub-categorises serve-side failures (``"exchange-
        timeout"``, ``"evicted"``) into their own counters alongside
        the shared total."""
        self.metrics.counter("failures").inc()
        if kind:
            self.metrics.counter(f"failures_{kind}").inc()
        if self.tracer:
            self.tracer.event("failure", sim, client,
                              **({"kind": kind} if kind else {}))

    # ------------------------------------------- resilience hooks ---
    # (the serve loop, repro_torch.serve, the chaos transport of
    # ROADMAP.md queue 1 item 9b, and the runtimes' checkpoints): retry/dedup, liveness and
    # checkpoint traffic.  Metrics-first like every other hook.

    def duplicate(self, client, sim):
        """A deduplicated upload: ``seq <= last_seq`` — a retry or a
        chaos duplicate; the server replayed its cached reply."""
        self.metrics.counter("duplicate_uploads").inc()
        if self.tracer:
            self.tracer.event("duplicate", sim, client)

    def evict(self, client, sim, *, reason="liveness"):
        """A client evicted (liveness deadline or transport death)."""
        self.metrics.counter("evictions").inc()
        if self.tracer:
            self.tracer.event("evict", sim, client, reason=reason)

    def readmit(self, client, sim, *, fresh=False):
        """An evicted client re-admitted (``fresh`` = it was restarted
        or reconnected and got a fresh decode base)."""
        self.metrics.counter("readmissions").inc()
        if fresh:
            self.metrics.counter("readmissions_fresh").inc()
        if self.tracer:
            self.tracer.event("readmit", sim, client, fresh=fresh)

    def wire_error(self, n=1):
        """Corrupt frames discarded by the wire-format checks."""
        self.metrics.counter("wire_errors").inc(n)

    def fault(self, kind, n=1):
        """Chaos-injected faults drained from the transport's ground
        truth (``ChaosTransport.poll_fault_stats``), promoted to
        first-class metrics so the soak's injection schedule is visible
        live.  ``kind`` is one of the transport's fixed fate codes —
        a bounded set, so the interpolated name stays low-cardinality."""
        self.metrics.counter("chaos_faults").inc(n)
        self.metrics.counter(f"chaos_faults_{kind}").inc(n)

    def retry(self, n=1):
        """Client-side exchange retries absorbed after the fleet joined
        (``FLServer.absorb_client_stats``) — the at-least-once half of
        the exactly-once reconciliation."""
        self.metrics.counter("client_retries").inc(n)

    def alert(self, probe, status, *, value=None, detail=None):
        """A health-probe transition (the live probes, ROADMAP.md queue
        1 item 9b): the probe crossed into ``status`` ("warn"/"crit", or
        back to "ok").
        Status names are a fixed three-element set — bounded metric
        cardinality by construction."""
        self.metrics.counter("alerts").inc()
        self.metrics.counter(f"alerts_{status}").inc()
        if self.tracer:
            tags = {"probe": probe, "status": status}
            if value is not None:
                tags["value"] = value
            if detail:
                tags["detail"] = detail
            self.tracer.event("alert", None, None, **tags)

    def checkpoint(self, step, host_start, *, restored=False):
        """One run-state checkpoint written (or, ``restored``, loaded)."""
        self.metrics.counter("resumes" if restored
                             else "checkpoints").inc()
        if self.tracer:
            self.tracer.span("resume" if restored else "checkpoint",
                             None, None, host_start, step=step)

    @contextmanager
    def timed(self, name, *, sim=None, client=None, **tags):
        """Host-timed span around a code block (codec encodes etc.)."""
        h0 = self.host_now()
        try:
            yield
        finally:
            self.metrics.counter(f"{name}_calls").inc()
            if self.tracer:
                self.tracer.span(name, sim, sim, h0, client=client, **tags)

    def profile_start(self):
        """Start the opt-in device profiler (``cfg.torch_profile`` = a
        directory): ``torch.profiler`` with CPU activity, and CUDA
        activity when a card is visible; no-op otherwise.  The batched
        engine brackets its hot loop with start/stop directly so the
        loop body needs no extra indentation level."""
        if self.cfg.torch_profile and self._profiler is None:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.start()

    def profile_stop(self):
        """Stop the profiler and export its Chrome trace into
        ``cfg.torch_profile`` (``torch_profile.<pid>.<n>.json``)."""
        if self._profiler is None:
            return
        prof, self._profiler = self._profiler, None
        prof.stop()
        os.makedirs(self.cfg.torch_profile, exist_ok=True)
        path = os.path.join(self.cfg.torch_profile,
                            f"torch_profile.{os.getpid()}.{len(self.profile_paths)}.json")
        prof.export_chrome_trace(path)
        self.profile_paths.append(path)

    def sampler_start(self):
        """Start the opt-in background MetricsSampler
        (``cfg.sample_interval`` = seconds between registry snapshots;
        None — the default — is a no-op).  The engines bracket their
        hot loops with start/stop exactly like the device profiler, so
        live runs stream and default runs pay one ``if``."""
        if self.cfg.sample_interval and self.sampler is None:
            from repro_torch.obs.live import MetricsSampler
            self.sampler = MetricsSampler(
                self.metrics, interval=self.cfg.sample_interval,
                capacity=self.cfg.sample_capacity)
            self.sampler.start()

    def sampler_stop(self):
        if self.sampler is not None:
            self.sampler.stop()

    # ------------------------------------------------------- finish ---

    def finish(self, result=None):
        """Seal the run: fill the compile gauge, export configured trace
        files, attach ``metrics``/``trace_path`` to the ``RunResult``,
        and print the summary if asked.  Returns the metrics snapshot."""
        self.sampler_stop()
        if self.sampler is not None:
            self.metrics.gauge("metric_samples").set(len(self.sampler))
        self.metrics.gauge("jit_compiles").set(
            compile_tracking.compile_count() - self._compiles0)
        if self.tracer is not None:
            self.metrics.counter("trace_events").inc(
                len(self.tracer.events))
            if self.tracer.dropped:
                self.metrics.counter("trace_events_dropped").inc(
                    self.tracer.dropped)
        snap = self.metrics.snapshot() if self.cfg.metrics else None
        trace_path = None
        if self.tracer is not None:
            if self.cfg.trace_jsonl:
                trace_path = write_jsonl(self.tracer, self.cfg.trace_jsonl,
                                         self.meta)
            if self.cfg.chrome_trace:
                p = write_chrome_trace(self.tracer, self.cfg.chrome_trace,
                                       self.meta)
                trace_path = trace_path or p
        if result is not None:
            result.metrics = snap
            result.trace_path = trace_path
        if self.cfg.summary:
            # the opt-in end-of-run summary sink (cfg.summary=True)
            print(console_summary(self, result))
        return snap
