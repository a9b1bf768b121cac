"""Dual-timeline trace collection.  Copy of ``repro.obs.tracer``.

Every record carries up to two timestamps: ``sim`` — the simulated
clock from ``repro_torch.sim``/the event scheduler (the time the *federation*
experienced), and ``host`` — monotonic host seconds since run start
(the time the *machine* spent).  Spans additionally carry ``sim_dur`` /
``host_dur``.  Either timeline may be absent: the round-based runtime
has no simulated clock outside a scenario (its ``sim`` is the round
index, matching ``RoundRecord.time``), and codec-encode spans are
host-only.

Records are plain dicts appended to an in-memory list — the exporters
(``repro_torch.obs.exporters``) turn them into JSONL or Chrome
``trace_event`` JSON.  Collection is bounded by ``max_events``;
overflow is *counted* (``dropped``), never silent.
"""
from __future__ import annotations

import time

# record phases, following the Chrome trace_event convention:
INSTANT = "i"      # a point event (upload, broadcast, failure, ...)
SPAN = "X"         # a completed duration (window, local update, eval)


class Tracer:
    def __init__(self, max_events: int = 1_000_000):
        self.max_events = max_events
        self.events: list = []
        self.dropped = 0
        self._t0 = time.perf_counter()

    def host_now(self) -> float:
        """Host seconds since run start (monotonic)."""
        return time.perf_counter() - self._t0

    def emit(self, name: str, ph: str, *, sim=None, sim_dur=None,
             host=None, host_dur=None, client=None, **tags):
        """Append one record.  ``host`` defaults to now for instants;
        spans normally pass the captured start and let ``host_dur`` be
        computed from it (``host_dur=None`` + ``host`` given)."""
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        if host is None:
            host = self.host_now()
        elif ph == SPAN and host_dur is None:
            host_dur = self.host_now() - host
        rec = {"name": name, "ph": ph, "host": host}
        if host_dur is not None:
            rec["host_dur"] = host_dur
        if sim is not None:
            rec["sim"] = sim
        if sim_dur is not None:
            rec["sim_dur"] = sim_dur
        if client is not None:
            rec["client"] = client
        if tags:
            rec.update(tags)
        self.events.append(rec)

    def event(self, name, sim=None, client=None, **tags):
        self.emit(name, INSTANT, sim=sim, client=client, **tags)

    def span(self, name, sim0=None, sim1=None, host_start=None,
             client=None, **tags):
        """A completed span: simulated bounds [sim0, sim1] (either may be
        None) and host duration measured from ``host_start`` (a value
        previously returned by ``host_now``) to now."""
        sim_dur = (None if sim0 is None or sim1 is None
                   else max(0.0, sim1 - sim0))
        self.emit(name, SPAN, sim=sim0, sim_dur=sim_dur,
                  host=host_start, client=client, **tags)
