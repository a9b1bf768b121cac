"""Trace/metrics exporters: JSONL, Chrome ``trace_event`` JSON, and a
console run summary.  Copy of ``repro.obs.exporters``.

The Chrome export renders the dual timeline as two trace "processes":
pid 1 is the **simulated clock** (one thread lane per client, so a
client's uploads/failures line up on its own row), pid 2 is the **host
clock** (orchestration spans: window dispatch, evals, codec encodes).
Load the file in ``chrome://tracing`` or https://ui.perfetto.dev.
"""
from __future__ import annotations

import json
import os

from repro_torch.obs.tracer import INSTANT, SPAN

TRACE_SCHEMA = "obs-trace/v1"
SIM_PID, HOST_PID = 1, 2
_US = 1e6                       # trace_event timestamps are microseconds

_CORE = ("name", "ph", "sim", "sim_dur", "host", "host_dur", "client")


def _ensure_dir(path):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


def _tags(rec):
    return {k: v for k, v in rec.items() if k not in _CORE}


def write_jsonl(tracer, path: str, meta: dict) -> str:
    """One record per line; the first line is a header carrying the
    schema, run metadata and the dropped-event count."""
    _ensure_dir(path)
    with open(path, "w") as f:
        f.write(json.dumps({"schema": TRACE_SCHEMA, "meta": meta,
                            "events": len(tracer.events),
                            "dropped": tracer.dropped}) + "\n")
        for rec in tracer.events:
            f.write(json.dumps(rec) + "\n")
    return path


def read_jsonl(path: str):
    """Load a JSONL trace back: ``(header, events)``."""
    with open(path) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    return lines[0], lines[1:]


def chrome_trace_events(tracer, meta: dict) -> dict:
    """The trace as a Chrome ``trace_event`` document (JSON-ready)."""
    out = [
        {"ph": "M", "pid": SIM_PID, "name": "process_name",
         "args": {"name": "simulated clock (repro_torch.sim)"}},
        {"ph": "M", "pid": HOST_PID, "name": "process_name",
         "args": {"name": "host clock"}},
    ]
    for rec in tracer.events:
        args = _tags(rec)
        name = rec["name"]
        tid = rec.get("client", 0)
        if rec.get("sim") is not None:
            ev = {"name": name, "pid": SIM_PID, "tid": tid,
                  "ts": rec["sim"] * _US, "args": args}
            if rec["ph"] == SPAN:
                ev.update(ph="X", dur=(rec.get("sim_dur") or 0.0) * _US)
            else:
                ev.update(ph="i", s="t")
            out.append(ev)
        if rec["ph"] == SPAN and rec.get("host_dur") is not None:
            out.append({"name": name, "pid": HOST_PID, "tid": 0, "ph": "X",
                        "ts": rec["host"] * _US,
                        "dur": rec["host_dur"] * _US, "args": args})
        elif rec.get("sim") is None:
            # host-only instant (nothing anchors it to the sim timeline)
            out.append({"name": name, "pid": HOST_PID, "tid": 0, "ph": "i",
                        "s": "t", "ts": rec["host"] * _US, "args": args})
    return {"traceEvents": out,
            "otherData": {"schema": TRACE_SCHEMA, **meta,
                          "dropped": tracer.dropped}}


def write_chrome_trace(tracer, path: str, meta: dict) -> str:
    _ensure_dir(path)
    with open(path, "w") as f:
        json.dump(chrome_trace_events(tracer, meta), f)
    return path


def console_summary(observer, result=None) -> str:
    """Human-readable run summary: per-span-name counts/durations plus
    the metrics snapshot's counters and gauges."""
    lines = [f"[obs] run summary — {observer.meta}"]
    if observer.tracer is not None:
        per: dict = {}
        for rec in observer.tracer.events:
            name = rec["name"]
            cnt, hd, sd = per.get(name, (0, 0.0, 0.0))
            per[name] = (cnt + 1, hd + (rec.get("host_dur") or 0.0),
                         sd + (rec.get("sim_dur") or 0.0))
        lines.append(f"[obs] {'span':<16}{'count':>8}{'host_s':>10}"
                     f"{'sim_s':>10}")
        for name, (cnt, hd, sd) in sorted(per.items()):
            lines.append(f"[obs] {name:<16}{cnt:>8}{hd:>10.3f}{sd:>10.1f}")
        if observer.tracer.dropped:
            lines.append(f"[obs] DROPPED {observer.tracer.dropped} events "
                         f"(max_events={observer.cfg.max_events})")
    snap = observer.metrics.snapshot()
    for kind in ("counters", "gauges"):
        for name, v in snap[kind].items():
            lines.append(f"[obs] {kind[:-1]} {name} = {v}")
    if result is not None and result.trace_path:
        lines.append(f"[obs] trace: {result.trace_path}")
    return "\n".join(lines)
