"""``ObsHttpServer``: the stdlib-only HTTP face of the live plane.  Copy
of ``repro.obs.live.http``.

Four read-only endpoints over any number of serving federations (one
``LiveTarget`` per tenant):

* ``/metrics``  — Prometheus text exposition: every tenant's registry
  snapshot (labelled ``tenant="<name>"`` when more than one), histogram
  families with derived p50/p95/p99, and the sampler's per-second
  counter rates.
* ``/healthz``  — the probe verdict as JSON; HTTP 200 while OK/WARN,
  503 once any probe is CRIT (the shape load balancers expect).
* ``/clients``  — the per-client scoreboard(s).
* ``/trace``    — the most recent trace events (``?n=`` tail length,
  default 100).

Built on ``ThreadingHTTPServer`` bound to ``127.0.0.1`` with an
ephemeral port by default (``port=0``; read ``.port``/``.url`` after
``start()``).  Handlers only *read* live state — snapshots and
scoreboards are built fresh per request, nothing blocks the serve hot
loop — and request logging is routed to /dev/null so a scraper doesn't
spam the run's stdout.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence
from urllib.parse import parse_qs, urlparse

from repro_torch.obs.live.probes import CRIT, ProbeContext, ProbeSet, worst
from repro_torch.obs.live.prometheus import render_prometheus
from repro_torch.obs.live.scoreboard import client_scoreboard


class LiveTarget:
    """One federation under the plane: its server (scoreboard +
    probe context), observer (metrics/trace/sampler) and its own
    ProbeSet (transition state is per-tenant)."""

    def __init__(self, server, *, probes=None):
        self.server = server
        self.obs = server.obs
        self.name = getattr(server, "name", "default")
        self.probeset = ProbeSet(probes, obs=self.obs)

    def snapshot(self) -> dict:
        if self.obs is None:
            return {"counters": {}, "gauges": {}, "histograms": {}}
        return self.obs.metrics.snapshot()

    def context(self) -> ProbeContext:
        return ProbeContext(self.snapshot(),
                            sampler=getattr(self.obs, "sampler", None),
                            server=self.server)

    def health(self) -> dict:
        results = self.probeset.evaluate(self.context())
        return {"tenant": self.name,
                "status": self.probeset.verdict(results),
                "probes": [r.to_dict() for r in results]}

    def trace_tail(self, n: int) -> list:
        tracer = self.obs.tracer if self.obs is not None else None
        if tracer is None:
            return []
        return list(tracer.events[-n:])


class ObsHttpServer:
    """The live plane over one or more serving federations."""

    def __init__(self, servers: Sequence, *, host: str = "127.0.0.1",
                 port: int = 0, probes=None):
        self.targets = [s if isinstance(s, LiveTarget)
                        else LiveTarget(s, probes=probes)
                        for s in servers]
        if not self.targets:
            raise ValueError("ObsHttpServer needs at least one server")
        self._host, self._port_req = host, port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------- lifecycle ---

    def start(self) -> "ObsHttpServer":
        if self._httpd is not None:
            return self
        plane = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass                        # scrapers must not spam stdout

            def do_GET(self):               # noqa: N802 (stdlib API name)
                try:
                    status, ctype, body = plane._route(self.path)
                except Exception as e:      # surface, never kill the thread
                    status, ctype = 500, "application/json"
                    body = json.dumps({"error": repr(e)}).encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((self._host, self._port_req),
                                          Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="obs-http", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        self._thread = None

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("ObsHttpServer not started")
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    # --------------------------------------------------------- routing ---

    def _route(self, path: str):
        parsed = urlparse(path)
        route = parsed.path.rstrip("/") or "/"
        if route == "/metrics":
            return 200, "text/plain; version=0.0.4", \
                self.render_metrics().encode()
        if route == "/healthz":
            doc = self.health()
            code = 503 if doc["status"] == CRIT else 200
            return code, "application/json", _js(doc)
        if route == "/clients":
            return 200, "application/json", _js(self.scoreboards())
        if route == "/trace":
            q = parse_qs(parsed.query)
            n = max(1, int(q.get("n", ["100"])[0]))
            tail = {t.name: t.trace_tail(n) for t in self.targets}
            return 200, "application/json", _js(tail)
        if route == "/":
            return 200, "application/json", _js(
                {"endpoints": ["/metrics", "/healthz", "/clients",
                               "/trace"],
                 "tenants": [t.name for t in self.targets]})
        return 404, "application/json", _js({"error": f"no route {route}"})

    # ----------------------------------------------------- the payloads ---
    # (public so single-process callers — benchmarks, tests — can read
    # the plane without going through a socket)

    def render_metrics(self) -> str:
        multi = len(self.targets) > 1
        sources, rates = [], {}
        for idx, t in enumerate(self.targets):
            labels = {"tenant": t.name} if multi else {}
            sources.append((labels, t.snapshot()))
            sampler = getattr(t.obs, "sampler", None) if t.obs else None
            if sampler is not None:
                r = sampler.rates()
                if r:
                    rates[idx] = r
        return render_prometheus(sources, rates=rates)

    def health(self) -> dict:
        tenants = [t.health() for t in self.targets]
        doc = {"status": worst([h["status"] for h in tenants]),
               "tenants": tenants}
        if len(tenants) == 1:
            doc["probes"] = tenants[0]["probes"]
        return doc

    def scoreboards(self):
        boards = [client_scoreboard(t.server) for t in self.targets]
        return boards[0] if len(boards) == 1 else boards


def _js(doc) -> bytes:
    return json.dumps(doc, default=_jsonable).encode()


def _jsonable(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return repr(v)
