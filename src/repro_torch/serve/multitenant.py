"""Multi-tenant serving: several federations sharing one device.  Port
of ``repro.serve.multitenant``.

``FLServer.step()`` processes one window and returns without blocking,
so a host can interleave any number of independent federations in one
thread: round-robin the servers, sleep only when EVERY queue is quiet.

    mt = MultiTenantServer([server_a, server_b])
    results = mt.run()        # [RunResult, RunResult] in tenant order

Each tenant keeps its own transport, algorithm state, CommStats and obs;
nothing is shared but the device, the loop and, with ``live=``, one HTTP
telemetry plane over every tenant.
"""
from __future__ import annotations

import time
from typing import List, Sequence

from repro_torch.core.metrics import RunResult

_IDLE_SLEEP = 0.002


class MultiTenantServer:
    """Round-robin executor over independent :class:`FLServer`\\ s."""

    def __init__(self, servers: Sequence, *, live=None):
        if not servers:
            raise ValueError("MultiTenantServer needs at least one server")
        self.servers = list(servers)
        self._stopping = False
        # the live telemetry plane (repro_torch.obs.live): ONE HTTP
        # endpoint over every tenant, each labelled tenant="<server.name>"
        # in the /metrics exposition; built on start(), stopped after run()
        self._live_req = live
        self.live = None

    def stop(self) -> None:
        self._stopping = True

    def start(self) -> None:
        if self._live_req and self.live is None:
            from repro_torch.serve.run import resolve_live
            self.live = resolve_live(self._live_req, self.servers)
        for s in self.servers:
            s.start()

    def run(self, stall_timeout: float = 60.0) -> List[RunResult]:
        """Interleave every tenant's windows until all federations hit
        their event totals (or the whole fleet stalls); returns each
        tenant's finalized ``RunResult`` in construction order."""
        for s in self.servers:     # opt-in live metric samplers
            if s.obs is not None:
                s.obs.sampler_start()
        last_msg = time.monotonic()
        while not self._stopping:
            active = [s for s in self.servers if s.processed < s.total_events]
            if not active:
                break
            drained = 0
            for s in active:
                drained += s.step(timeout=0)
            if drained:
                last_msg = time.monotonic()
            else:
                if time.monotonic() - last_msg > stall_timeout:
                    break
                time.sleep(_IDLE_SLEEP)
        try:
            return [s.finalize() for s in self.servers]
        finally:
            if self.live is not None:
                self.live.stop()
                self.live = None
