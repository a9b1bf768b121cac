"""The per-client health scoreboard: one JSON-ready row per client,
joined from the surfaces the serving stack already maintains.  Copy of
``repro.obs.live.scoreboard``.

Per-client data lives HERE, not in the metric namespace: metrics stay
low-cardinality, and the scoreboard carries the identified state: the
scheduler's byte ledgers (``EventScheduler.client_up_bytes``/
``client_down_bytes``, which under the thread driver's
``account_bytes=True`` sum EXACTLY to ``CommStats.uplink_bytes``/
``downlink_bytes``), committed-update counts, staleness against
the current server version, dedup watermarks, pending two-phase
exchanges, and the liveness state (evicted + dead reason, seconds since
last heard).
"""
from __future__ import annotations

import time


def client_scoreboard(server) -> dict:
    """The scoreboard for one :class:`~repro_torch.serve.server.FLServer`."""
    sched = server.sched
    now = time.monotonic()
    rows = []
    for i in range(server.cfg.num_clients):
        rows.append({
            "client": i,
            "up_bytes": int(sched.client_up_bytes[i]),
            "down_bytes": int(sched.client_down_bytes[i]),
            "accepted_updates": int(server.accepted_by_client[i]),
            "staleness": int(server.server_version
                             - server.model_version[i]),
            "last_seq": int(server._last_seq[i]),
            "pending_exchange": i in server._pending,
            "alive": i not in server._evicted,
            "dead_reason": server.dead_reason.get(i),
            "last_heard_s": round(now - float(server._last_heard[i]), 3),
        })
    return {
        "tenant": server.name,
        "algorithm": server.cfg.algorithm,
        "processed": server.processed,
        "total_events": server.total_events,
        "server_version": server.server_version,
        "clients_alive": sum(1 for r in rows if r["alive"]),
        "clients_dead": sum(1 for r in rows if not r["alive"]),
        "totals": {
            "up_bytes": sum(r["up_bytes"] for r in rows),
            "down_bytes": sum(r["down_bytes"] for r in rows),
            "accepted_updates": sum(r["accepted_updates"] for r in rows),
        },
        "counters": {
            "duplicates": server.duplicates,
            "evictions": server.evictions,
            "readmissions": server.readmissions,
            "exchange_expired": server.exchange_expired,
            "wire_errors": server.wire_errors,
            "restarts": server.restarts,
        },
        "clients": rows,
    }
