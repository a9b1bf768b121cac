"""``ChaosTransport``: fault injection as a transport wrapper.  Port of
``repro.resilience.chaos``.

Registered as the builtin ``"chaos"`` transport, it wraps ANY inner
transport (name or instance; ``inproc`` by default) and subjects every
frame to a seeded, counter-based :class:`FaultPlan`, so each failure
mode the serve stack must survive reproduces from a seed:

* ``drop``: the frame vanishes; the client's retry recovers it.
* ``corrupt``: the receiver would discard the frame as a
  :class:`~repro_torch.serve.messages.WireError`; modelled as a counted
  drop (``stats["corrupt"]``, surfaced to the server through
  ``poll_wire_errors``) with the stream surviving.
* ``duplicate``: delivered twice; the server's ``(client, seq)`` dedup
  proves idempotency.
* ``reorder`` / ``delay``: held back briefly so later traffic (other
  clients, the client's own retry) passes it; released by the server's
  next drain.
* ``reset``: a connection reset mid-exchange: the frame is lost and the
  client's inbound broadcasts are discarded for ``reset_s`` (the reply
  never arrives -> retry -> dedup -> reply replay).
* ``blackout``: a client killed mid-exchange: it goes dark both ways
  for ``blackout_s`` and is reported through ``dead_clients()`` (reason
  ``"blackout"``) so the liveness tracker evicts it; its next frame
  after rejoining re-admits it.

Faults never reorder one client's surviving frames relative to each
other outside the hold window, and the inner transport's own contract
(arrival stamping, backpressure, device placement) is untouched: held
frames re-enter through the channel of the client that sent them.  The
reference re-sends them through a channel of its own for the client,
which over ``socket`` is a second connection whose hello takes the
client's broadcasts away from it.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.resilience.faults import (BLACKOUT, CORRUPT, DELAY, DROP, DUPLICATE, OK, REORDER,
                                           RESET, FaultPlan, FaultSpec)
from repro_torch.serve.messages import UploadMsg
from repro_torch.serve.transport import ClientChannel, Transport


class _ChaosChannel(ClientChannel):
    """One client's endpoint with the fault plan between it and the inner
    channel."""

    def __init__(self, t: "ChaosTransport", client: int, inner: ClientChannel):
        self._t = t
        self._client = client
        self._inner = inner

    def send(self, msg: UploadMsg, timeout: Optional[float] = None) -> bool:
        return self._t._send_upload(self._client, self._inner, msg, timeout)

    def recv(self, timeout: Optional[float] = None):
        msg = self._inner.recv(timeout=timeout)
        if msg is None:
            return None
        if self._t._downlink_lost(self._client, msg):
            return None
        return msg

    def close(self) -> None:
        self._inner.close()


class ChaosTransport(Transport):
    name = "chaos"

    def __init__(self, num_clients: int, capacity: int = 0, *, inner="inproc",
                 faults: Optional[FaultSpec] = None, availability=None, device="cuda"):
        from repro_torch.serve.transport import get_transport
        self.num_clients = num_clients
        if isinstance(inner, Transport):
            self._inner = inner
        else:
            self._inner = get_transport(inner)(num_clients, capacity, device=device)
        self.spec = faults or FaultSpec()
        self.plan = FaultPlan(self.spec, num_clients, availability=availability)
        self._lock = threading.Lock()
        # held (delayed/reordered) uplink frames: (release host time,
        # tie-break counter, client, msg, the sender's inner channel),
        # released by the server's pump
        self._held: List[Tuple[float, int, int, UploadMsg, ClientChannel]] = []
        self._held_seq = 0
        self._dark_until: Dict[int, float] = {}    # blackout windows
        self._reset_until: Dict[int, float] = {}   # reset windows
        self._wire_errors = 0                      # undrained corrupt count
        self.stats: Dict[str, int] = {
            k: 0 for k in (DROP, CORRUPT, RESET, BLACKOUT, DUPLICATE, REORDER, DELAY,
                           "bcast_drop", "sent", "delivered")}
        self._fault_drained: Dict[str, int] = {}   # poll_fault_stats marks

    # ------------------------------------------------------ fault paths ---

    def _send_upload(self, client: int, inner: ClientChannel, msg: UploadMsg,
                     timeout: Optional[float]) -> bool:
        now = time.monotonic()
        with self._lock:
            self.stats["sent"] += 1
            if self._dark_until.get(client, 0.0) > now:
                # still dark: the frame never leaves the dead client
                self.stats[DROP] += 1
                return True
            fate = self.plan.fate(client)
            if fate != OK:
                self.stats[fate] += 1
            if fate == DROP:
                return True
            if fate == CORRUPT:
                # the receiver discards it as a WireError; the server
                # drains the count into obs (poll_wire_errors)
                self._wire_errors += 1
                return True
            if fate == RESET:
                self._reset_until[client] = now + self.spec.reset_s
                return True
            if fate == BLACKOUT:
                self._dark_until[client] = now + self.spec.blackout_s
                return True
            if fate in (REORDER, DELAY):
                hold = self.spec.reorder_s if fate == REORDER else self.spec.delay_s
                self._held_seq += 1
                self._held.append((now + hold, self._held_seq, client, msg, inner))
                return True
        # duplicate and ok deliver through the inner channel OUTSIDE the
        # lock (a bounded inner queue may block on backpressure)
        ok = inner.send(msg, timeout=timeout)
        if ok:
            with self._lock:
                self.stats["delivered"] += 1
        if ok and fate == DUPLICATE:
            if inner.send(msg, timeout=timeout):
                with self._lock:
                    self.stats["delivered"] += 1
        return ok

    def _downlink_lost(self, client: int, msg) -> bool:
        """Downlink fate of one received broadcast (True: dropped).
        Bootstrap and teardown frames (init/final) are exempt: a lost INIT
        wedges a client before it has anything to retry."""
        if getattr(msg, "kind", None) in ("init", "final"):
            return False
        now = time.monotonic()
        with self._lock:
            if (self._dark_until.get(client, 0.0) > now
                    or self._reset_until.get(client, 0.0) > now):
                self.stats["bcast_drop"] += 1
                return True
            if self.plan.bcast_fate(client) == DROP:
                self.stats["bcast_drop"] += 1
                return True
        return False

    def _pump(self) -> None:
        """Release held frames whose hold expired into the inner transport
        (called from the server's receive path).  A frame whose sender
        has closed its channel meanwhile is lost: the client finished, so
        the frame was a stale copy of an answered exchange."""
        now = time.monotonic()
        due = []
        with self._lock:
            if not self._held:
                return
            keep = []
            for item in self._held:
                (due if item[0] <= now else keep).append(item)
            self._held = keep
        for _, _, _, msg, inner in sorted(due, key=lambda item: item[:2]):
            try:
                ok = inner.send(msg, timeout=0)
            except OSError:
                continue
            if ok:
                with self._lock:
                    self.stats["delivered"] += 1

    # -------------------------------------------------------- Transport ---

    def recv_upload(self, timeout: Optional[float] = None) -> Optional[UploadMsg]:
        self._pump()
        return self._inner.recv_upload(timeout=timeout)

    def queue_depth(self) -> int:
        return self._inner.queue_depth() + len(self._held)

    def send_broadcast(self, client: int, msg) -> None:
        # downlink faults apply on the client's receive (so the arrival
        # stamp and mailbox mechanics stay the inner transport's); only
        # delivery happens here
        self._inner.send_broadcast(client, msg)

    def client_channel(self, client: int) -> ClientChannel:
        return _ChaosChannel(self, client, self._inner.client_channel(client))

    def dead_clients(self) -> set:
        """Inner deaths plus clients in a blackout window: the liveness
        tracker evicts them; their next surviving frame re-admits them."""
        now = time.monotonic()
        with self._lock:
            dark = {c for c, t in self._dark_until.items() if t > now}
        inner = self._inner.dead_clients() if hasattr(self._inner, "dead_clients") else set()
        return inner | dark

    def dead_reasons(self) -> Dict[int, str]:
        now = time.monotonic()
        with self._lock:
            dark = {c: "blackout" for c, t in self._dark_until.items() if t > now}
        inner = self._inner.dead_reasons() if hasattr(self._inner, "dead_reasons") else {}
        return {**inner, **dark}

    def poll_reconnects(self) -> set:
        return (self._inner.poll_reconnects() if hasattr(self._inner, "poll_reconnects")
                else set())

    def poll_wire_errors(self) -> int:
        """Corrupt-frame count since the last poll (drained into the
        server's obs wire-error counter)."""
        with self._lock:
            n, self._wire_errors = self._wire_errors, 0
        return n

    def poll_fault_stats(self) -> Dict[str, int]:
        """Injected-fault counts since the last poll: {fate: delta} for the
        fault fates only (drop, corrupt, reset, blackout, duplicate,
        reorder, delay, bcast_drop; sent and delivered stay internal).
        The server drains this into obs (``Observer.fault``), so the
        registry reconciles with ``self.stats``, the ground truth, at the
        run's end."""
        out = {}
        with self._lock:
            for k, v in self.stats.items():
                if k in ("sent", "delivered"):
                    continue
                delta = v - self._fault_drained.get(k, 0)
                if delta:
                    out[k] = delta
                    self._fault_drained[k] = v
        return out

    def close(self) -> None:
        self._inner.close()
