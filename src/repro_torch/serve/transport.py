"""Transport layer: how upload and broadcast messages move between
client workers and the ``FLServer``, behind a string registry mirroring
``repro_torch.algorithms`` and ``repro_torch.sim`` (``get_transport`` /
``register_transport``; builtins load lazily, a deliberate
pre-registration wins, accidental duplicates stay loud).  Port of
``repro.serve.transport``.

A :class:`Transport` owns one server-side upload queue (all clients
funnel into it: arrival order IS the serve loop's event order) and one
broadcast mailbox per client.  Every implementation keeps:

* **per-client FIFO, no drops**: messages from one client arrive in the
  order it sent them (the two-phase report -> update exchange and the
  staleness accounting depend on it); concurrent producers interleave
  arbitrarily but never lose or reorder one client's stream;
* **backpressure**: the upload queue is bounded (``capacity``);
  ``ClientChannel.send`` blocks up to its timeout and returns False
  instead of dropping;
* **non-blocking server recv**: every server-side receive takes a
  timeout.

Builtins: ``inproc`` (a bounded ``queue.Queue`` pair: threads in one
process, no serialization, trees and payloads by reference), ``socket``
(``repro_torch.serve.socket_transport``: localhost TCP with
magic-prefixed, length-bounded pickle frames, for client processes) and
``chaos`` (``repro_torch.resilience.chaos``: a fault-injecting wrapper
around any inner transport).

A factory is called as ``factory(num_clients, capacity, device=...)``:
``device`` is where the server's trees live, which a transport that
decodes frames puts them on.
"""
from __future__ import annotations

import importlib
import queue
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.serve.messages import UploadMsg


class ClientChannel:
    """One client's endpoint: send uploads, receive broadcasts."""

    def send(self, msg: UploadMsg, timeout: Optional[float] = None) -> bool:
        """Enqueue an upload.  Blocks up to ``timeout`` when the upload
        queue is full (backpressure); returns False instead of dropping
        on timeout."""
        raise NotImplementedError

    def recv(self, timeout: Optional[float] = None):
        """Next broadcast for this client, or None on timeout."""
        raise NotImplementedError

    def close(self) -> None:
        """Release the endpoint; idempotent."""


class Transport:
    """Server side of a transport (plus the client-channel factory)."""

    name: str = "transport"

    def recv_upload(self, timeout: Optional[float] = None) -> Optional[UploadMsg]:
        """Next upload in arrival order, or None on timeout."""
        raise NotImplementedError

    def drain_uploads(self, max_batch: int, timeout: Optional[float] = None) -> List[UploadMsg]:
        """One serve-loop window: wait up to ``timeout`` for the first
        message, then take whatever is already queued (no extra waiting)
        up to ``max_batch``."""
        first = self.recv_upload(timeout=timeout)
        if first is None:
            return []
        out = [first]
        while len(out) < max_batch:
            nxt = self.recv_upload(timeout=0)
            if nxt is None:
                break
            out.append(nxt)
        return out

    def queue_depth(self) -> int:
        """Uploads currently queued (approximate under concurrency)."""
        raise NotImplementedError

    def send_broadcast(self, client: int, msg) -> None:
        """Deliver a broadcast to one client's mailbox (never blocks:
        mailboxes are unbounded, so the server never wedges on a dead
        client)."""
        raise NotImplementedError

    def client_channel(self, client: int) -> ClientChannel:
        raise NotImplementedError

    def close(self) -> None:
        """Tear the transport down; idempotent."""


# ---------------------------------------------------------------- inproc ---

class _InprocChannel(ClientChannel):
    def __init__(self, transport: "InprocTransport", client: int):
        self._t = transport
        self._client = client

    def send(self, msg: UploadMsg, timeout: Optional[float] = None) -> bool:
        return self._t._put_upload(msg, timeout)

    def recv(self, timeout: Optional[float] = None):
        box = self._t._bcast[self._client]
        try:
            return box.get(timeout=timeout) if timeout else box.get_nowait()
        except queue.Empty:
            return None


class InprocTransport(Transport):
    """Bounded in-process queue pair, the default.  Trees and payloads
    cross by reference (no copies), as the closed-loop runtimes alias
    ``client_params[i] = global_params``, so the determinism bridge stays
    bit-exact; ``device`` is accepted for the registry's call and unused
    (nothing is decoded)."""

    name = "inproc"

    def __init__(self, num_clients: int, capacity: int = 0, *, device=None):
        self._uploads: queue.Queue = queue.Queue(maxsize=capacity)
        self._bcast = [queue.Queue() for _ in range(num_clients)]
        self.num_clients = num_clients

    def _put_upload(self, msg: UploadMsg, timeout: Optional[float]) -> bool:
        msg.recv_host = time.monotonic()
        try:
            if timeout is None:
                self._uploads.put(msg)
            else:
                self._uploads.put(msg, timeout=timeout)
            return True
        except queue.Full:
            return False

    def recv_upload(self, timeout: Optional[float] = None) -> Optional[UploadMsg]:
        try:
            if timeout:
                return self._uploads.get(timeout=timeout)
            return self._uploads.get_nowait()
        except queue.Empty:
            return None

    def queue_depth(self) -> int:
        return self._uploads.qsize()

    def send_broadcast(self, client: int, msg) -> None:
        self._bcast[client].put(msg)

    def client_channel(self, client: int) -> ClientChannel:
        return _InprocChannel(self, client)


# -------------------------------------------------------------- registry ---

_REGISTRY: Dict[str, Callable[..., Transport]] = {}
_BUILTIN_OWNED: set = set()

_BUILTIN_FACTORIES: Tuple[Tuple[str, str, str], ...] = (
    # (name, module, attr): imported lazily on first lookup
    ("inproc", "repro_torch.serve.transport", "InprocTransport"),
    ("socket", "repro_torch.serve.socket_transport", "SocketTransport"),
    ("chaos", "repro_torch.resilience.chaos", "ChaosTransport"),
)
_builtins_loaded = False


def _ensure_builtins() -> None:
    global _builtins_loaded
    if not _builtins_loaded:
        for name, mod, attr in _BUILTIN_FACTORIES:
            factory = getattr(importlib.import_module(mod), attr)
            # pre-registration wins: a plugin that deliberately took a
            # builtin name before the lazy load keeps it
            if name in _REGISTRY and name not in _BUILTIN_OWNED:
                continue
            _REGISTRY[name] = factory
            _BUILTIN_OWNED.add(name)
        _builtins_loaded = True


def register_transport(name: str, factory: Callable[..., Transport], *,
                       overwrite: bool = False) -> None:
    """Register a transport factory ``factory(num_clients, capacity=0, *,
    device)`` under ``name``.  Re-registration is an error unless ``overwrite``."""
    if not overwrite and name in _REGISTRY:
        raise ValueError(f"transport {name!r} already registered")
    _REGISTRY[name] = factory
    _BUILTIN_OWNED.discard(name)


def get_transport(name: str) -> Callable[..., Transport]:
    """Resolve a transport name to its factory; unknown names fail
    loudly with the registered set in the message."""
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown transport {name!r}; registered transports: "
                         f"{', '.join(available_transports())}") from None


_PREFERRED = ("inproc", "socket", "chaos")


def available_transports() -> Tuple[str, ...]:
    """Registered names: builtins first (stable order), then third-party
    registrations in registration order."""
    _ensure_builtins()
    head = [n for n in _PREFERRED if n in _REGISTRY]
    return tuple(head) + tuple(n for n in _REGISTRY if n not in _PREFERRED)
