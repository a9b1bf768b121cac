"""Interprocess transport: localhost TCP, length-prefixed pickle frames.
Port of ``repro.serve.socket_transport``.

The server listens on an ephemeral loopback port; each client connects
and sends a hello frame naming its client id, then streams
``UploadMsg`` frames while a reader thread per connection pushes them,
decoded and arrival-stamped, into the same bounded queue the ``inproc``
transport uses, so the ``FLServer`` hot loop is transport-agnostic.
Broadcasts go back on the same connection (one send lock per socket).

A frame carries its trees as host numpy (``messages.msg_to_wire``); the
receiving end puts them on its own device: the server's reader threads
on the transport's ``device``, a client channel on the device its
worker computes on.  Bits survive the hop exactly (fp32, bf16, and a
payload's int8 values and int32 indices).

Failure semantics: a connection that dies mid-frame (a killed worker)
or fails the frame checks (``WireError``: bad magic, oversized length,
undecodable body) raises on its reader thread, which records the
client as dead with a reason (``"disconnect"`` / ``"wire-error"``) and
enqueues nothing.  The server's liveness tracker polls
``dead_clients()``/``dead_reasons()`` each step and evicts; a client
that reconnects (a new hello on a fresh socket) is surfaced through
``poll_reconnects()`` for re-admission with a fresh decode base.
Per-client FIFO holds because TCP keeps each connection's byte order.

One choice differs from the reference and changes no message: a
client channel waits for a frame with ``select`` and then reads the
whole frame in blocking mode, where the reference set a socket timeout
for the read.  A timeout that fired inside a frame dropped the bytes
already read and desynced the stream, and a timeout set by the receiving
thread also bound a concurrent ``sendall`` on the same socket (the chaos
transport re-sends held frames from the server's thread).
"""
from __future__ import annotations

import queue
import select
import socket
import threading
import time
from typing import Dict, List, Optional

from repro_torch.core.config import resolve_device
from repro_torch.serve.messages import UploadMsg, WireError, msg_from_wire, msg_to_wire, read_frame
from repro_torch.serve.transport import ClientChannel, Transport

_HELLO = "hello"


class _SocketChannel(ClientChannel):
    """Client side: one connected socket, frames both ways; received
    trees land on ``device``."""

    def __init__(self, host: str, port: int, client: int, *, device="cuda",
                 connect_timeout: float = 30.0):
        self.client = client
        self.device = resolve_device(device)
        self._sock = socket.create_connection((host, port), timeout=connect_timeout)
        self._sock.settimeout(None)
        self._lock = threading.Lock()
        self._sock.sendall(msg_to_wire((_HELLO, client)))

    def send(self, msg: UploadMsg, timeout: Optional[float] = None) -> bool:
        # TCP's own flow control is the backpressure: sendall blocks when
        # the server's bounded queue stops draining the socket buffer
        with self._lock:
            self._sock.sendall(msg_to_wire(msg))
        return True

    def recv(self, timeout: Optional[float] = None):
        if self._sock.fileno() < 0:
            raise OSError(f"client {self.client}'s channel is closed")
        ready, _, _ = select.select([self._sock], [], [], timeout if timeout else 0.001)
        if not ready:
            return None
        try:
            body = read_frame(self._sock)
        except WireError:
            # a corrupt server->client frame desyncs the stream; close so
            # the next send fails loudly (the worker loop ends, the
            # server's liveness deadline evicts) instead of misparsing
            self.close()
            return None
        return None if body is None else msg_from_wire(body, device=self.device)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class SocketTransport(Transport):
    """Server side: a listener and one reader thread per accepted client.
    Uploads are decoded onto ``device`` (the server's; a CUDA device
    unless the caller asks for the CPU), and ``client_channel`` gives
    in-process clients (thread workers, the bridge) channels whose trees
    land there too."""

    name = "socket"

    def __init__(self, num_clients: int, capacity: int = 0, host: str = "127.0.0.1", *,
                 device="cuda"):
        self.num_clients = num_clients
        self.device = resolve_device(device)
        self._uploads: queue.Queue = queue.Queue(maxsize=capacity)
        self._conns: Dict[int, socket.socket] = {}
        self._send_locks: Dict[int, threading.Lock] = {}
        # broadcasts addressed to a client that has not connected yet (the
        # init broadcast racing a slow process spawn) wait in a per-client
        # buffer and flush, in order and under the same send lock, the
        # moment its hello lands
        self._pending_bcast: Dict[int, List[bytes]] = {}
        self._dead: set = set()
        # why each dead client died ("disconnect" | "wire-error") and which
        # dead clients have since presented a fresh hello; the server's
        # liveness tracker drains both every step
        self._dead_reasons: Dict[int, str] = {}
        self._reconnected: set = set()
        self._threads: List[threading.Thread] = []
        self._closing = False
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, 0))
        self._listener.listen(num_clients)
        self.address = self._listener.getsockname()   # (host, port)
        t = threading.Thread(target=self._accept_loop, daemon=True, name="serve-accept")
        t.start()
        self._threads.append(t)

    # ------------------------------------------------- server internals ---

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return   # listener closed
            t = threading.Thread(target=self._reader, args=(conn,), daemon=True,
                                 name="serve-reader")
            t.start()
            self._threads.append(t)

    def _reader(self, conn: socket.socket) -> None:
        client = None
        try:
            hello = msg_from_wire(read_frame(conn))
            if not (isinstance(hello, tuple) and hello[0] == _HELLO):
                raise ConnectionError("expected hello frame")
            client = int(hello[1])
            with self._lock_for(client):
                if client in self._dead:
                    # a dead client came back on a fresh socket: clear the
                    # tombstone and surface the reconnect so the server
                    # re-admits it (fresh init broadcast, fresh decode base)
                    self._dead.discard(client)
                    self._dead_reasons.pop(client, None)
                    self._reconnected.add(client)
                self._conns[client] = conn
                for frame in self._pending_bcast.pop(client, []):
                    conn.sendall(frame)
            while True:
                body = read_frame(conn)
                if body is None:
                    return                     # clean close
                msg = msg_from_wire(body, device=self.device)
                msg.recv_host = time.monotonic()
                self._uploads.put(msg)         # bounded: blocks the reader
        except WireError:
            # a corrupt, truncated or oversized frame: the stream past it
            # is garbage, so the client is dead until it reconnects
            self._mark_dead(client, "wire-error")
        except (ConnectionError, OSError):
            self._mark_dead(client, "disconnect")
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _mark_dead(self, client: Optional[int], reason: str) -> None:
        if client is not None:
            self._dead.add(client)
            self._dead_reasons[client] = reason

    # -------------------------------------------------------- Transport ---

    def recv_upload(self, timeout: Optional[float] = None) -> Optional[UploadMsg]:
        try:
            if timeout:
                return self._uploads.get(timeout=timeout)
            return self._uploads.get_nowait()
        except queue.Empty:
            return None

    def queue_depth(self) -> int:
        return self._uploads.qsize()

    def dead_clients(self) -> set:
        """Clients whose connection died mid-stream (the discard path)."""
        return set(self._dead)

    def dead_reasons(self) -> Dict[int, str]:
        """Why each currently dead client died: ``"disconnect"`` (the peer
        vanished) or ``"wire-error"`` (a corrupt frame tripped the
        ``MAGIC``/size/decode checks)."""
        return dict(self._dead_reasons)

    def poll_reconnects(self) -> set:
        """Drain the clients that reconnected (a fresh hello after being
        marked dead) since the last poll; the server re-admits each with
        a fresh init broadcast."""
        out, self._reconnected = self._reconnected, set()
        return out

    def _lock_for(self, client: int) -> threading.Lock:
        # dict.setdefault is atomic under the GIL: concurrent first
        # touches from a reader thread and the serve loop agree on one lock
        return self._send_locks.setdefault(client, threading.Lock())

    def send_broadcast(self, client: int, msg) -> None:
        if client in self._dead:
            return   # never wedge on (or buffer for) a dead client
        frame = msg_to_wire(msg)
        with self._lock_for(client):
            conn = self._conns.get(client)
            if conn is None:
                # not connected yet: hold the frame for the hello flush
                self._pending_bcast.setdefault(client, []).append(frame)
                return
            try:
                conn.sendall(frame)
            except OSError:
                self._mark_dead(client, "disconnect")

    def client_channel(self, client: int) -> ClientChannel:
        host, port = self.address
        return _SocketChannel(host, port, client, device=self.device)

    def close(self) -> None:
        """Close the listener and every connection; shutting each socket
        down first wakes the accept and reader threads blocked on it."""
        self._closing = True
        for sock in [self._listener, *self._conns.values()]:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
