"""The serve wire protocol (schema ``serve-wire/v1``).  Port of
``repro.serve.messages``.

Two message families cross a transport:

* ``UploadMsg``: client -> server.  ``kind="report"`` carries the
  policy's declared scalars (Eq. 1 value, gradient norm), so the SERVER
  makes the ship/skip decision with exact policy state (VAFL's
  above-mean gate is fleet-wide: no client can evaluate it alone);
  ``kind="update"`` carries the model payload of an accepted upload (a
  :class:`repro_torch.compress.Payload` delta under a codec, the full
  parameter tree under identity).

* ``BroadcastMsg``: server -> client.  ``kind="init"`` bootstraps a
  client (initial model plus the run flags it needs: which scalars to
  compute, whether the exchange is two-phase); ``kind="decision"``
  answers a report (two-phase algorithms only); ``kind="download"``
  closes every event with the latest global model; ``kind="final"``
  tells free-running clients to stop.

The two-phase exchange mirrors the paper's protocol: a 4-byte scalar
report precedes each decision, and the model payload ships only when
the server says so, which is what ``CommStats`` accounts (reports cost
4 B; declined events cost no payload).  Decision frames are
control-plane traffic and are NOT billed, as in the closed-loop
runtimes, where the decision is a function call.

In process (the ``inproc`` transport) messages pass by reference, trees
as tensors on the federation's device.  On the wire (:func:`msg_to_wire`)
every tree leaf and payload plane is host numpy (a dtype numpy has no
name for, bfloat16, travels as its bits), and :func:`msg_from_wire`
puts them back on a given device.

Frame format: 4 magic bytes (``MAGIC``: format version, a cheap
corruption tripwire) + a 4-byte big-endian length + the pickled body,
the length bounded by ``MAX_FRAME_BYTES``.  A frame that fails the
checks raises :class:`WireError` (a ``ConnectionError``) so a transport
routes it through its dead-client path.  Reading frames off a socket
(``read_frame``) comes with the socket transport, ROADMAP.md queue 1
item 9b.
"""
from __future__ import annotations

import pickle
import struct
from dataclasses import dataclass, field, replace
from typing import Any, Optional

from repro_torch.checkpoint.store import tree_to_device, tree_to_host
from repro_torch.compress.base import Payload

WIRE_SCHEMA = "serve-wire/v1"

# frame-format magic: four bytes every frame starts with.  Bumping the
# frame layout bumps this; a stream that desyncs trips it at once.
MAGIC = b"RFL1"

# bound on one frame's body: a corrupted length prefix becomes a
# WireError instead of a 3 GB read
MAX_FRAME_BYTES = 1 << 28      # 256 MiB


class WireError(ConnectionError):
    """A frame failed the wire-format checks (bad magic, oversized
    length, undecodable body).  A ``ConnectionError``, because the stream
    is unusable past the bad frame: transports treat the peer as dead
    (reason ``"wire-error"``)."""


# UploadMsg kinds
REPORT = "report"
UPDATE = "update"
# BroadcastMsg kinds
INIT = "init"
DECISION = "decision"
DOWNLOAD = "download"
FINAL = "final"


@dataclass
class UploadMsg:
    """One client -> server message.

    ``version`` is the global-model version the client last downloaded
    (its training base: the server's staleness metadata and, under a
    codec, the delta's reference).  ``seq`` is the client's own message
    counter (per-client FIFO and dedup key), ``sim_time`` the client's
    clock (scenario-paced simulated seconds, or host seconds for
    free-running workers).  ``recv_host`` is stamped by the transport
    when the message lands server-side (the commit-latency clock)."""
    kind: str                      # REPORT | UPDATE
    client: int
    seq: int
    version: int
    sim_time: float = 0.0
    value: Optional[float] = None  # Eq. 1 V (policies with needs_values)
    norm: Optional[float] = None   # ||eff_grad||^2 (needs_norms)
    codec: str = "identity"
    payload: Any = None            # Payload (codec) | param tree (identity)
    enc_seed: int = 0              # the payload's deterministic encode seed
    recv_host: float = 0.0         # transport-stamped server arrival time


@dataclass
class BroadcastMsg:
    """One server -> client message (init / decision / download / final).

    ``ack_seq`` echoes the upload ``seq`` a decision or download answers,
    so a retrying client can discard a stale extra reply instead of
    reading it as the next exchange's answer; -1 on unsolicited frames
    (init / final)."""
    kind: str
    version: int = 0
    tree: Any = None               # model tree (init / download)
    upload: bool = False           # DECISION: ship the payload?
    meta: dict = field(default_factory=dict)   # INIT: run flags
    ack_seq: int = -1              # the upload seq this frame answers


def _payload_to(payload: Payload, device) -> Payload:
    """A payload whose decode-side ``meta["device"]`` is ``device``
    (None: the host); its planes are host numpy already."""
    meta = dict(payload.meta)
    if "device" in meta:
        meta["device"] = device if device is not None else "cpu"
    return replace(payload, meta=meta)


def msg_to_wire(msg) -> bytes:
    """Pickle one message into a magic + length-prefixed frame, its trees
    as host numpy."""
    if isinstance(msg, BroadcastMsg) and msg.tree is not None:
        msg = replace(msg, tree=tree_to_host(msg.tree))
    elif isinstance(msg, UploadMsg) and msg.payload is not None:
        if isinstance(msg.payload, Payload):
            msg = replace(msg, payload=_payload_to(msg.payload, None))
        else:                                    # identity: the raw tree
            msg = replace(msg, payload=tree_to_host(msg.payload))
    body = pickle.dumps((WIRE_SCHEMA, msg), protocol=pickle.HIGHEST_PROTOCOL)
    if len(body) > MAX_FRAME_BYTES:
        raise WireError(f"frame body of {len(body)} bytes exceeds "
                        f"MAX_FRAME_BYTES ({MAX_FRAME_BYTES})")
    return MAGIC + struct.pack("!I", len(body)) + body


def msg_from_wire(body: bytes, device="cpu"):
    """Decode one frame body (magic and length prefix already consumed),
    its trees as tensors on ``device``.  An undecodable body raises
    WireError; a well-formed body of another schema raises ValueError."""
    try:
        schema, msg = pickle.loads(body)
    except Exception as e:                    # noqa: BLE001: any pickle failure is corrupt bytes
        raise WireError(f"undecodable frame body: {e}") from e
    if schema != WIRE_SCHEMA:
        raise ValueError(f"wire schema mismatch: got {schema!r}, expected {WIRE_SCHEMA!r}")
    if isinstance(msg, BroadcastMsg) and msg.tree is not None:
        msg = replace(msg, tree=tree_to_device(msg.tree, device))
    elif isinstance(msg, UploadMsg) and msg.payload is not None:
        if isinstance(msg.payload, Payload):
            msg = replace(msg, payload=_payload_to(msg.payload, device))
        else:
            msg = replace(msg, payload=tree_to_device(msg.payload, device))
    return msg
