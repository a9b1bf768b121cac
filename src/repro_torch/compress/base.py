"""Update-compression primitives: wire payloads, the Codec protocol and
the codec registry.  Port of ``repro.compress.base``.

A ``Codec`` maps a parameter/update tree to a :class:`Payload`, the
exact planes a client would put on the wire, and back.  Payloads know
their own ``nbytes``, which is what CommStats records.

Spec strings accepted by :func:`get_codec`:

  "identity" | "none" | ""      no-op, nbytes = full fp32 tree
  "topk" / "topk0.05"           magnitude sparsification, fp32 values +
                                int32 indices (default fraction 0.1)
  "int8" / "int4"               dense stochastic uniform quantization,
                                per-leaf symmetric scale (plain torch ops)
  "topk_int8" / "topk0.05_int8" top-k, then stochastic int8 values: the
                                topk_quant kernel
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.common.pytree import tree_flatten, tree_unflatten


@dataclass
class Payload:
    """What goes on the wire for one compressed transfer: ``planes`` are
    the host arrays a client would serialize, ``wire_overhead`` counts
    scalar metadata the planes don't carry, and ``meta`` is decode-side
    state that never ships (structure, shapes, device)."""
    codec: str
    planes: Dict[str, np.ndarray]
    meta: Dict[str, Any] = field(default_factory=dict)
    wire_overhead: int = 0

    @property
    def nbytes(self) -> int:
        return int(sum(int(p.nbytes) for p in self.planes.values())
                   + self.wire_overhead)


class Codec:
    """encode(tree, seed) -> Payload; decode(Payload) -> tree."""
    name: str = "codec"
    is_identity: bool = False

    def encode(self, tree, *, seed: int = 0) -> Payload:
        raise NotImplementedError

    def decode(self, payload: Payload):
        raise NotImplementedError


class IdentityCodec(Codec):
    """No-op codec: the full fp32 tree on the wire."""
    name = "identity"
    is_identity = True

    def encode(self, tree, *, seed: int = 0) -> Payload:
        leaves, treedef = tree_flatten(tree)
        return Payload(self.name,
                       {f"p{i}": x.detach().cpu().numpy() for i, x in enumerate(leaves)},
                       meta={"treedef": treedef, "device": leaves[0].device})

    def decode(self, payload: Payload):
        leaves = [torch.from_numpy(payload.planes[f"p{i}"]).to(payload.meta["device"])
                  for i in range(len(payload.planes))]
        return tree_unflatten(payload.meta["treedef"], leaves)


_REGISTRY: Dict[str, Callable[..., Codec]] = {}


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


_TOPK_RE = re.compile(r"topk(\d*\.?\d+)?(_int8)?$")


def get_codec(spec: Optional[str]) -> Codec:
    """Parse a codec spec string (module docstring grammar) to a Codec."""
    if spec is None or spec in ("", "none", "identity"):
        return IdentityCodec()
    if spec in _REGISTRY:
        return _REGISTRY[spec]()
    m = _TOPK_RE.fullmatch(spec)
    if m:
        frac = float(m.group(1)) if m.group(1) else 0.1
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"top-k fraction out of (0, 1]: {spec!r}")
        factory = _REGISTRY["topk_int8" if m.group(2) else "topk"]
        return factory(frac)
    raise ValueError(f"unknown codec spec {spec!r} "
                     f"(known: identity, int8, int4, topk[frac], topk[frac]_int8)")
