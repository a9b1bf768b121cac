"""Composed top-k + int8 codec on the topk_quant kernel.  Port of
``repro.compress.composed``.

Magnitude sparsification to frac·n entries, then stochastic int8
quantization of the survivors: 5 bytes per kept entry (int32 index +
int8 value) plus the 4-byte scale.  On the update's device the prologue
picks the threshold and scale (``torch.topk``), the kernel does
selection and quantization in one pass, ``torch.nonzero`` compacts the
kept entries, and the index plane, value plane and scale reach the host
in one copy.  Ties at the threshold all survive (more than k entries),
and the byte count is that of the entries actually kept.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.compress.base import Codec, Payload, register
from repro_torch.compress.sparsify import flatten_tree, unflatten_tree
from repro_torch.kernels.topk_quant import ops, ref


class TopKQuantCodec(Codec):
    """topk(frac) -> stochastic int8 on the values plane, fused.
    ``use_kernel=False`` routes through the plain version (the
    reference's switch to its oracle; nothing on the main path sets it)."""

    def __init__(self, frac: float = 0.1, *, use_kernel: bool = True):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"top-k fraction out of (0, 1]: {frac}")
        self.frac = frac
        self.use_kernel = use_kernel
        self.name = f"topk{frac:g}_int8"

    def encode(self, tree, *, seed: int = 0) -> Payload:
        flat, treedef, shapes, dtypes = flatten_tree(tree)
        n = int(flat.shape[0])
        k = max(1, int(round(self.frac * n)))
        thr, scale = ops.topk_threshold_scale(flat, k)
        quant = ops.topk_quant if self.use_kernel else ref.topk_quant
        q, mask = quant(flat, thr, scale, seed & 0xFFFFFFFF)
        kept = torch.nonzero(mask).reshape(-1).to(torch.int32)
        # one device->host copy: [idx bytes | val bytes | scale bytes]
        wire = torch.cat([kept.view(torch.uint8), q[kept.long()].view(torch.uint8),
                          scale.reshape(1).view(torch.uint8)]).cpu().numpy()
        nk = kept.numel()
        planes = {"idx": wire[:4 * nk].view(np.int32),
                  "val": wire[4 * nk:5 * nk].view(np.int8)}
        meta = {"treedef": treedef, "shapes": shapes, "dtypes": dtypes, "n": n,
                "scale": float(wire[5 * nk:].view(np.float32)[0]), "device": flat.device}
        return Payload(self.name, planes, meta=meta, wire_overhead=4)

    def decode(self, payload: Payload):
        m = payload.meta
        dev = m["device"]
        flat = torch.zeros(m["n"], dtype=torch.float32, device=dev)
        idx = torch.from_numpy(payload.planes["idx"]).to(dev).long()
        flat[idx] = torch.from_numpy(payload.planes["val"]).to(dev).float() * m["scale"]
        return unflatten_tree(flat, m["treedef"], m["shapes"], m["dtypes"])


register("topk_int8")(TopKQuantCodec)
