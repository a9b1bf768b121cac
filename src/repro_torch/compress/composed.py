"""Composed top-k + int8 codec on the topk_quant kernels.  Port of
``repro.compress.composed``.

Magnitude sparsification to frac·n entries, then stochastic int8
quantization of the survivors: 5 bytes per kept entry (int32 index +
int8 value) plus the 4-byte scale.  On a CUDA update the whole encode
runs on the device (``ops.topk_int8_encode``): radix select of the
threshold, quantization and compaction read the update's leaves where
they lie, and one copy brings the index plane, value plane and scale to
the host.  On CPU tensors, and with ``use_kernel=False``, the plain
route runs instead (``ops.encode_plain``: ``torch.topk``, the plain
quantization, ``torch.nonzero``).  Ties at the threshold all survive
(more than k entries), and the byte count is that of the entries
actually kept.
"""
from __future__ import annotations

import torch

from repro_torch.common.pytree import tree_flatten
from repro_torch.compress.base import Codec, Payload, register
from repro_torch.compress.sparsify import flatten_tree, unflatten_tree
from repro_torch.kernels.topk_quant import ops


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
        leaves, treedef = tree_flatten(tree)
        shapes, dtypes = [tuple(x.shape) for x in leaves], [x.dtype for x in leaves]
        n = int(sum(x.numel() for x in leaves))
        if self.use_kernel:
            idx, val, scale = ops.topk_int8_encode(leaves, self.frac, seed & 0xFFFFFFFF)
        else:
            flat = flatten_tree(tree)[0]
            idx, val, scale = ops.encode_plain(flat, ops.encode_k(self.frac, n),
                                               seed & 0xFFFFFFFF)
        meta = {"treedef": treedef, "shapes": shapes, "dtypes": dtypes, "n": n,
                "scale": scale, "device": leaves[0].device}
        return Payload(self.name, {"idx": idx, "val": val}, meta=meta, wire_overhead=4)

    def decode(self, payload: Payload):
        m = payload.meta
        dev = m["device"]
        flat = torch.zeros(m["n"], dtype=torch.float32, device=dev)
        idx = torch.from_numpy(payload.planes["idx"]).to(dev).long()
        flat[idx] = torch.from_numpy(payload.planes["val"]).to(dev).float() * m["scale"]
        return unflatten_tree(flat, m["treedef"], m["shapes"], m["dtypes"])


register("topk_int8")(TopKQuantCodec)
