"""Dense stochastic uniform quantization codecs (int8 / int4).  Port of
``repro.compress.quantize``.

QSGD-style symmetric quantization with a per-leaf scale: each leaf is
mapped to q = floor(x / scale + u) with u ~ U[0,1) from the counter hash
(``repro_torch.kernels.topk_quant.ref.hash_uniform``, bit-exact with the
reference's), so E[decode(encode(x))] = x and the whole encode is
reproducible from (tree, seed).  int4 planes ship nibble-packed (two
values per byte) so Payload.nbytes is the literal wire size.

These are plain torch ops on both devices, as the reference's are plain
``jnp`` ops outside any Pallas kernel.  The reference runs them
eagerly, so both divisions are true divisions (no reciprocal rewrite):
the divisors here are tensors on the leaf's device, which keeps CUDA's
division by a host scalar, a multiply by its reciprocal, out of the
way.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.pytree import tree_flatten, tree_unflatten
from repro_torch.compress.base import Codec, Payload, register
from repro_torch.kernels.topk_quant.ref import hash_uniform


def _qmax(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)   # 127 for int8, 7 for int4


def stochastic_quantize(leaf, qmax: float, seed: int):
    """leaf (any shape, float) -> (q int8 flat, scale fp32 0-dim tensor)."""
    x = leaf.reshape(-1).float()
    q_max = torch.tensor(qmax, dtype=torch.float32, device=x.device)
    scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-12) / q_max
    u = hash_uniform(torch.arange(x.numel(), dtype=torch.int64, device=x.device),
                     seed & 0xFFFFFFFF)
    y = torch.clamp(x / scale, -qmax, qmax)
    q = torch.clamp(torch.floor(y + u), -qmax, qmax).to(torch.int8)
    return q, scale


def pack_nibbles(q: np.ndarray) -> np.ndarray:
    """int8 values in [-8, 7] -> nibble-packed uint8 (pads odd length)."""
    u = (q.astype(np.int16) + 8).astype(np.uint8)
    if u.size % 2:
        u = np.concatenate([u, np.zeros(1, np.uint8)])
    return (u[0::2] | (u[1::2] << 4)).astype(np.uint8)


def unpack_nibbles(packed: np.ndarray, n: int) -> np.ndarray:
    lo = (packed & 0x0F).astype(np.int16) - 8
    hi = (packed >> 4).astype(np.int16) - 8
    out = np.empty(packed.size * 2, np.int16)
    out[0::2], out[1::2] = lo, hi
    return out[:n].astype(np.int8)


class QuantCodec(Codec):
    """Per-leaf symmetric stochastic intN quantization (N = 8 or 4)."""

    def __init__(self, bits: int = 8):
        if bits not in (4, 8):
            raise ValueError(f"QuantCodec bits must be 4 or 8, got {bits}")
        self.bits = bits
        self.name = f"int{bits}"

    def encode(self, tree, *, seed: int = 0) -> Payload:
        leaves, treedef = tree_flatten(tree)
        qmax = _qmax(self.bits)
        planes, scales = {}, []
        for i, leaf in enumerate(leaves):
            # multiplicative per-leaf mixing: adjacent (seed, leaf) pairs
            # must not alias across clients the way seed+i would
            leaf_seed = (seed * 0x9E3779B1 + i) & 0xFFFFFFFF
            q, scale = stochastic_quantize(leaf, qmax, leaf_seed)
            qn = q.cpu().numpy()
            planes[f"q{i}"] = pack_nibbles(qn) if self.bits == 4 else qn
            scales.append(float(scale))
        meta = {"treedef": treedef, "shapes": [tuple(x.shape) for x in leaves],
                "dtypes": [x.dtype for x in leaves], "scales": scales,
                "device": leaves[0].device}
        return Payload(self.name, planes, meta=meta, wire_overhead=4 * len(scales))

    def decode(self, payload: Payload):
        m = payload.meta
        leaves = []
        for i, (shape, dtype, scale) in enumerate(zip(m["shapes"], m["dtypes"], m["scales"])):
            n = int(np.prod(shape)) if shape else 1
            q = payload.planes[f"q{i}"]
            if self.bits == 4:
                q = unpack_nibbles(q, n)
            leaf = torch.from_numpy(q).to(m["device"]).float().reshape(shape) * scale
            leaves.append(leaf.to(dtype))
        return tree_unflatten(m["treedef"], leaves)


register("int8")(lambda: QuantCodec(8))
register("int4")(lambda: QuantCodec(4))
