"""Magnitude top-k sparsification codec.  Port of
``repro.compress.sparsify``.

Keeps the k largest-magnitude entries of the flattened update and ships
an int32 index plane + fp32 value plane.  The k entries are the first
k of a stable descending sort of |x|: ``lax.top_k``'s order, by
magnitude and then lower index first, so under tied magnitudes the port
keeps the same entries as the reference, in the same order
(``torch.topk`` breaks ties otherwise, and at the k-th magnitude that
keeps a different entry and decodes a different tree).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.pytree import tree_flatten, tree_unflatten
from repro_torch.compress.base import Codec, Payload, register


def flatten_tree(tree):
    """Tree -> (flat fp32 vector in tree_flatten order, treedef, shapes,
    dtypes), with one ``torch.cat``."""
    leaves, treedef = tree_flatten(tree)
    flat = torch.cat([x.reshape(-1).float() for x in leaves])
    return flat, treedef, [tuple(x.shape) for x in leaves], [x.dtype for x in leaves]


def unflatten_tree(flat, treedef, shapes, dtypes):
    leaves, off = [], 0
    for shape, dtype in zip(shapes, dtypes):
        n = int(np.prod(shape)) if shape else 1
        leaves.append(flat[off:off + n].reshape(shape).to(dtype))
        off += n
    return tree_unflatten(treedef, leaves)


class TopKCodec(Codec):
    """Keep the frac·n largest-|x| entries of the flat update."""

    def __init__(self, frac: float = 0.1):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"top-k fraction out of (0, 1]: {frac}")
        self.frac = frac
        self.name = f"topk{frac:g}"

    def k_of(self, n: int) -> int:
        return max(1, int(round(self.frac * n)))

    def encode(self, tree, *, seed: int = 0) -> Payload:
        flat, treedef, shapes, dtypes = flatten_tree(tree)
        n = int(flat.shape[0])
        idx = torch.sort(torch.abs(flat), descending=True, stable=True).indices[:self.k_of(n)]
        planes = {"idx": idx.to(torch.int32).cpu().numpy(),
                  "val": flat[idx].cpu().numpy()}
        meta = {"treedef": treedef, "shapes": shapes, "dtypes": dtypes, "n": n,
                "device": flat.device}
        return Payload(self.name, planes, meta=meta)

    def decode(self, payload: Payload):
        m = payload.meta
        flat = torch.zeros(m["n"], dtype=torch.float32, device=m["device"])
        idx = torch.from_numpy(payload.planes["idx"]).to(m["device"]).long()
        flat[idx] = torch.from_numpy(payload.planes["val"]).to(m["device"])
        return unflatten_tree(flat, m["treedef"], m["shapes"], m["dtypes"])


register("topk")(TopKCodec)
