"""Plain PyTorch version of the topk_quant kernel: the path taken on CPU
tensors, and what ``chip_smoke.py`` holds the kernel against on the card.

Semantics, bit for bit those of ``repro/kernels/topk_quant/ref.py``:

  keep = |x| >= thr
  q    = clip(floor(clip(x / scale, -127, 127) + u), -127, 127)  where kept
  u    = hash_uniform(flat index, seed), a uint32 multiply-xorshift hash

The uint32 hash runs in int64 with every product reduced to its low 32
bits; the multiplies are split into 16-bit halves so that no int64
product overflows.
"""
from __future__ import annotations

import torch

QMAX = 127.0
_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """Low 32 bits of x * c for int64 x in [0, 2^32) and a uint32 constant."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def hash_uniform(idx, seed: int):
    """Uniform [0, 1) fp32 from int64 flat indices and a uint32 seed."""
    x = (_mul32(idx, 2654435761) + (int(seed) & _M32)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x.to(torch.float32) * (2.0 ** -32)


def topk_quant(x, thr, scale, seed: int):
    """x: flat fp32 (n,); thr, scale: fp32 scalars (0-dim tensors or
    floats); seed: uint32.  Returns (q int8 (n,), mask int8 (n,))."""
    x = x.float()
    idx = torch.arange(x.numel(), dtype=torch.int64, device=x.device)
    u = hash_uniform(idx, seed)
    keep = torch.abs(x) >= thr
    y = torch.clamp(x / scale, -QMAX, QMAX)
    q = torch.clamp(torch.floor(y + u), -QMAX, QMAX).to(torch.int8)
    q = torch.where(keep, q, torch.zeros_like(q))
    return q, keep.to(torch.int8)
