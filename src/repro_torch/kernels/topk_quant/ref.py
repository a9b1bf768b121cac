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


# (shift, bits) of the encode kernel's three radix digits of a magnitude key
DIGITS = ((20, 11), (10, 10), (0, 10))


def radix_threshold_scale(x, k: int, inv_qmax: float):
    """Plain model of the encode kernel's select (csrc/topk_quant.cu),
    used by the tests: the k-th largest |x| found digit by digit on the
    bits of key = bits(x) & 0x7FFFFFFF, one histogram a digit over the
    keys that match the digits found so far, and max|x| as the integer
    max of the keys; both clamped at 1e-12, scale = max * inv_qmax.
    Returns (thr, scale) as fp32 0-dim tensors."""
    key = x.float().reshape(-1).view(torch.int32).to(torch.int64) & 0x7FFFFFFF
    prefix, krem = 0, int(k)
    for shift, bits in DIGITS:
        high = shift + bits
        cand = key[(key >> high) == (prefix >> high)]
        hist = torch.bincount((cand >> shift) & ((1 << bits) - 1), minlength=1 << bits)
        above = torch.flip(torch.cumsum(torch.flip(hist, [0]), 0), [0]) - hist
        b = int(torch.nonzero((above < krem) & (krem <= above + hist))[0, 0])
        krem -= int(above[b])
        prefix |= b << shift

    def as_f32(bits: int):
        return torch.tensor([bits], dtype=torch.int32).view(torch.float32)[0]
    thr = torch.clamp_min(as_f32(prefix), 1e-12)
    scale = torch.clamp_min(as_f32(int(key.max())), 1e-12) * inv_qmax
    return thr, scale
