"""Public wrappers of the topk_quant kernel: a flat update in, the int8
value plane and selection mask out.

``topk_threshold_scale`` is the prologue (k-th largest |x| and the
symmetric int8 scale), computed on the update's device with
``torch.topk`` as the reference computes it with ``lax.top_k`` outside
its Pallas body.  ``topk_quant`` is the fused pass: CPU tensors take the
plain version in ``ref.py``; CUDA tensors launch the kernel or raise.
The compact index/value planes that go on the wire are built by the
codec (``repro_torch.compress.composed``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.topk_quant import ref

# kernel launches since the last reset (chip_smoke.py reads it to show
# that a run went through the kernel)
launches = 0

_THREADS = 256
_MAX_BLOCKS = 132 * 8     # one full wave of 256-thread blocks on an H100


# The reference's scale is max|x| * fl32(1/127), not max|x| / 127: XLA
# rewrites a division by a constant into a multiplication by its fp32
# reciprocal, and the two differ in the last bit for some inputs.
_INV_QMAX = float(np.float32(1.0) / np.float32(ref.QMAX))


def topk_threshold_scale(flat, k: int):
    """(thr, scale) as fp32 0-dim tensors on ``flat``'s device: the k-th
    largest |x|, and max|x| * fl32(1/127), both from values clamped at
    1e-12, bit for bit as the reference computes them."""
    top = torch.topk(torch.abs(flat.float()), k).values
    thr = torch.clamp_min(top[-1], 1e-12)
    scale = torch.clamp_min(top[0], 1e-12) * _INV_QMAX
    return thr, scale


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.library("topk_quant").topk_quant
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, thr, scale, seed):
    global launches
    n = x.numel()
    if n >= 2 ** 32:
        raise ValueError(f"topk_quant hashes a uint32 flat index; n = {n} is too large")
    fn = _kernel()
    x = x.float().contiguous()
    if x.data_ptr() % 16:
        x = x.clone()   # the kernel reads 16-byte vectors
    thr = torch.as_tensor(thr, dtype=torch.float32, device=x.device).reshape(())
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device).reshape(())
    blocks = max(1, min(_MAX_BLOCKS, -(-n // (4 * _THREADS))))
    with torch.cuda.device(x.device):
        q = torch.empty(n, dtype=torch.int8, device=x.device)
        mask = torch.empty(n, dtype=torch.int8, device=x.device)
        err = fn(x.data_ptr(), thr.data_ptr(), scale.data_ptr(), int(seed) & 0xFFFFFFFF,
                 q.data_ptr(), mask.data_ptr(), n, blocks,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"topk_quant kernel launch failed: CUDA error {err}")
    launches += 1
    return q, mask


def topk_quant(flat, thr, scale, seed: int):
    """Fused select + quantize over a flat fp32 update -> (q int8, mask int8)."""
    if flat.dim() != 1:
        raise ValueError(f"topk_quant takes a flat buffer, got shape {tuple(flat.shape)}")
    if flat.device.type == "cpu":
        return ref.topk_quant(flat, thr, scale, seed)
    if flat.device.type != "cuda":
        raise RuntimeError(f"topk_quant runs on CPU or CUDA tensors, not {flat.device}")
    if flat.numel() == 0:
        empty = torch.empty(0, dtype=torch.int8, device=flat.device)
        return empty, empty.clone()
    return _launch(flat, thr, scale, seed)
