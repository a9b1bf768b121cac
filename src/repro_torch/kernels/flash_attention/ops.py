"""Public wrapper of the flash_attention kernel: the model layer's GQA
layout in, causal attention out.  Port of
``repro.kernels.flash_attention.ops.gqa_flash_attention``.

``gqa_flash_attention`` takes q (B, S, H, hd) and k, v (B, S, KV, hd) as
they come out of the attention layer's projections and returns
(B, S, H, hd) in q's dtype.  CUDA tensors launch the kernel in
``csrc/flash_attention.cu``, which reads all three through their strides
and maps query head h to kv head ``h // (H // KV)``, so nothing is
repeated or transposed; any S works (the kernel masks the ragged edge).
bf16 inputs take the tensor-core route, whose 16-byte asynchronous
copies need every row of q, k and v 16-byte aligned: a tensor whose base
pointer or (b, s, head) strides do not allow that is first copied to a
contiguous one (``needs_copy``).  The strided views of a fused qkv
projection are aligned and read in place.  CPU tensors take the plain
version in ``ref.py``.  Nothing else falls back: a CUDA tensor the
kernel does not take raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

# kernel launches since the last reset (chip_smoke.py reads it to show
# that a run went through the kernel)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.library("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def needs_copy(x) -> bool:
    """Whether the kernel cannot read ``x`` (B, S, heads, hd) in place:
    the head dim must be unit-stride, and for bf16 (16-byte cp.async
    rows) the base pointer and the (b, s, head) strides must be whole
    multiples of 16 bytes.  The fp32 route reads single elements."""
    if x.stride(-1) != 1:
        return True
    if x.dtype != torch.bfloat16:
        return False
    esize = x.element_size()
    return x.data_ptr() % 16 != 0 or any(st * esize % 16 for st in x.stride()[:3])


def _launch(q, k, v, window):
    global launches
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, got {q.dtype}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if max(B, H) > 65535:
        raise ValueError(f"flash_attention takes at most 65535 batch rows and heads (grid), "
                         f"got B={B}, H={H}")
    q, k, v = (x.clone(memory_format=torch.contiguous_format) if needs_copy(x) else x
               for x in (q, k, v))
    fn = _kernel()
    with torch.cuda.device(q.device):
        out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
        strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                           *v.stride()[:3], *out.stride()[:3])
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
                 B, S, H, KV, hd, ctypes.addressof(strides), window or 0, 1.0 / hd ** 0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def gqa_flash_attention(q, k, v, *, window=None):
    """q (B,S,H,hd), k/v (B,S,KV,hd) -> (B,S,H,hd), causal; ``window``
    keeps keys with ``q - k < window``."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"need q (B,S,H,hd) and k, v (B,S,KV,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not form GQA groups")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if q.device.type == "cpu":
        return ref.gqa_attention(q, k, v, window=window)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention runs on CPU or CUDA tensors, not {q.device}")
    return _launch(q, k, v, window)
