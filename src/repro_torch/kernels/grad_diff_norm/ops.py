"""Public wrapper of the grad_diff_norm kernel: stacked trees in, one
fp32 value per client out.

``tree_grad_diff_sq_norm`` flattens two stacked trees (leading axis =
client, W rows) into (W, P) buffers with one ``torch.cat`` each and
reduces every row with one kernel launch.  It is the port's default
value backend (``FLRunConfig.value_backend``); the Eq. 1 epilogue
``(1 + N/1e3)^acc`` stays in ``core/value.py``.  CPU tensors take the
plain version in ``ref.py``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.common.pytree import tree_leaves
from repro_torch.kernels import build
from repro_torch.kernels.grad_diff_norm import ref

# kernel launches since the last reset (chip_smoke.py reads it to show
# that a run went through the kernel)
launches = 0

_THREADS = 256
_PER_THREAD = 8          # elements a thread sums per row before the block reduce
_MAX_BLOCKS_PER_ROW = 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flatten_stacked(stacked):
    """Stacked tree -> (W, P) buffer in tree_flatten order.  Leaves of
    mixed dtypes are widened to fp32."""
    leaves = tree_leaves(stacked)
    w = leaves[0].shape[0]
    rows = [x.reshape(w, -1) for x in leaves]
    if len({x.dtype for x in rows}) > 1:
        rows = [x.float() for x in rows]
    return torch.cat(rows, dim=1)


def blocks_per_row(p: int) -> int:
    """Stage-1 blocks per row: a function of P alone, so a rerun with the
    same shapes sums in the same order."""
    return max(1, min(_MAX_BLOCKS_PER_ROW, math.ceil(p / (_THREADS * _PER_THREAD))))


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.library("grad_diff_norm").grad_diff_sq_norm
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(a, b):
    global launches
    if a.dtype not in _DTYPES:
        raise TypeError(f"grad_diff_norm kernel takes float32 or bfloat16, got {a.dtype}")
    w, p = a.shape
    if w > 65535:
        raise ValueError(f"grad_diff_norm takes at most 65535 rows per call (grid y), got {w}")
    fn = _kernel()
    a, b = a.contiguous(), b.contiguous()
    g = blocks_per_row(p)
    with torch.cuda.device(a.device):
        partial = torch.empty((w, g), dtype=torch.float32, device=a.device)
        out = torch.empty((w,), dtype=torch.float32, device=a.device)
        err = fn(a.data_ptr(), b.data_ptr(), _DTYPES[a.dtype], partial.data_ptr(),
                 out.data_ptr(), w, p, g, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grad_diff_norm kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def grad_diff_sq_norm_2d(a, b):
    """(W, P) pair of equal dtype -> (W,) fp32 values of ||a_w - b_w||^2."""
    if a.shape != b.shape or a.dim() != 2 or a.dtype != b.dtype:
        raise ValueError(f"need two (W, P) buffers of one dtype, got "
                         f"{tuple(a.shape)} {a.dtype} and {tuple(b.shape)} {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return ref.grad_diff_sq_norm_2d(a, b)
    if a.device.type != "cuda":
        raise RuntimeError(f"grad_diff_norm runs on CPU or CUDA tensors, not {a.device}")
    if a.shape[0] == 0 or a.shape[1] == 0:
        return torch.zeros(a.shape[0], dtype=torch.float32, device=a.device)
    return _launch(a, b)


def tree_grad_diff_sq_norm(stacked_a, stacked_b):
    """Stacked trees (W rows) -> (W,) fp32 ||a_w - b_w||^2, one launch.
    The port's default ``FLRunConfig.value_backend``."""
    return grad_diff_sq_norm_2d(flatten_stacked(stacked_a), flatten_stacked(stacked_b))
