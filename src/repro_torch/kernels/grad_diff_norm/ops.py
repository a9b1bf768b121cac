"""Public wrapper of the grad_diff_norm kernel: stacked trees in, one
fp32 value per client out.

``tree_grad_diff_sq_norm`` hands the kernel a table of the stacked
leaves (leading axis = client, W rows) and reduces every row in one
launch, reading each leaf where it lies.  It is the port's default
value backend (``FLRunConfig.value_backend``); the Eq. 1 epilogue
``(1 + N/1e3)^acc`` stays in ``core/value.py``.  Trees of one dtype
(fp32 or bf16) are read as they are; a tree whose leaves mix dtypes is
widened to fp32, leaf by leaf, as ``flatten_stacked`` widens it.  A tree
of more than ``MAX_LEAVES`` leaves is first concatenated into one
(W, P) leaf.  CPU tensors take ``flatten_stacked`` and the plain
version in ``ref.py``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.common.pytree import tree_leaves
from repro_torch.kernels import build
from repro_torch.kernels.grad_diff_norm import ref

# wrapper calls that launched the kernel since the last reset (one CUDA
# launch each; chip_smoke.py reads it to show that a run went through
# the kernel)
launches = 0

MAX_LEAVES = 64          # the kernel's leaf table (csrc/grad_diff_norm.cu kMaxLeaves)
_THREADS = 256
_PER_THREAD = 8          # elements a thread sums per row before the block reduce
_MAX_BLOCKS_PER_ROW = 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_scratch = {}            # device -> (partials, tickets), grown on demand


def stacked_leaves(stacked):
    """A stacked tree's leaves (W, ...) in tree_flatten order, widened to
    fp32 if their dtypes mix."""
    leaves = tree_leaves(stacked)
    if len({x.dtype for x in leaves}) > 1:
        leaves = [x.float() for x in leaves]
    return leaves


def flatten_stacked(stacked):
    """Stacked tree -> (W, P) buffer in tree_flatten order.  Leaves of
    mixed dtypes are widened to fp32."""
    leaves = stacked_leaves(stacked)
    w = leaves[0].shape[0]
    return torch.cat([x.reshape(w, -1) for x in leaves], dim=1)


def blocks_per_row(p: int) -> int:
    """Blocks per row: a function of P alone, so a rerun with the same
    shapes sums in the same order."""
    return max(1, min(_MAX_BLOCKS_PER_ROW, math.ceil(p / (_THREADS * _PER_THREAD))))


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.library("grad_diff_norm").grad_diff_sq_norm
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _scratch_for(device, w: int, g: int):
    """Cached per device: W * G fp32 partials and W integer tickets,
    zero at rest (the kernel's last block of a row resets its ticket).
    One stream at a time per device uses them."""
    parts, tickets = _scratch.get(device, (None, None))
    if parts is None or parts.numel() < w * g:
        parts = torch.empty(max(w * g, 1024), dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < w:
        tickets = torch.zeros(max(w, 64), dtype=torch.int32, device=device)
    _scratch[device] = (parts, tickets)
    return parts, tickets


def leaf_table(leaves_a, leaves_b):
    """The kernel's leaf table from two lists of stacked leaves (W, ...)
    of one shape list: the non-empty leaves it reads, contiguous (a
    strided view is copied), concatenated into one (W, P) leaf each above
    ``MAX_LEAVES``; and each leaf's elements per row."""
    w = leaves_a[0].shape[0]
    la, lb = [], []
    for x, y in zip(leaves_a, leaves_b):
        if x.numel():
            la.append(x.contiguous())
            lb.append(y.contiguous())
    if len(la) > MAX_LEAVES:
        la = [torch.cat([x.reshape(w, -1) for x in la], dim=1)]
        lb = [torch.cat([x.reshape(w, -1) for x in lb], dim=1)]
    return la, lb, [x.numel() // w for x in la]


def _launch(leaves_a, leaves_b):
    """One launch over two lists of stacked leaves (W, ...) of one dtype."""
    global launches
    dtype = leaves_a[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"grad_diff_norm kernel takes float32 or bfloat16, got {dtype}")
    w = leaves_a[0].shape[0]
    if w > 65535:
        raise ValueError(f"grad_diff_norm takes at most 65535 rows per call (grid y), got {w}")
    device = leaves_a[0].device
    if w == 0:
        return torch.zeros(0, dtype=torch.float32, device=device)
    la, lb, numel = leaf_table(leaves_a, leaves_b)
    if not la:
        return torch.zeros(w, dtype=torch.float32, device=device)
    n = len(la)
    g = blocks_per_row(sum(numel))
    fn = _kernel()
    with torch.cuda.device(device):
        parts, tickets = _scratch_for(device, w, g)
        out = torch.empty((w,), dtype=torch.float32, device=device)
        err = fn((ctypes.c_void_p * n)(*[x.data_ptr() for x in la]),
                 (ctypes.c_void_p * n)(*[x.data_ptr() for x in lb]),
                 (ctypes.c_longlong * n)(*numel), n, _DTYPES[dtype], parts.data_ptr(),
                 out.data_ptr(), tickets.data_ptr(), w, g,
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grad_diff_norm kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _check_pair(leaves_a, leaves_b):
    if ([x.shape for x in leaves_a] != [x.shape for x in leaves_b]
            or leaves_a[0].dtype != leaves_b[0].dtype):
        raise ValueError(f"need two stacked operands of one shape and dtype, got "
                         f"{[tuple(x.shape) for x in leaves_a]} {leaves_a[0].dtype} and "
                         f"{[tuple(x.shape) for x in leaves_b]} {leaves_b[0].dtype}")
    device = leaves_a[0].device
    if leaves_b[0].device != device:
        raise ValueError(f"operands on {device} and {leaves_b[0].device}")
    if device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"grad_diff_norm runs on CPU or CUDA tensors, not {device}")
    return device


def grad_diff_sq_norm_2d(a, b):
    """(W, P) pair of equal dtype -> (W,) fp32 values of ||a_w - b_w||^2:
    the one-leaf case of ``tree_grad_diff_sq_norm``."""
    if a.dim() != 2:
        raise ValueError(f"need two (W, P) buffers, got {tuple(a.shape)} and {tuple(b.shape)}")
    device = _check_pair([a], [b])
    if device.type == "cpu":
        return ref.grad_diff_sq_norm_2d(a, b)
    return _launch([a], [b])


def tree_grad_diff_sq_norm(stacked_a, stacked_b):
    """Stacked trees (W rows) -> (W,) fp32 ||a_w - b_w||^2, one launch and
    no concatenation on CUDA.  The port's default
    ``FLRunConfig.value_backend``."""
    leaves_a, leaves_b = stacked_leaves(stacked_a), stacked_leaves(stacked_b)
    device = _check_pair(leaves_a, leaves_b)
    if device.type == "cpu":
        return ref.grad_diff_sq_norm_2d(flatten_stacked(stacked_a), flatten_stacked(stacked_b))
    return _launch(leaves_a, leaves_b)
