"""fp32 arithmetic rounded as the reference's XLA CPU compile rounds it.

Two operations of the event runtimes round differently in XLA than in
eager PyTorch, and their last bits reach the staleness weights, Eq. 1's
amplifier and every mixed parameter:

* ``powf``: XLA's CPU backend computes an fp32 ``pow`` with the C
  library's ``powf``.  torch's fp32 ``pow`` differs from it in the last
  bit at 956 of the 4096 entries of the staleness table, and float64
  ``pow`` rounded to fp32 at 4 (tau = 1057, 1249, 1457, 4049, where the
  C function rounds a near-tie the other way).  ``powf`` here calls the
  same C function.
* ``fma``: XLA fuses ``a * x + y`` into one fused multiply-add, rounded
  once; torch rounds the product and then the sum.

And one rounds differently in eager PyTorch on the CPU than anywhere
else: ``sqrt``.  torch's vectorised CPU fp32 square root is not always
correctly rounded (sqrt(8.579716) came out one ulp low), while XLA's and
CUDA's are; Adam's denominator reads it for every parameter.

On the card a third setting decides the bits: ``ieee()`` keeps the
model's matmuls and cuDNN's convolutions in IEEE fp32 whatever the
process-wide TF32 flags say.
"""
from __future__ import annotations

import contextlib
import ctypes
import ctypes.util
import functools
import threading

import numpy as np
import torch


_ieee_lock = threading.Lock()
_ieee_depth = 0          # threads (and nested scopes) inside ieee()
_ieee_restore = None     # the first entrant's ExitStack: restores the flags


@contextlib.contextmanager
def ieee():
    """Run the enclosed CUDA matmuls in IEEE fp32 and cuDNN's
    convolutions in IEEE fp32 with deterministic algorithms, whatever the
    process-wide flags say: ``torch.set_float32_matmul_precision("high")``
    or cuDNN's ``allow_tf32``, which is on by default, would round their
    inputs to TF32's 10-bit mantissa.  Inert on the CPU.

    The flags are process-wide, so the scope is reference-counted under
    a lock: the first scope to enter, in any thread, saves them and sets
    IEEE; the last one to leave restores them.  While any thread is
    inside, no thread inside sees TF32, and the caller's setting comes
    back once all have left."""
    global _ieee_depth, _ieee_restore
    with _ieee_lock:
        if _ieee_depth == 0:
            stack = contextlib.ExitStack()
            prev = torch.get_float32_matmul_precision()
            stack.callback(torch.set_float32_matmul_precision, prev)
            torch.set_float32_matmul_precision("highest")
            cudnn = torch.backends.cudnn
            stack.enter_context(cudnn.flags(enabled=cudnn.enabled, benchmark=False,
                                            deterministic=True, allow_tf32=False))
            _ieee_restore = stack
        _ieee_depth += 1
    try:
        yield
    finally:
        with _ieee_lock:
            _ieee_depth -= 1
            if _ieee_depth == 0:
                stack, _ieee_restore = _ieee_restore, None
                stack.close()


@functools.lru_cache(maxsize=None)
def _c_powf():
    fn = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6").powf
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


def powf(x, y) -> np.ndarray:
    """Elementwise fp32 ``x ** y`` by the C library's ``powf``, on the
    host: array-likes in, an fp32 numpy array of their broadcast shape
    out."""
    x, y = np.broadcast_arrays(np.asarray(x, np.float32), np.asarray(y, np.float32))
    fn = _c_powf()
    out = [fn(float(a), float(b)) for a, b in zip(x.ravel(), y.ravel())]
    return np.asarray(out, np.float32).reshape(x.shape)


def fma(a: float, x, y):
    """fl32(a * x + y) rounded once, for an fp32 scalar ``a`` and fp32
    tensors ``x``, ``y`` on any device.  The product of two fp32 numbers
    is exact in float64.  The float64 sum is rounded to odd (TwoSum gives
    what the sum lost; an inexact sum that came out even steps one ulp
    toward it), and rounding a round-to-odd float64 to fp32 rounds the
    exact sum once.  The same float64 operations run on CPU and CUDA, so
    both devices give the same bits."""
    p = x.double() * float(a)
    y = y.double()
    s = p + y
    yv = s - p
    err = (p - (s - yv)) + (y - yv)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.full_like(s, float("inf")),
                       torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.float()


def sqrt(x):
    """Correctly rounded fp32 square root of an fp32 tensor on either
    device.  On the CPU it is taken in float64 and rounded once more,
    which is exact for a square root (53 >= 2 * 24 + 2 bits); CUDA's
    ``sqrt`` is correctly rounded already."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)
