"""Public wrapper of the flash_attention kernels: the model layer's GQA
layout in, causal attention out, with its gradient.  Port of
``repro.kernels.flash_attention.ops.gqa_flash_attention``.

``gqa_flash_attention`` takes q, k (B, S, H | KV, hd) and v (B, S, KV,
dv) as they come out of the attention layer's projections and returns
(B, S, H, dv) in q's dtype.  With ``causal=False`` it attends to every
key, and k and v may hold Sk positions where q holds Sq (whisper's
encoder self-attention, and its cross-attention from the decoder's
queries to the encoder's frames): the reference's plain ``_sdpa`` with a
mask of all ones, which the TPU kernel, causal only, does not compute.
A window needs ``causal``, and so does Sq = Sk; both are refused in
Python before any launch.  dv is hd (``HEAD_DIMS``) but for MLA's
unequal pairs (``UNEQUAL_HEAD_DIMS``: minicpm3_4b's q.k 96 / v 64 and
its smoke width's 48 / 32), which the forward kernel takes as template
instances of their own.  It is ``FlashAttention``, a
``torch.autograd.Function``:

* forward: CUDA tensors launch the kernel in ``csrc/flash_attention.cu``,
  which reads all three through their strides and maps query head h to
  kv head ``h // (H // KV)``, so nothing is repeated or transposed; any S
  works (the kernel masks the ragged edge).  bf16 inputs take the
  tensor-core route, whose 16-byte asynchronous copies need every row of
  q, k and v 16-byte aligned: a tensor whose base pointer or (b, s,
  head) strides do not allow that is first copied to a contiguous one
  (``needs_copy``).  With grad enabled the launch also writes each row's
  logsumexp ``lse`` (fp32, (B, H, Sq)) for the backward; under
  ``torch.no_grad`` (serving) it writes none and is the same launch as
  before training existed.
* backward: CUDA tensors launch ``csrc/flash_attention_bwd.cu`` (no
  atomics: dK and dV a key tile, then dQ a query tile) from q, k, v, o,
  dO and lse, and return gradients in the input dtype.  It takes the
  forward's equal head dims, 32, 64, 112 (zamba2_7b's shared attention:
  the bf16 route's tiles hold 112 columns padded with zeros to 128) and
  128 (``BWD_HEAD_DIMS``); an unequal pair raises ``ValueError`` before
  any launch (MLA trains on the CPU only), and so does the non-causal
  mode, or Sq != Sk (whisper trains on the CPU only).  The route
  follows the dtype.  bf16 (the ``[train]`` path) runs every product on
  the tensor cores (``wgmma``, one warpgroup a 64-row tile, P and dS
  rounded to bf16 in registers) with ``cp.async`` rings of bf16 tiles,
  and needs every base pointer 16-byte aligned; it splits a GQA
  group's query heads over ``bwd_plan(...)`` chunks of blocks, whose
  fp32 partials of dK and dV (``torch.empty`` scratch here) a last pass
  sums in chunk order.  fp32, held to 1e-4 of scale, keeps fp32 FMA
  tiles on the CUDA cores.  Both are bound by operations: 5 products at
  989 TFLOP/s in bf16 (the kernels do 7, the score products twice).
* vmap: a ``torch.func.vmap`` over the Function (the FL runtimes'
  per-client loss) folds the vmapped axis into B and calls the Function
  once, since the kernel cannot read a batched tensor's storage.

CPU tensors take the plain versions in ``ref.py`` inside the same
Function (forward, and autograd through it for the backward), so the
gradient plumbing and the vmap rule run on the CPU too.  Nothing else
falls back: a CUDA tensor the kernels do not take raises, and so does a
backward on the card of a forward that kept no ``lse``.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

# kernel launches since the last reset, forward and backward (one a
# wrapper call; a backward call is three CUDA launches, four for a bf16
# one whose GQA group is split); chip_smoke.py reads them to show that a
# run went through the kernels
launches = 0
bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 112, 128)   # the forward kernel's (112: zamba2_7b's shared attention)
UNEQUAL_HEAD_DIMS = ((96, 64), (48, 32))   # (q.k, v) of MLA: minicpm3_4b, its smoke width
BWD_HEAD_DIMS = (32, 64, 112, 128)   # the backward kernel's
BWD_TILE = 64              # queries and keys a tile of the bf16 backward
BWD_BLOCKS_PER_SM = 2      # its dK/dV blocks resident an SM at hd 128 (255 registers, 100 KB)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.library("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    fn = build.library("flash_attention_bwd").flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
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


def _check_mode(Sq, Sk, window, causal):
    """Raise for a mode neither the kernel nor the plain version takes: a
    causal pair of unequal lengths (the causal mask is positional over
    one sequence), or a window without ``causal``."""
    if causal and Sq != Sk:
        raise ValueError(f"causal flash_attention takes as many keys as queries, got Sq={Sq}, "
                         f"Sk={Sk}: pass causal=False to attend to every key")
    if window is not None and not causal:
        raise ValueError(f"a window ({window}) needs causal flash_attention")


def _check_launch(q, backward: bool = False, dv=None, sk=None, window=None, causal=True):
    """Raise for what the kernels do not take: q (B, Sq, H, hd), a v head
    dim ``dv`` (hd where None), ``sk`` keys (Sq where None), the window and
    the mode."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, got {q.dtype}")
    B, S, H, hd = q.shape
    sk = S if sk is None else sk
    _check_mode(S, sk, window, causal)
    if backward and not causal:
        raise ValueError(f"flash_attention backward kernel is causal only, got causal=False "
                         f"(Sq={S}, Sk={sk}): whisper trains on the CPU only (ROADMAP.md §1 "
                         f"item 11)")
    dv = hd if dv is None else dv
    if dv != hd:
        if backward:
            raise ValueError(f"flash_attention backward kernel takes equal q.k and v head dims, "
                             f"got ({hd}, {dv}): MLA trains on the CPU only (ROADMAP.md §1 "
                             f"item 11)")
        if (hd, dv) not in UNEQUAL_HEAD_DIMS:
            raise ValueError(f"flash_attention kernel takes unequal (q.k, v) head dims in "
                             f"{UNEQUAL_HEAD_DIMS}, got ({hd}, {dv})")
    elif backward and hd not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention backward kernel takes head_dim in {BWD_HEAD_DIMS}, "
                         f"got {hd}")
    elif hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if max(B, H) > 65535:
        raise ValueError(f"flash_attention takes at most 65535 batch rows and heads (grid), "
                         f"got B={B}, H={H}")


def _launch(q, k, v, window, causal=True, need_lse=False):
    """The forward kernel: (o, lse), lse None unless ``need_lse``."""
    global launches
    dv = v.shape[-1]
    _check_launch(q, dv=dv, sk=k.shape[1], window=window, causal=causal)
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    q, k, v = (x.clone(memory_format=torch.contiguous_format) if needs_copy(x) else x
               for x in (q, k, v))
    fn = _kernel()
    with torch.cuda.device(q.device):
        out = torch.empty((B, S, H, dv), dtype=q.dtype, device=q.device)
        lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
               if need_lse else None)
        strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                           *v.stride()[:3], *out.stride()[:3])
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
                 B, S, Sk, H, KV, hd, dv, ctypes.addressof(strides), window or 0, int(causal),
                 1.0 / hd ** 0.5, lse.data_ptr() if lse is not None else None,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out, lse


def bwd_plan(B, S, H, KV, sms):
    """Query-head chunks of a GQA group in the bf16 backward's dK/dV
    launch: the fewest that give about two waves of blocks on ``sms``
    SMs, at most the group's G = H // KV heads (1 where G is 1)."""
    blocks = -(-S // BWD_TILE) * KV * B
    return max(1, min(H // KV, -(-2 * sms * BWD_BLOCKS_PER_SM // blocks)))


def _launch_bwd(q, k, v, o, do, lse, window, causal=True):
    """The backward kernels: (dq, dk, dv) in q's dtype."""
    global bwd_launches
    _check_launch(q, backward=True, dv=v.shape[-1], sk=k.shape[1], window=window, causal=causal)
    if not q.dtype == o.dtype == do.dtype or lse.dtype != torch.float32:
        raise TypeError(f"flash_attention backward takes q, o, dO of one dtype and fp32 lse, "
                        f"got {q.dtype}, {o.dtype}, {do.dtype}, {lse.dtype}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if (o.shape != q.shape or do.shape != q.shape or k.shape != (B, S, KV, hd)
            or v.shape != k.shape or lse.shape != (B, H, S)):
        raise ValueError(f"flash_attention backward takes q, o, dO (B,S,H,hd), k, v (B,S,KV,hd) "
                         f"and lse (B,H,S), got {tuple(q.shape)}, {tuple(o.shape)}, "
                         f"{tuple(do.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(lse.shape)}")
    # contiguous, and for bf16 (16-byte cp.async and vector loads) 16-byte aligned
    q, k, v, o, do, lse = (x.clone(memory_format=torch.contiguous_format)
                           if not x.is_contiguous() or x.data_ptr() % 16 else x
                           for x in (q, k, v, o, do, lse))
    fn = _bwd_kernel()
    with torch.cuda.device(q.device):
        chunks = 1
        if q.dtype == torch.bfloat16:
            chunks = bwd_plan(B, S, H, KV, torch.cuda.get_device_properties(q.device)
                              .multi_processor_count)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        sp = -(-S // BWD_TILE) * BWD_TILE
        dvec = torch.empty(2 * B * H * sp, dtype=torch.float32, device=q.device)
        part = (torch.empty(2 * chunks * B * S * KV * hd, dtype=torch.float32, device=q.device)
                if chunks > 1 else None)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 part.data_ptr() if part is not None else None, chunks, _DTYPES[q.dtype],
                 B, S, H, KV, hd, window or 0, 1.0 / hd ** 0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA error {err}")
    bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """GQA attention, causal or not, with its gradient: the kernels on
    CUDA tensors, the plain versions on CPU tensors.  ``apply(q, k, v,
    window, causal, need_lse)`` returns (o, lse); lse is None on the CPU
    and unless ``need_lse``."""

    @staticmethod
    def forward(q, k, v, window, causal, need_lse):
        if q.device.type == "cpu":
            return ref.gqa_attention(q, k, v, window=window, causal=causal), None
        if q.device.type != "cuda":
            raise RuntimeError(f"flash_attention runs on CPU or CUDA tensors, not {q.device}")
        return _launch(q, k, v, window, causal, need_lse)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, window, causal, _ = inputs
        o, lse = output
        ctx.window, ctx.causal = window, causal
        if lse is not None:
            ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse)

    @staticmethod
    @once_differentiable
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = ref.gqa_attention_bwd(q, k, v, do, window=ctx.window, causal=ctx.causal)
        elif lse is None:
            raise RuntimeError("flash_attention backward on the card needs the forward's "
                               "logsumexp: the forward ran with grad disabled")
        else:
            dq, dk, dv = _launch_bwd(q, k, v, o, do, lse, ctx.window, ctx.causal)
        return dq, dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, window, causal, need_lse):
        n = info.batch_size

        def fold(x, d):   # (n, B, ...) -> (n B, ...): the vmapped axis joins the batch
            x = x.unsqueeze(0).expand((n,) + tuple(x.shape)) if d is None else x.movedim(d, 0)
            return x.reshape((n * x.shape[1],) + tuple(x.shape[2:]))

        o, lse = FlashAttention.apply(fold(q, in_dims[0]), fold(k, in_dims[1]),
                                      fold(v, in_dims[2]), window, causal, need_lse)
        o = o.reshape((n, -1) + tuple(o.shape[1:]))
        if lse is None:
            return (o, None), (0, None)
        return (o, lse.reshape((n, -1) + tuple(lse.shape[1:]))), (0, 0)


def gqa_flash_attention(q, k, v, *, window=None, causal=True):
    """q (B,Sq,H,hd), k (B,Sk,KV,hd), v (B,Sk,KV,dv) -> (B,Sq,H,dv): causal
    (Sq = Sk; ``window`` keeps keys with ``q - k < window``), or with
    ``causal=False`` over every key.  Differentiable in q, k and v (on the
    card only where causal and dv == hd)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"need q (B,Sq,H,hd), k (B,Sk,KV,hd) and v (B,Sk,KV,dv), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[1] < 1 or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not form GQA groups")
    _check_mode(S, k.shape[1], window, causal)
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    return FlashAttention.apply(q, k, v, window, causal, torch.is_grad_enabled())[0]
