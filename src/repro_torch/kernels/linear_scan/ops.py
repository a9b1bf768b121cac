"""Public wrapper of the linear_scan kernel on the model layer's shapes.
Port of ``repro.kernels.linear_scan.ops.recurrence``.

``recurrence`` takes q, k, la (B, S, H, K), v (B, S, H, V), the RWKV6
bonus u (H, K) and an optional fp32 initial state (B, H, K, V), and
returns y (B, S, H, V) in v's dtype with the fp32 final state, which the
decode cache needs.  A per-dim la (B, S, H, K) is clamped to
[LOG_A_MIN, 0] (RWKV6); a per-head la (B, S, H), one log-decay a head
(Mamba2), is taken as it is, without the clamp, as the reference's
per-head model path takes it.  CUDA tensors launch the kernel in
``csrc/linear_scan.cu``, which reads every input through its strides and
indexes u by head.  bf16 q/k/v take the tensor-core route, whose 16-byte
asynchronous copies need every row of q, k, v and la 16-byte aligned and
K, V multiples of 8: ``kernel_operands`` zero-pads K and V and copies a
view whose base pointer or (b, s, head) strides do not allow that to a
contiguous one; the projections of the RWKV6 layer are read in place,
and so are Mamba2's C and B broadcast over the heads (head stride 0) and
its per-head la, which the kernel reads a float at a time.
CPU tensors take the plain version in ``ref.py``.

``recurrence`` is ``LinearScan``, a ``torch.autograd.Function``: its
backward launches ``csrc/linear_scan_bwd.cu`` on CUDA tensors and
``ref.recurrence_bwd`` on CPU tensors.  Both forms, no atomics, du
summed in a fixed order.  fp32 inputs take the exact recurrence with
float64 states (a forward scan that rebuilds the state for dq, a reverse
scan of its gradient for dk, dv and the initial state's gradient, dla
from the gated-linear-attention identity).  bf16 inputs take a chunked
form on the tensor cores: the chunks' edge states from one launch of
two sweeps (fp32 scratch, 2 B H ceil(S / 32) K V floats), then a block a
chunk; as in the forward, K and V are zero-padded to multiples of 8
and a view whose rows are not 16-byte aligned is copied
(``kernel_operands``).  The backward reads q, k, v, la and dy through
their strides, so Mamba2's C and B (head stride 0) are read in place;
their gradients come back per head (B, S, H, K) and the broadcast's own
backward sums them over the heads.  Nothing else falls back: a CUDA
tensor that the kernels do not take raises, forward or backward.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch.kernels import build
from repro_torch.kernels.linear_scan import ref

# kernel launches since the last reset, forward and backward (one a
# wrapper call; a backward call is two CUDA launches, three with du, on
# either route);
# chip_smoke.py reads them to show that a run went through the kernels
launches = 0
bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 64   # largest K and V the kernel takes


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.library("linear_scan").linear_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    fn = build.library("linear_scan_bwd").linear_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def needs_copy(x, rows16: bool) -> bool:
    """Whether the kernel cannot read ``x`` (B, S, heads, n) in place: the
    last dim must be unit-stride, and on the bf16 route (``rows16``:
    16-byte cp.async rows of q, k, v and la) the base pointer and the
    (b, s, head) strides must be whole multiples of 16 bytes.  The fp32
    route reads single elements."""
    if x.stride(-1) != 1:
        return True
    if not rows16:
        return False
    esize = x.element_size()
    return x.data_ptr() % 16 != 0 or any(st * esize % 16 for st in x.stride()[:3])


def kernel_operands(q, k, v, la, u=None, initial_state=None):
    """What the kernel reads in place of (q, k, v, la, u, initial_state).
    On the bf16 route K and V are zero-padded to multiples of 8 (u, a
    per-dim la and the initial state alike): zero q, k and v entries add
    nothing to y or to the state, whose padded rows and columns stay
    zero, so the wrapper slices y and the final state back.  Then each of
    q, k, v and a per-dim la that ``needs_copy`` is copied to a contiguous
    tensor; a per-head la (B, S, H) is read a float at a time through its
    strides and never copied."""
    rows16 = v.dtype == torch.bfloat16
    per_head = la.dim() == 3
    pk, pv = (-q.shape[-1] % 8, -v.shape[-1] % 8) if rows16 else (0, 0)
    if pk or pv:
        q, k = F.pad(q, (0, pk)), F.pad(k, (0, pk))
        la = la if per_head else F.pad(la, (0, pk))
        v = F.pad(v, (0, pv))
        u = None if u is None else F.pad(u, (0, pk))
        if initial_state is not None:
            initial_state = F.pad(initial_state, (0, pv, 0, pk))
    q, k, v = (x.clone(memory_format=torch.contiguous_format) if needs_copy(x, rows16)
               else x for x in (q, k, v))
    if not per_head and needs_copy(la, rows16):
        la = la.clone(memory_format=torch.contiguous_format)
    if u is not None:
        u = u.contiguous()
    if initial_state is not None:
        initial_state = initial_state.contiguous()
    return q, k, v, la, u, initial_state


def _launch(q, k, v, la, u, include_current, initial_state):
    global launches
    if v.dtype not in _DTYPES:
        raise TypeError(f"linear_scan kernel takes float32 or bfloat16 q/k/v, got {v.dtype}")
    B, S, H, K = q.shape
    V = v.shape[-1]
    if K > MAX_DIM or V > MAX_DIM:
        raise ValueError(f"linear_scan kernel takes K, V <= {MAX_DIM}, got K={K}, V={V}")
    if max(B, H) > 65535:
        raise ValueError(f"linear_scan takes at most 65535 batch rows and heads (grid), "
                         f"got B={B}, H={H}")
    q, k, v, la, u, initial_state = kernel_operands(q, k, v, la, u, initial_state)
    Kk, Vk = q.shape[-1], v.shape[-1]
    fn = _kernel()
    with torch.cuda.device(q.device):
        y = torch.empty((B, S, H, Vk), dtype=v.dtype, device=v.device)
        state = torch.empty((B, H, Kk, Vk), dtype=torch.float32, device=v.device)
        strides = (ctypes.c_longlong * 15)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                           *la.stride()[:3], *y.stride()[:3])
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), la.data_ptr(),
                 None if u is None else u.data_ptr(),
                 None if initial_state is None else initial_state.data_ptr(),
                 y.data_ptr(), state.data_ptr(), _DTYPES[v.dtype], B, S, H, Kk, Vk,
                 int(include_current), int(la.dim() == 3), ctypes.addressof(strides),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"linear_scan kernel launch failed: CUDA error {err}")
    launches += 1
    if (Kk, Vk) != (K, V):
        return y[..., :V].contiguous(), state[:, :, :K, :V].contiguous()
    return y, state


def _launch_bwd(q, k, v, la, u, dy, d_state, include_current, initial_state):
    """The backward kernels: (dq, dk, dv in q's dtype, dla fp32 in la's
    shape, du (H, K) fp32 or None, d_initial_state fp32 or None)."""
    global bwd_launches
    if v.dtype not in _DTYPES or dy.dtype != v.dtype:
        raise TypeError(f"linear_scan backward takes float32 or bfloat16 q/k/v and dy of "
                        f"their dtype, got {v.dtype} and {dy.dtype}")
    B, S, H, K = q.shape
    V = v.shape[-1]
    if K > MAX_DIM or V > MAX_DIM:
        raise ValueError(f"linear_scan backward takes K, V <= {MAX_DIM}, got K={K}, V={V}")
    if max(B, H) > 65535:
        raise ValueError(f"linear_scan backward takes at most 65535 batch rows and heads, "
                         f"got B={B}, H={H}")
    per_head = la.dim() == 3
    bonus = not include_current
    u = u if bonus else None
    f32, f64, dev = torch.float32, torch.float64, q.device
    tc = v.dtype == torch.bfloat16            # the chunked tensor-core route
    if tc:
        q, k, v, la, u, initial_state = kernel_operands(q, k, v, la, u, initial_state)
        pv, pk = v.shape[-1] - V, q.shape[-1] - K
        if pv:
            dy = F.pad(dy, (0, pv))
        if needs_copy(dy, True):
            dy = dy.clone(memory_format=torch.contiguous_format)
        if d_state is not None and (pk or pv):
            d_state = F.pad(d_state, (0, pv, 0, pk))
    else:
        q, k, v, dy = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v, dy))
        if not per_head and la.stride(-1) != 1:
            la = la.contiguous()
        u = u.contiguous() if u is not None else None
    Kk, Vk = q.shape[-1], v.shape[-1]
    nc = -(-S // ref.CHUNK)                   # the bf16 route's chunks
    fn = _bwd_kernel()
    with torch.cuda.device(dev):
        dq = torch.empty((B, S, H, Kk), dtype=q.dtype, device=dev)
        dk = torch.empty((B, S, H, Kk), dtype=q.dtype, device=dev)
        dv = torch.empty((B, S, H, Vk), dtype=q.dtype, device=dev)
        dla = torch.empty(tuple(la.shape), dtype=f32, device=dev)
        if tc:   # fp32 scratch: each chunk's entry state and exit gradient; du's chunk partials
            xq = torch.empty((2, B, H, nc, Kk, Vk), dtype=f32, device=dev)
            xfin = None
            du_part = (torch.empty((B, H, nc, Kk), dtype=f32, device=dev)
                       if u is not None else None)
        else:    # float64 scratch: the query terms of dla between the two launches,
            # dS . S_final a row, du's (b, h) partials
            xq = torch.empty(tuple(la.shape), dtype=f64, device=dev)
            xfin = torch.empty((B, H, K), dtype=f64, device=dev)
            du_part = (torch.empty((B, H, K), dtype=f64, device=dev)
                       if u is not None else None)
        du = torch.empty((H, Kk), dtype=f32, device=dev) if u is not None else None
        ds0 = (torch.empty((B, H, Kk, Vk), dtype=f32, device=dev)
               if initial_state is not None else None)
        s0 = initial_state.contiguous() if initial_state is not None else None
        ds = d_state.to(f32).contiguous() if d_state is not None else None
        strides = (ctypes.c_longlong * 15)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                           *la.stride()[:3], *dy.stride()[:3])
        ptr = lambda x: None if x is None else x.data_ptr()
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dy.data_ptr(), la.data_ptr(),
                 ptr(u), ptr(s0), ptr(ds), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 dla.data_ptr(), xq.data_ptr(), ptr(xfin), ptr(du_part), ptr(du),
                 ptr(ds0), _DTYPES[v.dtype], B, S, H, Kk, Vk, int(include_current),
                 int(per_head), ctypes.addressof(strides),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"linear_scan backward launch failed: CUDA error {err}")
    bwd_launches += 1
    if (Kk, Vk) != (K, V):
        dq, dk, dv = (x[..., :n].contiguous() for x, n in ((dq, K), (dk, K), (dv, V)))
        dla = dla if per_head else dla[..., :K].contiguous()
        du = None if du is None else du[:, :K].contiguous()
        ds0 = None if ds0 is None else ds0[:, :, :K, :V].contiguous()
    return dq, dk, dv, dla, du, ds0


class LinearScan(torch.autograd.Function):
    """The recurrence with its gradient: the kernels on CUDA tensors, the
    plain versions on CPU tensors.  ``apply(q, k, v, la, u,
    include_current, initial_state)`` returns (y, final state)."""

    @staticmethod
    def forward(q, k, v, la, u, include_current, initial_state):
        if q.device.type == "cpu":
            return ref.recurrence(q, k, v, la, u, include_current=include_current,
                                  initial_state=initial_state)
        return _launch(q, k, v, la, u, include_current, initial_state)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, la, u, include_current, initial_state = inputs
        ctx.include_current = include_current
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, la, u, initial_state)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, d_state):
        q, k, v, la, u, initial_state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(v.shape, dtype=v.dtype, device=v.device)
        if q.device.type == "cpu":
            grads = ref.recurrence_bwd(q, k, v, la, u, dy, d_state,
                                       include_current=ctx.include_current,
                                       initial_state=initial_state)
        else:
            grads = _launch_bwd(q, k, v, la, u, dy, d_state, ctx.include_current,
                                initial_state)
        dq, dk, dv, dla, du, ds0 = grads
        if u is not None and du is None:      # u unused by the Mamba2 form
            du = torch.zeros_like(u)
        need = ctx.needs_input_grad
        return (dq if need[0] else None, dk if need[1] else None, dv if need[2] else None,
                dla.to(la.dtype) if need[3] else None,
                du.to(u.dtype) if need[4] else None, None,
                ds0.to(initial_state.dtype) if need[6] else None)


def recurrence(q, k, v, la, u=None, *, include_current: bool = True, initial_state=None):
    """Layer shapes: q, k (B,S,H,K); la (B,S,H,K) per dim, clamped, or
    (B,S,H) per head, unclamped; v (B,S,H,V); u (H,K) optional;
    initial_state (B,H,K,V).  Returns y (B,S,H,V) in v's dtype and the
    fp32 final state (B,H,K,V).  Differentiable in q, k, v, la, u and
    initial_state."""
    if (q.dim() != 4 or q.shape != k.shape or la.shape not in (q.shape, q.shape[:3])
            or v.shape[:3] != q.shape[:3]):
        raise ValueError(f"need q, k (B,S,H,K), la (B,S,H,K) or (B,S,H) and v (B,S,H,V), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(la.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, K = q.shape
    V = v.shape[-1]
    if u is not None and tuple(u.shape) != (H, K):
        raise ValueError(f"u must be (H, K) = {(H, K)}, got {tuple(u.shape)}")
    if initial_state is not None and tuple(initial_state.shape) != (B, H, K, V):
        raise ValueError(f"initial_state must be {(B, H, K, V)}, got {tuple(initial_state.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    others = [t for t in (u, initial_state) if t is not None]
    if any(t.device != q.device for t in (k, v, la, *others)):
        raise ValueError("q, k, v, la, u and initial_state must share one device")
    if q.device.type == "cuda":
        if la.dtype != torch.float32 or any(t.dtype != torch.float32 for t in others):
            raise TypeError(f"linear_scan kernel takes float32 la, u and initial_state, got "
                            f"{la.dtype}, {[t.dtype for t in others]}")
    elif q.device.type != "cpu":
        raise RuntimeError(f"linear_scan runs on CPU or CUDA tensors, not {q.device}")
    return LinearScan.apply(q, k, v, la, u, include_current, initial_state)
