"""Public wrappers of the topk_quant kernels.

``topk_int8_encode`` is the whole topk<r>_int8 encode on the device: the
update's leaves in, the wire planes (int32 index plane in ascending flat
index, int8 value plane) and the scale out.  On a CUDA tensor it makes
one wrapper call of the ``topk_int8_encode`` CUDA entry, which finds
the threshold and scale by radix select, quantizes and compacts (one
CUDA launch on the resident route, five on the streaming route), then
one device-to-host copy brings ``[count | idx | val | scale]`` back (a
second only when ties at the threshold keep more than k entries).  On
CPU tensors it takes ``encode_plain``: ``torch.topk`` for the threshold
and scale (``topk_threshold_scale``), the plain version in ``ref.py``,
``torch.nonzero`` for the compaction.  That is the plain version the
kernel is held against.

``topk_quant`` is the elementwise pass alone, the one-for-one
counterpart of the TPU kernel: CPU tensors take ``ref.topk_quant``,
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.topk_quant import ref

# wrapper calls that launched a kernel since the last reset: one per
# topk_quant call and one per topk_int8_encode call on CUDA (chip_smoke.py
# reads it to show that a run went through the kernels)
launches = 0

_THREADS = 256
_MAX_BLOCKS = 132 * 8     # one full wave of 256-thread blocks on an H100
# the encode's limits, as csrc/topk_quant.cu sets them (its entry point
# refuses a table or route that breaks them)
MAX_LEAVES = 64           # leaves in the kernel-parameter table; more are concatenated
RESIDENT_GROUPS = 13312   # groups of 4 elements one resident CTA stages (212,992 bytes)
MAX_CLUSTER = 8           # CTAs of a resident cluster (the portable limit)
SPREAD_GROUPS = 2048      # groups a resident CTA takes before the cluster grows (up to 4)
STREAM_BLOCK_GROUPS = 4096  # groups a streaming block covers
_STATE_WORDS = 2048 + 16  # StreamState
_scratch = {}             # device -> (out bytes, streaming scratch words), grown on demand


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


# ------------------------------------------------------------- encode ---

def leaf_table(leaves):
    """The encode's leaf table: the update's non-empty leaves in
    tree-flatten order as contiguous fp32 tensors (a leaf of another
    dtype, or a strided view, is copied; the rest are read in place),
    concatenated into one flat leaf above ``MAX_LEAVES``; and each
    leaf's first flat index, with n last."""
    flat = []
    for x in leaves:
        if x.numel():
            flat.append(x if x.dtype == torch.float32 and x.is_contiguous()
                        else x.float().contiguous())
    if len(flat) > MAX_LEAVES:
        flat = [torch.cat([x.reshape(-1) for x in flat])]
    offsets = [0]
    for x in flat:
        offsets.append(offsets[-1] + x.numel())
    return flat, offsets


def groups(numels) -> int:
    """Groups of four elements the kernel cuts the leaves into (a leaf's
    last group may be short)."""
    return sum(-(-int(n) // 4) for n in numels)


def encode_route(numels):
    """("resident", CTAs of the cluster) when the leaves' groups fit the
    shared memory of at most ``MAX_CLUSTER`` CTAs, else ("streaming",
    blocks of each of its five launches).  The cluster is the smallest
    power of two that holds the groups and, up to 4 CTAs, gives no CTA
    more than ``SPREAD_GROUPS``: one SM alone runs the select passes
    several times slower than four."""
    q = groups(numels)
    c = 1
    while c < MAX_CLUSTER and (q > c * RESIDENT_GROUPS or (c < 4 and q > c * SPREAD_GROUPS)):
        c *= 2
    if q <= c * RESIDENT_GROUPS:
        return "resident", c
    return "streaming", -(-q // STREAM_BLOCK_GROUPS)


def cuda_launches_per_encode(numels) -> int:
    """CUDA launches one encode call makes: 1 resident, 5 streaming."""
    return 1 if encode_route(numels)[0] == "resident" else 5


def encode_k(frac: float, n: int) -> int:
    """The codec's k: round(frac * n), at least 1."""
    return max(1, int(round(frac * n)))


def _planes(wire: np.ndarray, nk: int):
    """[idx int32 x nk | val int8 x nk | scale] bytes -> (idx, val, scale)."""
    return (wire[:4 * nk].view(np.int32), wire[4 * nk:5 * nk].view(np.int8),
            float(wire[5 * nk:5 * nk + 4].copy().view(np.float32)[0]))


def encode_plain(flat, k: int, seed: int):
    """The plain route over a flat update: ``torch.topk`` prologue, the
    plain quantization, ``torch.nonzero`` compaction, one host copy.
    Returns (idx int32, val int8, scale)."""
    thr, scale = topk_threshold_scale(flat, k)
    q, mask = ref.topk_quant(flat, thr, scale, seed & 0xFFFFFFFF)
    kept = torch.nonzero(mask).reshape(-1).to(torch.int32)
    wire = torch.cat([kept.view(torch.uint8), q[kept.long()].view(torch.uint8),
                      scale.reshape(1).view(torch.uint8)]).cpu().numpy()
    return _planes(wire, kept.numel())


@functools.lru_cache(maxsize=None)
def _encode_kernel():
    fn = build.library("topk_quant").topk_int8_encode
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
                   ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def candidate_capacity(n: int) -> int:
    """Keys the streaming route's first pass may gather as candidates (a
    quarter of the update); above it the later passes read the update."""
    return max(1024, n // 4)


def _scratch_for(device, n: int, blocks: int):
    """Cached per device: the output bytes (8 + 5 n) and the streaming
    route's scratch (its state, zero at rest; three words a block; the
    candidates).  One stream at a time per device uses them; each call's
    host copy ends before the next call is launched."""
    out, state = _scratch.get(device, (None, None))
    if out is None or out.numel() < 8 + 5 * n:
        out = torch.empty(8 + 5 * n, dtype=torch.uint8, device=device)
    words = _STATE_WORDS + 3 * blocks + candidate_capacity(n) if blocks else 0
    if state is None or state.numel() < words:
        state = torch.zeros(max(words, _STATE_WORDS), dtype=torch.int32, device=device)
    _scratch[device] = (out, state)
    return out, state


def _launch_encode(flat, n: int, k: int, seed: int):
    """Launch the encode over a leaf table on its device; returns the
    device bytes [count | idx | val | scale] (a cached buffer, valid until
    the next encode on the device)."""
    global launches
    fn = _encode_kernel()
    device = flat[0].device
    route, size = encode_route([x.numel() for x in flat])
    m = len(flat)
    with torch.cuda.device(device):
        out, state = _scratch_for(device, n, size if route == "streaming" else 0)
        err = fn((ctypes.c_void_p * m)(*[x.data_ptr() for x in flat]),
                 (ctypes.c_longlong * m)(*[x.numel() for x in flat]), m, k,
                 int(seed) & 0xFFFFFFFF, _INV_QMAX, size if route == "resident" else 0,
                 out.data_ptr(), state.data_ptr(), candidate_capacity(n),
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"topk_int8_encode kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _to_host(out, nbytes: int) -> np.ndarray:
    """One synchronous copy of the first ``nbytes`` device bytes into
    page-locked host memory (from torch's caching host allocator)."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    host.copy_(out[:nbytes])
    return host.numpy()


def _encode_table(leaves, frac: float):
    """(leaf table, n, k) of an update, checked."""
    flat, offsets = leaf_table(leaves)
    n = offsets[-1]
    if n == 0:
        raise ValueError("topk_int8_encode needs a non-empty update")
    if n >= 2 ** 32:
        raise ValueError(f"topk_int8 hashes a uint32 flat index; n = {n} is too large")
    device = flat[0].device
    if any(x.device != device for x in flat):
        raise ValueError("the update's leaves lie on more than one device")
    if device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"topk_int8_encode runs on CPU or CUDA tensors, not {device}")
    return flat, n, encode_k(frac, n)


def encode_on_device(leaves, frac: float, seed: int):
    """The device half of ``topk_int8_encode`` on CUDA leaves: launches
    the encode and returns (device bytes [count | idx | val | scale], k)
    without waiting for it."""
    flat, n, k = _encode_table(leaves, frac)
    if flat[0].device.type != "cuda":
        raise RuntimeError(f"encode_on_device takes CUDA tensors, not {flat[0].device}")
    return _launch_encode(flat, n, k, seed), k


def topk_int8_encode(leaves, frac: float, seed: int):
    """The topk<frac>_int8 encode of an update given as its leaves in
    tree-flatten order -> (idx int32, val int8, scale float): the flat
    indices with |x| >= thr in ascending order, their stochastic int8
    values, and the scale, bit for bit as the reference's codec."""
    flat, n, k = _encode_table(leaves, frac)
    if flat[0].device.type == "cpu":
        return encode_plain(torch.cat([x.reshape(-1) for x in flat]), k, seed)
    out = _launch_encode(flat, n, k, seed)
    # one copy of the expected k entries; a second only if ties kept more
    host = _to_host(out, 8 + 5 * k)
    nk = int(host[:4].view(np.int32)[0])
    if nk > k:
        host = _to_host(out, 8 + 5 * nk)
    return _planes(host[4:], nk)
