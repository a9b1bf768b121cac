"""Grouped-query attention with a KV-cache decode path.  Port of the GQA
part of ``repro.models.attention``.

Shapes: x (B, S, D); q (B, S, H, hd); k/v (B, S, KV, hd).
KV caches: {"k": (B, C, KV, hd), "v": ...} where C is the cache length
(seq_len, or the sliding window for long-context serving).

The causal self-attention of prefill and training runs through the
flash_attention kernels' autograd Function (``kernels/flash_attention/
ops.py``): on CUDA the hand-written forward kernel, and in training its
hand-written backward; on the CPU their plain versions.  Decode (one
query against the cache) has no kernel in the reference either and
stays plain PyTorch.  MLA and cross-attention wait (ROADMAP.md §1 item
11).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.models.factory import ParamFactory
from repro_torch.models.layers import apply_rope, rms_normalize

NEG_INF = -1e30


def init_attention(fac: ParamFactory, cfg):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": fac.param((d, H * hd), ("embed", "heads")),
        "wk": fac.param((d, KV * hd), ("embed", "heads")),
        "wv": fac.param((d, KV * hd), ("embed", "heads")),
        "wo": fac.param((H * hd, d), ("heads", "embed")),
    }
    if cfg.use_bias:
        p["bq"] = fac.param((H * hd,), ("heads",), init="zeros")
        p["bk"] = fac.param((KV * hd,), ("heads",), init="zeros")
        p["bv"] = fac.param((KV * hd,), ("heads",), init="zeros")
        p["bo"] = fac.param((d,), ("embed",), init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = fac.param((hd,), (None,), init="ones")
        p["k_norm"] = fac.param((hd,), (None,), init="ones")
    return p


def _project_qkv(p, cfg, x):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_normalize(q) * p["q_norm"]
        k = rms_normalize(k) * p["k_norm"]
    return q, k, v


def _out_proj(p, attn_out):
    B, S = attn_out.shape[:2]
    y = attn_out.reshape(B, S, -1) @ p["wo"]
    if "bo" in p:
        y = y + p["bo"]
    return y


def attention_forward(p, cfg, x, positions, *, window: Optional[int] = None,
                      kv_override=None, return_kv: bool = False):
    """Training/prefill causal self-attention, differentiable in ``p``
    and ``x``.

    ``positions`` (S,) are the RoPE positions and must be 0..S-1, as in
    every caller of the reference: the kernel masks by index.  The
    attention runs through ``flash.gqa_flash_attention`` on both devices:
    with grad enabled its forward keeps the logsumexp that the backward
    kernel reads, and under ``torch.no_grad`` (the serving prefill) it is
    the forward launch alone.  The reference's ``q_chunk`` (a
    memory-saving scan over query blocks) has no counterpart: neither
    kernel materialises the S x S scores.  return_kv: also return the
    post-rope (k, v), which prefill packs into the decode cache.
    """
    if kv_override is not None:
        raise NotImplementedError("cross-attention (kv_override) is not ported to "
                                  "repro_torch yet (ROADMAP.md §1 item 11)")
    if positions.dim() != 1 or positions.shape[0] != x.shape[1]:
        raise ValueError(f"positions must be (S,) = 0..{x.shape[1] - 1}, "
                         f"got shape {tuple(positions.shape)}")
    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = flash.gqa_flash_attention(q, k, v, window=window)
    y = _out_proj(p, o)
    return (y, (k, v)) if return_kv else y


def init_attn_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16, device="cpu"):
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, cache_len, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, cache_len, KV, hd), dtype=dtype, device=device),
    }


def attention_decode(p, cfg, x, cache, pos: int, *, window: Optional[int] = None):
    """Single-token decode. x (B, 1, D); pos the current index (int).

    The cache holds `cache_len` slots; with a sliding window the slot is
    pos % cache_len (rotating buffer), and positions for RoPE/masking are
    reconstructed from pos.  Returns (y, new_cache); the input cache is
    not modified.
    """
    B = x.shape[0]
    dev = x.device
    q, k, v = _project_qkv(p, cfg, x)
    pos_t = torch.full((1,), pos, dtype=torch.int32, device=dev)
    q = apply_rope(q, pos_t, cfg.rope_theta)
    k = apply_rope(k, pos_t, cfg.rope_theta)

    C = cache["k"].shape[1]
    slot = pos % C if window is not None else pos
    ck, cv = cache["k"].clone(), cache["v"].clone()
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)

    # effective absolute position of each cache slot
    idx = torch.arange(C, dtype=torch.int64, device=dev)
    if window is not None:
        # rotating buffer: slot i holds the largest t <= pos with t % C == i
        turn = (pos // C) * C + idx
        k_pos = torch.where(turn > pos, turn - C, turn)
        valid = (k_pos >= 0) & (k_pos >= pos - (window - 1)) & (k_pos <= pos)
    else:
        valid = idx <= pos

    scale = 1.0 / (cfg.head_dim ** 0.5)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // KV
    qg = q.reshape(B, KV, G, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, ck.to(q.dtype)).float() * scale
    scores = torch.where(valid[None, None, None, :], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs, cv)
    # a bf16 cache under fp32 compute: jnp promotes the product to fp32
    out = out.to(torch.promote_types(out.dtype, p["wo"].dtype))
    y = _out_proj(p, out.reshape(B, 1, H, hd))
    return y, {"k": ck, "v": cv}
