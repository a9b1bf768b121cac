"""Grouped-query attention and Multi-head Latent Attention (MLA), each
with a KV-cache decode path.  Port of ``repro.models.attention``.

Shapes: x (B, S, D); q (B, S, H, hd); k/v (B, S, KV, hd).
KV caches: {"k": (B, C, KV, hd), "v": ...} where C is the cache length
(seq_len, or the sliding window for long-context serving).  An MLA
cache holds the compressed latent and the roped key half a position,
{"ckv": (B, C, kv_lora), "krope": (B, C, qk_rope)}, always full length.

The causal self-attention of prefill and training runs through the
flash_attention kernels' autograd Function (``kernels/flash_attention/
ops.py``): on CUDA the hand-written forward kernel, and in training its
hand-written backward; on the CPU their plain versions.  Decode (one
query against the cache) has no kernel in the reference either and
stays plain PyTorch.  MLA's prefill runs in the expanded form, q and k
at qk_nope + qk_rope = 96 and v at 64 (minicpm3_4b), through the same
kernel at its unequal head dims; its decode runs in the absorbed form
over the compressed cache, plain PyTorch as in the reference.
Whisper's encoder self-attention (``encoder_attention``) and its
cross-attention (``attention_forward(kv_override=)``: the decoder's
queries over the encoder's frames) run through the same kernel in its
non-causal mode, with no RoPE; the reference runs both through its plain
``_sdpa`` with a mask of all ones.
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


def _project_q(p, cfg, x):
    """q alone, as ``_project_qkv`` computes it (cross-attention: k and v
    come from the encoder's output).  ``_project_qkv`` keeps its own
    order of operations: the order in which autograd sums the three
    projections' gradients into x's sets the bf16 rounding of training."""
    B, S, _ = x.shape
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_normalize(q) * p["q_norm"]
    return q


def _out_proj(p, attn_out):
    B, S = attn_out.shape[:2]
    y = attn_out.reshape(B, S, -1) @ p["wo"]
    if "bo" in p:
        y = y + p["bo"]
    return y


def attention_forward(p, cfg, x, positions, *, window: Optional[int] = None,
                      kv_override=None, return_kv: bool = False):
    """Training/prefill causal self-attention, differentiable in ``p``
    and ``x``; with ``kv_override`` = (k, v), (B, Sk, KV, hd) each,
    cross-attention: q alone is projected from ``x``, no RoPE is applied
    and every query attends to all Sk keys (the kernel's non-causal
    mode); ``positions`` are then unused.  The reference also projects
    and discards k and v from ``x`` there; the port does not.

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
        k, v = kv_override
        o = flash.gqa_flash_attention(_project_q(p, cfg, x), k, v, causal=False)
        y = _out_proj(p, o)
        return (y, (k, v)) if return_kv else y
    if positions.dim() != 1 or positions.shape[0] != x.shape[1]:
        raise ValueError(f"positions must be (S,) = 0..{x.shape[1] - 1}, "
                         f"got shape {tuple(positions.shape)}")
    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = flash.gqa_flash_attention(q, k, v, window=window)
    y = _out_proj(p, o)
    return (y, (k, v)) if return_kv else y


def encoder_attention(p, cfg, x):
    """The encoder's self-attention (the reference's
    ``decoder._enc_self_attn``): every frame attends to every frame, no
    RoPE (the stub embeddings carry position), scale 1/sqrt(head_dim),
    through the kernel's non-causal mode."""
    q, k, v = _project_qkv(p, cfg, x)
    return _out_proj(p, flash.gqa_flash_attention(q, k, v, causal=False))


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


# ================================================================== MLA ===

def init_mla(fac: ParamFactory, cfg):
    d, H = cfg.d_model, cfg.num_heads
    m = cfg.mla
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": fac.param((d, m.q_lora_rank), ("embed", "qlora")),
        "q_norm": fac.param((m.q_lora_rank,), (None,), init="ones"),
        "wq_b": fac.param((m.q_lora_rank, H * qk_head), ("qlora", "heads")),
        "wkv_a": fac.param((d, m.kv_lora_rank + m.qk_rope_head_dim), ("embed", None)),
        "kv_norm": fac.param((m.kv_lora_rank,), (None,), init="ones"),
        "wkv_b": fac.param((m.kv_lora_rank, H * (m.qk_nope_head_dim + m.v_head_dim)),
                           ("kvlora", "heads")),
        "wo": fac.param((H * m.v_head_dim, d), ("heads", "embed")),
    }


def _mla_q(p, cfg, x):
    B, S, _ = x.shape
    m, H = cfg.mla, cfg.num_heads
    ql = rms_normalize(x @ p["wq_a"]) * p["q_norm"]
    q = (ql @ p["wq_b"]).reshape(B, S, H, m.qk_nope_head_dim + m.qk_rope_head_dim)
    return torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)  # q_nope, q_rope


def _mla_ckv(p, cfg, x):
    m = cfg.mla
    ckv, krope = torch.split(x @ p["wkv_a"], [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    return rms_normalize(ckv) * p["kv_norm"], krope


def mla_forward(p, cfg, x, positions, *, return_ckv: bool = False):
    """Training/prefill MLA in the expanded form: every head's k is its
    own nope part beside the one roped part broadcast over the heads, v
    its own, and the causal attention runs through
    ``flash.gqa_flash_attention`` at q and k of qk_nope + qk_rope and v of
    v_head (scale 1/sqrt(qk_nope + qk_rope), the kernel's for its q).
    ``positions`` as in ``attention_forward``.  return_ckv also returns
    the compressed (ckv, roped krope) pair that fills the decode cache."""
    if positions.dim() != 1 or positions.shape[0] != x.shape[1]:
        raise ValueError(f"positions must be (S,) = 0..{x.shape[1] - 1}, "
                         f"got shape {tuple(positions.shape)}")
    B, S, _ = x.shape
    m, H = cfg.mla, cfg.num_heads
    q_nope, q_rope = _mla_q(p, cfg, x)
    ckv, krope = _mla_ckv(p, cfg, x)
    kvb = (ckv @ p["wkv_b"]).reshape(B, S, H, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = torch.split(kvb, [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    krope = apply_rope(krope[:, :, None, :], positions, cfg.rope_theta)   # (B, S, 1, rope)
    # q and k are built once here, contiguous; v is read in place through
    # its strides (a slice of kvb: unit-stride rows at 16-byte offsets)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, krope.expand(B, S, H, m.qk_rope_head_dim)], dim=-1)
    o = flash.gqa_flash_attention(q, k, v)
    y = o.reshape(B, S, H * m.v_head_dim) @ p["wo"]
    return (y, (ckv, krope[:, :, 0, :])) if return_ckv else y


def init_mla_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16, device="cpu"):
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, cache_len, m.kv_lora_rank), dtype=dtype, device=device),
        "krope": torch.zeros((batch, cache_len, m.qk_rope_head_dim), dtype=dtype, device=device),
    }


def mla_decode(p, cfg, x, cache, pos: int):
    """Single-token MLA decode in the absorbed form: q's nope part is
    taken into the latent space through wkv_b's key half, so the scores
    and the weighted sum run over the compressed cache (kv_lora + rope a
    position, MLA's memory saving) and wkv_b's value half maps the result
    back.  x (B, 1, D); pos the current index (int).  Returns (y,
    new_cache); the input cache is not modified."""
    B = x.shape[0]
    m, H = cfg.mla, cfg.num_heads
    dev = x.device
    q_nope, q_rope = _mla_q(p, cfg, x)            # (B,1,H,nope), (B,1,H,rope)
    ckv_new, krope_new = _mla_ckv(p, cfg, x)      # (B,1,kvl), (B,1,rope)
    pos_t = torch.full((1,), pos, dtype=torch.int32, device=dev)
    q_rope = apply_rope(q_rope, pos_t, cfg.rope_theta)
    krope_new = apply_rope(krope_new[:, :, None, :], pos_t, cfg.rope_theta)[:, :, 0, :]

    ckv, krp = cache["ckv"].clone(), cache["krope"].clone()
    ckv[:, pos] = ckv_new[:, 0].to(ckv.dtype)
    krp[:, pos] = krope_new[:, 0].to(krp.dtype)

    # absorb wkv_b: its key part (kvl, H, nope) and value part (kvl, H, v)
    wkvb = p["wkv_b"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim)
    wk, wv = torch.split(wkvb, [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    qc = torch.einsum("bqhn,chn->bqhc", q_nope, wk)                 # (B,1,H,kvl)
    valid = torch.arange(ckv.shape[1], device=dev) <= pos
    scale = 1.0 / ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** 0.5)
    scores = (torch.einsum("bqhc,bsc->bhqs", qc, ckv.to(qc.dtype))
              + torch.einsum("bqhr,bsr->bhqs", q_rope, krp.to(q_rope.dtype)))
    scores = scores.float() * scale
    scores = torch.where(valid[None, None, None, :], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(ckv.dtype)
    out_c = torch.einsum("bhqs,bsc->bqhc", probs, ckv)               # (B,1,H,kvl)
    out = torch.einsum("bqhc,chv->bqhv", out_c.to(wv.dtype), wv)     # (B,1,H,v)
    y = out.reshape(B, 1, H * m.v_head_dim) @ p["wo"]
    return y, {"ckv": ckv, "krope": krp}
