"""Basic neural-net layers: norms, RoPE, MLPs, embeddings.  Port of
``repro.models.layers``.

All layers are plain functions over parameter dicts made by a
``ParamFactory``, with the reference's names, shapes and logical axes,
so a reference tree carries over leaf for leaf.  Where the reference's
arithmetic has a convention of its own, the port spells it out:
``jnp.var`` is the population variance, ``jax.nn.gelu`` the tanh
approximation, and RoPE rotates non-interleaved halves with fp32 angles.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.factory import ParamFactory


# ---------------------------------------------------------------- norms ---

def init_norm(fac: ParamFactory, d: int, kind: str, use_bias: bool):
    p = {"scale": fac.param((d,), ("embed",), init="ones")}
    if kind == "layernorm" and use_bias:
        p["bias"] = fac.param((d,), ("embed",), init="zeros")
    return p


def apply_norm(p, x, kind: str, eps: float):
    x32 = x.float()
    if kind == "rmsnorm":
        var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps)
    elif kind == "layernorm":
        mu = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.var(x32, dim=-1, keepdim=True, correction=0)
        y = (x32 - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def rms_normalize(x, eps: float = 1e-6):
    """Scale-free RMS normalisation (used by qk-norm with its own scale)."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype)


def init_group_norm(fac: ParamFactory, heads: int, head_dim: int):
    return {"scale": fac.param((heads, head_dim), (None, None), init="ones"),
            "bias": fac.param((heads, head_dim), (None, None), init="zeros")}


def apply_group_norm(p, x, eps: float = 64e-5):
    """Per-head LayerNorm over head_dim, x: (..., H, hd). (RWKV ln_x)"""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    # the reference adds scale/bias in their own dtype (promotion), then casts
    return (y * p["scale"] + p["bias"]).to(x.dtype)


# ----------------------------------------------------------------- rope ---

def rope_angles(positions, head_dim: int, theta: float):
    """positions: (...,) int -> cos,sin of shape (..., head_dim//2)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd) (llama-style non-interleaved halves); positions (B,S) or (S,)."""
    hd = x.shape[-1]
    cos, sin = rope_angles(positions, hd, theta)  # (B,S,half) or (S,half)
    if cos.dim() == 2:  # (S, half) -> broadcast batch
        cos, sin = cos[None], sin[None]
    cos, sin = cos[..., None, :], sin[..., None, :]  # head axis
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ mlp ---

def init_mlp(fac: ParamFactory, d: int, d_ff: int, activation: str, use_bias: bool):
    p = {}
    if activation == "silu":  # SwiGLU
        p["w_gate"] = fac.param((d, d_ff), ("embed", "mlp"))
        p["w_up"] = fac.param((d, d_ff), ("embed", "mlp"))
    else:
        p["w_up"] = fac.param((d, d_ff), ("embed", "mlp"))
        if use_bias:
            p["b_up"] = fac.param((d_ff,), ("mlp",), init="zeros")
    p["w_down"] = fac.param((d_ff, d), ("mlp", "embed"))
    if use_bias:
        p["b_down"] = fac.param((d,), ("embed",), init="zeros")
    return p


def apply_mlp(p, x, activation: str):
    if activation == "silu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = x @ p["w_up"]
        if "b_up" in p:
            h = h + p["b_up"]
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    y = h @ p["w_down"]
    if "b_down" in p:
        y = y + p["b_down"]
    return y


# ----------------------------------------------------------- embeddings ---

def init_embedding(fac: ParamFactory, vocab: int, d: int):
    return {"table": fac.param((vocab, d), ("vocab", "embed"), init="normal", scale=0.02)}


def embed_tokens(p, tokens):
    return p["table"][tokens]


def unembed(p_out, x, tied_table=None):
    """Final logits projection. p_out holds 'w' unless embeddings are tied."""
    w = tied_table.T if tied_table is not None else p_out["w"]
    return x @ w


def init_unembed(fac: ParamFactory, d: int, vocab: int):
    return {"w": fac.param((d, vocab), ("embed", "vocab"), init="normal", scale=0.02)}
