"""Plain PyTorch version of the flash_attention kernel: the path taken on
CPU tensors, and what ``chip_smoke.py`` holds the kernel against on the
card.  It computes what ``repro.kernels.flash_attention.ref.attention``
computes (causal softmax attention in fp32, scale ``1/sqrt(D)``, masked
scores at -1e30, an optional sliding window ``q - k < window``), on the
model layer's layout: q (B, S, H, hd) and k, v (B, S, KV, hd), query head
h reading kv head ``h // (H // KV)``.  v may be narrower than q and k
(MLA: q.k head dim 96, v 64); the scale stays ``1/sqrt`` of q's.  With
``causal=False`` nothing is masked and k and v may hold another number
of positions Sk than q's Sq: the reference's ``_sdpa`` with a mask of all
ones (whisper's encoder self-attention and its cross-attention over the
encoder's frames).  ``gqa_attention_bwd`` is its gradient by autograd,
the plain version of the backward kernel."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention(q, k, v, window=None, causal=True):
    """q (BH, Sq, D), k (BH, Sk, D), v (BH, Sk, Dv) -> (BH, Sq, Dv) in q's
    dtype; causal (Sq = Sk; an optional sliding window), or with
    ``causal=False`` over every key."""
    D = q.shape[2]
    scale = 1.0 / (D ** 0.5)
    ct = torch.promote_types(q.dtype, torch.float32)   # fp32, or fp64 for gradcheck
    s = torch.einsum("bqd,bkd->bqk", q.to(ct), k.to(ct)) * scale
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = qpos >= kpos
        if window is not None:
            mask &= (qpos - kpos) < window
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(ct)).to(q.dtype)


def gqa_attention(q, k, v, window=None, causal=True):
    """q (B,Sq,H,hd), k (B,Sk,KV,hd), v (B,Sk,KV,dv) -> (B,Sq,H,dv); causal
    (Sq = Sk), or over every key with ``causal=False``."""
    B, _, H, _ = q.shape
    G = H // k.shape[2]
    kq = torch.repeat_interleave(k, G, dim=2)
    vq = torch.repeat_interleave(v, G, dim=2)

    def to_bh(x):
        return x.permute(0, 2, 1, 3).reshape(B * H, x.shape[1], x.shape[-1])

    o = attention(to_bh(q), to_bh(kq), to_bh(vq), window=window, causal=causal)
    return o.reshape(B, H, q.shape[1], v.shape[-1]).permute(0, 2, 1, 3)


def gqa_attention_bwd(q, k, v, do, window=None, causal=True):
    """Gradients (dq, dk, dv) of ``gqa_attention`` against the output
    gradient ``do``, by autograd through it, in the inputs' dtypes."""
    with torch.enable_grad():
        qkv = [x.detach().requires_grad_(True) for x in (q, k, v)]
        o = gqa_attention(*qkv, window=window, causal=causal)
        return torch.autograd.grad(o, qkv, do)
