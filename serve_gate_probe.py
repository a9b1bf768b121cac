#!/usr/bin/env python3
"""Two readings behind chip_smoke.py's bf16 serving gates, on one CUDA
card, at the full width and depth chip_smoke.py serves:

1. llava_next_mistral_7b's prefix path in bf16, batch 4, 1,152 prefix
   embeddings + 2,048 tokens: a prefix prefill of n - 1 tokens and one
   decode step against the prefix prefill of all n (``_prefix_gap``), as
   served, then with decode's attention scores, probabilities and their
   product with v kept in fp32 (``attention_decode_fp32_scores``), so the
   part of the gap that decode's bf16 rounding of its scores makes shows.
2. command_r_35b's bf16 gate at 40 layers (prefill of 128 tokens against
   128 decode steps, bf16 compute and KV cache) on the weights drawn from
   each of ``SEEDS``; chip_smoke.py gates seed 0 at 2e-2 of the scale.

    python3 serve_gate_probe.py

prints one line a reading and, last, one JSON object of them all.  It
imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
from typing import Optional

import chip_smoke as cs

SEEDS = (0, 1, 2)


def attention_decode_fp32_scores(p, cfg, x, cache, pos: int, *, window: Optional[int] = None):
    """``repro_torch.models.attention.attention_decode`` with its scores,
    softmax probabilities and their product with v computed in fp32 from
    the cached k and v as stored; the projections and the cache are as
    served."""
    import torch
    from repro_torch.models import attention as attn
    B, dev = x.shape[0], x.device
    q, k, v = attn._project_qkv(p, cfg, x)
    pos_t = torch.full((1,), pos, dtype=torch.int32, device=dev)
    q = attn.apply_rope(q, pos_t, cfg.rope_theta)
    k = attn.apply_rope(k, pos_t, cfg.rope_theta)
    C = cache["k"].shape[1]
    slot = pos % C if window is not None else pos
    ck, cv = cache["k"].clone(), cache["v"].clone()
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    idx = torch.arange(C, dtype=torch.int64, device=dev)
    if window is not None:
        turn = (pos // C) * C + idx
        k_pos = torch.where(turn > pos, turn - C, turn)
        valid = (k_pos >= 0) & (k_pos >= pos - (window - 1)) & (k_pos <= pos)
    else:
        valid = idx <= pos
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qg = q.reshape(B, KV, H // KV, hd).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, ck.float()) * (1.0 / hd ** 0.5)
    scores = torch.where(valid[None, None, None, :], scores,
                         torch.full_like(scores, attn.NEG_INF))
    out = torch.einsum("bkgs,bskd->bkgd", torch.softmax(scores, dim=-1), cv.float())
    out = out.to(torch.promote_types(q.dtype, p["wo"].dtype))
    return attn._out_proj(p, out.reshape(B, 1, H, hd)), {"k": ck, "v": cv}


def prefix_readings() -> dict:
    """Reading 1, on llava's weights drawn from seed 0 in bf16 (each leaf
    cast as drawn: the served tree)."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import decoder
    from repro_torch.models.registry import get_config
    cfg = get_config("llava_next_mistral_7b")
    params = decoder.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                 dtype=getattr(torch, cfg.compute_dtype))
    prefix, tokens = cs._prefix_inputs(cfg, cs.SERVE["batch"])
    out = {}
    served = attn.attention_decode
    with torch.no_grad():
        for name, fn in (("served", served), ("fp32 scores", attention_decode_fp32_scores)):
            attn.attention_decode = fn
            try:
                err, scale = cs._prefix_gap(cfg, params, prefix, tokens)
            finally:
                attn.attention_decode = served
            out[name] = err / scale
            cs.say(f"[probe] llava_next_mistral_7b prefix path, bf16, batch "
                   f"{cs.SERVE['batch']}, {prefix.shape[1]} + {tokens.shape[1]} positions, "
                   f"decode's attention {name}: max abs diff {err:.4g} of scale {scale:.4g} "
                   f"({err / scale:.4g}; chip_smoke.py's limit for its gates 2e-2)")
    del params
    torch.cuda.empty_cache()
    return out


def command_r_readings() -> dict:
    """Reading 2: one bf16 draw of command_r_35b at a time (60.6 GB)."""
    import torch
    from repro_torch.models import decoder
    from repro_torch.models.registry import get_config
    cfg = get_config("command_r_35b").replace(compute_dtype="bfloat16")
    out = {}
    for seed in SEEDS:
        params = decoder.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                                     dtype=torch.bfloat16)
        err, scale = cs._prefill_vs_stepwise(cfg, params, "bfloat16")
        out[seed] = err / scale
        cs.say(f"[probe] command_r_35b, weights from seed {seed}, {cfg.num_layers} layers, "
               f"bfloat16 compute and KV cache: prefill of {cs.CONSISTENCY_LEN} tokens vs "
               f"{cs.CONSISTENCY_LEN} decode_step calls, max abs diff {err:.4g} of scale "
               f"{scale:.4g} ({err / scale:.4g}; limit 2e-2)")
        del params
        torch.cuda.empty_cache()
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("serve_gate_probe: no CUDA device")
    sys.path.insert(0, str(cs.ROOT / "src"))
    cs.say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip())
    res = {"llava_prefix_bf16": prefix_readings(), "command_r_bf16_by_seed": command_r_readings()}
    cs.say(json.dumps(res))


if __name__ == "__main__":
    main()
