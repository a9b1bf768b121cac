"""Serving entry point: batched prefill + token-by-token greedy decode.  Port
of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_3b --smoke \\
        --batch 4 --prompt-len 32 --gen 16 [--device cpu]

(``--arch`` also starcoder2_3b, minicpm_2b, zamba2_7b, the two MoE
models, granite_moe_3b_a800m and qwen3_moe_30b_a3b, minicpm3_4b (MLA),
llava_next_mistral_7b, command_r_35b and whisper_small, the
encoder-decoder.)  The device defaults to ``cuda`` and raises without a
card.  On the card the prompt's attention (zamba2_7b's shared block at
head_dim 112, MLA's at q.k 96 / v 64, and whisper's encoder and
cross-attention in the kernel's non-causal mode among it) runs through
the flash_attention kernel, and RWKV6's time-mix and Mamba2's per-head
scan through the linear_scan kernel; decode, and the MoE layers' routing
and expert products, are plain PyTorch, as in the reference.  The prompt
is tokens only, as in the reference: a VLM's prefix embeddings go
through ``make_prefill_step``'s ``batch["prefix_embeds"]``.  An
encoder-decoder's stub audio frames are drawn here as the reference
draws them, 0.02 N(0, 1) of shape (batch, num_frames, d_model) in fp32,
from ``torch.Generator(device).manual_seed(9)`` (``encoder_embeds=``
overrides them), and reach the prefill as ``batch["encoder_embeds"]``;
the prefill's time includes the encoder.  Parameters are drawn from an explicit
``torch.Generator`` in ``param_dtype``, each leaf cast to the compute
dtype as it is drawn (``decoder.init_params(dtype=)``), so no fp32 tree
is ever whole: qwen3_moe_30b_a3b's 30.5 B parameters take 61 GB in
bf16, command_r_35b's 30.3 B 60.6 GB.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import decoder
from repro_torch.models.registry import get_config, get_smoke_config


def serve(arch: str, *, smoke: bool, batch: int, prompt_len: int, gen: int,
          cache_len: int = 0, seed: int = 0, device="cuda", cfg=None, params=None,
          encoder_embeds=None, stats: dict | None = None, verbose: bool = True):
    """Greedy-decode ``gen`` tokens after a random prompt of ``prompt_len``
    tokens (``np.random.RandomState(seed)``, as the reference draws it).
    Returns the generated tokens (batch, gen) as numpy.

    ``cfg`` and ``params`` override the registry's config and the seeded
    draw (tests pass the reference's tree), ``encoder_embeds`` an
    encoder-decoder's drawn stub frames; ``stats``, if given, is filled
    with the prefill seconds, decode seconds and tokens per second (host
    clock around synchronised work) and whether every logit was finite."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve(device='cuda') needs a CUDA card; pass device='cpu' "
                           "for the plain path")
    cfg = cfg or (get_smoke_config(arch) if smoke else get_config(arch))
    if params is None:
        params = decoder.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                                     dtype=getattr(torch, cfg.compute_dtype))
    params = decoder.cast_params(cfg, params)   # once; free for a tree cast already
    cache_len = cache_len or (prompt_len + gen)
    prefill_fn = make_prefill_step(cfg, fill_cache=True, cache_len=cache_len)
    step_fn = make_serve_step(cfg)

    rng = np.random.RandomState(seed)
    prompt = rng.randint(0, cfg.vocab_size, size=(batch, prompt_len)).astype(np.int32)
    tokens = torch.from_numpy(prompt).to(device=device, dtype=torch.long)
    inputs = {"tokens": tokens}
    if cfg.encoder is not None:
        if encoder_embeds is None:
            encoder_embeds = 0.02 * torch.randn(
                (batch, cfg.encoder.num_frames, cfg.d_model),
                generator=torch.Generator(device=device).manual_seed(9), device=device)
        inputs["encoder_embeds"] = encoder_embeds.to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    logits, cache = prefill_fn(params, inputs)
    finite = torch.isfinite(logits).all()
    sync()
    t_prefill = time.perf_counter() - t0
    out = []
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for t in range(prompt_len, prompt_len + gen):
        out.append(tok[:, 0])
        logits, cache = step_fn(params, cache, tok, t)
        finite &= torch.isfinite(logits).all()
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    sync()
    t_decode = time.perf_counter() - t0 - t_prefill
    toks = torch.stack(out, dim=1).cpu().numpy() if out else np.zeros((batch, 0), np.int64)
    rate = batch * gen / max(t_decode, 1e-9)
    if stats is not None:
        stats.update(prefill_s=t_prefill, decode_s=t_decode, decode_tok_per_s=rate,
                     logits_finite=bool(finite))
    if verbose:
        print(f"prefill {batch}x{prompt_len} in {t_prefill:.2f}s; decoded "
              f"{batch}x{gen} in {t_decode:.2f}s ({rate:.1f} tok/s)")
    return toks


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="minicpm_2b, starcoder2_3b, rwkv6_3b, zamba2_7b, "
                         "granite_moe_3b_a800m, qwen3_moe_30b_a3b, minicpm3_4b, "
                         "llava_next_mistral_7b, command_r_35b or whisper_small "
                         "(the encoder-decoder, behind stub audio frames)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    toks = serve(a.arch, smoke=a.smoke, batch=a.batch, prompt_len=a.prompt_len,
                 gen=a.gen, device=a.device)
    print("sample:", toks[0][:12])


if __name__ == "__main__":
    main()
