"""Training entry point.  Port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b --smoke \\
        --steps 20 --batch 8 --seq 128 [--device cpu] [--ckpt-dir DIR]

The device defaults to ``cuda`` and raises without a card.  Parameters
are drawn from ``torch.Generator(device).manual_seed(0)`` in
``param_dtype``; the data is ``token_stream`` (seed 1), as in the
reference.  Each step is ``make_train_step``: the decoder's LM loss with
each layer checkpointed, its gradient, a global-norm clip and AdamW.
Every ported architecture trains on the card: the attention layers
(minicpm_2b, starcoder2_3b, the MoE models and zamba2_7b's shared
attention at head_dim 112) through the flash_attention forward and
backward kernels, RWKV6 (rwkv6_3b) and Mamba2 (zamba2_7b) through the
linear_scan forward and backward kernels, and the MoE models
(granite_moe_3b_a800m, qwen3_moe_30b_a3b) through the default "einsum"
dispatch, whose scatter and gather are plain PyTorch.  The reference's
production mesh (``--mesh prod``) has no counterpart: the port trains
on one device.
``--ckpt-dir`` saves the final parameters through
``repro_torch.checkpoint.save``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import save
from repro_torch.data.synthetic import token_stream
from repro_torch.launch.steps import make_train_step
from repro_torch.models import decoder
from repro_torch.models.registry import get_config, get_smoke_config


def run(arch: str, *, smoke: bool, steps: int, batch: int, seq: int, lr: float,
        ckpt_dir=None, log_every: int = 5, device="cuda", verbose: bool = True):
    """Train ``steps`` steps; returns the losses (floats)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train(device='cuda') needs a CUDA card; pass device='cpu' "
                           "to train on the host")
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    step_fn, opt_init = make_train_step(cfg, lr=lr)
    params = decoder.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    opt_state = opt_init(params)

    toks, labs = token_stream(max(steps * batch, batch), seq, cfg.vocab_size, seed=1)
    toks = torch.from_numpy(toks).long().to(device)
    labs = torch.from_numpy(labs).long().to(device)
    losses = []
    t0 = time.perf_counter()
    for s in range(steps):
        lo = (s * batch) % (len(toks) - batch + 1)
        b = {"tokens": toks[lo:lo + batch], "labels": labs[lo:lo + batch]}
        params, opt_state, info = step_fn(params, opt_state, b, s)
        losses.append(float(info["loss"]))
        if verbose and (s + 1) % log_every == 0:
            print(f"step {s+1:4d} loss={losses[-1]:.4f} "
                  f"({(time.perf_counter()-t0)/(s+1):.2f}s/step)")
    if ckpt_dir:
        save(ckpt_dir, steps, params, {"arch": cfg.name, "loss": losses[-1]})
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args()
    losses = run(a.arch, smoke=a.smoke, steps=a.steps, batch=a.batch, seq=a.seq,
                 lr=a.lr, ckpt_dir=a.ckpt_dir, device=a.device)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
