"""Step functions that the serving entry point runs.  Port of the serving
part of ``repro.launch.steps``.

  make_prefill_step — batched prompt pass: last-position logits (and,
      with ``fill_cache``, the filled decode cache)
  make_serve_step   — one decode token against the KV/state cache

The training steps (``make_train_step``, ``make_fl_train_step``) wait
for the optimisers and a backward of the kernels (ROADMAP.md §1 item 11).
"""
from __future__ import annotations

import torch

from repro_torch.models import decoder


def make_prefill_step(cfg, *, fill_cache: bool = False, cache_len: int = 0):
    """fill_cache=True runs the serving prefill (returns the filled decode
    cache alongside the last-position logits)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        if fill_cache:
            logits, cache, _ = decoder.prefill(cfg, params, batch["tokens"], cache_len)
            return logits, cache
        logits, _ = decoder.forward(cfg, params, batch["tokens"])
        return logits[:, -1]
    return prefill_step


def make_serve_step(cfg):
    @torch.no_grad()
    def serve_step(params, cache, token, pos: int):
        return decoder.decode_step(cfg, params, cache, token, pos)
    return serve_step
