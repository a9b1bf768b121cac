"""Architecture registry: maps --arch ids to config modules.  Port of
``repro.models.registry``.

``ARCH_IDS`` lists every architecture of the reference's zoo; the port
has the ones in ``PORTED`` (``repro_torch/configs/<id>.py``): minicpm_2b
trains and serves (dense MHA with muP-style scales and tied
embeddings), starcoder2_3b trains and serves, granite_moe_3b_a800m and
qwen3_moe_30b_a3b (Mixture-of-Experts, qwen3 with per-head q/k
RMSNorm) serve and train, rwkv6_3b and zamba2_7b (Mamba2 with a shared
attention block) serve and train, on the card through the linear_scan
kernel and its backward.  minicpm3_4b (Multi-head Latent Attention),
llava_next_mistral_7b (a Mistral backbone behind stub vision prefix
embeddings) and command_r_35b (parallel attention and FFN blocks)
serve; MLA trains on the CPU only (the attention backward kernel takes
no unequal q.k and v head dims).  whisper_small (an encoder-decoder
behind stub audio frame embeddings) serves, its encoder and
cross-attention through the flash_attention kernel's non-causal mode;
it trains on the CPU only (the attention backward kernel is causal
only, ROADMAP.md §1 item 11).
"""
from __future__ import annotations

import importlib

ARCH_IDS = (
    "llava_next_mistral_7b",
    "granite_moe_3b_a800m",
    "minicpm_2b",
    "starcoder2_3b",
    "command_r_35b",
    "minicpm3_4b",
    "zamba2_7b",
    "qwen3_moe_30b_a3b",
    "rwkv6_3b",
    "whisper_small",
)
PORTED = ("minicpm_2b", "starcoder2_3b", "rwkv6_3b", "zamba2_7b", "granite_moe_3b_a800m",
          "qwen3_moe_30b_a3b", "minicpm3_4b", "llava_next_mistral_7b", "command_r_35b",
          "whisper_small")


def normalize(arch: str) -> str:
    return arch.replace("-", "_")


def _module(arch: str):
    name = normalize(arch)
    if name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}; known: {', '.join(ARCH_IDS)}")
    if name not in PORTED:
        raise NotImplementedError(
            f"{name} is not ported to repro_torch yet (ROADMAP.md §1 item 11); "
            f"ported: {', '.join(PORTED)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _module(arch).config()


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()
