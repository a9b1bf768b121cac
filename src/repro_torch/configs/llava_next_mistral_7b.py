"""llava-next-mistral-7b [vlm] — LLaVA-NeXT with Mistral-7B backbone.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]

The ViT/SigLIP vision tower + projector are stubs: the caller feeds
precomputed patch embeddings as ``prefix_embeds`` (anyres tiling: base
576 + one 576-patch tile = 1152 prefix tokens).  The language
backbone (Mistral-7B: 32L, d=4096, 32H GQA kv=8, ff=14336, vocab=32000)
is fully implemented.  Long-context serving uses Mistral's sliding window
(4096), which is what makes long_500k sub-quadratic for this arch.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava_next_mistral_7b",
        arch_type="vlm",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=32000,
        attention="gqa", rope_theta=1e6,
        sliding_window=None, serve_window=4096,
        activation="silu", norm="rmsnorm",
        frontend=FrontendConfig(kind="vision", num_prefix_tokens=1152),
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf (anyres tiling)",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="llava_next_mistral_7b_smoke",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512, serve_window=64,
        frontend=FrontendConfig(kind="vision", num_prefix_tokens=16),
    )
