"""qwen3-moe-30b-a3b [moe] — Qwen3-30B-A3B. [hf:Qwen/Qwen3-30B-A3B]

48L, d=2048, 32H GQA kv=4, head_dim=128, 128 experts top-8 with per-expert
d_ff=768, vocab=151936.  Qwen3 uses per-head q/k RMSNorm (qk_norm) and no
shared expert.  Expert-parallel sharding over the model axis is the main
distribution feature this arch exercises.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3_moe_30b_a3b",
        arch_type="moe",
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
        head_dim=128, d_ff=768, vocab_size=151936,
        attention="gqa", rope_theta=1e6, qk_norm=True,
        activation="silu", norm="rmsnorm",
        serve_window=4096,
        moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
        source="hf:Qwen/Qwen3-30B-A3B (128 experts top-8)",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="qwen3_moe_30b_a3b_smoke",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=512, serve_window=64,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
    )
