"""granite-moe-3b-a800m [moe] — IBM Granite 3.0 MoE family.
[hf:ibm-granite/granite-3.0-1b-a400m-base (scaled 3b-a800m sibling)]

32L, d=1536, 24H GQA kv=8, per-expert d_ff=512, vocab=49155.
The assignment line cites both "MoE 40e" and "32 experts"; we follow the
primary config string (40 experts, top-8) and note the discrepancy here.
Granite MoE ties embeddings and uses SwiGLU experts.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite_moe_3b_a800m",
        arch_type="moe",
        num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
        head_dim=64, d_ff=512, vocab_size=49155,
        attention="gqa", rope_theta=10000.0,
        activation="silu", norm="rmsnorm", tie_embeddings=True,
        serve_window=4096,
        moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512),
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="granite_moe_3b_a800m_smoke",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=512, serve_window=64,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
    )
