"""zamba2-7b [hybrid] — Zamba2-7B: Mamba2 backbone + shared attention.
[arXiv:2411.15242]

81 blocks, d=3584, ssm_state=64; a single *shared* full-attention block
(32H, kv=32, head_dim=112) is invoked every 6th layer (13 invocations),
the rest are Mamba2 blocks.  (Zamba2's per-invocation LoRA deltas on the
shared block are omitted — simplification noted in DESIGN.md.)  Mamba2
state gives O(1) decode: long_500k runs natively sub-quadratic.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig


def _pattern(n_layers: int, period: int = 6):
    pat = []
    for i in range(n_layers):
        pat.append("shared_attn" if (i + 1) % period == 0 else "mamba2")
    return tuple(pat)


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2_7b",
        arch_type="hybrid",
        num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
        head_dim=112, d_ff=14336, vocab_size=32000,
        attention="gqa", rope_theta=10000.0,
        activation="silu", norm="rmsnorm", tie_embeddings=True,
        layer_pattern=_pattern(81),
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4),
        source="arXiv:2411.15242 (Zamba2: Mamba2 + shared attn blocks)",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="zamba2_7b_smoke",
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=512,
        layer_pattern=("mamba2", "shared_attn"),
        ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, conv_width=4, chunk=16),
    )
