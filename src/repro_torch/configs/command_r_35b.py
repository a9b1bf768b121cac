"""command-r-35b [dense] — Cohere Command-R. [hf:CohereForAI/c4ai-command-r-v01]

40L, d=8192, 64H GQA kv=8, head_dim=128, ff=22528, vocab=256000.
Cohere block: *parallel* attention+FFN residual, bias-free LayerNorm,
tied embeddings, logit scale 0.0625, rope theta 8e6.  Full attention —
long contexts are served with the sliding-window serve variant (window
4096).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command_r_35b",
        arch_type="dense",
        num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=22528, vocab_size=256000,
        attention="gqa", rope_theta=8e6,
        activation="silu", norm="layernorm", use_bias=False,
        parallel_block=True, tie_embeddings=True, logits_scale=0.0625,
        serve_window=4096,
        source="hf:CohereForAI/c4ai-command-r-v01 (GQA, no-bias, parallel block)",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="command_r_35b_smoke",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512, serve_window=64,
    )
