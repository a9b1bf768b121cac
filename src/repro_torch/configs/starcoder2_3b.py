"""starcoder2-3b [dense] — StarCoder2-3B. [arXiv:2402.19173]

30L, d=3072, 24H GQA kv=2, head_dim=128, ff=12288, vocab=49152.
StarCoder2 uses LayerNorm with biases, GELU FFN, RoPE (theta ~1e5) and a
4096-token sliding window (which also serves long_500k sub-quadratically).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2_3b",
        arch_type="dense",
        num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
        head_dim=128, d_ff=12288, vocab_size=49152,
        attention="gqa", rope_theta=1e5,
        sliding_window=4096, serve_window=4096,
        activation="gelu", norm="layernorm", use_bias=True,
        source="arXiv:2402.19173 (StarCoder2; GQA, RoPE, SWA-4096)",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="starcoder2_3b_smoke",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512, sliding_window=32, serve_window=32,
    )
