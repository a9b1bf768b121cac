"""rwkv6-3b [ssm] — RWKV-6 'Finch' 3B. [arXiv:2404.05892]

32L, d=2560, attention-free (data-dependent decay time-mix, head_dim=64
-> 40 wkv heads), channel-mix ff=8960, vocab=65536.  The wkv state is
O(1) per token: long_500k decode runs natively.
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6_3b",
        arch_type="ssm",
        num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40,
        head_dim=64, d_ff=8960, vocab_size=65536,
        attention="none", norm="layernorm", use_bias=True,
        layer_pattern=("rwkv6",) * 32,
        rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32, chunk=32),
        source="arXiv:2404.05892 (RWKV-6 Finch: data-dependent decay)",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="rwkv6_3b_smoke",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512,
        layer_pattern=("rwkv6",) * 2,
        rwkv=RWKVConfig(head_dim=32, decay_lora=16, mix_lora=8, chunk=8),
    )
