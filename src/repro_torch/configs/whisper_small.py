"""whisper-small [audio] — Whisper-small enc-dec. [arXiv:2212.04356]

12L encoder + 12L decoder, d=768, 12H MHA, ff=3072, vocab=51865, GELU,
LayerNorm+bias.  The mel-spectrogram + conv frontend is a stub: callers
pass precomputed frame embeddings as ``encoder_embeds`` (1500 frames =
30 s).  Deviation, as in the reference: the decoder uses RoPE instead of
Whisper's learned positional embedding, so decode cache positions are
well-defined.  Whisper's decoder takes at most 448 positions; its
previous-text prompt is at most about half of them.
"""
from repro_torch.configs.base import EncoderConfig, FrontendConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper_small",
        arch_type="audio",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
        head_dim=64, d_ff=3072, vocab_size=51865,
        attention="gqa", rope_theta=10000.0,
        activation="gelu", norm="layernorm", use_bias=True,
        encoder=EncoderConfig(num_layers=12, num_frames=1500),
        frontend=FrontendConfig(kind="audio", num_prefix_tokens=0),
        source="arXiv:2212.04356 (Whisper; enc-dec, conv frontend stubbed)",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="whisper_small_smoke",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512,
        encoder=EncoderConfig(num_layers=2, num_frames=16),
    )
