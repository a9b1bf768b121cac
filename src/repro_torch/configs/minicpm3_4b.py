"""minicpm3-4b [dense/MLA] — MiniCPM3-4B. [hf:openbmb/MiniCPM3-4B]

62L, d=2560, 40H, ff=6400, vocab=73448 — Multi-head Latent Attention
(q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64).  Decode uses
the absorbed formulation: the cache stores only (kv_lora + rope) = 288
floats/token — MLA's KV-compression is what we exercise at decode_32k.
MiniCPM scaling: scale_emb=12, depth scale 1.4/sqrt(L), logits 1/(d/256).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3_4b",
        arch_type="dense",
        num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
        head_dim=96, d_ff=6400, vocab_size=73448,
        attention="mla", rope_theta=10000.0,
        activation="silu", norm="rmsnorm", tie_embeddings=True,
        scale_emb=12.0, scale_depth=1.4, logits_scale=0.1,
        serve_window=4096,
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                      qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
        source="hf:openbmb/MiniCPM3-4B (MLA)",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="minicpm3_4b_smoke",
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=48,
        d_ff=512, vocab_size=512, serve_window=64,
        mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                      qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32),
    )
