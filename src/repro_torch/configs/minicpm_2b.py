"""minicpm-2b [dense] — MiniCPM-2B with WSD schedule. [arXiv:2404.06395]

40L, d=2304, 36H MHA (kv=36), head_dim=64, ff=5760, vocab=122753.
MiniCPM's muP-style scaling: scale_emb=12, residual depth scale
1.4/sqrt(L), logits scaled by 1/(d/256)=1/9; tied embeddings.
The WSD (warmup-stable-decay) schedule lives in repro_torch.optim.schedules
and is selected by this arch's training recipe.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm_2b",
        arch_type="dense",
        num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
        head_dim=64, d_ff=5760, vocab_size=122753,
        attention="gqa", rope_theta=10000.0,
        activation="silu", norm="rmsnorm", tie_embeddings=True,
        scale_emb=12.0, scale_depth=1.4, logits_scale=1.0 / 9.0,
        serve_window=4096,
        source="arXiv:2404.06395 (MiniCPM; WSD schedule)",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="minicpm_2b_smoke",
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=512, serve_window=64,
    )
