"""Model / run configuration system.

A single frozen dataclass family describes every architecture in the zoo
(dense, MoE, MLA, SSM, hybrid, enc-dec, VLM/audio-stub).  Architectures are
registered by module files in ``repro_torch/configs/<arch_id>.py`` which expose a
``config()`` (full production config) and ``smoke_config()`` (reduced
variant for CPU tests).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    router_aux_coef: float = 0.01
    # which layers are MoE ("all", "interleave:<n>" = every n-th layer)
    layer_pattern: str = "all"
    # FSDP-shard expert weights on d_model over "data"?  True halves memory
    # 16x but makes every expert matmul contract over a sharded dim (per-
    # layer output all-reduce).  Small expert pools (granite: 3.8 B total)
    # fit per-chip HBM unsharded on d and save ~10x cross-chip traffic.
    shard_expert_dmodel: bool = True


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style SSD block parameters."""
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 'Finch' time-mix parameters."""
    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32
    chunk: int = 128


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder tower for enc-dec models (whisper).  The conv/mel frontend is
    a stub: inputs are precomputed frame embeddings of shape
    (batch, num_frames, d_model)."""
    num_layers: int
    num_frames: int  # e.g. 1500 for whisper (30s @ 50Hz after conv stride 2)


@dataclass(frozen=True)
class FrontendConfig:
    """Stub modality frontend (vision patches / audio frames) — provides the
    number of prefix embedding positions that ``input_specs`` must feed."""
    kind: str  # "vision" | "audio"
    num_prefix_tokens: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str              # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention flavour ---
    attention: str = "gqa"      # gqa | mla | none
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None    # training-time SWA (mistral)
    serve_window: Optional[int] = None      # decode-time window for long ctx
    qk_norm: bool = False                   # qwen3-style per-head q/k RMSNorm
    use_bias: bool = False
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    activation: str = "silu"    # silu (SwiGLU) | gelu (plain FFN)
    parallel_block: bool = False            # command-r parallel attn+FFN
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # --- muP-ish scaling (MiniCPM WSD family) ---
    scale_emb: float = 1.0
    scale_depth: Optional[float] = None     # residual scale = scale_depth/sqrt(L)
    logits_scale: float = 1.0

    # --- per-layer block pattern; None => all "attn" ---
    # entries: "attn" | "mamba2" | "rwkv6" | "shared_attn"
    layer_pattern: Optional[Tuple[str, ...]] = None

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    mla: Optional[MLAConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[FrontendConfig] = None

    # vocab padding: embedding/unembed tables are padded to a multiple of
    # this so the vocab dim shards over the model axis (odd vocab sizes
    # like 49155/122753 otherwise force a replicated — 16x redundant — LM
    # head; §Perf iterations 3 and 12).  Padded logit columns are masked to
    # -inf; logits keep the padded width.  Semantics-free, so it is the
    # default; set 1 to reproduce the unpadded baseline.
    pad_vocab_to: int = 128

    # dtype policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # provenance
    source: str = ""

    # ------------------------------------------------------------------
    def padded_vocab(self) -> int:
        p = max(self.pad_vocab_to, 1)
        return ((self.vocab_size + p - 1) // p) * p

    def pattern(self) -> Tuple[str, ...]:
        if self.layer_pattern is not None:
            assert len(self.layer_pattern) == self.num_layers
            return self.layer_pattern
        return ("attn",) * self.num_layers

    def is_moe_layer(self, idx: int) -> bool:
        if self.moe is None:
            return False
        pat = self.moe.layer_pattern
        if pat == "all":
            return True
        if pat.startswith("interleave:"):
            n = int(pat.split(":")[1])
            return (idx % n) == (n - 1)
        raise ValueError(pat)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # --- parameter count (analytic, for roofline 6ND) -----------------
    def param_counts(self) -> dict:
        """Returns dict with total and active parameter counts."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        total = emb
        active = emb
        for idx, kind in enumerate(self.pattern()):
            if kind in ("attn", "shared_attn"):
                if kind == "shared_attn" and idx != self.pattern().index("shared_attn"):
                    pass  # shared weights counted once below
                else:
                    total_attn = self._attn_params()
                    total += total_attn
                active += self._attn_params()
            elif kind == "mamba2":
                p = self._mamba_params()
                total += p
                active += p
            elif kind == "rwkv6":
                p = self._rwkv_params()
                total += p
                active += p
            # MLP / MoE
            if kind in ("attn", "shared_attn", "rwkv6"):
                if self.is_moe_layer(idx):
                    m = self.moe
                    per_exp = 3 * d * m.d_ff_expert
                    total += m.num_experts * per_exp + d * m.num_experts
                    active += (m.top_k + m.num_shared_experts) * per_exp + d * m.num_experts
                elif kind != "rwkv6":  # rwkv6 has channel-mix inside block
                    n_mat = 3 if self.activation == "silu" else 2
                    p = n_mat * d * ff
                    total += p
                    active += p
        if self.encoder is not None:
            enc = self.encoder.num_layers * (self._attn_params() + (3 if self.activation == "silu" else 2) * d * ff)
            # plus cross-attention in each decoder layer
            cross = self.num_layers * self._attn_params()
            total += enc + cross
            active += enc + cross
        return {"total": int(total), "active": int(active)}

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attention == "mla":
            m = self.mla
            qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
            p = d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qk_head
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            p += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
            p += self.num_heads * m.v_head_dim * d
            return p
        hd = self.head_dim
        return d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d

    def _mamba_params(self) -> int:
        s = self.ssm
        d = self.d_model
        d_inner = s.expand * d
        nheads = d_inner // s.head_dim
        conv_dim = d_inner + 2 * s.state_dim
        return (d * (2 * d_inner + 2 * s.state_dim + nheads)  # in_proj (x,z,B,C,dt)
                + conv_dim * s.conv_width + nheads * 2        # conv + A,D
                + d_inner * d)                                # out_proj

    def _rwkv_params(self) -> int:
        d, ff = self.d_model, self.d_ff
        r = self.rwkv
        tm = 4 * d * d + d * r.decay_lora * 2 + 5 * d * r.mix_lora * 2 + d * d  # r,k,v,g,o + loras
        cm = 2 * d * ff + ff * 0  # rwkv channel mix: k: d->ff, v: ff->d, r: d->d
        cm = d * ff + ff * d + d * d
        return tm + cm


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
