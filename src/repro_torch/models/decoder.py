"""Decoder stack for training and serving: dense GQA (starcoder2,
minicpm and mistral style, with qwen3's per-head q/k RMSNorm), Multi-head
Latent Attention (MiniCPM3), Cohere's parallel attention and FFN block
(command-r), Mixture-of-Experts (granite and qwen3-moe), RWKV6, the
Mamba2 hybrid with one shared attention block (Zamba2), the
vision-language stub (LLaVA-NeXT: prefix embeddings before the tokens)
and the encoder-decoder behind a stub audio frontend (Whisper).  Port of
the ``("attn", False)``, ``("attn", True)``, ``("rwkv6", False)``,
``("mamba2", False)`` and ``("shared_attn", False)`` layer families of
``repro.models.decoder``, and of its encoder tower.

Layers are grouped into maximal runs of identical block type with
stacked parameters, as in the reference, so a reference tree carries
over leaf for leaf (``repro_torch.weights.from_jax_params``); where the
reference runs ``lax.scan`` over a group, the port loops over the layer
index.  A ``shared_attn`` layer holds its own norms and MLP and reads the
one attention block at the top level, ``params["shared_attn"]``, which
every invocation shares; each invocation keeps its own KV cache.  An MoE
layer holds ``moe`` (``models/moe.py``) in place of ``mlp`` and returns
its router's load-balance loss, which ``forward`` sums over the layers
and ``loss_fn`` adds at ``cfg.moe.router_aux_coef``.  An MLA layer
(``cfg.attention == "mla"``) holds ``attn`` from ``attention.init_mla``
and keeps a full-length compressed cache, {"ckv", "krope"}; a parallel
block (``cfg.parallel_block``) has no ``norm2`` and adds its attention
and FFN, both of the one normed input, to the residual at once.
``prefix_embeds`` (B, P, d), a stub frontend's output (vision), go
before the scaled token embeddings in ``forward``, ``prefill`` and
``loss_fn``; positions count them.  An encoder-decoder config
(``cfg.encoder``, whisper) has ``params["encoder"]`` ({"groups": one
stack of ``cfg.encoder.num_layers`` attention layers, "final_norm"}),
drawn after everything else, and each decoder layer holds ``cross_norm``
and ``cross_attn`` between its attention and ``norm2``.
``encoder_embeds`` (B, F, d), the stub audio frontend's frames, go
through the encoder (non-causal self-attention, no RoPE, no residual
scale) in ``forward``, ``loss_fn``, ``prefill`` and ``init_cache``; each
decoder layer then attends to its output through its cross-attention,
whose k and v (B, F, KV, hd) a layer prefill and ``init_cache`` keep in
``cache["cross"]`` (one stack a group) for ``decode_step``.

Public API (plain functions of (cfg, params, ...)):
  init_params(cfg, generator, dtype=None)
  forward(cfg, params, tokens, prefix_embeds=None, encoder_embeds=None,
          remat=True)                            -> logits, aux
  loss_fn(cfg, params, batch, remat=True)        -> loss, metrics
  prefill(cfg, params, tokens, cache_len, prefix_embeds=None,
          encoder_embeds=None)                   -> last logits, cache, next pos
  init_cache(cfg, params, batch, cache_len, encoder_embeds=None)
  decode_step(cfg, params, cache, token, pos)    -> logits, cache

``forward``, ``loss_fn``, ``prefill`` and ``decode_step`` take the
reference's ``moe_dispatch`` ("einsum" or "sort"; MoE layers only).
``forward`` and ``loss_fn`` are differentiable in the parameters (the
attention layer's kernels have a backward; RWKV6 and Mamba2 through
the linear_scan kernel's; MLA and whisper train on the CPU only: the
attention backward kernel takes no unequal q.k and v head dims and no
non-causal attention, and raises).
``remat`` recomputes each layer's forward in the backward
(``torch.utils.checkpoint``, non-reentrant) instead of keeping its
activations, as the reference's ``jax.checkpoint`` of the scanned layer
does; it acts only while grad is enabled and changes no number.  The
reference's ``q_chunk`` has no counterpart: the attention kernels never
materialise the scores.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import recurrence as rec
from repro_torch.models.factory import ParamFactory
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                       init_embedding, init_mlp, init_norm,
                                       init_unembed, unembed)

PORTED_TAGS = (("attn", False), ("attn", True), ("rwkv6", False), ("mamba2", False),
               ("shared_attn", False))


# ------------------------------------------------------------- grouping ---

def layer_tags(cfg):
    return tuple((kind, cfg.is_moe_layer(i)) for i, kind in enumerate(cfg.pattern()))


def layer_groups(cfg):
    """Run-length encoding of layer tags -> ((tag, count), ...)."""
    groups = []
    for t in layer_tags(cfg):
        if groups and groups[-1][0] == t:
            groups[-1][1] += 1
        else:
            groups.append([t, 1])
    return tuple((t, c) for t, c in groups)


def check_supported(cfg) -> None:
    """Raise NotImplementedError for the parts of the zoo not ported yet.
    An encoder goes with GQA attention layers in sequential blocks alone
    (whisper), where the reference runs it; an audio frontend (the stub
    of whisper's) only beside an encoder."""
    missing = [f"layer {t}" for t, _ in layer_groups(cfg) if t not in PORTED_TAGS]
    fe = cfg.frontend
    missing += [name for name, on in (
        ("encoder beside MLA, parallel blocks or layers other than attention",
         cfg.encoder is not None and (cfg.attention != "gqa" or cfg.parallel_block
                                      or any(k != "attn" for k in cfg.pattern()))),
        ("audio frontend without an encoder",
         fe is not None and fe.kind == "audio" and cfg.encoder is None),
        ("frontend", fe is not None and fe.kind not in ("vision", "audio"))) if on]
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} not ported to "
                                  f"repro_torch yet (ROADMAP.md §1 item 11)")


# ----------------------------------------------------------------- init ---

def _init_layer(fac, cfg, tag, cross: bool = False):
    """One layer's tree, drawn in the reference's order; ``cross`` adds a
    decoder layer's cross-attention (an encoder-decoder config)."""
    kind, is_moe = tag
    p = {"norm1": init_norm(fac, cfg.d_model, cfg.norm, cfg.use_bias)}
    if kind == "mamba2":
        p["mamba"] = rec.init_mamba2(fac, cfg)
        return p
    if kind == "rwkv6":
        p["tm"] = rec.init_rwkv6(fac, cfg)
        p["norm2"] = init_norm(fac, cfg.d_model, cfg.norm, cfg.use_bias)
        return p
    if kind == "attn":
        p["attn"] = attn.init_mla(fac, cfg) if cfg.attention == "mla" else \
            attn.init_attention(fac, cfg)
    if cross:
        p["cross_norm"] = init_norm(fac, cfg.d_model, cfg.norm, cfg.use_bias)
        p["cross_attn"] = attn.init_attention(fac, cfg)
    if not cfg.parallel_block:
        p["norm2"] = init_norm(fac, cfg.d_model, cfg.norm, cfg.use_bias)
    if is_moe:
        p["moe"] = moe_lib.init_moe(fac, cfg)
    else:
        p["mlp"] = init_mlp(fac, cfg.d_model, cfg.d_ff, cfg.activation, cfg.use_bias)
    return p


class _CastingFactory(ParamFactory):
    """A ``ParamFactory`` that casts each floating leaf to ``cast`` as soon
    as it is drawn: the values ``cast_params`` gives the whole draw."""

    def __init__(self, generator, dtype, cast):
        super().__init__(generator, dtype=dtype)
        self.cast = cast

    def param(self, *args, **kwargs):
        x = super().param(*args, **kwargs)
        return x.to(self.cast) if x.is_floating_point() else x


def _stack_layers(fac, cfg, tag, count, cross=False):
    """``count`` layers drawn one after another, each written into the
    stacked buffers as it comes: one layer's leaves live beside the stack."""
    leaves, treedef = tree_flatten(_init_layer(fac, cfg, tag, cross))
    stacked = [torch.empty((count,) + tuple(x.shape), dtype=x.dtype, device=x.device)
               for x in leaves]
    for i in range(count):
        if i:
            leaves = tree_leaves(_init_layer(fac, cfg, tag, cross))
        for buf, x in zip(stacked, leaves):
            buf[i] = x
        del leaves
    return tree_unflatten(treedef, stacked)


def init_params(cfg, generator: torch.Generator, dtype=None):
    """Parameter tree drawn from ``generator`` on its device, in
    ``cfg.param_dtype``; with ``dtype`` each floating leaf is cast to it
    as soon as it is drawn.  The draw order is the same either way, so
    ``init_params(cfg, gen, dtype=ct)`` equals ``cast_params`` of the
    ``param_dtype`` draw bit for bit while holding the cast tree and one
    leaf of ``param_dtype`` at a time (qwen3_moe_30b_a3b: 61 GB in bf16
    where its fp32 draw would need 122 GB)."""
    check_supported(cfg)
    pt = getattr(torch, cfg.param_dtype)
    fac = ParamFactory(generator, dtype=pt) if dtype is None else \
        _CastingFactory(generator, pt, dtype)
    cross = cfg.encoder is not None
    params = {
        "embed": init_embedding(fac, cfg.padded_vocab(), cfg.d_model),
        "groups": [_stack_layers(fac, cfg, tag, count, cross)
                   for tag, count in layer_groups(cfg)],
        "final_norm": init_norm(fac, cfg.d_model, cfg.norm, cfg.use_bias),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init_unembed(fac, cfg.d_model, cfg.padded_vocab())
    if any(k == "shared_attn" for k in cfg.pattern()):
        params["shared_attn"] = attn.init_attention(fac, cfg)
    if cross:
        params["encoder"] = {
            "groups": [_stack_layers(fac, cfg, ("attn", False), cfg.encoder.num_layers)],
            "final_norm": init_norm(fac, cfg.d_model, cfg.norm, cfg.use_bias),
        }
    return params


# -------------------------------------------------------------- forward ---

def cast_params(cfg, params):
    """The reference's ``_cast_params``: float params to the compute
    dtype.  Idempotent: a tree already in that dtype comes back as it is,
    without a copy, so a server casts once and every later call is free."""
    ct = getattr(torch, cfg.compute_dtype)
    return tree_map(lambda x: x.to(ct) if x.is_floating_point() else x, params)


def _mask_padded_vocab(cfg, logits):
    """Padded vocab columns (sharding-only rows) must never win softmax/argmax."""
    Vp, V = cfg.padded_vocab(), cfg.vocab_size
    if Vp == V:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(col < V, logits, torch.full_like(logits, -1e30))


def _residual_scale(cfg):
    if cfg.scale_depth is None:
        return 1.0
    return cfg.scale_depth / (cfg.num_layers ** 0.5)


def _layer(gp, i):
    return tree_map(lambda x: x[i], gp)


def _embed(cfg, params, tokens, prefix_embeds=None):
    """Scaled token embeddings, after ``prefix_embeds`` (B, P, d) where
    given, in the compute dtype."""
    x = embed_tokens(params["embed"], tokens) * cfg.scale_emb
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x.to(getattr(torch, cfg.compute_dtype))


def _logits(cfg, params, x):
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    tied = params["embed"]["table"] if cfg.tie_embeddings else None
    logits = unembed(params.get("unembed"), x, tied_table=tied) * cfg.logits_scale
    return _mask_padded_vocab(cfg, logits)


def _ffn(cfg, lp, h, tag, moe_dispatch):
    """The layer's MLP, or its MoE: (y, aux loss or None)."""
    if tag[1]:
        return moe_lib.moe_forward(lp["moe"], cfg, h, dispatch=moe_dispatch)
    return apply_mlp(lp["mlp"], h, cfg.activation), None


def _apply_layer(cfg, lp, shared, x, positions, tag, *, enc_out=None, window=None,
                 cache_len=None, cache_dtype=torch.bfloat16, moe_dispatch="einsum"):
    """One layer forward (training/prefill); ``shared`` is the top-level
    attention block a ``shared_attn`` layer reads, ``enc_out`` the
    encoder's output that an encoder-decoder layer's cross-attention
    reads.  Returns (x, the layer's filled decode cache with
    ``cache_len``, else None, its MoE aux loss, else None, its cross
    cache {"k", "v"} with ``cache_len`` and ``enc_out``, else None)."""
    kind, _ = tag
    rs = _residual_scale(cfg)
    if kind == "mamba2":
        h = apply_norm(lp["norm1"], x, cfg.norm, cfg.norm_eps)
        y, (conv, ssm) = rec.mamba2_forward(lp["mamba"], cfg, h)
        return x + y * rs, {"conv": conv, "ssm": ssm}, None, None
    if kind == "rwkv6":
        h = apply_norm(lp["norm1"], x, cfg.norm, cfg.norm_eps)
        y, (sh, wkv) = rec.rwkv6_time_mix(lp["tm"], cfg, h)
        x = x + y * rs
        h = apply_norm(lp["norm2"], x, cfg.norm, cfg.norm_eps)
        y, cm_sh = rec.rwkv6_channel_mix(lp["tm"], h)
        return x + y * rs, {"tm_shift": sh, "wkv": wkv, "cm_shift": cm_sh}, None, None

    h = apply_norm(lp["norm1"], x, cfg.norm, cfg.norm_eps)
    lcache = None
    if kind == "attn" and cfg.attention == "mla":
        a, (ckv, krope) = attn.mla_forward(lp["attn"], cfg, h, positions, return_ckv=True)
        if cache_len is not None:      # the compressed cache is always full length
            lcache = {"ckv": _pack_full(ckv, cache_len, cache_dtype),
                      "krope": _pack_full(krope, cache_len, cache_dtype)}
    else:
        ap = shared if kind == "shared_attn" else lp["attn"]
        a, (k, v) = attn.attention_forward(ap, cfg, h, positions, window=window, return_kv=True)
        if cache_len is not None:
            w = cfg.serve_window
            alen = min(cache_len, w) if w else cache_len
            lcache = {"k": _pack_rotating(k, alen, cache_dtype),
                      "v": _pack_rotating(v, alen, cache_dtype)}
    if cfg.parallel_block:
        y, aux = _ffn(cfg, lp, h, tag, moe_dispatch)
        return x + (a + y) * rs, lcache, aux, None
    x = x + a * rs
    cross = None
    if enc_out is not None:
        h = apply_norm(lp["cross_norm"], x, cfg.norm, cfg.norm_eps)
        kc, vc = _cross_kv(lp["cross_attn"], cfg, enc_out)
        x = x + attn.attention_forward(lp["cross_attn"], cfg, h, positions,
                                       kv_override=(kc, vc)) * rs
        if cache_len is not None:      # the reference computes these twice; once is the same
            cross = {"k": kc.to(cache_dtype), "v": vc.to(cache_dtype)}
    h = apply_norm(lp["norm2"], x, cfg.norm, cfg.norm_eps)
    y, aux = _ffn(cfg, lp, h, tag, moe_dispatch)
    return x + y * rs, lcache, aux, cross


def _cross_kv(ap, cfg, enc_out):
    """A decoder layer's cross-attention k and v, (B, F, KV, hd) each, from
    the encoder's output (B, F, d)."""
    B, F, _ = enc_out.shape
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    k = (enc_out @ ap["wk"]).reshape(B, F, KV, hd)
    v = (enc_out @ ap["wv"]).reshape(B, F, KV, hd)
    if "bk" in ap:
        k = k + ap["bk"].reshape(KV, hd)
        v = v + ap["bv"].reshape(KV, hd)
    return k, v


def _enc_layer(cfg, lp, e):
    """One encoder layer: pre-norm non-causal self-attention and MLP, no
    residual scale (the reference's ``ebody``)."""
    h = apply_norm(lp["norm1"], e, cfg.norm, cfg.norm_eps)
    e = e + attn.encoder_attention(lp["attn"], cfg, h)
    h = apply_norm(lp["norm2"], e, cfg.norm, cfg.norm_eps)
    return e + apply_mlp(lp["mlp"], h, cfg.activation)


def _encode(cfg, params, encoder_embeds, remat: bool = False):
    """The encoder tower over ``encoder_embeds`` (B, F, d), in the compute
    dtype, then its final norm: (B, F, d).  With ``remat`` and grad
    enabled each layer is checkpointed, as the decoder's are."""
    if encoder_embeds is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass encoder_embeds "
                         f"(B, {cfg.encoder.num_frames}, {cfg.d_model})")
    params = cast_params(cfg, params)
    e = encoder_embeds.to(getattr(torch, cfg.compute_dtype))
    remat = remat and torch.is_grad_enabled()
    for gp in params["encoder"]["groups"]:
        for i in range(tree_leaves(gp)[0].shape[0]):
            if remat:
                e = checkpoint(_enc_layer, cfg, _layer(gp, i), e, use_reentrant=False)
            else:
                e = _enc_layer(cfg, _layer(gp, i), e)
    return apply_norm(params["encoder"]["final_norm"], e, cfg.norm, cfg.norm_eps)


def _train_layer(cfg, tag, moe_dispatch, lp, shared, x, positions, enc_out):
    x, _, aux, _ = _apply_layer(cfg, lp, shared, x, positions, tag, enc_out=enc_out,
                                window=cfg.sliding_window, moe_dispatch=moe_dispatch)
    return x, aux


def forward(cfg, params, tokens, *, prefix_embeds=None, encoder_embeds=None,
            moe_dispatch: str = "einsum", remat: bool = True):
    """tokens (B, S); ``prefix_embeds`` (B, P, d) go before them (the VLM
    stub); ``encoder_embeds`` (B, F, d) feed the encoder tower of an
    encoder-decoder config (the audio stub).  Returns (logits (B, P + S,
    V), the MoE layers' summed aux loss, fp32; 0 without MoE).  With
    ``remat`` and grad enabled each layer, the encoder's too, is
    checkpointed."""
    check_supported(cfg)
    params = cast_params(cfg, params)
    x = _embed(cfg, params, tokens, prefix_embeds)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    enc_out = _encode(cfg, params, encoder_embeds, remat) if cfg.encoder is not None else None
    remat = remat and torch.is_grad_enabled()
    shared = params.get("shared_attn")
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for gp, (tag, count) in zip(params["groups"], layer_groups(cfg)):
        for i in range(count):
            args = (cfg, tag, moe_dispatch, _layer(gp, i), shared, x, positions, enc_out)
            if remat:
                x, aux = checkpoint(_train_layer, *args, use_reentrant=False)
            else:
                x, aux = _train_layer(*args)
            if aux is not None:
                aux_total = aux_total + aux
    return _logits(cfg, params, x), aux_total


# ----------------------------------------------------------------- loss ---

def loss_fn(cfg, params, batch, *, moe_dispatch: str = "einsum", remat: bool = True):
    """batch: {"tokens": (B, S), "labels": (B, S) with -1 = masked,
    optionally "prefix_embeds" (B, P, d) and "encoder_embeds" (B, F, d)}.
    Mean next-token NLL over the unmasked labels, from an fp32
    ``log_softmax`` of the logits (prefix positions carry no loss), plus
    ``router_aux_coef`` times the summed aux loss for an MoE config.
    Returns (loss, {"nll", "aux"}): "nll" is the loss itself, as in the
    reference."""
    logits, aux = forward(cfg, params, batch["tokens"], prefix_embeds=batch.get("prefix_embeds"),
                          encoder_embeds=batch.get("encoder_embeds"),
                          moe_dispatch=moe_dispatch, remat=remat)
    labels = batch["labels"]
    logits = logits[:, logits.shape[1] - labels.shape[1]:]   # prefix positions carry no loss
    mask = (labels >= 0).float()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, torch.clamp_min(labels, 0).long()[..., None])[..., 0]
    loss = torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_coef * aux
    return loss, {"nll": loss, "aux": aux}


# -------------------------------------------------------------- prefill ---

def _pack_rotating(t, alen, dtype):
    """t (B, S, ...) -> rotating cache buffer (B, alen, ...): slot p%alen
    holds the latest position p (matches attention_decode's layout)."""
    B, S = t.shape[:2]
    buf = torch.zeros((B, alen) + tuple(t.shape[2:]), dtype=dtype, device=t.device)
    take = min(S, alen)
    slots = torch.arange(S - take, S, device=t.device) % alen
    buf[:, slots] = t[:, S - take:].to(dtype)
    return buf


def _pack_full(t, cache_len, dtype):
    """t (B, S, ...) -> full-length cache buffer (B, cache_len, ...) whose
    first S slots hold t (MLA's compressed cache)."""
    buf = torch.zeros((t.shape[0], cache_len) + tuple(t.shape[2:]), dtype=dtype, device=t.device)
    buf[:, :t.shape[1]] = t.to(dtype)
    return buf


def _stack_caches(layer_caches):
    return tree_map(lambda *xs: torch.stack(xs), *layer_caches)


def prefill(cfg, params, tokens, cache_len: int, *, prefix_embeds=None, encoder_embeds=None,
            cache_dtype=torch.bfloat16, moe_dispatch: str = "einsum"):
    """Batched prompt processing: one forward pass that returns
    (last_position_logits (B,1,V), filled_cache, next_pos), the same cache
    that stepping ``decode_step`` over the prompt fills.  With
    ``prefix_embeds`` (B, P, d) the prompt is those embeddings then the
    tokens, and next_pos counts both.  An encoder-decoder config runs its
    encoder over ``encoder_embeds`` (B, F, d) first and returns the cross
    caches too (``cache["cross"]``, as ``init_cache`` fills them)."""
    check_supported(cfg)
    params = cast_params(cfg, params)
    x = _embed(cfg, params, tokens, prefix_embeds)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    enc_out = _encode(cfg, params, encoder_embeds) if cfg.encoder is not None else None
    shared = params.get("shared_attn")
    caches, crosses = [], []
    for gp, (tag, count) in zip(params["groups"], layer_groups(cfg)):
        layer_caches, layer_crosses = [], []
        for i in range(count):
            x, lc, _, cc = _apply_layer(cfg, _layer(gp, i), shared, x, positions, tag,
                                        enc_out=enc_out, window=cfg.sliding_window,
                                        cache_len=cache_len, cache_dtype=cache_dtype,
                                        moe_dispatch=moe_dispatch)
            layer_caches.append(lc)
            layer_crosses.append(cc)
        caches.append(_stack_caches(layer_caches))
        if enc_out is not None:
            crosses.append(_stack_caches(layer_crosses))
    cache = {"groups": caches}
    if enc_out is not None:
        cache["cross"] = crosses
    return _logits(cfg, params, x[:, -1:]), cache, S


# --------------------------------------------------------------- decode ---

def init_cache(cfg, params, batch: int, cache_len: int, *, encoder_embeds=None,
               dtype=torch.bfloat16, device=None):
    """Build the per-group stacked cache tree (on the parameters' device
    unless ``device`` is given).  An MLA layer's compressed cache is
    ``cache_len`` long whatever ``serve_window`` is, as in the reference.
    A Mamba2 layer's conv state is fp32
    whatever ``dtype`` is, as in the reference (its prefill returns it in
    the compute dtype, and so does its first decode step).  An
    encoder-decoder config runs its encoder over ``encoder_embeds`` (B,
    F, d) and keeps each decoder layer's cross k and v in ``dtype``
    (``cache["cross"]``, one stack a group)."""
    check_supported(cfg)
    device = device if device is not None else params["embed"]["table"].device
    window = cfg.serve_window
    alen = min(cache_len, window) if window else cache_len
    caches = []
    for (kind, _), count in layer_groups(cfg):
        if kind == "attn" and cfg.attention == "mla":
            one = attn.init_mla_cache(cfg, batch, cache_len, dtype, device=device)
        elif kind in ("attn", "shared_attn"):
            one = attn.init_attn_cache(cfg, batch, alen, dtype, device=device)
        elif kind == "mamba2":
            conv, ssm = rec.init_mamba2_state(cfg, batch, device=device)
            one = {"conv": conv, "ssm": ssm}
        else:
            s = rec.init_rwkv6_state(cfg, batch, device=device)
            one = {"tm_shift": s[0], "wkv": s[1], "cm_shift": s[2]}
        caches.append(tree_map(lambda a: torch.stack([a] * count), one))
    cache = {"groups": caches}
    if cfg.encoder is not None:
        enc_out = _encode(cfg, params, encoder_embeds)
        cache["cross"] = []
        for gp, (_, count) in zip(cast_params(cfg, params)["groups"], layer_groups(cfg)):
            kv = [_cross_kv(_layer(gp, i)["cross_attn"], cfg, enc_out) for i in range(count)]
            cache["cross"].append({"k": torch.stack([k for k, _ in kv]).to(dtype),
                                   "v": torch.stack([v for _, v in kv]).to(dtype)})
    return cache


def _decode_layer(cfg, lp, shared, x, lcache, pos, tag, moe_dispatch, cross_kv=None):
    kind, _ = tag
    rs = _residual_scale(cfg)
    if kind == "mamba2":
        h = apply_norm(lp["norm1"], x, cfg.norm, cfg.norm_eps)
        y, (cv, st) = rec.mamba2_forward(lp["mamba"], cfg, h, conv_state=lcache["conv"],
                                         ssm_state=lcache["ssm"])
        return x + y * rs, {"conv": cv, "ssm": st}
    if kind == "rwkv6":
        h = apply_norm(lp["norm1"], x, cfg.norm, cfg.norm_eps)
        y, (sh, wkv) = rec.rwkv6_time_mix(lp["tm"], cfg, h, shift_state=lcache["tm_shift"],
                                          wkv_state=lcache["wkv"])
        x = x + y * rs
        h = apply_norm(lp["norm2"], x, cfg.norm, cfg.norm_eps)
        y, cm_sh = rec.rwkv6_channel_mix(lp["tm"], h, shift_state=lcache["cm_shift"])
        return x + y * rs, {"tm_shift": sh, "wkv": wkv, "cm_shift": cm_sh}

    h = apply_norm(lp["norm1"], x, cfg.norm, cfg.norm_eps)
    if kind == "attn" and cfg.attention == "mla":
        a, new_cache = attn.mla_decode(lp["attn"], cfg, h, lcache, pos)
    else:
        ap = shared if kind == "shared_attn" else lp["attn"]
        a, new_cache = attn.attention_decode(ap, cfg, h, lcache, pos, window=cfg.serve_window)
    if cfg.parallel_block:
        y, _ = _ffn(cfg, lp, h, tag, moe_dispatch)
        return x + (a + y) * rs, new_cache
    x = x + a * rs
    if cross_kv is not None:
        h = apply_norm(lp["cross_norm"], x, cfg.norm, cfg.norm_eps)
        x = x + _cross_decode(lp["cross_attn"], cfg, h, cross_kv) * rs
    h = apply_norm(lp["norm2"], x, cfg.norm, cfg.norm_eps)
    y, _ = _ffn(cfg, lp, h, tag, moe_dispatch)
    return x + y * rs, new_cache


def _cross_decode(ap, cfg, x, cross_kv):
    """One token's cross-attention over the layer's cross cache {"k", "v"}
    (B, F, KV, hd), plain PyTorch with fp32 scores, as the reference's
    (which projects q without qk-norm here)."""
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ ap["wq"]).reshape(B, 1, H, hd)
    if "bq" in ap:
        q = q + ap["bq"].reshape(H, hd)
    k, v = cross_kv["k"], cross_kv["v"]
    qg = q.reshape(B, KV, H // KV, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.to(q.dtype)).float() * (1.0 / hd ** 0.5)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v)
    # a bf16 cache under fp32 compute: jnp promotes the product to fp32
    out = out.to(torch.promote_types(out.dtype, ap["wo"].dtype))
    return attn._out_proj(ap, out.reshape(B, 1, H, hd))


def decode_step(cfg, params, cache, token, pos: int, *, moe_dispatch: str = "einsum"):
    """token (B, 1) int; pos the token's position (int).  Returns
    (logits (B,1,V), new cache); the input cache is not modified.  An MoE
    layer routes the step's B tokens as one group (capacity B: nothing
    drops) and runs every expert over its B slots, as the reference does."""
    check_supported(cfg)
    params = cast_params(cfg, params)
    x = _embed(cfg, params, token)
    shared = params.get("shared_attn")
    new_groups = []
    cross = cache.get("cross")
    for gi, (gp, (tag, count)) in enumerate(zip(params["groups"], layer_groups(cfg))):
        gc = cache["groups"][gi]
        layer_caches = []
        for i in range(count):
            x, nc = _decode_layer(cfg, _layer(gp, i), shared, x, _layer(gc, i), pos, tag,
                                  moe_dispatch,
                                  cross_kv=None if cross is None else _layer(cross[gi], i))
            layer_caches.append(nc)
        new_groups.append(_stack_caches(layer_caches))
    new_cache = dict(cache)
    new_cache["groups"] = new_groups
    return _logits(cfg, params, x), new_cache
