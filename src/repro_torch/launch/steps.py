"""Step functions that the training and serving entry points run.  Port
of ``repro.launch.steps``.

  make_train_step    — loss + grad + clip + AdamW update
  make_prefill_step  — batched prompt pass: last-position logits (and,
      with ``fill_cache``, the filled decode cache)
  make_serve_step    — one decode token against the KV/state cache
  make_fl_train_step — the paper's technique across silos: per-silo
      gradients, per-silo Eq. 1 communication values, the algorithm's
      stacked gate (Eq. 2 for vafl) and a masked cross-silo aggregation.

The reference lowers these under ``jit`` over a device mesh; here they
run eagerly on one device.  Its vmap over silos becomes a Python loop
over the pods on the one card (``torch.func`` transforms do not compose
with the layers' checkpointing), its ``lax.scan`` over local steps a
loop, and the per-silo value is one launch of the grad_diff_norm kernel
over the stacked (P, ...) gradients (``kernels/grad_diff_norm``).  The
gradients of the attention layers come from the flash_attention backward
kernel on the card (head_dim 112, zamba2_7b's shared attention,
included), those of the RWKV6 and Mamba2 recurrences from the
linear_scan backward kernel; every ported config serves, and every one
but minicpm3_4b and whisper_small (whose attention backwards the kernel
does not take) trains on the card.
Each step takes the reference's
``moe_dispatch`` ("einsum" or "sort") for the MoE configs; its
``q_chunk`` has no counterpart (``models/decoder``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.algorithms.registry import get_algorithm
from repro_torch.common.pytree import (tree_flatten, tree_leaves, tree_map, tree_sq_norm,
                                       tree_stack, tree_unflatten)
from repro_torch.core.config import FLRunConfig
from repro_torch.core.value import amplifier, stacked_sq_norms
from repro_torch.kernels.grad_diff_norm.ops import tree_grad_diff_sq_norm
from repro_torch.models import decoder
from repro_torch.optim import adamw, apply_updates, clip_by_global_norm


def value_and_grad(loss_fn, params, *args):
    """(loss, gradient tree) of ``loss_fn(params, *args) -> (loss, aux)``
    at ``params``, whose leaves need not require grad; both detached."""
    leaves, treedef = tree_flatten(params)
    req = [x.detach().requires_grad_(True) for x in leaves]
    loss, _ = loss_fn(tree_unflatten(treedef, req), *args)
    grads = torch.autograd.grad(loss, req)
    return loss.detach(), tree_unflatten(treedef, list(grads))


def make_train_step(cfg, *, lr: float = 3e-4, moe_dispatch: str = "einsum", remat: bool = True,
                    grad_clip: float = 1.0):
    """Returns (train_step, opt_init):
    ``train_step(params, opt_state, batch, step) -> (params, opt_state,
    {"loss", "grad_norm"})`` with batch {"tokens", "labels"} (B, S)."""
    opt_init, opt_update = adamw(lr, weight_decay=0.01)

    def lossf(p, batch):
        return decoder.loss_fn(cfg, p, batch, moe_dispatch=moe_dispatch, remat=remat)

    def train_step(params, opt_state, batch, step):
        loss, grads = value_and_grad(lossf, params, batch)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        updates, opt_state = opt_update(grads, opt_state, params, step)
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step, opt_init


def make_prefill_step(cfg, *, moe_dispatch: str = "einsum", fill_cache: bool = False,
                      cache_len: int = 0):
    """fill_cache=True runs the serving prefill (returns the filled decode
    cache alongside the last-position logits).  ``batch["prefix_embeds"]``
    (B, P, d), where present, goes before the tokens (the VLM stub); the
    next decode position is then P + the tokens' length.
    ``batch["encoder_embeds"]`` (B, F, d) feed an encoder-decoder config's
    encoder (the audio stub); the filled cache then holds the decoder
    layers' cross k and v."""
    @torch.no_grad()
    def prefill_step(params, batch):
        kw = dict(prefix_embeds=batch.get("prefix_embeds"),
                  encoder_embeds=batch.get("encoder_embeds"), moe_dispatch=moe_dispatch)
        if fill_cache:
            logits, cache, _ = decoder.prefill(cfg, params, batch["tokens"], cache_len, **kw)
            return logits, cache
        logits, _ = decoder.forward(cfg, params, batch["tokens"], **kw)
        return logits[:, -1]
    return prefill_step


def make_serve_step(cfg, *, moe_dispatch: str = "einsum"):
    @torch.no_grad()
    def serve_step(params, cache, token, pos: int):
        return decoder.decode_step(cfg, params, cache, token, pos, moe_dispatch=moe_dispatch)
    return serve_step


# ------------------------------------------------------ FL across silos ---

def make_fl_train_step(cfg, *, n_pods: int, lr: float = 3e-4, moe_dispatch: str = "einsum",
                       algorithm: str = "vafl", local_steps: int = 1, local_lr: float = 1e-2,
                       comm_dtype=None):
    """Cross-silo VAFL train step.

    batch leaves have a leading pod axis (n_pods, B_pod, ...); params are
    one tree, shared by the pods.  Per step:

      1. per-pod gradients, one pod after another,
      2. per-pod V = ||g_prev - g||^2 * (1+P/1e3)^acc  (Eq. 1; acc proxied
         by the pod's negative loss -> exp(-loss) in [0,1]), the norms in
         one grad_diff_norm launch over the stacked (P, ...) gradients,
      3. the algorithm's gate (vafl: Eq. 2, mask = V >= mean(V)), falling
         back to the strongest pod when it selects none,
      4. masked weighted average of the pods' gradients,
      5. global-norm clip to 1 and AdamW with the aggregated gradient.

    Returns (fl_train_step, opt_init) with ``fl_train_step(params,
    opt_state, prev_grads, batch, step) -> (params, opt_state, grads,
    info)``: ``grads`` the stacked (P, ...) gradients, the next step's
    ``prev_grads``; info {"loss", "V", "mask", "grad_norm"}.
    ``algorithm`` is any registered name; its ``gate_stacked`` decides
    (afl / fedavg / fedasync: the ungated mean, vafl: Eq. 2, eaflm: Eq. 3
    against the previous step's mean gradient scaled by the server lr).

    local_steps > 1 (the paper's r local rounds): each silo takes
    ``local_steps`` local SGD steps on its own microbatches before the
    gated sync and contributes the *effective gradient*
    (theta_start - theta_end)/local_lr; batch leaves are then
    (P, local_steps, B, ...).  comm_dtype (e.g. torch.bfloat16) casts the
    aggregated payload.
    """
    opt_init, opt_update = adamw(lr, weight_decay=0.01)
    # resolve the algorithm up front: a typo'd name fails here with the
    # registered set in the message
    policy = get_algorithm(algorithm).make_policy(FLRunConfig(algorithm=algorithm))

    def lossf(p, batch):
        return decoder.loss_fn(cfg, p, batch, moe_dispatch=moe_dispatch)

    def pod_grad(p, pod_batch):
        """One silo's contribution: plain grad, or the effective gradient
        of ``local_steps`` local SGD steps (pod_batch leading dim = step)."""
        if local_steps == 1:
            return value_and_grad(lossf, p, pod_batch)
        pp, losses = p, []
        for s in range(local_steps):
            loss, g = value_and_grad(lossf, pp, tree_map(lambda x: x[s], pod_batch))
            pp = tree_map(lambda x, gg: (x.float() - local_lr * gg.float()).to(x.dtype), pp, g)
            losses.append(loss)
        eff = tree_map(lambda a, b: (a.float() - b.float()) / local_lr, p, pp)
        return torch.mean(torch.stack(losses)), eff

    def fl_train_step(params, opt_state, prev_grads, batch, step):
        # 1. per-pod (effective) grads, stacked: leading axis = pod
        per_pod = [pod_grad(params, tree_map(lambda x: x[i], batch)) for i in range(n_pods)]
        losses = torch.stack([loss for loss, _ in per_pod])
        grads = tree_stack([g for _, g in per_pod])
        del per_pod
        if comm_dtype is not None:
            grads = tree_map(lambda g: g.to(comm_dtype), grads)

        # 2. Eq. 1 per pod: one kernel launch over the stacked trees
        prev, cur = prev_grads, grads
        if tree_leaves(prev)[0].dtype != tree_leaves(cur)[0].dtype:   # fp32 zeros, comm_dtype
            prev, cur = (tree_map(lambda x: x.float(), t) for t in (prev, cur))
        diffs = tree_grad_diff_sq_norm(prev, cur)
        accs = torch.exp(-losses.float())                   # proxy Acc in [0, 1]
        V = diffs * amplifier(n_pods, accs, diffs.device)

        # 3. + 4. the algorithm's gate and the masked aggregation; inputs
        # it did not declare are never computed
        sq_norms = stacked_sq_norms(grads) if policy.needs_norms else None
        delta_sq = (torch.tensor(np.float32(lr * lr), device=V.device) * tree_sq_norm(
            tree_map(lambda g: torch.mean(g, 0), prev_grads)) if policy.needs_norms else None)
        mask = policy.gate_stacked(values=V, sq_norms=sq_norms, server_delta_sq=delta_sq)
        if policy.needs_norms or policy.needs_values:
            # a gate that suppresses every silo falls back to the strongest
            # one: otherwise AdamW would still move the params (decoupled
            # weight decay, stale momentum) on a zero aggregated gradient
            ref = sq_norms if sq_norms is not None else V
            fallback = (ref == torch.max(ref)).float()
            mask = torch.where(torch.sum(mask) > 0.0, mask, fallback)
        w = mask / torch.clamp_min(torch.sum(mask), 1.0)

        def agg(leaf):   # (P, ...) -> (...)
            return torch.sum(leaf.float() * w.reshape((-1,) + (1,) * (leaf.dim() - 1)), 0)

        agg_grads = tree_map(agg, grads)

        # 5. optimizer
        agg_grads, gnorm = clip_by_global_norm(agg_grads, 1.0)
        updates, opt_state = opt_update(agg_grads, opt_state, params, step)
        params = apply_updates(params, updates)
        info = {"loss": torch.mean(losses), "V": V, "mask": mask, "grad_norm": gnorm}
        return params, opt_state, grads, info

    return fl_train_step, opt_init
