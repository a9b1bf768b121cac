"""Mixture-of-Experts layer: top-k softmax router + expert FFNs.  Port of
``repro.models.moe``.

Both dispatches of the reference, selected per call (``dispatch=``):

* ``einsum`` — the reference's GShard/Switch capacity dispatch.  Tokens
  go in groups of ``group``; each (token, choice) pair takes the next
  slot of its expert's queue, and pairs beyond the capacity C are
  dropped.  The reference builds one-hot (g, k, E, C) dispatch and
  combine tensors and contracts them with the activations.  Each slot
  holds one token or zeros, so the port computes the same function by
  index: a kept pair's token row is added into its (expert, slot) row of
  a zero buffer, and a token sums its kept pairs' expert outputs times
  their weights (fp32 products and sum, rounded once, as the
  contraction accumulates).  At qwen3_moe_30b_a3b's width the one-hot
  dispatch tensor alone would hold 2.7 GB a layer in bf16, and its two
  contractions would cost more operations than the experts.
* ``sort`` — the reference's group-local stable argsort by expert id,
  scatter into the buffer and back, ported as written; a token's k
  contributions are summed in choice order (the reference scatter-adds
  them), which keeps the card's result free of atomics' order.

Both drop the same pairs: a pair's slot is its position in the cumsum
over the group's flattened (token, choice) order, so earlier tokens win
and choice 0 comes before choice 1; a dropped pair adds zeros.  The
router's product runs in IEEE fp32 on the card (``common/fp32.ieee``)
whatever the process-wide TF32 setting, so expert choices do not hang on
it, and top-k breaks ties toward the lower expert id, as ``lax.top_k``
does.  The expert products are ``torch.bmm`` over the experts, the
groups folded into the slots (the reference vmaps its group-local
products over the groups).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common import fp32
from repro_torch.models.factory import ParamFactory


def init_moe(fac: ParamFactory, cfg):
    d, m = cfg.d_model, cfg.moe
    E, f = m.num_experts, m.d_ff_expert
    d_ax = "embed" if m.shard_expert_dmodel else None
    p = {
        "router": fac.param((d, E), ("embed", None), init="normal", scale=0.02),
        "w_gate": fac.param((E, d, f), ("expert", d_ax, "mlp")),
        "w_up": fac.param((E, d, f), ("expert", d_ax, "mlp")),
        "w_down": fac.param((E, f, d), ("expert", "mlp", d_ax)),
    }
    if m.num_shared_experts:
        fs = f * m.num_shared_experts
        p["shared"] = {
            "w_gate": fac.param((d, fs), ("embed", "mlp")),
            "w_up": fac.param((d, fs), ("embed", "mlp")),
            "w_down": fac.param((fs, d), ("mlp", "embed")),
        }
    return p


def _expert_ffn(p, xe):
    """xe (E, C, d) -> (E, C, d): each expert's SwiGLU over its slots."""
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    return torch.bmm(h, p["w_down"])


def _route(p, cfg, x2d, ids=None):
    """x2d (T, d) -> (weights (T, k) in x2d's dtype, ids (T, k), aux loss).
    Given ``ids`` (T, k), those are the choices in place of the top k (a
    check replays one route's choices in another)."""
    m = cfg.moe
    with fp32.ieee():
        logits = x2d.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    if ids is None:
        ids = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :m.top_k]
    w = torch.gather(probs, 1, ids)
    w = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-9)
    # Switch-style load balance loss: E * sum_e f_e * P_e, f_e of the top-1 id
    f_e = torch.bincount(ids[:, 0], minlength=m.num_experts).float() / x2d.shape[0]
    P_e = torch.mean(probs, dim=0)
    aux = m.num_experts * torch.sum(f_e * P_e)
    return w.to(x2d.dtype), ids, aux


def _capacity(group: int, cfg) -> int:
    """Per-expert slot budget: capacity factor 1.25 at scale; small groups
    (decode steps, smoke tests) get full capacity so nothing drops where
    dropping would be a correctness surprise rather than a throughput
    trade-off."""
    m = cfg.moe
    c = int(group * m.top_k * 1.25 / m.num_experts) + 1
    return max(min(group, max(c, 16)), 1)


def _plan(p, cfg, x, group: int):
    """Route ``x`` (B, S, d) in groups of ``g = min(group, B S)`` tokens.
    Returns (G, C, w, ids, slot, keep, aux): the group count, the
    capacity, and for each group's flattened (token, choice) pairs
    (G, g k) their weight, expert id, slot in the expert's queue (the
    count of earlier pairs of the group with the same expert) and whether
    the slot is within C."""
    B, S, d = x.shape
    m = cfg.moe
    T = B * S
    g = min(group, T)
    if T % g:
        raise ValueError(f"{B * S} tokens do not split into MoE groups of {g} "
                         f"(the reference asserts T % g == 0)")
    G = T // g
    C = _capacity(g, cfg)
    w, ids, aux = _route(p, cfg, x.reshape(T, d))
    w, ids = w.reshape(G, g * m.top_k), ids.reshape(G, g * m.top_k)
    oh = F.one_hot(ids, m.num_experts).to(torch.int32)          # (G, g k, E)
    pos = torch.cumsum(oh, dim=1, dtype=torch.int32) - oh
    slot = torch.gather(pos, 2, ids[..., None])[..., 0]
    return G, C, w, ids, slot, slot < C, aux


def _buffer_rows(ids, slot, keep, C: int):
    """Each pair's row of the expert-major (E, G, C) buffer; a dropped
    pair points at slot 0 of its expert and adds zeros there."""
    G = ids.shape[0]
    grp = torch.arange(G, device=ids.device)[:, None]
    return (ids * G + grp) * C + torch.where(keep, slot, torch.zeros_like(slot))


def _experts(p, cfg, rows, xs, G: int, C: int):
    """Scatter the pairs' rows ``xs`` (n, d) into the zero (E, G C, d)
    buffer at ``rows`` (n,), run the experts, and gather their outputs
    back at ``rows``: (n, d)."""
    E, d = cfg.moe.num_experts, xs.shape[-1]
    buf = xs.new_zeros(E * G * C, d).index_add(0, rows, xs)
    ye = _expert_ffn(p, buf.view(E, G * C, d))
    return ye.reshape(E * G * C, d)[rows]


def _shared(p, cfg, x, y):
    if cfg.moe.num_shared_experts:
        sp = p["shared"]
        y = y + (F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]
    return y


def moe_forward_einsum(p, cfg, x, group: int = 2048):
    """GShard-style grouped capacity dispatch, computed by index."""
    B, S, d = x.shape
    k = cfg.moe.top_k
    G, C, w, ids, slot, keep, aux = _plan(p, cfg, x, group)
    kf = keep.reshape(-1, 1)
    xs = torch.where(kf, x.reshape(B * S, d).repeat_interleave(k, dim=0), 0.0)
    out = _experts(p, cfg, _buffer_rows(ids, slot, keep, C).reshape(-1), xs, G, C)
    out = torch.where(kf, out, 0.0).view(B * S, k, d)
    y = torch.sum(out.float() * w.reshape(B * S, k, 1).float(), dim=1).to(x.dtype)
    return _shared(p, cfg, x, y.reshape(B, S, d)), aux


def moe_forward_sort(p, cfg, x, group: int = 2048):
    """Sort-based dispatch, group-local: pairs are stably sorted by expert
    id within each group and moved by index into the buffer and back."""
    B, S, d = x.shape
    k = cfg.moe.top_k
    G, C, w, ids, slot, keep, aux = _plan(p, cfg, x, group)
    n = ids.shape[1]                                            # g k pairs a group
    order = torch.argsort(ids, dim=1, stable=True)
    tok_of = torch.gather(
        (torch.arange(n, device=x.device) // k).expand(G, n), 1, order)
    keep_s = torch.gather(keep, 1, order)
    rows = _buffer_rows(torch.gather(ids, 1, order), torch.gather(slot, 1, order), keep_s, C)
    xg = x.reshape(G, n // k, d)
    xs = torch.gather(xg, 1, tok_of[..., None].expand(G, n, d))
    xs = torch.where(keep_s[..., None], xs, 0.0)
    out = _experts(p, cfg, rows.reshape(-1), xs.reshape(G * n, d), G, C).view(G, n, d)
    out = torch.where(keep_s[..., None], out, 0.0)
    contrib = out * torch.gather(w, 1, order)[..., None].to(x.dtype)
    unsort = torch.argsort(order, dim=1)        # back to (token, choice) order
    contrib = torch.gather(contrib, 1, unsort[..., None].expand(G, n, d))
    y = torch.sum(contrib.view(B * S, k, d), dim=1)
    return _shared(p, cfg, x, y.reshape(B, S, d)), aux


def moe_forward(p, cfg, x, dispatch: str = "einsum", group: int = 2048):
    """x (B, S, d) -> (y (B, S, d), aux loss)."""
    if dispatch == "einsum":
        return moe_forward_einsum(p, cfg, x, group)
    if dispatch == "sort":
        return moe_forward_sort(p, cfg, x, group)
    raise ValueError(dispatch)


@torch.no_grad()
def dispatch_counts(p, cfg, x, group: int = 2048):
    """What ``moe_forward`` on ``x`` routes: (the (token, choice) pairs it
    drops beyond capacity, a 0-dim tensor; the pairs routed to each
    expert before the drop, (E,)), on x's device, without a host sync."""
    _, _, _, ids, _, keep, _ = _plan(p, cfg, x, group)
    return torch.sum(~keep), torch.bincount(ids.reshape(-1), minlength=cfg.moe.num_experts)
