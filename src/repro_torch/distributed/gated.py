"""Value-gated collectives across processes: VAFL's gate on
``torch.distributed``.  Port of ``repro.distributed.gated``.

In the cross-silo mapping each process (rank) is one federated silo.
The client->server upload becomes the all-reduce of model deltas;
VAFL's gate becomes:

  1. an all-reduce mean of the scalar communication values V (the cheap
     exchange, Algorithm 1 line 5: 4 bytes a rank),
  2. the Eq. 2 mask ``V_local >= mean(V)``,
  3. an all-reduce sum of the selected ranks' weights, then one of the
     weighted delta per leaf, to which unselected ranks contribute
     zeros (Algorithm 1 line 16), and the reference's epilogue
     ``where(any_sel, sum / max(w_tot, 1e-9), 0)``.

These are the reference's collectives in the reference's order; where
it runs them inside ``shard_map`` over a "pod" mesh axis, one call here
is one rank's share, and every rank of the group must make it.  An
all-reduce is dense whatever the zeros, so the bytes saved come from
invocation frequency: ``should_sync`` lets a training loop skip the
heavy collective on rounds where no rank clears the threshold, and the
V exchange is O(ranks) scalars instead of O(params).  Every collective
is counted in ``repro_torch.distributed.hlo``.

Backends: NCCL takes one rank a card; several ranks sharing one card
(or the CPU) use gloo, whose ``all_reduce`` takes CUDA tensors (it
stages them through the host itself), so the values, masks and sums
here stay on the ranks' devices either way.  The sums run in the
backend's order (gloo's ring), not the reference's, so the aggregate
agrees with it to rounding; the selection and ``any_sel`` are exact.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.common.pytree import tree_map
from repro_torch.core.value import amplifier
from repro_torch.distributed import hlo
from repro_torch.kernels.grad_diff_norm.ops import tree_grad_diff_sq_norm


def _all_reduce(t, op, group):
    dist.all_reduce(t, op=op, group=group)
    hlo.record("all-reduce", t.numel() * t.element_size())
    return t


def pod_values(grad_prev, grad_cur, acc, n_pods):
    """This rank's Eq. 1 value, computed locally (no traffic): the
    squared norm through the grad_diff_norm kernel (one launch over the
    tree on the card), times ``(1 + P/1e3)^acc`` by ``powf``."""
    one = lambda t: tree_map(lambda x: x.unsqueeze(0), t)
    diff = tree_grad_diff_sq_norm(one(grad_prev), one(grad_cur))[0]
    return diff * amplifier(n_pods, torch.as_tensor(acc, dtype=torch.float32),
                            diff.device)


def gated_allreduce(update, v_local, weight_local, group=None):
    """One rank's share of the VAFL-gated weighted average.

    update: this rank's tree (its model delta); v_local: its scalar V;
    weight_local: its aggregation weight (n_i).  Returns (agg, selected,
    any_selected): agg = sum_sel(w*u)/sum_sel(w) if any rank is selected,
    else zeros, the same on every rank."""
    n = dist.get_world_size(group)
    dev = v_local.device
    v_mean = _all_reduce(v_local.detach().float().reshape(()).clone(),
                         dist.ReduceOp.SUM, group) / n
    selected = (v_local.float() >= v_mean).float()                       # Eq. 2
    w = selected * torch.as_tensor(weight_local, dtype=torch.float32, device=dev)
    w_tot = _all_reduce(w.clone(), dist.ReduceOp.SUM, group)
    any_sel = w_tot > 0

    def agg_leaf(u):
        s = _all_reduce(u.float() * w, dist.ReduceOp.SUM, group)
        return torch.where(any_sel, s / torch.clamp_min(w_tot, 1e-9), torch.zeros_like(s))

    return tree_map(agg_leaf, update), selected, any_sel


def make_gated_allreduce(group=None):
    """The gated aggregation bound to a process group:
    ``fn(update, value, weight) -> (agg, selected (1,), any_sel)`` for
    this rank, where the reference's jitted function takes the stacked
    (n_pods, ...) inputs of every pod."""
    def fn(update, value, weight):
        agg, sel, any_sel = gated_allreduce(update, value, weight, group)
        return agg, sel.reshape(1), any_sel
    return fn


def should_sync(value, group=None):
    """Round-level gate: at least one rank at or above the mean (always
    true by the max >= mean argument unless the values are equal, in
    which case all ranks sync: Algorithm 1's >= comparison)."""
    n = dist.get_world_size(group)
    v_mean = _all_reduce(value.detach().float().reshape(()).clone(),
                         dist.ReduceOp.SUM, group) / n
    above = (value.float() >= v_mean).to(torch.int32).reshape(())
    return bool(_all_reduce(above, dist.ReduceOp.MAX, group) > 0)
