"""Server-side aggregation: the masked weighted FedAvg of Algorithm 1
(lines 9-16).  Port of ``repro.core.aggregation:17-47``; the
asynchronous mixes wait for the event runtimes."""
from __future__ import annotations

import torch

from repro_torch.common.pytree import tree_map


def aggregation_weights(mask, sample_counts):
    """Algorithm 1 line 16: theta <- sum_i (n_i / n) theta_i over the
    selected clients; n = total samples of the selected set.  Per-client
    weights, zero where unselected; they sum to 1 when any is selected."""
    m = mask.float()
    w = m * sample_counts.float()
    tot = torch.sum(w)
    return torch.where(tot > 0, w / torch.clamp_min(tot, 1e-9), torch.zeros_like(w))


def masked_weighted_average(stacked_params, mask, sample_counts):
    """Weighted average over the leading client axis (fp32 accumulation,
    cast back to the leaf's dtype).  A zero tree when nothing is selected."""
    w = aggregation_weights(mask, sample_counts)

    def avg(leaf):
        wf = w.reshape((-1,) + (1,) * (leaf.dim() - 1))
        return torch.sum(leaf.float() * wf, dim=0).to(leaf.dtype)
    return tree_map(avg, stacked_params)


def aggregate_or_keep(global_params, stacked_params, mask, sample_counts):
    """Masked FedAvg; keeps the current global model when the mask is
    empty or the selected set holds zero samples in total (a lone
    zero-count client must not zero the global model).  Decided on the
    device, with no host sync."""
    any_sel = torch.sum(aggregation_weights(mask, sample_counts)) > 0
    agg = masked_weighted_average(stacked_params, mask, sample_counts)
    return tree_map(lambda g, a: torch.where(any_sel, a.to(g.dtype), g), global_params, agg)
