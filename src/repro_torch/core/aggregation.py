"""Server-side aggregation: the masked weighted FedAvg of Algorithm 1
(lines 9-16), and the staleness weight and asynchronous mix of the event
runtime.  Port of ``repro.core.aggregation:17-68,109-121``; the FedBuff
buffered flush comes with the batched engine (ROADMAP.md, queue 1
item 6).

The staleness weight and the mix reproduce the reference's rounding:
``powf`` and ``fma`` in ``repro_torch.common.fp32`` say why."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import fp32
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


def staleness_weight(staleness, kind: str = "poly", a: float = 0.5, b: float = 6.0):
    """FedAsync-style staleness decay s(tau) (Xie et al., Eq. hinge/poly),
    in fp32 on the host: 'poly' (1+tau)^-a, 'const' 1, 'hinge' 1 for
    tau <= b else 1/(a(tau-b)+1), continuous at tau=b and <= 1 for every
    a > 0.  ``a`` defaults to the poly exponent; hinge callers pass their
    own slope (FedAsync's a=10, b=6).  'poly' raises with the C library's
    ``powf``, as the reference's CPU compile does, so the 4096-entry
    table of ``Aggregator.stale_weight`` equals the reference's bit for
    bit (tests/test_torch_events.py)."""
    tau = np.asarray(staleness, np.float32)
    one = np.float32(1.0)
    if kind == "poly":
        return fp32.powf(one + tau, -np.float32(a))
    if kind == "const":
        return np.ones_like(tau)
    if kind == "hinge":
        slope = np.float32(a) * np.maximum(tau - np.float32(b), np.float32(0.0))
        return np.where(tau <= b, one, one / (slope + one)).astype(np.float32)
    raise ValueError(kind)


def async_mix(global_params, client_params, rho):
    """Single-client asynchronous mix: theta <- (1-rho) theta + rho theta_i
    (the classic async-FedAvg server step, used on each arrival in the
    event runtime).  Rounded as the reference's compiled mix
    (``async_mix_jit``) rounds it on the CPU: fma(1-rho, theta,
    fl32(rho theta_i)), one rounding for the multiply-add
    (``fp32.fma``).  The same float64 form runs on CUDA tensors."""
    rho = np.float32(rho)
    keep = np.float32(1.0) - rho
    return tree_map(
        lambda g, c: fp32.fma(keep, g.float(), c.float() * float(rho)).to(g.dtype),
        global_params, client_params)
