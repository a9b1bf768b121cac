"""Server-side aggregation: the masked weighted FedAvg of Algorithm 1
(lines 9-16), the staleness weight and asynchronous mix of the event
runtimes, and the batched engine's FedBuff buffered flush.  Port of
``repro.core.aggregation``.

The staleness weight, the mix and the flush reproduce the reference's
rounding on the CPU: ``powf`` and ``fma`` in ``repro_torch.common.fp32``
say why.  The flush's weighted mean is a chain of fused multiply-adds
in buffer order, the form XLA's CPU compile gives its
``einsum("k,k...->...")``: bit-equal to the reference's flush for
K = 2, 3, 4 and 16 (tests/test_torch_batched.py)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import fp32
from repro_torch.common.pytree import (tree_flatten, tree_gather, tree_leaves, tree_map,
                                       tree_unflatten)


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


def _flat(tree, rows: bool = False):
    """A tree's leaves as one fp32 vector in tree_flatten order, or a
    stacked tree's as (K, P) rows: the mixes below are elementwise, so
    they run once over the whole model instead of once a leaf."""
    leaves = tree_leaves(tree)
    if rows:
        return torch.cat([x.reshape(x.shape[0], -1).float() for x in leaves], 1)
    return torch.cat([x.reshape(-1).float() for x in leaves])


def _split_like(flat, tree):
    """``flat`` cut back into ``tree``'s leaf shapes and dtypes."""
    leaves, treedef = tree_flatten(tree)
    out, off = [], 0
    for x in leaves:
        out.append(flat[off:off + x.numel()].reshape(x.shape).to(x.dtype))
        off += x.numel()
    return tree_unflatten(treedef, out)


def buffered_mean(recons_stacked, coef):
    """Weighted mean over the leading axis of a stacked reconstruction
    tree (fp32): fma(c_{K-1}, r_{K-1}, ... fma(c_1, r_1, fl32(c_0 r_0))),
    rounded once per term as the reference's compiled einsum rounds it.
    ``coef`` is a sequence of K fp32 weights; shared by ``buffered_mix``
    and the batched engine's fused flush."""
    coef = [float(c) for c in np.asarray(coef, np.float32)]
    r = _flat(recons_stacked, rows=True)
    acc = r[0] * coef[0]
    for k in range(1, len(coef)):
        acc = fp32.fma(coef[k], r[k], acc)
    return _split_like(acc, tree_map(lambda x: x[0], recons_stacked))


def buffered_coefs(stale_weights, rho):
    """The flush weighting in one place: normalized staleness coefficients
    s_i / sum_j s_j (fp32) and the effective mix rate rho * mean_i s_i."""
    s = np.asarray(stale_weights, np.float64)
    return (s / s.sum()).astype(np.float32), rho * float(s.mean())


def buffered_mix(global_params, recons, stale_weights, rho, mix=None):
    """FedBuff-style buffer flush (Nguyen et al.): the server mixes the
    staleness-weighted mean of the K buffered client reconstructions in
    one step,

        theta <- (1 - rho * s_bar) theta + rho * s_bar * recon_bar,
        recon_bar = sum_i (s_i / sum_j s_j) recon_i,   s_bar = mean_i s_i.

    With K=1 this is exactly ``async_mix(theta, recon, rho * s)`` (the
    singleton mean passes recon through untouched), so the batched
    engine's buffer_size=1 path reproduces the sequential per-arrival
    mix bit for bit.  ``mix`` lets callers supply an aggregator's mix."""
    mix = mix if mix is not None else async_mix
    if len(recons) == 1:
        return mix(global_params, recons[0], rho * float(np.asarray(stale_weights)[0]))
    coef, rho_sbar = buffered_coefs(stale_weights, rho)
    bar = buffered_mean(tree_map(lambda *xs: torch.stack(xs), *recons), coef)
    return mix(global_params, bar, rho_sbar)


def flush_mix(global_params, src, rows, coef, rho_sbar):
    """FedBuff buffer flush: gather the buffered ``rows`` from their
    stacked source, staleness-weighted mean, async mix (the reference's
    ``flush_mix_jit``)."""
    bar = buffered_mean(tree_gather(src, rows), coef)
    return async_mix(global_params, bar, rho_sbar)


def async_mix(global_params, client_params, rho):
    """Single-client asynchronous mix: theta <- (1-rho) theta + rho theta_i
    (the classic async-FedAvg server step, used on each arrival in the
    event runtime).  Rounded as the reference's compiled mix
    (``async_mix_jit``) rounds it on the CPU: fma(1-rho, theta,
    fl32(rho theta_i)), one rounding for the multiply-add
    (``fp32.fma``).  The same float64 form runs on CUDA tensors, over
    the whole model at once."""
    rho = np.float32(rho)
    keep = np.float32(1.0) - rho
    out = fp32.fma(keep, _flat(global_params), _flat(client_params) * float(rho))
    return _split_like(out, global_params)
