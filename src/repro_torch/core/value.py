"""Communication value: the paper's Eq. 1 (VAFL) and the EAFLM rule
(Eq. 3).  Port of ``repro.core.value``.

    V_i = ||grad_i^{k-1} - grad_i^k||^2 * (1 + N/1e3)^{Acc_i}        (Eq. 1)

The squared gradient-difference norm comes from a pluggable stacked
function, by default the grad_diff_norm kernel's wrapper
(``repro_torch.kernels.grad_diff_norm.ops.tree_grad_diff_sq_norm``),
which reduces all W clients of a call in one launch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import fp32
from repro_torch.common.pytree import (stacked_index, tree_leaves, tree_map,
                                       tree_sq_diff_norm, tree_sq_norm)
from repro_torch.kernels.grad_diff_norm.ops import tree_grad_diff_sq_norm

N_SCALE = 1e3  # the paper's 10^3 denominator in (1 + N/10^3)


def value_base(n_clients, device=None):
    """The power-function base (1 + N/10^3), fp32."""
    return 1.0 + torch.tensor(float(n_clients), dtype=torch.float32, device=device) / N_SCALE


def amplifier(n_clients, accs, device=None):
    """Eq. 1's (1 + N/10^3)^Acc in fp32, computed on the host with the C
    library's ``powf``, the function the reference's CPU compile calls
    (torch's fp32 ``pow`` differs from it in the last bit at some
    accuracies); returned on ``device``."""
    if isinstance(accs, torch.Tensor):
        accs = accs.detach().cpu().numpy()
    base = float(value_base(n_clients))
    return torch.from_numpy(fp32.powf(base, accs)).to(device)


def communication_value(grad_prev, grad_cur, acc, n_clients):
    """Eq. 1 for one client's pair of gradient trees."""
    diff_sq = tree_sq_diff_norm(grad_prev, grad_cur)
    return (diff_sq * amplifier(n_clients, acc, diff_sq.device)).float()


def communication_values_stacked(grads_prev, grads_cur, accs, n_clients, *,
                                 sq_diff_fn=tree_grad_diff_sq_norm):
    """Eq. 1 over stacked client trees (leading axis = client) -> (W,).
    ``sq_diff_fn(stacked_a, stacked_b) -> (W,)`` gives the norms."""
    diff_sq = sq_diff_fn(grads_prev, grads_cur)
    return (diff_sq * amplifier(n_clients, accs, diff_sq.device)).float()


def communication_values_host(diff_sq, accs, n_clients) -> np.ndarray:
    """Eq. 1 from norms and accuracies already read back to the host:
    the same fp32 product as ``communication_values_stacked`` (one IEEE
    single multiply by the same ``powf`` amplifier), so the batched
    engine reads one copy a window and never waits for the card before
    its pipelined host work."""
    base = float(value_base(n_clients))
    return np.asarray(diff_sq, np.float32) * fp32.powf(base, accs)


def vafl_threshold(values):
    """Eq. 2 threshold: mean communication value over the federation."""
    return torch.mean(values)


def vafl_mask(values):
    """Eq. 2: upload iff V_i >= mean_j V_j.  In fp32 the mean can round
    above every element, so the max element is explicitly kept and the
    selection is never empty."""
    values = torch.as_tensor(values, dtype=torch.float32)
    return (values >= vafl_threshold(values)) | (values >= torch.max(values))


# ----------------------------------------------------------------- EAFLM ---

def eaflm_threshold(server_param_deltas, alpha: float, beta: float, m: int, xi=None):
    """RHS of Eq. 3: (1/(alpha^2 beta m^2)) * ||sum_d xi_d (theta^{k-d} -
    theta^{k-1-d})||^2 over a list of D delta trees (the paper: D = 1,
    xi_d = 1/D)."""
    D = len(server_param_deltas)
    xi = xi if xi is not None else [1.0 / D] * D
    acc = tree_map(lambda x: x * xi[0], server_param_deltas[0])
    for d in range(1, D):
        acc = tree_map(lambda a, x: a + xi[d] * x, acc, server_param_deltas[d])
    return tree_sq_norm(acc) / (alpha ** 2 * beta * m ** 2)


def stacked_sq_norms(stacked):
    """(W,) squared norms of the rows of a stacked tree."""
    n = tree_leaves(stacked)[0].shape[0]
    return torch.stack([tree_sq_norm(stacked_index(stacked, i)) for i in range(n)])


def eaflm_mask_stacked(grads, threshold):
    """Upload mask over stacked client grads: True = upload (not lazy)."""
    return stacked_sq_norms(grads) > threshold
