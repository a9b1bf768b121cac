"""Plain PyTorch version of the linear_scan kernel: the exact sequential
recurrence.  It is the path taken on CPU tensors, and what
``chip_smoke.py`` holds the kernel against on the card.

    S_t = diag(exp(la_t)) S_{t-1} + k_t v_t^T              S: (K, V), fp32
    y_t = q_t^T S_t                           (include_current=True, Mamba2)
    y_t = q_t^T (S_{t-1} + diag(u) k_t v_t^T)                (RWKV6 bonus)

with ``la`` clipped to [LOG_A_MIN, 0], as ``repro.kernels.linear_scan.ref``
computes it.  Every exponent is <= 0, so no input overflows it.
"""
from __future__ import annotations

import torch

LOG_A_MIN = -8.0


def scan(q, k, v, log_a, u=None, *, include_current: bool = True, initial_state=None):
    """Unclipped sequential recurrence on the layer layout.  q, k, log_a
    (B,S,H,K); v (B,S,H,V); u (H,K) or (B,H,K); initial_state (B,H,K,V).
    Returns y (B,S,H,V) in v's dtype and the final fp32 state (B,H,K,V)."""
    B, S, H, K = q.shape
    V = v.shape[-1]
    f32, out_dtype = torch.float32, v.dtype
    state = (initial_state.to(f32) if initial_state is not None
             else torch.zeros((B, H, K, V), dtype=f32, device=q.device))
    q, k, v, w = q.to(f32), k.to(f32), v.to(f32), torch.exp(log_a.to(f32))
    if u is not None:
        u = u.to(f32)
        u = (u if u.dim() == 3 else u[None])[..., None]          # (B|1, H, K, 1)
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]           # (B,H,K,V)
        if include_current:
            state = w[:, t, :, :, None] * state + kv
            ys.append(torch.einsum("bhk,bhkv->bhv", q[:, t], state))
        else:
            att = state + (u * kv if u is not None else kv)
            ys.append(torch.einsum("bhk,bhkv->bhv", q[:, t], att))
            state = w[:, t, :, :, None] * state + kv
    y = torch.stack(ys, dim=1) if ys else torch.zeros((B, 0, H, V), dtype=f32, device=q.device)
    return y.to(out_dtype), state


def recurrence(q, k, v, la, u=None, *, include_current: bool = True, initial_state=None):
    """The kernel's function on the layer layout: ``scan`` with ``la``
    clipped to [LOG_A_MIN, 0].  Returns (y in v's dtype, fp32 final state)."""
    la = torch.clamp(la.to(torch.float32), LOG_A_MIN, 0.0)
    return scan(q, k, v, la, u, include_current=include_current, initial_state=initial_state)


def linear_scan(q, k, v, la, u=None, *, include_current: bool = True):
    """The reference oracle's layout: q, k, la (BH,S,K); v (BH,S,V);
    u (BH,K) -> y (BH,S,V)."""
    y, _ = recurrence(q[:, :, None], k[:, :, None], v[:, :, None], la[:, :, None],
                      None if u is None else u[:, None], include_current=include_current)
    return y[:, :, 0]
