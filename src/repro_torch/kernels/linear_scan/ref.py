"""Plain PyTorch version of the linear_scan kernel: the exact sequential
recurrence.  It is the path taken on CPU tensors, and what
``chip_smoke.py`` holds the kernel against on the card.

    S_t = diag(exp(la_t)) S_{t-1} + k_t v_t^T              S: (K, V), fp32
    y_t = q_t^T S_t                           (include_current=True, Mamba2)
    y_t = q_t^T (S_{t-1} + diag(u) k_t v_t^T)                (RWKV6 bonus)

with a per-dim ``la`` (B, S, H, K) clipped to [LOG_A_MIN, 0], as
``repro.kernels.linear_scan.ref`` computes it, and a per-head ``la``
(B, S, H) (Mamba2) taken as it is, as the reference's per-head model
path takes it.  Every exponent is <= 0, so no input overflows it.

``chunked`` is a plain model of the bf16 kernel's chunked arithmetic
(``csrc/linear_scan.cu``), for the tests only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

LOG_A_MIN = -8.0
CHUNK, SUBS = 32, (16, 8)   # the bf16 kernel's chunk and its two levels of sub-blocks
                            # (csrc/linear_scan.cu)


def scan(q, k, v, log_a, u=None, *, include_current: bool = True, initial_state=None):
    """Unclipped sequential recurrence on the layer layout.  q, k (B,S,H,K);
    log_a (B,S,H,K), or (B,S,H) shared by a head's K rows; v (B,S,H,V);
    u (H,K) or (B,H,K); initial_state (B,H,K,V).  Returns y (B,S,H,V) in
    v's dtype and the final fp32 state (B,H,K,V)."""
    B, S, H, K = q.shape
    V = v.shape[-1]
    f32, out_dtype = torch.float32, v.dtype
    state = (initial_state.to(f32) if initial_state is not None
             else torch.zeros((B, H, K, V), dtype=f32, device=q.device))
    q, k, v, w = q.to(f32), k.to(f32), v.to(f32), torch.exp(log_a.to(f32))
    if w.dim() == 3:
        w = w[..., None]                                         # (B, S, H, 1)
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
    """The kernel's function on the layer layout: ``scan`` with a per-dim
    ``la`` (B,S,H,K) clipped to [LOG_A_MIN, 0], or a per-head ``la``
    (B,S,H) as it is.  Returns (y in v's dtype, fp32 final state)."""
    la = la.to(torch.float32)
    if la.dim() == 4:
        la = torch.clamp(la, LOG_A_MIN, 0.0)
    return scan(q, k, v, la, u, include_current=include_current, initial_state=initial_state)


def linear_scan(q, k, v, la, u=None, *, include_current: bool = True):
    """The reference oracle's layout: q, k, la (BH,S,K); v (BH,S,V);
    u (BH,K) -> y (BH,S,V)."""
    y, _ = recurrence(q[:, :, None], k[:, :, None], v[:, :, None], la[:, :, None],
                      None if u is None else u[:, None], include_current=include_current)
    return y[:, :, 0]


def chunked(q, k, v, la, u=None, *, include_current: bool = True, initial_state=None,
            exponents=None):
    """The bf16 kernel's chunked form in fp32, on the layer layout (as
    ``recurrence``: a per-head la is shared by the K rows, unclamped).
    With cum the chunk's cumulative (per-dim clamped) log-decay and x =
    cum (Mamba2) or cum - la (RWKV6, taken as cum one step back,
    0 at the chunk's first step, so that x_t - cum_s <= 0 holds exactly
    for s < t, as in the kernel), a chunk's y is the readout
    (q exp(x)) S_in plus the scores A times v, and the state becomes
    exp(cum_C) S_in + (k exp(cum_C - cum))^T v.  A chunk of CHUNK steps
    is cut into blocks of SUBS[0]; a pair of them (i after j) factors its
    decay about the step r just before block i, as q exp(x - cum_r)
    times k exp(cum_r - cum_s), and each diagonal block is cut again by
    SUBS[1:]; the last level takes the
    masked exp(x_t - cum_s) elementwise (the kernel forms it there as a
    running product of the decays exp(la) <= 1, the same number).  Every exponent it takes is
    appended (its maximum) to ``exponents`` when a list is given, so a
    test can show that none is positive.  Returns (y in v's dtype, fp32
    final state)."""
    B, S, H, K = q.shape
    V = v.shape[-1]
    f32 = torch.float32
    pad = (-S) % CHUNK

    def padded(x):                                   # zero steps past S (la 0: no decay)
        return F.pad(x.to(f32), (0, 0, 0, 0, 0, pad))

    q, k, v = padded(q), padded(k), padded(v)
    la = la.to(f32)
    la = la[..., None].expand(B, S, H, K) if la.dim() == 3 else torch.clamp(la, LOG_A_MIN, 0.0)
    la = padded(la)
    state = (initial_state.to(f32) if initial_state is not None
             else torch.zeros((B, H, K, V), dtype=f32, device=q.device))
    uu = u.to(f32) if u is not None else torch.ones((H, K), dtype=f32, device=q.device)

    def exp(x, taken=None):
        if exponents is not None:
            kept = x if taken is None else x[taken]
            if kept.numel():
                exponents.append(float(kept.max()))
        return torch.exp(x if taken is None else x.masked_fill(~taken, -float("inf")))

    def scores(qc, kc, x, cum, lo, n, sizes, out):
        """A[lo:lo+n, lo:lo+n] of one chunk into out (B, H, C, C)."""
        blk = slice(lo, lo + n)
        if not sizes:                                # masked exponent elementwise
            ts = torch.arange(n, device=q.device)
            taken = (ts[:, None] >= ts[None, :]) if include_current else (ts[:, None] > ts[None, :])
            diff = x[:, blk, None] - cum[:, None, blk]               # (B, t, s, H, K)
            e = exp(diff, taken[None, :, :, None, None].expand_as(diff))
            a = torch.einsum("bthk,bshk,btshk->bhts", qc[:, blk], kc[:, blk], e)
            if not include_current:                  # RWKV6 bonus on the diagonal
                a = a + torch.diag_embed(
                    torch.einsum("bthk,hk,bthk->bht", qc[:, blk], uu, kc[:, blk]))
            out[:, :, blk, blk] = a
            return
        size = sizes[0]
        for i in range(n // size):
            ti = slice(lo + i * size, lo + (i + 1) * size)
            r = lo + i * size - 1
            for j in range(i):
                tj = slice(lo + j * size, lo + (j + 1) * size)
                qt = qc[:, ti] * exp(x[:, ti] - cum[:, r:r + 1])
                kt = kc[:, tj] * exp(cum[:, r:r + 1] - cum[:, tj])
                out[:, :, ti, tj] = torch.einsum("bthk,bshk->bhts", qt, kt)
            scores(qc, kc, x, cum, lo + i * size, size, sizes[1:], out)

    ys = []
    for c0 in range(0, S + pad, CHUNK):
        qc, kc, vc, lc = (x[:, c0:c0 + CHUNK] for x in (q, k, v, la))   # (B, C, H, .)
        cum = torch.cumsum(lc, dim=1)
        x = cum if include_current else F.pad(cum[:, :-1], (0, 0, 0, 0, 1, 0))
        y = torch.einsum("bthk,bhkv->bthv", qc * exp(x), state)
        a = torch.zeros((B, H, CHUNK, CHUNK), dtype=f32, device=q.device)
        scores(qc, kc, x, cum, 0, CHUNK, SUBS, a)
        ys.append(y + torch.einsum("bhts,bshv->bthv", a, vc))
        tot = cum[:, -1]                                             # (B, H, K)
        state = (exp(tot)[..., None] * state
                 + torch.einsum("bshk,bshv->bhkv", kc * exp(tot[:, None] - cum), vc))
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(v.dtype), state
