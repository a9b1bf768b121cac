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

``recurrence_bwd`` is the plain version of the backward kernel
(``csrc/linear_scan_bwd.cu``), written as the kernel computes it: a
forward scan that rebuilds the state for dq, a reverse scan of the
state's gradient for dk, dv and the initial state's gradient, and dla
from the gated-linear-attention identity, with no state stored.

``chunked`` is a plain model of the bf16 kernel's chunked arithmetic
(``csrc/linear_scan.cu``), and ``recurrence_bwd_chunked`` the backward
kernel's bf16 algebra, for the tests only.

The forward functions compute in fp32, or in float64 when given
float64 inputs (the tests' exact check of the backward's derivation);
``recurrence_bwd`` computes in float64 whatever its inputs, as the
kernel does (its docstring says why).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

LOG_A_MIN = -8.0
CHUNK, SUBS = 32, (16, 8)   # the bf16 kernels' chunk and its two levels of sub-blocks
                            # (csrc/linear_scan.cu, csrc/linear_scan_bwd.cu)


def scan(q, k, v, log_a, u=None, *, include_current: bool = True, initial_state=None):
    """Unclipped sequential recurrence on the layer layout.  q, k (B,S,H,K);
    log_a (B,S,H,K), or (B,S,H) shared by a head's K rows; v (B,S,H,V);
    u (H,K) or (B,H,K); initial_state (B,H,K,V).  Returns y (B,S,H,V) in
    v's dtype and the final fp32 state (B,H,K,V)."""
    B, S, H, K = q.shape
    V = v.shape[-1]
    f32, out_dtype = torch.promote_types(v.dtype, torch.float32), v.dtype
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
    la = la.to(torch.promote_types(la.dtype, torch.float32))
    if la.dim() == 4:
        la = torch.clamp(la, LOG_A_MIN, 0.0)
    return scan(q, k, v, la, u, include_current=include_current, initial_state=initial_state)


def recurrence_bwd(q, k, v, la, u, dy, d_state, *, include_current: bool = True,
                   initial_state=None):
    """Gradients of ``recurrence`` against dy (B,S,H,V) and the final
    state's gradient ``d_state`` (B,H,K,V; None: zeros), computed as the
    backward kernel computes them.  Returns (dq, dk, dv in the inputs'
    dtypes, dla (per dim or per head, as la came in) in fp32, du (H,K) or
    None, d_initial_state (B,H,K,V) or None).

    * dq: a forward scan rebuilds S_t from the initial state and reads
      S_t dy_t (S_{t-1} dy_t with the bonus, plus u k_t (v_t . dy_t)).
    * dk, dv: a reverse scan of G_t, the gradient of S_t, from d_state:
      G_t = diag(exp(la_{t+1})) G_{t+1} + q_t dy_t^T (with the bonus
      q_{t+1} dy_{t+1}^T, one step on); dk_t = G_t v_t, dv_t = G_t^T k_t,
      plus the bonus terms; what G is after step 0 is the initial
      state's gradient.
    * dla: with c_t the cumulative (clamped) log-decay, every decayed
      term of the function is exp(c_t - c_s), t a query's step and s a
      key's, so dL/dc_t = q_t . dq_t - k_t . dk_t taken over the decayed
      terms only: the query's exponent is c_t (c_{t-1} with the bonus,
      whose terms carry no decay), and the final state adds
      d_state . S_final at the last step.  dla is the reverse cumulative
      sum of dL/dc, zero where the per-dim clamp cut la (as the clamp's
      gradient is), and summed over K in the per-head form.
    * du = sum over (b, t) of q_t k_t (v_t . dy_t).

    Every state, product and sum is float64: the query and key terms of
    dla nearly cancel (they are equal where a step's decay is near 0),
    so in fp32 their rounding, that of the fp32 states above all, is
    what is left of them, and a parameter summed over every step's dla,
    such as Mamba2's A_log, comes out 1e-4 of its scale from the float64
    gradient where autograd through the fp32 scan is 1e-6 from it.
    dq, dk, dv are rounded once to the inputs' dtype, dla, du and
    d_initial_state to fp32 (float64 inputs keep float64)."""
    B, S, H, K = q.shape
    V = v.shape[-1]
    ct = torch.float64
    out_f = torch.promote_types(v.dtype, torch.float32)
    per_head = la.dim() == 3
    la = la.to(torch.promote_types(la.dtype, torch.float32))
    lac = la if per_head else torch.clamp(la, LOG_A_MIN, 0.0)
    w = torch.exp(lac.to(ct))
    w = w[..., None] if per_head else w                          # (B, S, H, K | 1)
    qf, kf, vf, dyf = (x.to(ct) for x in (q, k, v, dy))
    bonus = not include_current
    uu = (u.to(ct) if u is not None else torch.ones((H, K), dtype=ct, device=q.device))
    vdy = torch.einsum("bshv,bshv->bsh", vf, dyf)[..., None]     # (B, S, H, 1)

    # forward: the state, and the decayed part of dq
    state = (initial_state.to(ct) if initial_state is not None
             else torch.zeros((B, H, K, V), dtype=ct, device=q.device))
    dq_dec = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        if include_current:
            state = w[:, t, :, :, None] * state + kv
            dq_dec.append(torch.einsum("bhkv,bhv->bhk", state, dyf[:, t]))
        else:
            dq_dec.append(torch.einsum("bhkv,bhv->bhk", state, dyf[:, t]))
            state = w[:, t, :, :, None] * state + kv
    dq_dec = torch.stack(dq_dec, dim=1)                          # (B, S, H, K)

    # reverse: G, the gradient of the state, and the decayed part of dk
    g = (d_state.to(ct) if d_state is not None
         else torch.zeros((B, H, K, V), dtype=ct, device=q.device))
    dk_dec, dv = [None] * S, [None] * S
    for t in reversed(range(S)):
        qdy = qf[:, t, :, :, None] * dyf[:, t, :, None, :]
        if include_current:
            g = g + qdy
            dk_dec[t] = torch.einsum("bhkv,bhv->bhk", g, vf[:, t])
            dv[t] = torch.einsum("bhkv,bhk->bhv", g, kf[:, t])
            g = w[:, t, :, :, None] * g
        else:
            dk_dec[t] = torch.einsum("bhkv,bhv->bhk", g, vf[:, t])
            quk = torch.einsum("bhk,hk,bhk->bh", qf[:, t], uu, kf[:, t])
            dv[t] = torch.einsum("bhkv,bhk->bhv", g, kf[:, t]) + quk[..., None] * dyf[:, t]
            g = w[:, t, :, :, None] * g + qdy
    dk_dec, dv = torch.stack(dk_dec, dim=1), torch.stack(dv, dim=1)

    dq, dk = dq_dec, dk_dec
    if bonus:
        dq = dq + uu * kf * vdy
        dk = dk + qf * uu * vdy
    # dla: the query terms at each cumulative position, minus the key terms
    xq = qf * dq_dec
    if bonus:                                    # position t reads q_{t+1} . dq_{t+1}
        xq = torch.cat([xq[:, 1:], torch.zeros_like(xq[:, :1])], dim=1)
    if d_state is not None:
        xq[:, -1] = xq[:, -1] + torch.einsum("bhkv,bhkv->bhk", d_state.to(ct), state)
    dc = xq - kf * dk_dec
    dla = torch.flip(torch.cumsum(torch.flip(dc, [1]), dim=1), [1])
    if per_head:
        dla = dla.sum(-1)
    else:
        dla = torch.where((la >= LOG_A_MIN) & (la <= 0.0), dla, torch.zeros_like(dla))
    du = None
    if bonus and u is not None:
        du = torch.einsum("bshk,bshk,bsh->hk", qf, kf, vdy[..., 0]).to(out_f)
    d_init = g.to(out_f) if initial_state is not None else None
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dla.to(out_f), du, d_init)


def _hi_lo(x):
    """x as bf16 hi + lo, each held in x's dtype: hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16).to(x.dtype)
    return hi, (x - hi).to(torch.bfloat16).to(x.dtype)


def _mul(a, b, split):
    """a * b; with ``split`` as ``_mm`` takes it, for one product."""
    if not split:
        return a * b
    (ah, al), (bh, bl) = _hi_lo(a), _hi_lo(b)
    return ah * bh + ah * bl + al * bh


def _mm(eq, a, b, split):
    """einsum(eq, a, b); with ``split`` as the tensor cores take two fp32
    operands: hi hi + hi lo + lo hi, lo lo dropped."""
    if not split:
        return torch.einsum(eq, a, b)
    (ah, al), (bh, bl) = _hi_lo(a), _hi_lo(b)
    return torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)


def recurrence_bwd_chunked(q, k, v, la, u, dy, d_state, *, include_current: bool = True,
                           initial_state=None, chunk: int = CHUNK, dtype=torch.float32,
                           split: bool = False):
    """The bf16 backward kernel's algebra (``csrc/linear_scan_bwd.cu``) in
    plain PyTorch, for the tests: the same arguments and results as
    ``recurrence_bwd``, computed in ``dtype`` by chunks of ``chunk`` steps.

    * Edge states: a sweep forward over the chunks rebuilds each chunk's
      entry state S_in, one update a chunk, S_out = exp(cum_C) S_in +
      (k exp(cum_C - cum))^T v; a sweep backward walks each chunk's exit
      gradient G_out from d_state, G_in = exp(cum_C) G_out +
      (q exp(x))^T dy, and G_in of the first chunk is the initial
      state's gradient.  cum is the chunk's inclusive cumulative
      (clamped) log-decay, x = cum (Mamba2) or cum one step back (RWKV6).
    * Each chunk then alone, with D[t,s] = dy_t . v_s and the masked
      decay exp(x_t - cum_s) (s <= t, or s < t with the bonus):
      dq_t = exp(x_t) (S_in dy_t) + sum_s D[t,s] k_s exp(x_t - cum_s),
      dk_s = exp(cum_C - cum_s) (G_out v_s) + sum_t D[t,s] q_t exp(..),
      dv_s = G_out^T (k_s exp(cum_C - cum_s)) + sum_t A[t,s] dy_t, A the
      forward's scores, plus the bonus terms.
    * dla_t = exp(la_t) <S_{t-1}, G_t> over V, split four ways inside the
      chunk: (a) exp(cum_C) <S_in, G_out>, the same at every step; (b)
      the reverse cumulative sum, from t on (past t with the bonus), of q
      dq's S_in part; (c) the forward sum before t of k dk's G_out part;
      (d) the chunk's own pairs (t', s) that straddle t, s < t <= t' (s <
      t < t'), summed straight.  No sum crosses a chunk and none
      subtracts, so nothing cancels, and fp32 suffices where the identity
      over the whole sequence needs float64.

    With ``split`` every product that the kernel runs on the tensor cores
    with an fp32 operand rounds that operand (and the other) to bf16 hi +
    lo and drops lo lo, so a CPU test reads the bf16 route's own
    precision."""
    B, S, H, K = q.shape
    V = v.shape[-1]
    ct = dtype
    out_f = torch.promote_types(v.dtype, torch.float32)
    per_head = la.dim() == 3
    cur = include_current
    la = la.to(torch.promote_types(la.dtype, torch.float32))
    lac = la if per_head else torch.clamp(la, LOG_A_MIN, 0.0)
    C = chunk
    pad = (-S) % C
    n = (S + pad) // C

    def chunks(x):                                   # (B, S, H, .) -> (B, n, C, H, .), zeros past S
        x = F.pad(x.to(ct), (0, 0, 0, 0, 0, pad))
        return x.reshape(B, n, C, H, x.shape[-1])

    qc, kc, vc, dyc = (chunks(x) for x in (q, k, v, dy))
    lc = chunks(lac[..., None] if per_head else lac)            # (B, n, C, H, 1 | K)
    cum = torch.cumsum(lc, dim=2)
    x = cum if cur else F.pad(cum[:, :, :-1], (0, 0, 0, 0, 1, 0))
    tot = cum[:, :, -1]                                          # (B, n, H, 1 | K)
    uu = u.to(ct) if u is not None else torch.ones((H, K), dtype=ct, device=q.device)
    mm = functools.partial(_mm, split=split)

    # the edge sweeps
    kt = kc * torch.exp(tot[:, :, None] - cum)                   # k exp(cum_C - cum)
    qx = qc * torch.exp(x)                                       # q exp(x)
    zero = torch.zeros((B, H, K, V), dtype=ct, device=q.device)
    st = initial_state.to(ct) if initial_state is not None else zero
    s_in = []
    for c in range(n):
        s_in.append(st)
        st = torch.exp(tot[:, c])[..., None] * st + mm("bshk,bshv->bhkv", kt[:, c], vc[:, c])
    g = d_state.to(ct) if d_state is not None else zero
    g_out = [None] * n
    for c in reversed(range(n)):
        g_out[c] = g
        g = torch.exp(tot[:, c])[..., None] * g + mm("bthk,bthv->bhkv", qx[:, c], dyc[:, c])
    s_in, g_out = torch.stack(s_in, dim=1), torch.stack(g_out, dim=1)   # (B, n, H, K, V)

    # each chunk alone: the edge states' parts
    dq_inter = torch.exp(x) * mm("bnhkv,bnthv->bnthk", s_in, dyc)
    dk_inter = torch.exp(tot[:, :, None] - cum) * mm("bnhkv,bnshv->bnshk", g_out, vc)
    dv = mm("bnshk,bnhkv->bnshv", kt, g_out)
    # the intra-chunk parts, through the masked decay (B, n, t, s, H, 1 | K)
    ts = torch.arange(C, device=q.device)
    taken = (ts[:, None] >= ts[None, :]) if cur else (ts[:, None] > ts[None, :])
    taken = taken[None, None, :, :, None, None]
    dec = torch.exp(torch.where(taken, x[:, :, :, None] - cum[:, :, None], -torch.inf))
    dmat = torch.einsum("bnthv,bnshv->bnhts", dyc, vc)
    ke = kc[:, :, None] * dec                                    # k_s exp(x_t - cum_s)
    qe = qc[:, :, :, None] * dec                                 # q_t exp(x_t - cum_s)
    dq_intra = mm("bnhts,bntshk->bnthk", dmat, ke)
    dk_intra = mm("bnhts,bntshk->bnshk", dmat, qe)
    a = mm("bnthk,bntshk->bnhts", qc, ke)
    vdy = torch.diagonal(dmat, dim1=-2, dim2=-1).permute(0, 1, 3, 2)[..., None]   # (B,n,C,H,1)
    if not cur:                                  # the bonus on the scores' diagonal
        a = a + torch.diag_embed(torch.einsum("bnthk,hk,bnthk->bnht", qc, uu, kc))
    dv = dv + mm("bnhts,bnthv->bnshv", a, dyc)

    # dla's four parts, none summed across a chunk
    def rcum(y):                                 # inclusive reverse cumulative sum over t
        return torch.flip(torch.cumsum(torch.flip(y, [2]), dim=2), [2])

    qterm = rcum(qc * dq_inter)                  # (b)
    if not cur:                                  # t' > t: the query's exponent is one step back
        qterm = F.pad(qterm[:, :, 1:], (0, 0, 0, 0, 0, 1))
    kin = kc * dk_inter                          # (c)
    before = F.pad(torch.cumsum(kin, dim=2)[:, :, :-1], (0, 0, 0, 0, 1, 0))
    edge = (torch.exp(tot) * (s_in * g_out).sum(-1))[:, :, None]  # (a), (B, n, 1, H, K)
    # (d): each pair (t', s) of the chunk, q_t' k_s D[t', s] exp(x_t' - cum_s),
    # summed straight into every step t it straddles, s < t <= t' (s < t < t'
    # with the bonus); the identity's q dq - k dk over the chunk would leave
    # the rounding of the pairs that straddle nothing
    pair = _mul(dmat.permute(0, 1, 3, 4, 2)[..., None], ke, split)   # D[t', s] k_s exp(..)
    z = qc[:, :, :, None] * pair                                     # (B, n, t', s, H, K)
    straddle = (ts[None, None, :] < ts[:, None, None]) & (
        (ts[:, None, None] <= ts[None, :, None]) if cur else (ts[:, None, None] < ts[None, :, None]))
    own = torch.einsum("tus,bnushk->bnthk", straddle.to(ct), z)
    dla = edge + qterm + before + own

    dq, dk = dq_inter + dq_intra, dk_inter + dk_intra
    if not cur:
        dq = dq + uu * kc * vdy
        dk = dk + qc * uu * vdy

    def unchunk(y):
        return y.reshape(B, n * C, *y.shape[3:])[:, :S]

    dq, dk, dv, dla, vdy = (unchunk(y) for y in (dq, dk, dv, dla, vdy))
    if per_head:
        dla = dla.sum(-1)
    else:
        dla = torch.where((la >= LOG_A_MIN) & (la <= 0.0), dla, torch.zeros_like(dla))
    du = None
    if not cur and u is not None:
        du = torch.einsum("bshk,bshk,bsh->hk", q.to(ct), k.to(ct), vdy[..., 0]).to(out_f)
    d_init = g.to(out_f) if initial_state is not None else None
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dla.to(out_f), du, d_init)


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
