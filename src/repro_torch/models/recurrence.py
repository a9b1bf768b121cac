"""Linear-recurrence blocks: Mamba2 (SSD) and RWKV6 (Finch).  Port of
``repro.models.recurrence``.

Both are instances of the gated linear recurrence

    S_t = diag(exp(log_a_t)) @ S_{t-1} + k_t v_t^T          S: (K, V)
    y_t = q_t^T S_t                      (include_current=True, Mamba2)
    y_t = q_t^T (S_{t-1} + diag(u) k_t v_t^T)               (RWKV6 bonus)

RWKV6 with a per-dim decay, clamped to [LOG_A_MIN, 0] in the prompt
path; Mamba2 with one decay a head, unclamped, as in the reference.  The
prompt runs through the linear_scan kernel's wrapper
(``linear_recurrence``): on CUDA the hand-written kernel, which steps
through time exactly, on the CPU its plain sequential version.  Both
train: the wrapper is an autograd Function whose backward is the
hand-written backward kernel on CUDA (``csrc/linear_scan_bwd.cu``) and
its plain version on the CPU, for every input (q, k, v, the log-decay,
RWKV6's u and an initial state).  The reference's chunked algorithm is
a TPU decomposition of the same function and is not carried over.
Decode is one plain state update.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.linear_scan import ops as scan_ops
from repro_torch.kernels.linear_scan import ref as scan_ref
from repro_torch.models.factory import ParamFactory
from repro_torch.models.layers import apply_group_norm, init_group_norm

LOG_A_MIN = scan_ref.LOG_A_MIN  # per-step clamp of the per-dim log-decay in the prompt path


# ==================================================== linear recurrence ===

def linear_recurrence_scan(q, k, v, log_a, u=None, include_current=True,
                           initial_state=None):
    """Exact sequential reference, unclamped. q,k,log_a (B,S,H,K); v (B,S,H,V).
    Returns y (B,S,H,V), final state (B,H,K,V)."""
    return scan_ref.scan(q, k, v, log_a, u, include_current=include_current,
                         initial_state=initial_state)


def linear_recurrence(q, k, v, log_a, u=None, include_current=True,
                      initial_state=None, decay_per: str = "dim"):
    """The reference's prompt recurrence, through the linear_scan kernel's
    wrapper.  ``decay_per="dim"`` (RWKV6): log_a (B,S,H,K), clipped to
    [LOG_A_MIN, 0] per dim.  ``decay_per="head"`` (Mamba2): log_a (B,S,H),
    one decay a head, unclipped.  The reference's ``chunk`` (the size of
    its decomposition) has no counterpart: the function does not depend
    on it, and the kernel stages its own.  Returns y (B,S,H,V) in v's
    dtype and the fp32 final state (B,H,K,V)."""
    if decay_per not in ("dim", "head"):
        raise ValueError(f"decay_per must be 'dim' or 'head', got {decay_per!r}")
    want = q.shape if decay_per == "dim" else q.shape[:3]
    if log_a.shape != want:
        raise ValueError(f"decay_per={decay_per!r} takes log_a of shape {tuple(want)}, got "
                         f"{tuple(log_a.shape)}")
    if decay_per == "head":
        log_a = log_a.float()
    return scan_ops.recurrence(q, k, v, log_a, u, include_current=include_current,
                               initial_state=initial_state)


def recurrence_decode_step(state, qt, kt, vt, la_t, u=None, include_current=True):
    """One-token state update. state (B,H,K,V); qt/kt/la_t (B,H,K); vt (B,H,V)."""
    f32 = torch.float32
    out_dtype = vt.dtype
    qt, kt, vt, la_t = (t.to(f32) for t in (qt, kt, vt, la_t))
    kv = kt[..., :, None] * vt[..., None, :]
    if include_current:
        new = torch.exp(la_t)[..., None] * state + kv
        y = torch.einsum("bhk,bhkv->bhv", qt, new)
    else:
        att = state + (u.to(f32)[None, :, :, None] * kv if u is not None else kv)
        y = torch.einsum("bhk,bhkv->bhv", qt, att)
        new = torch.exp(la_t)[..., None] * state + kv
    return y.to(out_dtype), new


# ================================================================ Mamba2 ===

def init_mamba2(fac: ParamFactory, cfg):
    d, s = cfg.d_model, cfg.ssm
    d_in = s.expand * d
    nheads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.state_dim
    return {
        "in_proj": fac.param((d, 2 * d_in + 2 * s.state_dim + nheads), ("embed", "mlp")),
        "conv_w": fac.param((s.conv_width, conv_dim), (None, "mlp")),
        "conv_b": fac.param((conv_dim,), ("mlp",), init="zeros"),
        "dt_bias": fac.param((nheads,), (None,), init="zeros"),
        "A_log": fac.param((nheads,), (None,), init="constant", scale=0.0),
        "D": fac.param((nheads,), (None,), init="ones"),
        "norm_scale": fac.param((d_in,), ("mlp",), init="ones"),
        "out_proj": fac.param((d_in, d), ("mlp", "embed")),
    }


def _mamba_split(p, cfg, x):
    d, s = cfg.d_model, cfg.ssm
    d_in = s.expand * d
    nheads = d_in // s.head_dim
    zxbcdt = x @ p["in_proj"]
    z, xin, Bc, Cc, dt = torch.split(
        zxbcdt, [d_in, d_in, s.state_dim, s.state_dim, nheads], dim=-1)
    return z, xin, Bc, Cc, dt, d_in, nheads


def _causal_conv(xs, w, b, conv_state=None):
    """Depthwise causal conv. xs (B,S,C); w (W,C). Returns y, new_state
    (B,W-1,C) in xs's dtype."""
    W = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xs.shape[0], W - 1, xs.shape[2]), dtype=xs.dtype, device=xs.device)
    else:
        pad = conv_state.to(xs.dtype)
    xp = torch.cat([pad, xs], dim=1)
    y = sum(xp[:, i:i + xs.shape[1]] * w[i] for i in range(W)) + b
    new_state = xp[:, xp.shape[1] - (W - 1):]
    return F.silu(y), new_state


def mamba2_forward(p, cfg, x, conv_state=None, ssm_state=None):
    """x (B,S,d) -> (y, (conv_state, ssm_state)).  The prompt's scan runs
    through ``linear_recurrence`` with per-head decay (the linear_scan
    kernel on CUDA), q and k being C and B broadcast over the heads
    without a copy; S == 1 with a state is one plain decode step.  The
    reference's ``chunk`` has no counterpart (``linear_recurrence``)."""
    B, S, _ = x.shape
    s = cfg.ssm
    z, xin, Bc, Cc, dt, d_in, nheads = _mamba_split(p, cfg, x)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"], p["conv_b"], conv_state)
    xin, Bc, Cc = torch.split(conv_out, [d_in, s.state_dim, s.state_dim], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])                        # (B,S,H)
    log_a = -torch.exp(p["A_log"].float()) * dt                       # (B,S,H) <= 0
    xh = xin.reshape(B, S, nheads, s.head_dim)
    v = xh * dt[..., None].to(xh.dtype)                               # dt * x
    k = Bc[:, :, None, :].expand(B, S, nheads, s.state_dim)
    q = Cc[:, :, None, :].expand(B, S, nheads, s.state_dim)

    if S == 1 and ssm_state is not None:
        la0 = log_a[:, 0][..., None].expand(k[:, 0].shape)           # (B,H)->(B,H,K)
        y, new_state = recurrence_decode_step(
            ssm_state, q[:, 0], k[:, 0], v[:, 0], la0, include_current=True)
        y = y[:, None]
    else:
        y, new_state = linear_recurrence(
            q, k, v, log_a, include_current=True, initial_state=ssm_state, decay_per="head")
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(B, S, d_in)
    # gated RMSNorm (Mamba2): norm(y * silu(z))
    y = y * F.silu(z)
    y32 = y.float()
    var = torch.mean(torch.square(y32), dim=-1, keepdim=True)
    y = (y32 * torch.rsqrt(var + 1e-5) * p["norm_scale"]).to(x.dtype)
    return y @ p["out_proj"], (new_conv, new_state)


def init_mamba2_state(cfg, batch: int, dtype=torch.float32, device="cpu"):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.state_dim
    return (torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype, device=device),
            torch.zeros((batch, nheads, s.state_dim, s.head_dim), dtype=torch.float32,
                        device=device))


# ================================================================ RWKV6 ===

def init_rwkv6(fac: ParamFactory, cfg):
    d, ff, r = cfg.d_model, cfg.d_ff, cfg.rwkv
    H = d // r.head_dim
    names = ("r", "k", "v", "g", "w")
    p = {
        # time-mix ddlerp: x_c = x + (shift(x)-x) * (mu_c + lora)
        "mu": {c: fac.param((d,), ("embed",), init="uniform", scale=0.5) for c in names},
        "mix_A": fac.param((d, 5 * cfg.rwkv.mix_lora), ("embed", None)),
        "mix_B": {c: fac.param((r.mix_lora, d), (None, "embed")) for c in names},
        "wr": fac.param((d, d), ("embed", "heads")),
        "wk": fac.param((d, d), ("embed", "heads")),
        "wv": fac.param((d, d), ("embed", "heads")),
        "wg": fac.param((d, d), ("embed", "heads")),
        "wo": fac.param((d, d), ("heads", "embed")),
        "w0": fac.param((d,), ("embed",), init="constant", scale=-0.6),
        "decay_A": fac.param((d, r.decay_lora), ("embed", None)),
        "decay_B": fac.param((r.decay_lora, d), (None, "embed")),
        "u": fac.param((H, r.head_dim), (None, None), init="uniform", scale=0.5),
        "ln_x": init_group_norm(fac, H, r.head_dim),
        # channel mix
        "cm_mu_k": fac.param((d,), ("embed",), init="uniform", scale=0.5),
        "cm_mu_r": fac.param((d,), ("embed",), init="uniform", scale=0.5),
        "cm_k": fac.param((d, ff), ("embed", "mlp")),
        "cm_v": fac.param((ff, d), ("mlp", "embed")),
        "cm_r": fac.param((d, d), ("embed", "heads")),
    }
    return p


def _token_shift(x, last=None):
    """shift(x)_t = x_{t-1}; last (B,d) is the carry for decode/chunking."""
    B, S, d = x.shape
    first = (torch.zeros((B, 1, d), dtype=x.dtype, device=x.device) if last is None
             else last[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def rwkv6_time_mix(p, cfg, x, shift_state=None, wkv_state=None):
    B, S, d = x.shape
    r_cfg = cfg.rwkv
    H, hd = d // r_cfg.head_dim, r_cfg.head_dim
    xx = _token_shift(x, shift_state) - x
    lora = torch.tanh(x @ p["mix_A"]).reshape(B, S, 5, r_cfg.mix_lora)
    mixed = {}
    for i, c in enumerate(("r", "k", "v", "g", "w")):
        mu = p["mu"][c] + lora[:, :, i] @ p["mix_B"][c]
        mixed[c] = x + xx * mu
    r = (mixed["r"] @ p["wr"]).reshape(B, S, H, hd)
    k = (mixed["k"] @ p["wk"]).reshape(B, S, H, hd)
    v = (mixed["v"] @ p["wv"]).reshape(B, S, H, hd)
    g = F.silu(mixed["g"] @ p["wg"])
    log_w = -torch.exp((p["w0"] + torch.tanh(mixed["w"] @ p["decay_A"]) @ p["decay_B"]
                        ).float())                              # (B,S,d) <= 0
    log_a = log_w.reshape(B, S, H, hd)

    if S == 1 and wkv_state is not None:
        y, new_wkv = recurrence_decode_step(
            wkv_state, r[:, 0], k[:, 0], v[:, 0], log_a[:, 0], u=p["u"],
            include_current=False)
        y = y[:, None]
    else:
        # the kernel takes u and the state in fp32 (bf16 u * fp32 kv
        # promotes to fp32 in the reference too)
        y, new_wkv = linear_recurrence(
            r, k, v, log_a, u=p["u"].float(), include_current=False,
            initial_state=wkv_state, decay_per="dim")
    y = apply_group_norm(p["ln_x"], y).reshape(B, S, d)
    y = (y * g) @ p["wo"]
    return y, (x[:, -1], new_wkv)


def rwkv6_channel_mix(p, x, shift_state=None):
    xx = _token_shift(x, shift_state) - x
    xk = x + xx * p["cm_mu_k"]
    xr = x + xx * p["cm_mu_r"]
    kk = torch.square(F.relu(xk @ p["cm_k"]))
    return torch.sigmoid(xr @ p["cm_r"]) * (kk @ p["cm_v"]), x[:, -1]


def init_rwkv6_state(cfg, batch: int, dtype=torch.float32, device="cpu"):
    d = cfg.d_model
    H, hd = d // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    return (torch.zeros((batch, d), dtype=dtype, device=device),            # tm shift
            torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),  # wkv state
            torch.zeros((batch, d), dtype=dtype, device=device))            # cm shift
