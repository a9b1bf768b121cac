"""The gradient of repro_torch's linear_scan: its plain backward
(``ref.recurrence_bwd``, the arithmetic of ``csrc/linear_scan_bwd.cu``)
and the ``LinearScan`` autograd Function around the kernels, on the CPU,
and the backward kernel on the card.

Tolerances:
* ``ref.recurrence_bwd`` against autograd through the plain forward
  (``ref.scan``) in float64: both are exact derivations of one function,
  summed in other orders, so **1e-10** of each gradient's scale;
* against ``jax.vjp`` of the reference's chunked ``linear_recurrence`` in
  fp32: sums in another order and the reference's chunked factorisation,
  **1e-4** of each gradient's scale (as tests/test_torch_hybrid.py holds
  the forward), compared where the reference's gradient is finite (its
  factorised exponents overflow past exp 88, ROADMAP.md §3 item 10: the
  draws here keep every chunk's summed decay far inside that range);
* rwkv6_3b's smoke model, loss and every leaf's gradient against the
  reference's ``loss_fn``: fp32 sums in another order, **1e-4** of scale;
* on the card (``gpu``), the kernel against ``ref.recurrence_bwd`` on the
  same inputs: 2e-4 of each gradient's scale in fp32 (sums in another
  order over 1024 steps; the forward scan's state is held to 2e-4), 2e-2
  in bf16 (dq, dk, dv are rounded to bf16, as the attention backward's
  gradients are).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import decoder as jdec  # noqa: E402
from repro.models.recurrence import linear_recurrence as jlinear_recurrence  # noqa: E402
from repro.models.registry import get_smoke_config as jget_smoke  # noqa: E402
from repro_torch.common.pytree import tree_leaves  # noqa: E402
from repro_torch.kernels.linear_scan import ops as ls_ops, ref as ls_ref  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

NAMES = ("dq", "dk", "dv", "dla", "du", "d_initial_state")
B, S, H, K, V = 2, 23, 3, 5, 4      # S ragged against the reference's chunk of 8


def _np(x):
    if torch.is_tensor(x):
        return x.detach().double().cpu().numpy()
    return np.asarray(x, np.float64)


def scaled_close(got, want, tol, what=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = float(np.abs(g - w).max()) if g.size else 0.0
    assert err <= tol * (float(np.abs(w).max()) + 1e-12), (what, err, float(np.abs(w).max()))


def _draw(seed, form, *, with_u, with_s0, with_ds, la="wide", dims=(B, S, H, K, V)):
    """numpy inputs of one case: q, k (B,S,H,K), v, dy (B,S,H,V), la per
    dim (B,S,H,K) or per head (B,S,H), u (H,K), initial state and final
    state's gradient (B,H,K,V), the optional ones None.  ``la`` "wide":
    -exp(1.5 z), about one in twelve below -8 and some below -20; "mild":
    the reference's own range (rwkv6's -exp(0.5 z - 0.6) per dim,
    Mamba2's -softplus(z) per head); "clamp": "mild" with a sixth of the
    entries at the clamp, -8; "init": the decays as the models are
    initialised in their papers (Mamba2: -A softplus(dt_proj + dt_bias),
    A in [1, 16] and softplus(dt_bias) in [1e-3, 0.1] a head; rwkv6:
    -exp(w0 + lora), w0 from -6 to -1 over the channels)."""
    B, S, H, K, V = dims
    rs = np.random.RandomState(seed)
    f = lambda *shape: rs.randn(*shape).astype(np.float32)
    q, k, v, dy = f(B, S, H, K), f(B, S, H, K), f(B, S, H, V), f(B, S, H, V)
    shape = (B, S, H) if form == "head" else (B, S, H, K)
    z = f(*shape)
    if la == "wide":
        lav = -np.exp(1.5 * z)
    elif la == "init" and form == "head":
        dt0 = np.exp(rs.uniform(np.log(1e-3), np.log(0.1), H))
        dt_bias = dt0 + np.log(-np.expm1(-dt0))
        lav = -rs.uniform(1.0, 16.0, H) * np.log1p(np.exp(0.5 * z + dt_bias))
    elif la == "init":
        n = np.arange(H * K).reshape(H, K) / (H * K - 1)
        lav = -np.exp(-6.0 + 5.0 * n ** 1.35 + 0.1 * z)
    elif form == "head":
        lav = -np.log1p(np.exp(z))
    else:
        lav = -np.exp(0.5 * z - 0.6)
    if la == "clamp":
        lav = np.where(z < -1.0, ls_ref.LOG_A_MIN, lav)
    u = f(H, K) if with_u else None
    s0 = f(B, H, K, V) if with_s0 else None
    ds = f(B, H, K, V) if with_ds else None
    return q, k, v, lav.astype(np.float32), u, s0, dy, ds


def _t(x, dtype=torch.float64):
    return None if x is None else torch.from_numpy(x).to(dtype)


def _autograd(q, k, v, la, u, s0, dy, ds, cur, forward=ls_ref.recurrence):
    """Gradients of <y, dy> + <final state, ds> by autograd through
    ``forward``, in NAMES order (None where an input is None)."""
    leaves = [None if x is None else x.detach().clone().requires_grad_(True)
              for x in (q, k, v, la, u, s0)]
    y, st = forward(*leaves[:5], include_current=cur, initial_state=leaves[5])
    loss = (y * dy).sum() + ((st * ds).sum() if ds is not None else 0.0)
    live = [x for x in leaves if x is not None]
    grads = iter(torch.autograd.grad(loss, live, allow_unused=True))
    out = []
    for x in leaves:
        g = None if x is None else next(grads)
        out.append(torch.zeros_like(x) if x is not None and g is None else g)
    return out


# ----------------------------------------------- the plain backward, exact ---

@pytest.mark.parametrize("with_ds", [False, True])
@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("with_u", [False, True])
@pytest.mark.parametrize("cur", [True, False])
@pytest.mark.parametrize("form", ["dim", "head"])
def test_plain_backward_equals_autograd_float64(form, cur, with_u, with_s0, with_ds):
    """Both forms, include_current either way, with and without u, an
    initial state and a final state's gradient, log-decays crossing the
    per-dim clamp at -8 (its gradient is 0 below it)."""
    q, k, v, la, u, s0, dy, ds = (_t(x) for x in _draw(
        1 + with_u + 2 * with_s0 + 4 * with_ds, form, with_u=with_u, with_s0=with_s0,
        with_ds=with_ds))
    assert float(la.min()) < ls_ref.LOG_A_MIN < float(la.max())
    got = ls_ref.recurrence_bwd(q, k, v, la, u, dy, ds, include_current=cur, initial_state=s0)
    want = _autograd(q, k, v, la, u, s0, dy, ds, cur)
    for name, g, w in zip(NAMES, got, want):
        if name == "du" and (cur or u is None):
            assert g is None      # the Mamba2 form reads no u; no u, no gradient
            continue
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == torch.float64 and g.shape == w.shape, name
        scaled_close(g, w, 1e-10, name)
    if form == "dim":             # entries the clamp cut get no gradient
        assert bool((got[3][la < ls_ref.LOG_A_MIN] == 0).all())


def test_plain_backward_rounds_to_the_input_dtype():
    """bf16 q, k, v, dy: dq, dk, dv come back in bf16, the rest in fp32,
    each the fp32 computation rounded once."""
    q, k, v, la, u, s0, dy, ds = _draw(9, "dim", with_u=True, with_s0=True, with_ds=True)
    bf = [_t(x, torch.bfloat16) for x in (q, k, v, dy)]
    f32 = [_t(x, torch.float32) for x in (la, u, s0, ds)]
    got = ls_ref.recurrence_bwd(bf[0], bf[1], bf[2], f32[0], f32[1], bf[3], f32[3],
                                include_current=False, initial_state=f32[2])
    want = ls_ref.recurrence_bwd(*(x.float() for x in bf[:3]), f32[0], f32[1], bf[3].float(),
                                 f32[3], include_current=False, initial_state=f32[2])
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32] * 3
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(g.dtype))


# ------------------------------- the bf16 route's algebra, chunk by chunk ---

CHUNKED_EXTRAS = {"none": (False, False, False), "u": (True, False, False),
                  "s0": (False, True, False), "ds": (False, False, True),
                  "all": (True, True, True)}


@pytest.mark.parametrize("Sc", [1, ls_ref.CHUNK - 1, ls_ref.CHUNK + 1, 77])
@pytest.mark.parametrize("extras", list(CHUNKED_EXTRAS))
@pytest.mark.parametrize("cur", [True, False])
@pytest.mark.parametrize("form", ["dim", "head"])
def test_chunked_backward_equals_plain_float64(form, cur, extras, Sc):
    """``ref.recurrence_bwd_chunked`` in float64 (edge states, each chunk
    alone, dla from its four parts) against ``ref.recurrence_bwd``: both
    exact, summed in other orders, so 1e-10 of each gradient's scale; K,
    V = 12, 40; S within one chunk, one step short of and past one, and
    three chunks; log-decays spread below the clamp and, per head, below
    -20.  Where dla's exact value is 0 (S = 1, no initial state) both
    sides are rounding, so its scale is floored at its query terms'."""
    with_u, with_s0, with_ds = CHUNKED_EXTRAS[extras]
    q, k, v, la, u, s0, dy, ds = (_t(x) for x in _draw(
        100 + Sc + 7 * len(extras), form, with_u=with_u, with_s0=with_s0, with_ds=with_ds,
        dims=(2, Sc, 3, 12, 40)))
    if form == "head" and Sc > 1:
        assert float(la.min()) < -20
    want = ls_ref.recurrence_bwd(q, k, v, la, u, dy, ds, include_current=cur, initial_state=s0)
    got = ls_ref.recurrence_bwd_chunked(q, k, v, la, u, dy, ds, include_current=cur,
                                        initial_state=s0, dtype=torch.float64)
    terms = q * want[0]
    terms = terms.sum(-1) if form == "head" else terms
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        scale = float(w.abs().max())
        if name == "dla":
            scale = max(scale, float(terms.abs().max()))
        assert float((g - w).abs().max()) <= 1e-10 * scale, name


# (B, S, H, K, V, form, la): zamba2_7b's smoke Mamba2 layer (16 heads of
# 32, state 16) with log-decays spread below -20, and rwkv6_3b's smoke
# layer (4 heads of 32) with a sixth of them at the clamp; each also with
# its decays as initialised, which carry states across all 16 chunks
FP32_CASES = {"zamba2": ((2, 512, 16, 16, 32), "head", "wide"),
              "rwkv6": ((2, 512, 4, 32, 32), "dim", "clamp"),
              "zamba2_init": ((2, 512, 16, 16, 32), "head", "init"),
              "rwkv6_init": ((2, 512, 4, 32, 32), "dim", "init")}


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("case", list(FP32_CASES))
def test_chunked_backward_in_fp32_needs_no_float64(case, split):
    """The bf16 route's algebra in fp32 against the float64 plain
    backward: dla, and each head's sum over (b, t) of dla la (Mamba2's
    A_log gradient, la = -exp(A_log) softplus(dt); per dim each (head,
    dim)'s, rwkv6's w0 gradient).  Without ``split``
    within 1e-4 and 1e-5 of their scale, ten times under the 1.04e-4
    that the identity over the whole sequence left in fp32; with
    ``split`` (each tensor-core operand as bf16 hi + lo) within 1e-3 and
    1e-4, the bars the card's kernel is held to."""
    dims, form, la_kind = FP32_CASES[case]
    cur = form == "head"
    q, k, v, la, u, s0, dy, ds = (_t(x, torch.float32) for x in _draw(
        7, form, with_u=not cur, with_s0=False, with_ds=False, la=la_kind, dims=dims))
    if la_kind == "wide":
        assert float(la.min()) < -20
    elif la_kind == "clamp":
        assert 0.1 < float((la == ls_ref.LOG_A_MIN).float().mean()) < 0.25
    else:     # some decays keep more than half a state over a chunk
        assert float(la.max()) * ls_ref.CHUNK > -0.7
    want = ls_ref.recurrence_bwd(q, k, v, la, u, dy, ds, include_current=cur)[3].double()
    got = ls_ref.recurrence_bwd_chunked(q, k, v, la, u, dy, ds, include_current=cur,
                                        split=split)[3]
    assert got.dtype == torch.float32
    got = got.double()
    tol_dla, tol_sum = (1e-3, 1e-4) if split else (1e-4, 1e-5)
    scaled_close(got, want, tol_dla, "dla")
    scaled_close((got * la.double()).sum((0, 1)), (want * la.double()).sum((0, 1)), tol_sum,
                 "sum of dla la")


# --------------------------------------------- against the reference's vjp ---

# form, include_current, u, initial state, final state's gradient, la.
# The per-head form is compared as Mamba2 runs it (include_current): the
# reference's per-head bonus form decays its intra-chunk scores by
# exp(cum_t - cum_s) where the recurrence has exp(cum_{t-1} - cum_s), so
# it is not the sequential recurrence the port computes; no model uses it.
JAX_CASES = {
    "rwkv6": ("dim", False, True, True, True, "mild"),
    "rwkv6_clamped": ("dim", False, True, False, False, "clamp"),
    "mamba2": ("head", True, False, True, True, "mild"),
    "mamba2_no_state": ("head", True, False, False, False, "mild"),
    "dim_current": ("dim", True, False, False, True, "mild"),
}


@pytest.mark.parametrize("plain", ["recurrence_bwd", "recurrence_bwd_chunked"])
@pytest.mark.parametrize("case", list(JAX_CASES))
def test_plain_backward_matches_reference_vjp(case, plain):
    """fp32: ``ref.recurrence_bwd`` (the fp32 route's arithmetic) and
    ``ref.recurrence_bwd_chunked`` (the bf16 route's, in fp32) against
    ``jax.vjp`` of the reference's chunked ``linear_recurrence`` (chunk 8)
    on the same numpy inputs.  "rwkv6_clamped" puts a tenth of the
    log-decays below the clamp (each chunk's summed decay stays above -88
    at chunk 8, where the reference's factorised form is finite)."""
    form, cur, with_u, with_s0, with_ds, la_kind = JAX_CASES[case]
    q, k, v, la, u, s0, dy, ds = _draw(20 + len(case), form, with_u=with_u, with_s0=with_s0,
                                       with_ds=with_ds, la="wide" if la_kind == "clamp" else "mild")
    if la_kind == "clamp":
        la = np.where(la < ls_ref.LOG_A_MIN, -10.0, np.maximum(la, -3.0)).astype(np.float32)
        assert 0 < (la < ls_ref.LOG_A_MIN).mean() < 0.2
    decay_per = "head" if form == "head" else "dim"
    args = [jnp.asarray(x) for x in (q, k, v, la)]
    extra = [jnp.asarray(x) for x in (u, s0) if x is not None]

    def jf(q_, k_, v_, la_, *rest):
        rest = list(rest)
        u_ = rest.pop(0) if u is not None else None
        s0_ = rest.pop(0) if s0 is not None else None
        return jlinear_recurrence(q_, k_, v_, la_, u_, include_current=cur, initial_state=s0_,
                                  chunk=8, decay_per=decay_per)

    (jy, jst), vjp = jax.vjp(jf, *args, *extra)
    dst = np.zeros((B, H, K, V), np.float32) if ds is None else ds
    jgrads = list(vjp((jnp.asarray(dy), jnp.asarray(dst))))
    want = {"dq": jgrads[0], "dk": jgrads[1], "dv": jgrads[2], "dla": jgrads[3]}
    rest = jgrads[4:]
    if u is not None:
        want["du"] = rest.pop(0)
    if s0 is not None:
        want["d_initial_state"] = rest.pop(0)
    y, st = ls_ops.recurrence(*(_t(x, torch.float32) for x in (q, k, v, la, u)),
                              include_current=cur, initial_state=_t(s0, torch.float32))
    scaled_close(y, jy, 1e-4, "y")
    scaled_close(st, jst, 1e-4, "final state")
    got = dict(zip(NAMES, getattr(ls_ref, plain)(
        *(_t(x, torch.float32) for x in (q, k, v, la, u, dy, ds)), include_current=cur,
        initial_state=_t(s0, torch.float32))))
    for name, w in want.items():
        w = np.asarray(w, np.float64)
        g = _np(got[name]) if got[name] is not None else np.zeros_like(w)
        finite = np.isfinite(w)
        assert finite.mean() > 0.99, (name, float(finite.mean()))
        err = float(np.abs(g - w)[finite].max())
        assert err <= 1e-4 * float(np.abs(w[finite]).max()), (name, err)


# ------------------------------------------------- the Function on the CPU ---

@pytest.mark.parametrize("form", ["rwkv6", "mamba2", "mamba2_broadcast"])
def test_function_cpu_route_equals_autograd_through_plain_forward(form):
    """``ops.recurrence`` (the LinearScan Function, whose CPU backward is
    ``ref.recurrence_bwd``) against autograd through ``ref.recurrence`` in
    float64, every input's gradient, no kernel launched; Mamba2's C and B
    broadcast over the heads (head stride 0) get theirs summed over the
    heads by the broadcast's own backward."""
    head = form != "rwkv6"
    q, k, v, la, u, s0, dy, ds = (_t(x) for x in _draw(
        31, "head" if head else "dim", with_u=not head, with_s0=True, with_ds=True))
    cur = head
    before = (ls_ops.launches, ls_ops.bwd_launches)
    if form == "mamba2_broadcast":
        C, Bc = q[:, :, 0].clone().requires_grad_(True), k[:, :, 0].clone().requires_grad_(True)
        rest = [x.clone().requires_grad_(True) for x in (v, la, s0)]

        def run(fn):
            y, st = fn(C[:, :, None].expand(B, S, H, K), Bc[:, :, None].expand(B, S, H, K),
                       rest[0], rest[1], None, include_current=True, initial_state=rest[2])
            loss = (y * dy).sum() + (st * ds).sum()
            return torch.autograd.grad(loss, [C, Bc, *rest])

        got, want = run(ls_ops.recurrence), run(ls_ref.recurrence)
        assert got[0].shape == (B, S, K) and got[1].shape == (B, S, K)
    else:
        got = _autograd(q, k, v, la, u, s0, dy, ds, cur, forward=ls_ops.recurrence)
        want = _autograd(q, k, v, la, u, s0, dy, ds, cur)
    assert (ls_ops.launches, ls_ops.bwd_launches) == before
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
            continue
        scaled_close(g, w, 1e-10, f"input {i}")


def test_function_final_state_alone_and_no_grad():
    """A loss of the final state alone (y unused: dy is None in the
    backward) and the forward under no_grad (no graph) both work."""
    q, k, v, la, u, s0, dy, ds = (_t(x) for x in _draw(
        33, "dim", with_u=True, with_s0=False, with_ds=True))
    vr = v.clone().requires_grad_(True)
    _, st = ls_ops.recurrence(q, k, vr, la, u, include_current=False)
    got, = torch.autograd.grad((st * ds).sum(), vr)
    vr2 = v.clone().requires_grad_(True)
    _, st2 = ls_ref.recurrence(q, k, vr2, la, u, include_current=False)
    want, = torch.autograd.grad((st2 * ds).sum(), vr2)
    scaled_close(got, want, 1e-10, "dv from the final state")
    with torch.no_grad():
        y, st = ls_ops.recurrence(q, k, vr, la, u, include_current=False)
    assert not y.requires_grad and not st.requires_grad


# ---------------------------------------- rwkv6_3b's smoke model, trained ---

@pytest.fixture(scope="module")
def rwkv_params():
    """The reference's rwkv6_3b smoke parameters (seed 0), numpy."""
    return jax.tree.map(np.asarray, jdec.init_params(jget_smoke("rwkv6_3b"), jax.random.key(0)))


def _batch(cfg, seed, Bt=2, T=17):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, size=(Bt, T)).astype(np.int32)
    labels = rs.randint(0, cfg.vocab_size, size=(Bt, T)).astype(np.int32)
    labels[0, :3] = -1
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long()})


@pytest.mark.parametrize("remat", [True, False])
def test_rwkv6_loss_and_every_leaf_gradient_match_reference(rwkv_params, remat):
    """fp32: rwkv6_3b's smoke model, loss_fn and the gradient of every
    leaf (through the LinearScan Function's CPU route, checkpointed or
    not) against jax.value_and_grad of the reference's loss_fn."""
    jcfg = jget_smoke("rwkv6_3b").replace(compute_dtype="float32")
    tcfg = registry.get_smoke_config("rwkv6_3b").replace(compute_dtype="float32")
    jb, tb = _batch(jcfg, 60)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jdec.loss_fn(jcfg, p, b), has_aux=True))(rwkv_params, jb)
    loss, grads = tsteps.value_and_grad(lambda p, b: tdec.loss_fn(tcfg, p, b, remat=remat),
                                        from_jax_params(rwkv_params), tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    leaves, jleaves = tree_leaves(grads), jax.tree.leaves(jgrads)
    assert len(leaves) == len(jleaves)
    for i, (g, w) in enumerate(zip(leaves, jleaves)):
        assert float(np.abs(np.asarray(w)).max()) > 0, i
        scaled_close(g, np.asarray(w), 1e-4, f"leaf {i}")


def test_rwkv6_train_entry_point_runs_on_the_cpu():
    """``repro_torch.launch.train.run("rwkv6_3b", smoke=True,
    device="cpu")``, the CLI's entry: four steps through the scan's
    autograd Function, each on its own batch, each loss finite."""
    from repro_torch.launch import train as ttrain
    losses = ttrain.run("rwkv6_3b", smoke=True, steps=4, batch=2, seq=16, lr=1e-2,
                        device="cpu", verbose=False)
    assert len(losses) == 4 and all(np.isfinite(losses))


# ------------------------------------------------------------- on the card ---

@pytest.fixture
def cuda():
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on an H100 host)")
    try:
        build.nvcc_path()
        build.require_hopper()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda")


GPU_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
BF16_F32_OUT_TOL = 1e-3   # bf16 inputs: dla, du and d_initial_state, fp32 outputs
BF16_DECAY_SUM_TOL = 1e-4  # bf16 inputs: the sum of dla la over (b, t), the decay's gradient
CHUNK = ls_ref.CHUNK      # the bf16 route's chunk


# form -> (per-head la, include_current): the models' two, and the other
# two pairings the kernels also take
CARD_FORMS = {"rwkv6": (False, False), "mamba2": (True, True), "dim_current": (False, True),
              "head_bonus": (True, False)}


def _card_case(cuda, seed, Bc, Sc, Hc, Kc, Vc, form, dtype, with_s0, with_ds, la_kind="wide"):
    """Inputs on the card.  ``la_kind`` "wide": -exp(1.5 z), per head
    spread below -20, per dim a tenth below the clamp; "clamp": every
    log-decay at the clamp, -8; "init": the decays as the models are
    initialised in their papers, which carry states across many chunks
    (Mamba2: -A softplus(dt_proj + dt_bias), A in [1, 16] and
    softplus(dt_bias) in [1e-3, 0.1] a head; rwkv6: -exp(w0 + lora),
    w0 from -6 to -1 over the channels)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    dt = getattr(torch, dtype)
    r = lambda *shape: torch.randn(*shape, generator=g, device=cuda)
    head, cur = CARD_FORMS[form]
    if head:                  # C and B broadcast over the heads
        q, k = (r(Bc, Sc, Kc).to(dt)[:, :, None].expand(Bc, Sc, Hc, Kc) for _ in range(2))
        la = -torch.exp(1.5 * r(Bc, Sc, Hc))
    else:
        q, k = r(Bc, Sc, Hc, Kc).to(dt), r(Bc, Sc, Hc, Kc).to(dt)
        la = -torch.exp(1.5 * r(Bc, Sc, Hc, Kc))
    if la_kind == "clamp":
        la = torch.full_like(la, ls_ref.LOG_A_MIN)
    elif la_kind == "init" and head:
        uni = lambda lo, hi: lo + (hi - lo) * torch.rand(Hc, generator=g, device=cuda)
        dt0 = torch.exp(uni(np.log(1e-3), np.log(0.1)))
        dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
        la = -uni(1.0, 16.0) * torch.nn.functional.softplus(0.5 * r(Bc, Sc, Hc) + dt_bias)
    elif la_kind == "init":
        n = torch.arange(Hc * Kc, device=cuda).reshape(Hc, Kc) / (Hc * Kc - 1)
        la = -torch.exp(-6.0 + 5.0 * n ** 1.35 + 0.1 * r(Bc, Sc, Hc, Kc))
    v, dy = r(Bc, Sc, Hc, Vc).to(dt), r(Bc, Sc, Hc, Vc).to(dt)
    u = r(Hc, Kc) if not cur else None
    s0 = r(Bc, Hc, Kc, Vc) if with_s0 else None
    ds = r(Bc, Hc, Kc, Vc) if with_ds else None
    return q, k, v, la, u, s0, dy, ds


def _bwd_cases():
    """(Bc, Sc, Hc, Kc, Vc, with_s0, with_ds, form, la_kind): the models'
    two forms at five shapes with la spread wide; three chunks at the
    clamp, the last one step long, each decayed to exp(-256) across; the
    two pairings no model uses at K, V = 20, 36 (zero-padded to 24, 40 on
    the bf16 route); and both forms over 32 chunks with the decays as
    the models are initialised."""
    shapes = [(2, 1, 3, 64, 64, False, False), (2, 33, 3, 64, 64, True, True),
              (1, 1000, 5, 64, 64, True, False), (3, 77, 4, 12, 40, False, True),
              (2, 1024, 40, 64, 64, False, False)]
    cases = [pytest.param(*s, form, "wide", id="-".join(map(str, (*s, form))))
             for form in ("rwkv6", "mamba2") for s in shapes]
    extra = [(2, 2 * CHUNK + 1, 3, 64, 64, True, True, "rwkv6", "clamp"),
             (2, 77, 3, 20, 36, True, True, "dim_current", "wide"),
             (2, 77, 3, 20, 36, True, True, "head_bonus", "wide"),
             (2, 1024, 8, 64, 64, True, True, "rwkv6", "init"),
             (2, 1024, 8, 64, 64, True, True, "mamba2", "init")]
    return cases + [pytest.param(*c, id="-".join(map(str, c))) for c in extra]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bc,Sc,Hc,Kc,Vc,with_s0,with_ds,form,la_kind", _bwd_cases())
def test_gpu_linear_scan_backward_matches_plain(cuda, Bc, Sc, Hc, Kc, Vc, with_s0, with_ds,
                                                form, la_kind, dtype):
    """The backward kernel (``_launch_bwd``) against ``ref.recurrence_bwd``
    on the same inputs, every gradient within GPU_TOL of its scale, and
    with bf16 inputs the fp32 outputs (dla, du, d_initial_state) within
    BF16_F32_OUT_TOL and, where S > 1, the sum over (b, t) of dla la a
    head (per dim: a (head, dim); the gradient of Mamba2's A_log or
    rwkv6's w0) within BF16_DECAY_SUM_TOL of the float64 plain
    version's; a second launch gives the same bits.  dla is a sum of
    query terms q dq less key terms k dk, which cancel exactly where y
    does not depend on la (S = 1 with no initial state): both sides are
    then rounding, so its scale is floored at its terms' own."""
    q, k, v, la, u, s0, dy, ds = _card_case(cuda, Sc + Kc, Bc, Sc, Hc, Kc, Vc, form, dtype,
                                            with_s0, with_ds, la_kind)
    cur = CARD_FORMS[form][1]
    before = ls_ops.bwd_launches
    got = ls_ops._launch_bwd(q, k, v, la, u, dy, ds, cur, s0)
    again = ls_ops._launch_bwd(q, k, v, la, u, dy, ds, cur, s0)
    torch.cuda.synchronize()
    assert ls_ops.bwd_launches == before + 2
    want = ls_ref.recurrence_bwd(q, k, v, la, u, dy, ds, include_current=cur, initial_state=s0)
    terms = q.float() * want[0].float()
    terms = terms.sum(-1) if la.dim() == 3 else terms
    for name, a, b, c in zip(NAMES, got, want, again):
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape and bool(torch.isfinite(a).all()), name
        err, scale = float((a.float() - b.float()).abs().max()), float(b.float().abs().max())
        if name == "dla":
            scale = max(scale, float(terms.abs().max()))
        assert err <= GPU_TOL[dtype] * scale, (name, err, scale)
        if dtype == "bfloat16" and name in ("dla", "du", "d_initial_state"):
            assert err <= BF16_F32_OUT_TOL * scale, (name, err, scale)
        assert torch.equal(a, c), name
    if dtype == "bfloat16" and Sc > 1:
        want_sum = (want[3].double() * la.double()).sum((0, 1))
        got_sum = (got[3].double() * la.double()).sum((0, 1))
        err, scale = float((got_sum - want_sum).abs().max()), float(want_sum.abs().max())
        assert err <= BF16_DECAY_SUM_TOL * scale, ("sum of dla la", err, scale)


@pytest.mark.gpu
def test_gpu_linear_scan_function_backward_launches_the_kernel(cuda):
    """Autograd through ``ops.recurrence`` on the card: one forward and one
    backward launch, Mamba2's C and B gradients summed over the heads."""
    q, k, v, la, _, s0, dy, ds = _card_case(cuda, 3, 2, 70, 6, 64, 64, "mamba2", "float32",
                                            True, True)
    C = q[:, :, 0].clone().requires_grad_(True)
    Bm = k[:, :, 0].clone().requires_grad_(True)
    vr, lar, s0r = (x.clone().requires_grad_(True) for x in (v, la, s0))
    before = (ls_ops.launches, ls_ops.bwd_launches)
    y, st = ls_ops.recurrence(C[:, :, None].expand(q.shape), Bm[:, :, None].expand(k.shape), vr,
                              lar, initial_state=s0r)
    grads = torch.autograd.grad((y * dy).sum() + (st * ds).sum(), [C, Bm, vr, lar, s0r])
    assert (ls_ops.launches - before[0], ls_ops.bwd_launches - before[1]) == (1, 1)
    want = ls_ref.recurrence_bwd(q, k, v, la, None, dy, ds, include_current=True,
                                 initial_state=s0)
    wq, wk = want[0].sum(2), want[1].sum(2)
    for name, a, b in zip(("dC", "dB", "dv", "dla", "ds0"), grads,
                          (wq, wk, want[2], want[3], want[5])):
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        assert err <= GPU_TOL["float32"] * scale, (name, err, scale)


@pytest.mark.gpu
def test_gpu_linear_scan_backward_refuses_what_it_does_not_take(cuda):
    """K = 96 (beyond the kernels' 64) and float16 raise on the card
    before any launch; nothing falls back to the plain backward."""
    q, k, v, la, u, _, dy, _ = _card_case(cuda, 5, 1, 8, 2, 96, 64, "rwkv6", "float32",
                                          False, False)
    before = ls_ops.bwd_launches
    with pytest.raises(ValueError, match="K, V <= 64"):
        ls_ops._launch_bwd(q, k, v, la, u, dy, None, False, None)
    with pytest.raises(ValueError, match="K, V <= 64"):
        ls_ops.recurrence(q.requires_grad_(True), k, v, la, u, include_current=False)
    h = [x[..., :64].half() for x in (q.detach(), k, v, dy)]
    with pytest.raises(TypeError):
        ls_ops._launch_bwd(h[0], h[1], h[2], la[..., :64], u[:, :64], h[3], None, False, None)
    assert ls_ops.bwd_launches == before
