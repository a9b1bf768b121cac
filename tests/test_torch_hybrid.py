"""repro_torch's hybrid layer family (Mamba2 with per-head decay and the
shared attention block of zamba2_7b) against repro's, on the same numpy
inputs and the reference's own parameters (carried over with
from_jax_params).

Tolerances are tests/test_torch_llm_serve.py's: at fp32 compute the two
packages differ only in the order of fp32 sums (the reference's chunked
recurrence against the port's sequential one), so outputs, states,
logits and gradients agree to 1e-4 of their scale (``TOL``); at bf16
compute they round at different places and agree to 2e-2 of it.  bf16
decode-cache entries may sit one bf16 step apart (``bf16_cache_close``).
The per-head recurrence is held with log-decays far below -8, where the
per-dim form's clamp would move its output by more than ``TOL``.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import SSMConfig as JSSMConfig  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.models import recurrence as jrec  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.models.registry import get_smoke_config as jget_smoke_config  # noqa: E402
from repro_torch.common.pytree import tree_flatten, tree_leaves, tree_map  # noqa: E402
from repro_torch.configs.base import EncoderConfig, SSMConfig  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.linear_scan import ops as ls_ops  # noqa: E402
from repro_torch.kernels.linear_scan import ref as ls_ref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models import recurrence as trec  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.weights import from_jax_params, to_numpy_params  # noqa: E402

ARCH = "zamba2_7b"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the smoke model, and one with zamba2_7b's head_dim 112 and SSM (state 64,
# head 64: 8 SSM heads at d_model 256), so that its shapes run through the
# plain versions here
VARIANTS = {"smoke": {}, "hd112": dict(head_dim=112)}
HD112_SSM = dict(state_dim=64, head_dim=64, expand=2, conv_width=4, chunk=16)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def scaled_close(got, want, tol, what=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = float(np.abs(g - w).max()) if g.size else 0.0
    scale = float(np.abs(w).max()) + 1e-6
    assert err <= tol * scale, (what, err, scale)


def gap(got, want):
    g, w = _np(got), _np(want)
    return float(np.abs(g - w).max() / (np.abs(w).max() + 1e-6))


def bf16_cache_close(got, want, what=""):
    """bf16 cache entries: one bf16 step of the entry apart, plus the fp32
    difference ``TOL`` of the leaf's scale that the two packages' values
    may have before they are rounded (an entry near zero, where terms
    cancel, can straddle several bf16 steps of its own size)."""
    g, w = _np(got), _np(want)
    big = np.maximum(np.maximum(np.abs(g), np.abs(w)), 2.0 ** -126)
    step = 2.0 ** (np.floor(np.log2(big)) - 7)        # bf16 keeps 8 significant bits
    slack = TOL["float32"] * float(np.abs(w).max())
    assert (np.abs(g - w) <= step + slack).all(), (what, float(np.abs(g - w).max()))


def rnd(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def both(x, dtype="float32"):
    """One numpy array -> (jax array, torch tensor) of ``dtype``."""
    return jnp.asarray(x, dtype), torch.from_numpy(np.array(x)).to(TORCH_DT[dtype])


def configs(variant="smoke", compute="float32", **kw):
    kw = dict(VARIANTS[variant], compute_dtype=compute, **kw)
    jcfg = jget_smoke_config(ARCH).replace(**kw)
    tcfg = registry.get_smoke_config(ARCH).replace(**kw)
    if variant == "hd112":
        jcfg = jcfg.replace(ssm=JSSMConfig(**HD112_SSM))
        tcfg = tcfg.replace(ssm=SSMConfig(**HD112_SSM))
    return jcfg, tcfg


def decays(seed, shape):
    """Log-decays -exp(1.5 z): most mild, about one in twelve below -8 and
    some below -20, as Mamba2's -exp(A_log) softplus(dt) gives them."""
    return (-np.exp(1.5 * np.random.RandomState(seed).randn(*shape))).astype(np.float32)


@pytest.fixture(scope="module")
def seed_params():
    """The reference's own draw of each variant (seed 0), numpy: A_log 0,
    dt_bias 0, so that a chunk's summed log-decay stays far inside fp32's
    exponent range, which the reference's gradient needs (its chunked
    per-head path takes exp of every score's decay difference, the masked
    ones too, and a masked inf makes jax.grad's where NaN)."""
    return {variant: jax.tree.map(np.asarray, jdec.init_params(configs(variant)[0],
                                                                  jax.random.key(0)))
            for variant in VARIANTS}


@pytest.fixture(scope="module")
def ref_params():
    """The reference's parameters of each variant (seed 0), numpy, with
    A_log and dt_bias drawn wide, so that the per-step log-decays spread
    well below -8."""
    out = {}
    for variant in VARIANTS:
        jcfg, _ = configs(variant)
        p = jax.tree.map(np.asarray, jdec.init_params(jcfg, jax.random.key(0)))
        for gp in p["groups"]:
            if "mamba" in gp:
                m = gp["mamba"]
                m["A_log"] = 1.2 * rnd(11, m["A_log"].shape) + 0.5
                m["dt_bias"] = rnd(12, m["dt_bias"].shape)
        out[variant] = p
    return out


def mamba_layer0(params):
    return jax.tree.map(lambda x: x[0], params["groups"][0])["mamba"]


def cast_pair(ptree, dtype):
    """A numpy parameter tree -> (jax tree, torch tree) of ``dtype``."""
    return (jax.tree.map(lambda x: jnp.asarray(x, dtype), ptree),
            tree_map(lambda x: x.to(TORCH_DT[dtype]), from_jax_params(ptree)))


def _tokens(seed, cfg, B, T):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(B, T)).astype(np.int32)


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, x in enumerate(tree) for n in _leaf_names(x, f"{prefix}/{i}")]
    return [prefix]


# ------------------------------------------------ per-head recurrence ---

class TestPerHeadRecurrence:
    B, S, H, K, V = 2, 37, 3, 8, 16           # S ragged against the reference's chunk of 16

    def inputs(self, seed):
        rs = np.random.RandomState(seed)
        q, k = (rs.randn(self.B, self.S, self.H, self.K).astype(np.float32) for _ in range(2))
        v = rs.randn(self.B, self.S, self.H, self.V).astype(np.float32)
        return q, k, v, decays(seed + 1, (self.B, self.S, self.H))

    @pytest.mark.parametrize("with_state", [False, True])
    def test_matches_reference_below_the_clamp(self, with_state):
        """The port's linear_recurrence(decay_per="head") against the
        reference's chunked per-head path, y and the final state at
        ``TOL``.  A port that clamped the decay at -8 would be more than
        ``TOL`` off."""
        q, k, v, la = self.inputs(40)
        assert (la < -8).mean() > 0.05 and la.min() < -20
        s0 = rnd(42, (self.B, self.H, self.K, self.V)) if with_state else None
        jy, js = jrec.linear_recurrence(
            *(jnp.asarray(x) for x in (q, k, v, la)), chunk=16, decay_per="head",
            initial_state=None if s0 is None else jnp.asarray(s0))
        tin = [torch.from_numpy(x) for x in (q, k, v, la)]
        ts0 = None if s0 is None else torch.from_numpy(s0)
        before = ls_ops.launches
        ty, ts = trec.linear_recurrence(*tin, decay_per="head", initial_state=ts0)
        assert ls_ops.launches == before          # CPU tensors: the plain version
        assert ty.dtype == torch.float32 and ts.dtype == torch.float32
        scaled_close(ty, jy, TOL["float32"], "y")
        scaled_close(ts, js, TOL["float32"], "final state")
        # the exact oracle agrees, and a clamped decay would not
        oy, _ = jrec.linear_recurrence_scan(*(jnp.asarray(x) for x in (q, k, v)),
                                            jnp.asarray(np.repeat(la[..., None], self.K, -1)),
                                            initial_state=None if s0 is None else jnp.asarray(s0))
        scaled_close(ty, oy, TOL["float32"], "y against the sequential oracle")
        cy, cs = ls_ref.recurrence(*tin[:3], torch.from_numpy(np.repeat(la[..., None], self.K, -1)),
                                   initial_state=ts0)
        assert max(gap(cy, jy), gap(cs, js)) > TOL["float32"]

    @pytest.mark.parametrize("decay_per, la_shape", [("head", (2, 37, 3, 8)), ("dim", (2, 37, 3))])
    def test_rejects_the_other_forms_decay_shape(self, decay_per, la_shape):
        """Each form takes its own log_a shape only: the per-head form no
        (B,S,H,K) decay, which the wrapper would clamp per dim, and the
        per-dim form no (B,S,H) decay, which it would leave unclamped."""
        q, k, v, _ = self.inputs(46)
        tin = [torch.from_numpy(x) for x in (q, k, v)]
        la = -torch.rand(la_shape)
        with pytest.raises(ValueError, match="takes log_a of shape"):
            trec.linear_recurrence(*tin, la, decay_per=decay_per)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_chunked_model_takes_no_positive_exponent(self, dtype):
        """The plain model of the bf16 kernel's chunked arithmetic, with a
        per-head la spread to -20 and beyond: every exponent it takes is
        <= 0, and it computes the sequential scan's function."""
        q, k, v, la = self.inputs(44)
        q, k, v = (torch.from_numpy(x).to(TORCH_DT[dtype]) for x in (q, k, v))
        la = torch.from_numpy(la)
        s0 = torch.from_numpy(rnd(45, (self.B, self.H, self.K, self.V)))
        exps = []
        y, st = ls_ref.chunked(q, k, v, la, initial_state=s0, exponents=exps)
        wy, ws = ls_ref.scan(q, k, v, la, initial_state=s0)
        assert exps and max(exps) <= 0.0
        scaled_close(y, wy, 1e-5 if dtype == "float32" else 1e-2, "y")
        scaled_close(st, ws, 1e-5, "state")

    def test_wrapper_takes_per_head_la_unclamped(self):
        q, k, v, la = (torch.from_numpy(x) for x in self.inputs(46))
        y, st = ls_ops.recurrence(q, k, v, la)
        wy, ws = ls_ref.scan(q, k, v, la[..., None].expand(q.shape))
        assert torch.equal(y, wy) and torch.equal(st, ws)
        with pytest.raises(ValueError, match="la"):
            ls_ops.recurrence(q, k, v, la[..., :2])
        with pytest.raises(ValueError, match="decay_per"):
            trec.linear_recurrence(q, k, v, la, decay_per="token")


# ------------------------------------------------------------- Mamba2 ---

class TestMamba2:
    @pytest.mark.parametrize("variant", list(VARIANTS))
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_forward_prefill_then_decode(self, ref_params, variant, dtype):
        """A prompt of 13 tokens (the prefill path: the per-head scan),
        then one token from the states it left (S == 1: the decode
        step): y, the conv state in the compute dtype and the fp32 SSM
        state against the reference's."""
        jcfg, tcfg = configs(variant, dtype)
        jp, tp = cast_pair(mamba_layer0(ref_params[variant]), dtype)
        jx, tx = both(rnd(50, (2, 13, jcfg.d_model)), dtype)
        before = ls_ops.launches
        got, (conv, ssm) = trec.mamba2_forward(tp, tcfg, tx)
        assert ls_ops.launches == before
        want, (jconv, jssm) = jrec.mamba2_forward(jp, jcfg, jx)
        assert conv.dtype == TORCH_DT[str(jconv.dtype)] and ssm.dtype == torch.float32
        scaled_close(got, want, TOL[dtype], "y")
        scaled_close(conv, jconv, TOL[dtype], "conv state")
        scaled_close(ssm, jssm, TOL[dtype], "ssm state")
        jx1, tx1 = both(rnd(51, (2, 1, jcfg.d_model)), dtype)
        got1, (conv1, ssm1) = trec.mamba2_forward(tp, tcfg, tx1, conv_state=conv, ssm_state=ssm)
        want1, (jconv1, jssm1) = jrec.mamba2_forward(jp, jcfg, jx1, conv_state=jconv,
                                                     ssm_state=jssm)
        scaled_close(got1, want1, TOL[dtype], "y decode")
        scaled_close(conv1, jconv1, TOL[dtype], "conv state decode")
        scaled_close(ssm1, jssm1, TOL[dtype], "ssm state decode")

    def test_prompt_from_a_state_and_init_state(self, ref_params):
        """A second prompt chunk (S > 1) continuing from the states of the
        first, and init_mamba2_state's shapes and dtypes."""
        jcfg, tcfg = configs()
        jp, tp = cast_pair(mamba_layer0(ref_params["smoke"]), "float32")
        jx, tx = both(rnd(52, (2, 20, jcfg.d_model)))
        _, (conv, ssm) = trec.mamba2_forward(tp, tcfg, tx[:, :9])
        got, (conv2, ssm2) = trec.mamba2_forward(tp, tcfg, tx[:, 9:], conv_state=conv,
                                                 ssm_state=ssm)
        want, (jconv, jssm) = jrec.mamba2_forward(jp, jcfg, jx)
        scaled_close(got, want[:, 9:], TOL["float32"], "continued y")
        scaled_close(conv2, jconv, TOL["float32"], "conv state")
        scaled_close(ssm2, jssm, TOL["float32"], "ssm state")
        for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            mine = trec.init_mamba2_state(tcfg, 3, dtype=tdt)
            ref = jrec.init_mamba2_state(jcfg, 3, dtype=jdt)
            assert [(tuple(t.shape), t.dtype) for t in mine] == \
                [(r.shape, TORCH_DT[str(r.dtype)]) for r in ref]
            assert all(not bool(t.any()) for t in mine)


# ---------------------------------------------------------- the model ---

def test_config_registry_and_layer_groups():
    """zamba2_7b and its smoke config equal the reference's field for
    field; 81 layers in 27 groups, 68 Mamba2 and 13 shared invocations;
    the reference's parameter count."""
    tdec.check_supported(registry.get_config(ARCH))
    for cfg_t, cfg_j in ((registry.get_config(ARCH), jget_config(ARCH)),
                         (registry.get_smoke_config("zamba2-7b"), jget_smoke_config(ARCH))):
        assert vars(cfg_t).keys() == vars(cfg_j).keys()
        for k in vars(cfg_j):
            a, b = getattr(cfg_t, k), getattr(cfg_j, k)
            assert (vars(a) == vars(b)) if hasattr(b, "__dataclass_fields__") else a == b, k
    cfg = registry.get_config(ARCH)
    groups = tdec.layer_groups(cfg)
    assert groups == jdec.layer_groups(jget_config(ARCH)) and len(groups) == 27
    assert sum(c for (k, _), c in groups if k == "mamba2") == 68
    assert sum(c for (k, _), c in groups if k == "shared_attn") == 13
    assert cfg.param_counts() == jget_config(ARCH).param_counts()
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        jdec.abstract_params(jget_config(ARCH)), is_leaf=lambda x: hasattr(x, "axes")))
    assert n_ref == 7_472_502_080


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_param_tree_matches_reference_layout(ref_params, variant):
    """The port's draw has the reference's leaves (names, shapes) and a
    reference tree round-trips leaf for leaf; a shared_attn layer holds
    norms and an MLP, the attention sits once at the top level."""
    _, tcfg = configs(variant)
    mine = tdec.init_params(tcfg, torch.Generator().manual_seed(0))
    ref = ref_params[variant]
    assert _leaf_names(mine) == _leaf_names(ref)
    assert [tuple(x.shape) for x in tree_leaves(mine)] == [x.shape for x in jax.tree.leaves(ref)]
    assert sorted(mine["groups"][1]) == ["mlp", "norm1", "norm2"]
    assert sorted(mine["groups"][0]) == ["mamba", "norm1"] and "shared_attn" in mine
    back = to_numpy_params(from_jax_params(ref))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_loss_and_every_leaf_gradient_match_reference(seed_params, variant):
    """fp32: forward's logits, loss_fn and the gradient of every leaf
    (through the plain per-head scan and the plain attention on the CPU)
    against jax.grad of the reference's loss_fn, at the reference's own
    draw (``seed_params``)."""
    jcfg, tcfg = configs(variant)
    params = seed_params[variant]
    toks = _tokens(60, jcfg, 2, 17)
    labels = _tokens(61, jcfg, 2, 17)
    labels[0, :3] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long()}
    jf, _ = jdec.forward(jcfg, params, jb["tokens"])
    tf, _ = tdec.forward(tcfg, from_jax_params(params), tb["tokens"])
    scaled_close(tf, jf, TOL["float32"], "forward logits")
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jdec.loss_fn(jcfg, p, b), has_aux=True))(params, jb)
    loss, grads = tsteps.value_and_grad(lambda p, b: tdec.loss_fn(tcfg, p, b),
                                        from_jax_params(params), tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    names = _leaf_names(grads)
    assert len(names) == len(jax.tree.leaves(jgrads))
    for name, g, w in zip(names, tree_leaves(grads), jax.tree.leaves(jgrads)):
        scaled_close(g, w, TOL["float32"], f"grad {name}")
    assert float(sum(torch.sum(g * g) for g in tree_leaves(grads))) > 0


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(ref_params, variant, cache_dtype):
    """fp32 compute: prefill's last logits and every cache leaf, with the
    reference's dtype (the conv state in the compute dtype, the SSM state
    fp32, the k/v cache in ``cache_dtype``), then 8 decode steps' logits
    and the final cache."""
    jcfg, tcfg = configs(variant)
    params = ref_params[variant]
    tp = from_jax_params(params)
    B, P, G, CL = 2, 12, 8, 24
    toks = _tokens(62, jcfg, B, P + G)
    jl, jc, jpos = jdec.prefill(jcfg, params, jnp.asarray(toks[:, :P]), CL,
                                cache_dtype=jnp.dtype(cache_dtype))
    tl, tc, tpos = tdec.prefill(tcfg, tp, torch.from_numpy(toks[:, :P]).long(), CL,
                                cache_dtype=TORCH_DT[cache_dtype])
    assert tpos == int(jpos) == P
    scaled_close(tl, jl, TOL["float32"], "prefill logits")
    decode_tol = TOL["float32"] if cache_dtype == "float32" else 1e-2

    def caches_close(tc, jc, after_prefill):
        jleaves, _ = tree_flatten(jax.tree.map(np.asarray, jc))
        tleaves, _ = tree_flatten(tc)
        assert len(jleaves) == len(tleaves) == 4   # {conv, ssm}, then {k, v}
        for name, t, j in zip(_leaf_names(tc), tleaves, jleaves):
            assert tuple(t.shape) == j.shape and t.dtype == TORCH_DT[str(j.dtype)], name
            if t.dtype == torch.bfloat16 and after_prefill:
                bf16_cache_close(t, j, name)
            else:
                scaled_close(t, j, TOL["float32"] if after_prefill else decode_tol, name)

    caches_close(tc, jc, True)
    for t in range(P, P + G):
        jl, jc = jdec.decode_step(jcfg, params, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl, tc = tdec.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        scaled_close(tl, jl, decode_tol, f"decode logits at {t}")
    caches_close(tc, jc, False)


def test_init_cache_matches_reference(ref_params):
    """init_cache: the conv state fp32 whatever the cache dtype, as the
    reference makes it, the SSM state fp32, the k/v cache in ``dtype``."""
    jcfg, tcfg = configs()
    for dt in ("float32", "bfloat16"):
        jc = jdec.init_cache(jcfg, ref_params["smoke"], 2, 10, dtype=jnp.dtype(dt))
        tc = tdec.init_cache(tcfg, from_jax_params(ref_params["smoke"]), 2, 10,
                             dtype=TORCH_DT[dt])
        jl, _ = tree_flatten(jax.tree.map(np.asarray, jc))
        assert [(tuple(t.shape), t.dtype) for t in tree_leaves(tc)] == \
            [(j.shape, TORCH_DT[str(j.dtype)]) for j in jl]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_prefill_and_forward_match_reference(ref_params, variant):
    """bf16 compute: the prefill's last logits and forward's logits at
    2e-2 of their scale."""
    jcfg, tcfg = configs(variant, "bfloat16")
    params = ref_params[variant]
    tp = from_jax_params(params)
    toks = _tokens(63, jcfg, 2, 10)
    jl, _, _ = jdec.prefill(jcfg, params, jnp.asarray(toks), 16)
    tl, _, _ = tdec.prefill(tcfg, tp, torch.from_numpy(toks).long(), 16)
    scaled_close(tl, jl, TOL["bfloat16"], "bf16 prefill logits")
    jf, _ = jdec.forward(jcfg, params, jnp.asarray(toks))
    tf, _ = tdec.forward(tcfg, tp, torch.from_numpy(toks).long())
    scaled_close(tf, jf, TOL["bfloat16"], "bf16 forward logits")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_serve_greedy_tokens_equal_reference(ref_params, variant, monkeypatch):
    """serve() at fp32 compute: the port's greedy tokens are the
    reference's, from the same prompt and the reference's parameters."""
    jcfg, tcfg = configs(variant)
    monkeypatch.setattr(jserve, "get_smoke_config", lambda a: jcfg)
    monkeypatch.setattr(jdec, "init_params",
                        lambda cfg, key: jax.tree.map(jnp.asarray, ref_params[variant]))
    want = jserve.serve(ARCH, smoke=True, batch=2, prompt_len=10, gen=6)
    got = tserve.serve(ARCH, smoke=True, batch=2, prompt_len=10, gen=6, device="cpu",
                       cfg=tcfg, params=from_jax_params(ref_params[variant]), verbose=False)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_prefill_then_decode_matches_stepwise():
    """The port against itself, as tests/test_prefill.py holds the
    reference: prefill of P tokens then decode equals decoding all."""
    cfg = registry.get_smoke_config(ARCH)
    params = tdec.init_params(cfg, torch.Generator().manual_seed(0))
    B, P, G, CL = 2, 6, 4, 16
    toks = torch.from_numpy(_tokens(64, cfg, B, P + G)).long()
    cache_a = tdec.init_cache(cfg, params, B, CL)
    logits_a = []
    for t in range(P + G):
        lg, cache_a = tdec.decode_step(cfg, params, cache_a, toks[:, t:t + 1], t)
        logits_a.append(lg[:, 0])
    lg, cache_b, pos = tdec.prefill(cfg, params, toks[:, :P], CL)
    assert pos == P
    logits_b = [lg[:, 0]]
    for t in range(P, P + G):
        lg, cache_b = tdec.decode_step(cfg, params, cache_b, toks[:, t:t + 1], t)
        logits_b.append(lg[:, 0])
    scaled_close(torch.stack(logits_b, 1), torch.stack(logits_a[P - 1:], 1), 3e-2)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_and_stepwise_decode_part_at_the_kv_cache(cache_dtype):
    """Twelve layers of the smoke model (10 Mamba2, 2 shared invocations)
    at fp32 compute, in both packages: one prefill's last logits against
    as many decode steps' over a KV cache of ``cache_dtype``.  With an
    fp32 cache each package's two paths agree to ``TOL``; with the bf16
    cache, the reference's default, both part by more than ``TOL`` and by
    about as much as each other: the rounding of k and v to bf16 parts
    them, as in the reference."""
    jcfg, tcfg = configs(num_layers=12, layer_pattern=jget_config(ARCH).layer_pattern[:12])
    params = jax.tree.map(np.asarray, jdec.init_params(jcfg, jax.random.key(0)))
    tp = from_jax_params(params)
    B, L = 2, 24
    toks = _tokens(70, jcfg, B, L)
    jl, _, _ = jdec.prefill(jcfg, params, jnp.asarray(toks), L)
    jc = jdec.init_cache(jcfg, params, B, L, dtype=jnp.dtype(cache_dtype))
    step = jax.jit(lambda p, c, t, i: jdec.decode_step(jcfg, p, c, t, i))
    with torch.no_grad():
        tl, _, _ = tdec.prefill(tcfg, tp, torch.from_numpy(toks).long(), L)
        tc = tdec.init_cache(tcfg, tp, B, L, dtype=TORCH_DT[cache_dtype])
        for t in range(L):
            js, jc = step(params, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
            ts, tc = tdec.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, t:t + 1]).long(), t)
    ref_gap, port_gap = gap(jl, js), gap(tl, ts)
    if cache_dtype == "float32":
        assert max(ref_gap, port_gap) <= TOL["float32"], (ref_gap, port_gap)
    else:
        assert min(ref_gap, port_gap) > TOL["float32"], (ref_gap, port_gap)
        assert ref_gap / 1.5 <= port_gap <= 1.5 * ref_gap, (ref_gap, port_gap)


def test_zamba2_trains_on_the_cpu_and_serve_cli(monkeypatch, capsys):
    """make_train_step takes a step through the plain per-head scan on
    the CPU; the serve CLI serves the smoke model with --device cpu."""
    _, tcfg = configs()
    step, opt_init = tsteps.make_train_step(tcfg)
    params = tdec.init_params(tcfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(65, tcfg, 2, 12)).long()
    params2, _, info = step(params, opt_init(params), {"tokens": toks, "labels": toks}, 0)
    assert np.isfinite(float(info["loss"])) and float(info["grad_norm"]) > 0
    assert all(not torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(params2)))
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--smoke", "--device", "cpu",
                                     "--batch", "2", "--prompt-len", "5", "--gen", "3"])
    tserve.main()
    assert "prefill 2x5" in capsys.readouterr().out


def test_backward_refuses_head_dim_112_and_the_rest_still_raises():
    """Both kernels take head_dim 112, the backward too (zamba2_7b's shared
    attention trains on the card); a head dim neither takes is refused in
    Python, before any launch, and so is MLA's unequal pair (96, 64) by the
    backward alone.  MLA, parallel blocks and the encoder-decoder are
    ported now (minicpm3_4b, command_r_35b, whisper_small); an encoder
    beside Mamba2 layers, and an audio frontend without an encoder, still
    raise."""
    assert 112 in fa_ops.HEAD_DIMS and 112 in fa_ops.BWD_HEAD_DIMS
    fa_ops._check_launch(torch.zeros(1, 1, 1, 112))
    fa_ops._check_launch(torch.zeros(1, 1, 1, 112), backward=True)
    for bad in (96, 256):
        with pytest.raises(ValueError, match="head_dim"):
            fa_ops._check_launch(torch.zeros(1, 1, 1, bad), backward=True)
    fa_ops._check_launch(torch.zeros(1, 1, 1, 96), dv=64)
    with pytest.raises(ValueError, match="equal q.k and v"):
        fa_ops._check_launch(torch.zeros(1, 1, 1, 96), backward=True, dv=64)
    cfg = registry.get_smoke_config(ARCH)
    tdec.check_supported(cfg.replace(parallel_block=True))
    for arch in ("minicpm3_4b", "command_r_35b", "whisper_small"):
        tdec.check_supported(registry.get_config(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tdec.check_supported(cfg.replace(encoder=EncoderConfig(num_layers=2, num_frames=8)))
    whisper = registry.get_config("whisper_small")
    with pytest.raises(NotImplementedError, match="audio frontend without an encoder"):
        tdec.check_supported(whisper.replace(encoder=None))


def test_plain_attention_at_head_dim_112():
    """The flash_attention wrapper's CPU route at head_dim 112 (GQA, a
    window, ragged S) is the plain version's function."""
    rs = np.random.RandomState(66)
    q = torch.from_numpy(rs.randn(2, 19, 4, 112).astype(np.float32))
    k, v = (torch.from_numpy(rs.randn(2, 19, 2, 112).astype(np.float32)) for _ in range(2))
    for window in (None, 5):
        got = fa_ops.gqa_flash_attention(q, k, v, window=window)
        want = fa_ref.gqa_attention(q, k, v, window=window)
        assert torch.equal(got, want)


# ------------------------------------------------------------ on the card ---

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


LS_TOL = {"bfloat16": (3e-2, 2e-4), "float32": (2e-4, 2e-4)}    # (y, final state)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,V,with_state", [(2, 2048, 112, 64, 64, False),
                                                  (2, 1000, 112, 64, 64, True),
                                                  (3, 77, 16, 16, 32, True)])
def test_gpu_linear_scan_per_head_matches_plain(cuda, B, S, H, K, V, with_state, dtype):
    """The kernel's per-head form against the unclamped plain scan, q and
    k broadcast over the heads (head stride 0) as Mamba2 passes them,
    log-decays spread below -20."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    dt = TORCH_DT[dtype]
    Bc = torch.randn(B, S, K, generator=gen, device=cuda).to(dt)
    Cc = torch.randn(B, S, K, generator=gen, device=cuda).to(dt)
    k, q = Bc[:, :, None].expand(B, S, H, K), Cc[:, :, None].expand(B, S, H, K)
    v = torch.randn(B, S, H, V, generator=gen, device=cuda).to(dt)
    la = -torch.exp(1.5 * torch.randn(B, S, H, generator=gen, device=cuda))
    s0 = torch.randn(B, H, K, V, generator=gen, device=cuda) if with_state else None
    before = ls_ops.launches
    y, st = ls_ops.recurrence(q, k, v, la, initial_state=s0)
    assert ls_ops.launches == before + 1
    wy, ws = ls_ref.scan(q, k, v, la, initial_state=s0)
    ty, ts = LS_TOL[dtype]
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    torch.testing.assert_close(y.float(), wy.float(), rtol=ty, atol=ty)
    torch.testing.assert_close(st, ws, rtol=ts, atol=ts)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window", [(2048, None), (1000, None), (2048, 256), (77, 16)])
def test_gpu_flash_attention_head_dim_112_matches_plain(cuda, S, window, dtype):
    gen = torch.Generator(device=cuda).manual_seed(8)
    dt = TORCH_DT[dtype]
    q = torch.randn(2, S, 8, 112, generator=gen, device=cuda).to(dt)
    k, v = (torch.randn(2, S, 4, 112, generator=gen, device=cuda).to(dt) for _ in range(2))
    before = fa_ops.launches
    with torch.no_grad():
        got = fa_ops.gqa_flash_attention(q, k, v, window=window)
    assert fa_ops.launches == before + 1
    want = fa_ref.gqa_attention(q, k, v, window=window)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _train_steps(tcfg, params, device, steps=3):
    """``make_train_step`` for ``steps`` steps from ``params`` on
    ``device``: (final parameters, losses, step 1's gradients, the
    (linear_scan, flash_attention) launches of the steps, forward and
    backward)."""
    step, opt_init = tsteps.make_train_step(tcfg)
    p = tree_map(lambda x: x.to(device), params)
    batch = lambda s: {k: torch.from_numpy(_tokens(70 + s + i, tcfg, 2, 40)).long().to(device)
                       for i, k in enumerate(("tokens", "labels"))}
    _, grads = tsteps.value_and_grad(lambda pp, b: tdec.loss_fn(tcfg, pp, b), p, batch(0))
    st = opt_init(p)
    before = (ls_ops.launches, ls_ops.bwd_launches, fa_ops.launches, fa_ops.bwd_launches)
    losses = []
    for s in range(steps):
        p, st, info = step(p, st, batch(s), s)
        losses.append(float(info["loss"]))
    after = (ls_ops.launches, ls_ops.bwd_launches, fa_ops.launches, fa_ops.bwd_launches)
    return p, losses, grads, tuple(a - b for a, b in zip(after, before))


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_gpu_zamba2_train_step_matches_cpu(cuda, ref_params, variant):
    """Three steps of the smoke model (and its head_dim-112 variant) at
    fp32 compute on the card, every Mamba2 scan and shared attention
    through the kernels forward and backward (each layer checkpointed:
    two forwards and one backward a layer a step), against the CPU path
    from the same parameters: step 1's gradients at 1e-4 of each leaf's
    scale, the losses at 1e-5."""
    _, tcfg = configs(variant)
    params = from_jax_params(ref_params[variant])
    pc, lc, gc, nc = _train_steps(tcfg, params, cuda)
    pp, lp, gp, _ = _train_steps(tcfg, params, "cpu")
    pat = tcfg.pattern()
    n_ssm, n_attn = pat.count("mamba2"), pat.count("shared_attn")
    assert n_ssm and n_attn and nc == (2 * 3 * n_ssm, 3 * n_ssm, 2 * 3 * n_attn, 3 * n_attn)
    np.testing.assert_allclose(lc, lp, rtol=1e-5)
    for name, a, b in zip(_leaf_names(gc), tree_leaves(gc), tree_leaves(gp)):
        assert bool(torch.isfinite(a).all()) and float(b.abs().max()) > 0, name
        scaled_close(a.cpu(), b, TOL["float32"], f"step 1 grad {name}")


@pytest.mark.gpu
def test_gpu_zamba2_train_steps_reproducible(cuda):
    """bf16 compute: two runs of three steps from one seed on the card give
    the same losses and parameters, bit for bit (no atomics in either
    backward kernel)."""
    _, tcfg = configs("hd112", "bfloat16")
    params = tdec.init_params(tcfg, torch.Generator().manual_seed(0))
    (pa, la, _, _), (pb, lb, _, _) = (_train_steps(tcfg, params, cuda) for _ in range(2))
    assert la == lb and all(np.isfinite(la))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pa), tree_leaves(pb)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window,H,KV", [(2048, None, 32, 32), (1000, None, 8, 4),
                                           (1024, 256, 8, 2), (77, 16, 4, 4), (1, None, 2, 1)])
def test_gpu_flash_attention_backward_head_dim_112_matches_plain(cuda, S, window, H, KV, dtype):
    """The backward kernel at head_dim 112 (its tiles padded with zeros to
    128 on the bf16 route) through the Function, against the plain
    backward: 1e-4 (fp32) or 2e-2 (bf16) of each gradient's scale,
    floored at 0.1 where S = 1 makes dq and dk exactly 0; two launches
    give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(S)
    dt = TORCH_DT[dtype]
    q = torch.randn(2, S, H, 112, generator=gen, device=cuda).to(dt)
    k, v = (torch.randn(2, S, KV, 112, generator=gen, device=cuda).to(dt) for _ in range(2))
    do = torch.randn(2, S, H, 112, generator=gen, device=cuda).to(dt)

    def grads():
        req = [x.detach().requires_grad_(True) for x in (q, k, v)]
        o = fa_ops.gqa_flash_attention(*req, window=window)
        return torch.autograd.grad(o, req, do)

    before = fa_ops.bwd_launches
    got, again = grads(), grads()
    torch.cuda.synchronize()
    assert fa_ops.bwd_launches == before + 2
    want = fa_ref.gqa_attention_bwd(q, k, v, do, window=window)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
        assert a.dtype == dt and bool(torch.isfinite(a).all()) and torch.equal(a, c), name
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * max(float(b.float().abs().max()), 0.1), (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_gpu_serve_matches_cpu_path(cuda, ref_params, variant, compute):
    """The smoke-width serve on the card, through both kernels (one
    linear_scan launch a Mamba2 layer, one flash_attention launch a
    shared invocation in the prefill, none in decode), against the CPU
    path with the same parameters: the same greedy tokens at fp32
    compute; the prefill logits at 2e-2 of their scale at bf16."""
    _, tcfg = configs(variant, compute)
    params = from_jax_params(ref_params[variant])
    kw = dict(smoke=True, batch=2, prompt_len=40, gen=6, cfg=tcfg, verbose=False)
    before = (ls_ops.launches, fa_ops.launches)
    stats = {}
    got = tserve.serve(ARCH, device=cuda, params=from_jax_params(ref_params[variant], cuda),
                       stats=stats, **kw)
    assert (ls_ops.launches - before[0], fa_ops.launches - before[1]) == (1, 1)
    assert stats["logits_finite"]
    want = tserve.serve(ARCH, device="cpu", params=params, **kw)
    if compute == "float32":
        np.testing.assert_array_equal(got, want)
    toks = torch.from_numpy(_tokens(68, tcfg, 2, 40)).long()
    lg, _, _ = tdec.prefill(tcfg, from_jax_params(ref_params[variant], cuda), toks.to(cuda), 46)
    lc, _, _ = tdec.prefill(tcfg, params, toks, 46)
    scaled_close(lg.cpu(), lc, TOL[compute] if compute == "bfloat16" else 1e-4)


@pytest.mark.gpu
def test_gpu_full_width_prefill_matches_reference(cuda):
    """zamba2_7b at its published width and fp32 compute, depth cut to the
    first 12 layers (10 Mamba2, 2 shared invocations; about 1.25 B
    parameters): the port's prefill on the card, through both kernels,
    against the reference's on the CPU with the reference's parameters,
    at 1e-2 of the logits' scale, as the other full-width prefills."""
    depth = 12
    pat = jget_config(ARCH).layer_pattern[:depth]
    jcfg = jget_config(ARCH).replace(compute_dtype="float32", num_layers=depth, layer_pattern=pat)
    tcfg = registry.get_config(ARCH).replace(compute_dtype="float32", num_layers=depth,
                                             layer_pattern=pat)
    params = jdec.init_params(jcfg, jax.random.key(0))
    toks = _tokens(69, jcfg, 1, 16)
    jl, _, _ = jax.jit(lambda p, t: jdec.prefill(jcfg, p, t, 16))(params, jnp.asarray(toks))
    tp = from_jax_params(jax.tree.map(np.asarray, params), cuda)
    del params
    before = (ls_ops.launches, fa_ops.launches)
    with torch.no_grad():
        tl, _, _ = tdec.prefill(tcfg, tp, torch.from_numpy(toks).long().to(cuda), 16)
    assert (ls_ops.launches - before[0], fa_ops.launches - before[1]) == (10, 2)
    scaled_close(tl.cpu(), jl, 1e-2, "zamba2_7b full-width prefill logits (12 layers)")
