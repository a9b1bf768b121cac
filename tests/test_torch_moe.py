"""repro_torch's Mixture-of-Experts slice (models/moe.py, the MoE and
qk-norm layers of the decoder, granite_moe_3b_a800m and qwen3_moe_30b_a3b
at smoke width, the streamed parameter draw) against repro's, on the same
numpy inputs and the reference's own parameters (from_jax_params).

Tolerances:
* ``_capacity``, the router's expert ids and which (token, choice) pairs
  drop: **exactly**;
* fp32: the packages differ only in the order of fp32 sums, so outputs,
  aux losses, losses and gradients agree to 1e-4 of their scale
  (``TOL``, as tests/test_torch_llm_serve.py);
* bf16: the packages round at other places (the reference's einsum
  contracts a bf16 one-hot, the port gathers), 2e-2 of the scale; the
  router's weights, fp32 until their cast, within one bf16 step;
* bf16 prefill and decode at 1 to 16 layers: no further from the
  reference's fp32 logits than 1.5 x the reference's own bf16 logits;
* the streamed draw: **bit-equal** to casting the whole draw.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.factory import ParamFactory as JParamFactory  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.models.registry import get_smoke_config as jget_smoke  # noqa: E402
from repro_torch.common.pytree import (tree_flatten, tree_leaves, tree_map,  # noqa: E402
                                       tree_unflatten)
from repro_torch.configs.base import EncoderConfig  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.factory import ParamFactory  # noqa: E402
from repro_torch.weights import from_jax_params, to_numpy_params  # noqa: E402

ARCHS = ["granite_moe_3b_a800m", "qwen3_moe_30b_a3b"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def rnd(seed, shape, shift=0.0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32) + shift


def configs(arch, compute="float32", **kw):
    return (jget_smoke(arch).replace(compute_dtype=compute, **kw),
            registry.get_smoke_config(arch).replace(compute_dtype=compute, **kw))


def _tokens(seed, cfg, B, T):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(B, T)).astype(np.int32)


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, x in enumerate(tree) for n in _leaf_names(x, f"{prefix}/{i}")]
    return [prefix]


@pytest.fixture(scope="module")
def ref_params():
    """The reference's parameters of each MoE smoke model (seed 0), numpy."""
    return {arch: jax.tree.map(np.asarray, jdec.init_params(configs(arch)[0], jax.random.key(0)))
            for arch in ARCHS}


@pytest.fixture(scope="module")
def moe_layer():
    """The reference's MoE leaves for qwen3_moe's smoke config (E 4,
    top-2, d 128), numpy, and a copy whose router sends every token's
    first choice to expert 0 (for inputs of positive mean): that expert
    overflows its capacity."""
    jcfg, tcfg = configs("qwen3_moe_30b_a3b")
    p = jax.tree.map(np.asarray, jmoe.init_moe(JParamFactory(key=jax.random.key(3)), jcfg))
    biased = dict(p, router=p["router"].copy())
    biased["router"][:, 0] += 0.05
    return jcfg, tcfg, {"plain": p, "overflow": biased}


def _keep_reference(p, jcfg, x, group):
    """Which pairs the reference keeps, from its router's ids and its
    cumsum slot rule (moe.py:94-101), (G, g k) bool."""
    B, S, d = x.shape
    _, ids, _ = jmoe._route(p, jcfg, jnp.asarray(x.reshape(B * S, d)))
    g = min(group, B * S)
    ids = np.asarray(ids).reshape(B * S // g, g * jcfg.moe.top_k)
    oh = np.eye(jcfg.moe.num_experts, dtype=np.int64)[ids]
    slot = np.take_along_axis(np.cumsum(oh, 1) - oh, ids[..., None], 2)[..., 0]
    return slot < jmoe._capacity(g, jcfg)


# ------------------------------------------------------------- capacity ---

@pytest.mark.parametrize("which", ["granite", "qwen3", "smoke"])
def test_capacity_matches_reference(which):
    jcfg = {"granite": jget_config("granite_moe_3b_a800m"),
            "qwen3": jget_config("qwen3_moe_30b_a3b"),
            "smoke": jget_smoke("qwen3_moe_30b_a3b")}[which]
    for g in list(range(1, 70)) + [100, 128, 256, 1000, 2047, 2048, 4096, 8192]:
        assert tmoe._capacity(g, jcfg) == jmoe._capacity(g, jcfg), g


# --------------------------------------------------------------- router ---

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inputs", ["normal", "tied"])
def test_route_matches_reference(moe_layer, dtype, inputs):
    """Weights, ids and the Switch aux loss.  ``tied``: the router's
    columns 2 and 3 copy columns 0 and 1, and a quarter of the rows are
    zero (every probability equal), so top-k meets exact ties and must
    take the lower expert id first, as ``lax.top_k`` does."""
    jcfg, tcfg, ps = moe_layer
    p = ps["plain"]
    x = rnd(4, (64, jcfg.d_model))
    if inputs == "tied":
        p = dict(p, router=np.concatenate([p["router"][:, :2]] * 2, axis=1))
        x[::4] = 0.0
    jw, jids, jaux = jmoe._route(p, jcfg, jnp.asarray(x, dtype))
    tw, tids, taux = tmoe._route(from_jax_params(p), tcfg,
                                 torch.from_numpy(x).to(TORCH_DT[dtype]))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert tw.dtype == TORCH_DT[dtype]
    if dtype == "float32":
        scaled_close(tw, jw, 1e-6, "weights")
    else:   # fp32 weights a few ulps apart round to bf16 at most one step apart
        np.testing.assert_allclose(_np(tw), _np(jw), rtol=2 ** -8, atol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    if inputs == "tied":
        np.testing.assert_array_equal(tids.numpy()[::4], [[0, 1]] * 16)
        assert (tids.numpy()[:, 0] < 2).all()


# ------------------------------------------------------------ dispatch ---

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("router", ["plain", "overflow"])
@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_dispatch_forward_matches_reference(moe_layer, dispatch, router, dtype):
    """The layer's output and aux loss against the reference's same
    dispatch, in groups of 64 tokens (capacity 41 of 128 pairs); with the
    overflow router expert 0 takes every first choice, and the port drops
    exactly the pairs the reference drops."""
    jcfg, tcfg, ps = moe_layer
    p = ps[router]
    x = rnd(5, (2, 64, jcfg.d_model), shift=1.0 if router == "overflow" else 0.0)
    jy, jaux = jmoe.moe_forward(jax.tree.map(lambda a: jnp.asarray(a, dtype), p), jcfg,
                                jnp.asarray(x, dtype), dispatch=dispatch, group=64)
    tp = tree_map(lambda a: a.to(TORCH_DT[dtype]), from_jax_params(p))
    tx = torch.from_numpy(x).to(TORCH_DT[dtype])
    ty, taux = tmoe.moe_forward(tp, tcfg, tx, dispatch=dispatch, group=64)
    assert ty.dtype == TORCH_DT[dtype]
    scaled_close(ty, jy, TOL[dtype], "moe output")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    keep = tmoe._plan(tp, tcfg, tx, 64)[5].numpy()
    np.testing.assert_array_equal(keep, _keep_reference(jax.tree.map(
        lambda a: jnp.asarray(a, dtype), p), jcfg, np.asarray(jnp.asarray(x, dtype)
                                                            .astype(jnp.float32)), 64))
    dropped, load = tmoe.dispatch_counts(tp, tcfg, tx, 64)
    assert int(dropped) == int((~keep).sum())
    assert int(load.sum()) == x.shape[0] * x.shape[1] * tcfg.moe.top_k
    if router == "overflow":
        assert int(dropped) > 0 and int(load[0]) == x.shape[0] * x.shape[1]
    else:
        assert int(dropped) == 0


@pytest.mark.parametrize("router", ["plain", "overflow"])
@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_dispatch_gradients_match_reference(moe_layer, dispatch, router):
    """fp32: the gradient of sum(y * r) + aux in every MoE leaf and the
    input, against the reference's same dispatch, drops included."""
    jcfg, tcfg, ps = moe_layer
    p = ps[router]
    x = rnd(6, (2, 64, jcfg.d_model), shift=1.0 if router == "overflow" else 0.0)
    r = rnd(7, x.shape)

    def jloss(pp, xx):
        y, aux = jmoe.moe_forward(pp, jcfg, xx, dispatch=dispatch, group=64)
        return jnp.sum(y * r) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    leaves, treedef = tree_flatten(from_jax_params(p))
    req = [t.requires_grad_(True) for t in leaves]
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_forward(tree_unflatten(treedef, req), tcfg, tx, dispatch=dispatch,
                              group=64)
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(r)) + aux, req + [tx])
    names = _leaf_names(p)
    for name, g, j in zip(names, grads[:-1], jax.tree.leaves(jgp)):
        scaled_close(g, j, TOL["float32"], f"d/d{name}")
    scaled_close(grads[-1], jgx, TOL["float32"], "d/dx")


def test_sort_and_einsum_agree_in_the_port(moe_layer):
    """The port's two dispatches compute one function (fp32, drops
    forced): outputs to 1e-5 of scale, aux equal."""
    _, tcfg, ps = moe_layer
    tp = from_jax_params(ps["overflow"])
    x = torch.from_numpy(rnd(8, (4, 32, tcfg.d_model), shift=1.0))
    y1, a1 = tmoe.moe_forward(tp, tcfg, x, dispatch="einsum", group=64)
    y2, a2 = tmoe.moe_forward(tp, tcfg, x, dispatch="sort", group=64)
    scaled_close(y2, y1, 1e-5)
    assert float(a1) == float(a2)
    with pytest.raises(ValueError):
        tmoe.moe_forward(tp, tcfg, x, dispatch="dense")


def test_token_count_not_a_multiple_of_the_group_raises(moe_layer):
    """B S above the group size and no multiple of it: the reference
    asserts, the port raises; neither pads."""
    jcfg, tcfg, ps = moe_layer
    x = rnd(9, (3, 5, jcfg.d_model))
    with pytest.raises(AssertionError):
        jmoe.moe_forward(ps["plain"], jcfg, jnp.asarray(x), group=4)
    for dispatch in ("einsum", "sort"):
        with pytest.raises(ValueError, match="groups of 4"):
            tmoe.moe_forward(from_jax_params(ps["plain"]), tcfg, torch.from_numpy(x),
                             dispatch=dispatch, group=4)
    tmoe.moe_forward(from_jax_params(ps["plain"]), tcfg, torch.from_numpy(x), group=5)


# -------------------------------------------------------- whole models ---

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_reference(ref_params, arch, dispatch, compute):
    jcfg, tcfg = configs(arch, compute)
    params = ref_params[arch]
    toks = _tokens(1, jcfg, 2, 24)
    jl, jaux = jdec.forward(jcfg, params, jnp.asarray(toks), moe_dispatch=dispatch)
    tl, taux = tdec.forward(tcfg, from_jax_params(params), torch.from_numpy(toks).long(),
                            moe_dispatch=dispatch)
    scaled_close(tl, jl, TOL[compute], "logits")
    assert taux.dtype == torch.float32 and float(taux) > 0.0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=TOL[compute])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(ref_params, arch):
    """fp32: the loss with its router aux term and every leaf's gradient
    (remat on in both packages), and the train step through it."""
    jcfg, tcfg = configs(arch)
    params = ref_params[arch]
    toks = _tokens(2, jcfg, 2, 16)
    labels = np.where(np.arange(16) % 5 == 4, -1, np.roll(toks, -1, axis=1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long()}
    (jl, jm), jg = jax.value_and_grad(lambda p: jdec.loss_fn(jcfg, p, jb), has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    tl, tg = tsteps.value_and_grad(lambda p, b: tdec.loss_fn(tcfg, p, b),
                                   from_jax_params(params), tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _, tm = tdec.loss_fn(tcfg, from_jax_params(params), tb)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-4)
    names = _leaf_names(params)
    assert any("/moe/" in n for n in names)
    for name, g, j in zip(names, tree_leaves(tg), jax.tree.leaves(jg)):
        scaled_close(g, j, TOL["float32"], name)
    step, opt_init = tsteps.make_train_step(tcfg, moe_dispatch="sort")
    p1, _, info = step(from_jax_params(params), opt_init(from_jax_params(params)), tb, 0)
    np.testing.assert_allclose(float(info["loss"]), float(jl), rtol=1e-5)
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(p1))


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(ref_params, arch, cache_dtype):
    """fp32 compute: prefill's last logits and caches, then 8 decode
    steps, against the reference (a 2 x 12 prompt is one group of 24
    tokens at capacity 16, where the reference may drop, and so must the
    port)."""
    jcfg, tcfg = configs(arch)
    params = ref_params[arch]
    tp = from_jax_params(params)
    B, P, G, CL = 2, 12, 8, 40
    toks = _tokens(3, jcfg, B, P + G)
    jl, jc, _ = jdec.prefill(jcfg, params, jnp.asarray(toks[:, :P]), CL,
                             cache_dtype=jnp.dtype(cache_dtype))
    tl, tc, pos = tdec.prefill(tcfg, tp, torch.from_numpy(toks[:, :P]).long(), CL,
                               cache_dtype=TORCH_DT[cache_dtype])
    assert pos == P
    scaled_close(tl, jl, 1e-4, "prefill logits")
    tol = 1e-4 if cache_dtype == "float32" else 1e-2
    for t in range(P, P + G):
        jl, jc = jdec.decode_step(jcfg, params, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl, tc = tdec.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        scaled_close(tl, jl, tol, f"decode logits at {t}")
    if cache_dtype == "float32":
        for t, j in zip(tree_leaves(tc), jax.tree.leaves(jc)):
            scaled_close(t, j, 1e-4, "cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_greedy_tokens_equal_reference(ref_params, arch, monkeypatch):
    """serve() at fp32 compute: the port's greedy tokens are the
    reference's, from the same prompt and the reference's parameters."""
    jcfg, tcfg = configs(arch)
    monkeypatch.setattr(jserve, "get_smoke_config", lambda a: jcfg)
    want = jserve.serve(arch, smoke=True, batch=2, prompt_len=10, gen=6)
    got = tserve.serve(arch, smoke=True, batch=2, prompt_len=10, gen=6, device="cpu",
                       cfg=tcfg, params=from_jax_params(ref_params[arch]), verbose=False)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_without_drops_equals_stepwise_decode(arch):
    """The port against itself in the regime chip_smoke.py gates: a 2 x 8
    prompt is one group of 16 tokens, where capacity is the whole group,
    so prefill and decode route alike and agree to 1e-4 (fp32)."""
    _, tcfg = configs(arch)
    params = tdec.init_params(tcfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(4, tcfg, 2, 8)).long()
    assert tmoe._capacity(16, tcfg) == 16
    lp, _, _ = tdec.prefill(tcfg, params, toks, 8, cache_dtype=torch.float32)
    cache = tdec.init_cache(tcfg, params, 2, 8, dtype=torch.float32)
    for t in range(8):
        ls, cache = tdec.decode_step(tcfg, params, cache, toks[:, t:t + 1], t)
    scaled_close(lp, ls, 1e-4)


def _last_logits(dec, cfg, params, toks, cache_dtype, to_dev):
    """The last-position logits of one prefill of ``toks`` and of as many
    decode steps over a ``cache_dtype`` cache, without the padded vocab
    columns: (prefill, stepwise)."""
    B, L = toks.shape
    lp, _, _ = dec.prefill(cfg, params, to_dev(toks), L, cache_dtype=cache_dtype)
    cache = dec.init_cache(cfg, params, B, L, dtype=cache_dtype)
    for t in range(L):
        pos = jnp.int32(t) if dec is jdec else t
        ls, cache = dec.decode_step(cfg, params, cache, to_dev(toks[:, t:t + 1]), pos)
    return _np(lp)[..., :cfg.vocab_size], _np(ls)[..., :cfg.vocab_size]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("depth", [1, 4, 8, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_by_depth_against_reference(arch, depth):
    """Serving's arithmetic, bf16 compute over the bf16 KV cache, at 1 to
    16 smoke-width layers: the port's prefill and its stepwise decode,
    each against the reference's same path.  The packages round
    differently in bf16 (ROADMAP.md §3 item 13: the port's prefill
    attention keeps its scores in fp32, as the kernel does, where the
    reference's einsum rounds them; XLA keeps fused elementwise chains in
    fp32), and a rounding can move a near-tied router choice.  So each
    path's bf16 logits are held to the reference's fp32 logits (fp32
    cache) no further than 1.5 x the reference's own bf16 logits are, and
    at 1 layer also to the reference's bf16 logits at 2e-2 of scale."""
    jcfg, tcfg = configs(arch, "bfloat16", num_layers=depth)
    params = jax.tree.map(np.asarray, jdec.init_params(jcfg, jax.random.key(0)))
    toks = _tokens(4, jcfg, 2, 8)
    bf = dict(cache_dtype=jnp.bfloat16, to_dev=jnp.asarray)
    exact = _last_logits(jdec, jcfg.replace(compute_dtype="float32"), params, toks,
                         to_dev=jnp.asarray, cache_dtype=jnp.float32)
    ref = _last_logits(jdec, jcfg, params, toks, **bf)
    got = _last_logits(tdec, tcfg, from_jax_params(params), toks, cache_dtype=torch.bfloat16,
                       to_dev=lambda t: torch.from_numpy(t).long())
    for path, g, r, e in zip(("prefill", "stepwise decode"), got, ref, exact):
        assert np.isfinite(g).all()
        assert _rel(g, e) <= 1.5 * _rel(r, e), (path, _rel(g, e), _rel(r, e))
        if depth == 1:
            assert _rel(g, r) <= TOL["bfloat16"], (path, _rel(g, r))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference_layout_and_round_trips(ref_params, arch):
    """The MoE layer's leaves (router, w_gate, w_up, w_down; qwen3's
    q_norm and k_norm) carry across from_jax_params as they are."""
    _, tcfg = configs(arch)
    mine = tdec.init_params(tcfg, torch.Generator().manual_seed(0))
    ref = ref_params[arch]
    assert _leaf_names(mine) == _leaf_names(ref)
    assert [tuple(x.shape) for x in tree_leaves(mine)] == [x.shape for x in jax.tree.leaves(ref)]
    assert ("/groups/0/attn/q_norm" in _leaf_names(ref)) == (arch == "qwen3_moe_30b_a3b")
    for a, b in zip(jax.tree.leaves(to_numpy_params(from_jax_params(ref))), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ streamed draw ---

def _whole_layer_draw(cfg, gen):
    """The draw as the port made it before the streamed route: every
    layer's tree whole, then stacked (the seed-0 weights of earlier
    chip runs); an encoder-decoder's layers with their cross-attention,
    then its encoder, as the reference draws them."""
    fac = ParamFactory(gen, dtype=getattr(torch, cfg.param_dtype))
    cross = cfg.encoder is not None

    def stack(tag, count, cross):
        return tree_map(lambda *xs: torch.stack(xs),
                        *[tdec._init_layer(fac, cfg, tag, cross) for _ in range(count)])

    params = {"embed": tdec.init_embedding(fac, cfg.padded_vocab(), cfg.d_model),
              "groups": [stack(tag, count, cross) for tag, count in tdec.layer_groups(cfg)],
              "final_norm": tdec.init_norm(fac, cfg.d_model, cfg.norm, cfg.use_bias)}
    if not cfg.tie_embeddings:
        params["unembed"] = tdec.init_unembed(fac, cfg.d_model, cfg.padded_vocab())
    if any(k == "shared_attn" for k in cfg.pattern()):
        params["shared_attn"] = tdec.attn.init_attention(fac, cfg)
    if cross:
        params["encoder"] = {
            "groups": [stack(("attn", False), cfg.encoder.num_layers, False)],
            "final_norm": tdec.init_norm(fac, cfg.d_model, cfg.norm, cfg.use_bias)}
    return params


def _bit_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert _leaf_names(a) == _leaf_names(b) and len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                           y.view(torch.int16) if y.dtype == torch.bfloat16 else y)


@pytest.mark.parametrize("arch", registry.PORTED)
def test_streamed_draw_equals_the_cast_whole_draw(arch):
    """init_params(dtype=bf16) is cast_params of the fp32 draw bit for
    bit, and the fp32 draw is the whole-layer draw of earlier slices, for
    every ported arch's smoke config."""
    cfg = registry.get_smoke_config(arch)
    full = tdec.init_params(cfg, torch.Generator().manual_seed(0))
    _bit_equal(full, _whole_layer_draw(cfg, torch.Generator().manual_seed(0)))
    streamed = tdec.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    _bit_equal(streamed, tdec.cast_params(cfg, full))


def test_check_supported_takes_moe_and_qk_norm_only():
    cfg = registry.get_smoke_config("qwen3_moe_30b_a3b")
    tdec.check_supported(cfg)
    tdec.check_supported(registry.get_smoke_config("starcoder2_3b").replace(qk_norm=True))
    assert ("attn", True) in tdec.PORTED_TAGS
    tdec.check_supported(cfg.replace(parallel_block=True))
    tdec.check_supported(registry.get_smoke_config("minicpm3_4b"))
    tdec.check_supported(registry.get_smoke_config("whisper_small"))
    tdec.check_supported(cfg.replace(encoder=EncoderConfig(num_layers=2, num_frames=8)))
    whisper = registry.get_smoke_config("whisper_small")
    with pytest.raises(NotImplementedError, match="audio frontend without an encoder"):
        tdec.check_supported(whisper.replace(encoder=None))


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


@pytest.mark.gpu
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gpu_moe_serve_matches_cpu_path(cuda, ref_params, arch, compute):
    """The smoke MoE models on the card (attention through the kernel)
    against the CPU path with the same parameters: the same greedy tokens
    at fp32 compute, the prefill logits at 1e-4 (fp32) or 2e-2 (bf16) of
    their scale."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    _, tcfg = configs(arch, compute)
    kw = dict(smoke=True, batch=2, prompt_len=40, gen=6, cfg=tcfg, verbose=False)
    before = fa_ops.launches
    got = tserve.serve(arch, device=cuda, params=from_jax_params(ref_params[arch], cuda), **kw)
    assert fa_ops.launches - before == tcfg.num_layers
    want = tserve.serve(arch, device="cpu", params=from_jax_params(ref_params[arch]), **kw)
    if compute == "float32":
        np.testing.assert_array_equal(got, want)
    toks = torch.from_numpy(_tokens(5, tcfg, 2, 40)).long()
    with torch.no_grad():
        lg, _, _ = tdec.prefill(tcfg, from_jax_params(ref_params[arch], cuda), toks.to(cuda), 46)
        lc, _, _ = tdec.prefill(tcfg, from_jax_params(ref_params[arch]), toks, 46)
    scaled_close(lg.cpu(), lc, TOL[compute] if compute == "bfloat16" else 1e-4)


@pytest.mark.gpu
def test_gpu_router_ignores_process_wide_tf32(cuda, moe_layer):
    """The router's fp32 product is IEEE on the card whatever
    ``set_float32_matmul_precision`` says: ids, weights and aux bit-equal
    under "highest" and "medium", and equal to the CPU's ids."""
    _, tcfg, ps = moe_layer
    p = from_jax_params(ps["plain"], cuda)
    x = torch.from_numpy(rnd(10, (512, tcfg.d_model))).to(cuda)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        a = tmoe._route(p, tcfg, x)
        torch.set_float32_matmul_precision("medium")
        b = tmoe._route(p, tcfg, x)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    c = tmoe._route(from_jax_params(ps["plain"]), tcfg, x.cpu())
    assert torch.equal(a[1].cpu(), c[1])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_gpu_moe_two_runs_from_one_seed_are_bit_equal(cuda, arch):
    """bf16 serve on the card twice from one seed, both dispatches'
    prefill logits: bit-equal (no atomics' order reaches a result)."""
    cfg = registry.get_smoke_config(arch)
    kw = dict(smoke=True, batch=2, prompt_len=32, gen=6, device=cuda, verbose=False)
    a = tserve.serve(arch, **kw)
    b = tserve.serve(arch, **kw)
    np.testing.assert_array_equal(a, b)
    params = tdec.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                              dtype=torch.bfloat16)
    toks = torch.from_numpy(_tokens(6, cfg, 2, 32)).long().to(cuda)
    with torch.no_grad():
        for dispatch in ("einsum", "sort"):
            l1, _, _ = tdec.prefill(cfg, params, toks, 32, moe_dispatch=dispatch)
            l2, _, _ = tdec.prefill(cfg, params, toks, 32, moe_dispatch=dispatch)
            assert torch.equal(l1, l2), dispatch


def _moe_train_steps(cfg, params, device, steps=3):
    """``make_train_step`` on a smoke MoE model: (final parameters,
    losses, step 1's gradients, the flash_attention launches of the
    steps, forward and backward)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    step, opt_init = tsteps.make_train_step(cfg)
    p = tree_map(lambda x: x.to(device), params)
    batch = lambda s: {k: torch.from_numpy(_tokens(80 + s + i, cfg, 2, 32)).long().to(device)
                       for i, k in enumerate(("tokens", "labels"))}
    _, grads = tsteps.value_and_grad(lambda pp, b: tdec.loss_fn(cfg, pp, b), p, batch(0))
    st = opt_init(p)
    before = (fa_ops.launches, fa_ops.bwd_launches)
    losses = []
    for s in range(steps):
        p, st, info = step(p, st, batch(s), s)
        losses.append(float(info["loss"]))
    return p, losses, grads, (fa_ops.launches - before[0], fa_ops.bwd_launches - before[1])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_gpu_moe_train_step_matches_cpu(cuda, ref_params, arch):
    """Three steps of the smoke MoE models at fp32 compute on the card
    (attention through the kernels forward and backward; qwen3's per-head
    q/k RMSNorm and both models' router, dispatch and experts in plain
    PyTorch, its aux loss included) against the CPU path from the same
    parameters: step 1's gradients at 1e-4 of each leaf's scale, the
    losses at 1e-5."""
    _, tcfg = configs(arch)
    params = from_jax_params(ref_params[arch])
    _, lc, gc, nc = _moe_train_steps(tcfg, params, cuda)
    _, lp, gp, _ = _moe_train_steps(tcfg, params, "cpu")
    assert nc == (2 * 3 * tcfg.num_layers, 3 * tcfg.num_layers)
    np.testing.assert_allclose(lc, lp, rtol=1e-5)
    for name, a, b in zip(_leaf_names(gc), tree_leaves(gc), tree_leaves(gp)):
        assert bool(torch.isfinite(a).all()) and float(b.abs().max()) > 0, name
        scaled_close(a.cpu(), b, TOL["float32"], f"step 1 grad {name}")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_gpu_moe_train_steps_reproducible(cuda, arch):
    """bf16 compute: two runs of three steps from one seed on the card give
    the same losses and parameters, bit for bit: the dispatch's scatter
    (index_add) and gather backward add a kept pair's gradient to zeros
    only, so no atomics' order reaches a result."""
    cfg = registry.get_smoke_config(arch)
    params = tdec.init_params(cfg, torch.Generator().manual_seed(0))
    (pa, la, _, _), (pb, lb, _, _) = (_moe_train_steps(cfg, params, cuda) for _ in range(2))
    assert la == lb and all(np.isfinite(la))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pa), tree_leaves(pb)))
