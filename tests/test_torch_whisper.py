"""repro_torch's encoder-decoder (whisper_small) against repro's, at smoke
width (2 encoder and 2 decoder layers, d 128, 4 heads of 32, 16 stub
audio frames), on the same numpy inputs and the reference's own
parameters (carried over with from_jax_params); and the flash_attention
kernel's non-causal mode, with queries unequal to keys, against the
reference's plain attention with a mask of all ones.

Tolerances, as tests/test_torch_llm_serve.py states them: plain
attention fp32 1e-5 of scale (sums in another order), bf16 2e-2 (the
reference rounds scores and weights to bf16, the port keeps them in
fp32); logits, caches and gradients at fp32 compute 1e-4 of their scale,
decode over a bf16 cache 1e-2 (an entry may round one bf16 step apart);
at bf16 compute 2e-2; a forward or prefill and its stepwise decode in the
port alone 2e-2, as the reference holds its own (tests/test_decode.py).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import FrontendConfig  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.models.registry import get_smoke_config as jget_smoke_config  # noqa: E402
from repro_torch.common.pytree import tree_flatten, tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.weights import from_jax_params, to_numpy_params  # noqa: E402

ARCH = "whisper_small"
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
FRAMES = 16     # whisper_small_smoke's num_frames


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


def bf16_cache_close(got, want, what=""):
    """bf16 cache entries: equal, or one bf16 step apart where the fp32
    values they were rounded from straddle a rounding boundary; an entry
    near zero, where that fp32 value is a cancellation, within the fp32
    tolerance of 1e-4 of the leaf's scale."""
    g, w = _np(got), _np(want)
    big = np.maximum(np.maximum(np.abs(g), np.abs(w)), 2.0 ** -126)
    step = np.maximum(2.0 ** (np.floor(np.log2(big)) - 7), 1e-4 * np.abs(w).max())
    assert (np.abs(g - w) <= step).all(), (what, float(np.abs(g - w).max()))


def configs(compute="float32", **kw):
    return (jget_smoke_config(ARCH).replace(compute_dtype=compute, **kw),
            registry.get_smoke_config(ARCH).replace(compute_dtype=compute, **kw))


def _tokens(seed, cfg, B, T):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(B, T)).astype(np.int32)


def _frames(seed, cfg, B, F=FRAMES, std=0.1):
    """Stub audio frames (B, F, d) from a seed."""
    return (std * np.random.RandomState(seed).randn(B, F, cfg.d_model)).astype(np.float32)


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, x in enumerate(tree) for n in _leaf_names(x, f"{prefix}/{i}")]
    return [prefix]


@pytest.fixture(scope="module")
def ref_params():
    """The reference's parameters of the smoke model (seed 0), numpy."""
    return jax.tree.map(np.asarray, jdec.init_params(configs()[0], jax.random.key(0)))


# ------------------------------------------------------- config and params ---

def test_config_and_param_tree_match_reference(ref_params):
    """The port's configs hold the reference's values field by field; its
    draw has the reference's tree leaf for leaf, in order, with the
    encoder and each decoder layer's cross-attention; the reference's tree
    round-trips through from_jax_params."""
    for t, j in ((registry.get_config(ARCH), jget_config(ARCH)),
                 (registry.get_smoke_config(ARCH), jget_smoke_config(ARCH))):
        assert vars(t).keys() == vars(j).keys()
        for k in vars(j):
            a, b = getattr(t, k), getattr(j, k)
            assert (vars(a) == vars(b)) if hasattr(b, "__dataclass_fields__") else a == b, k
    _, tcfg = configs()
    tdec.check_supported(tcfg)
    tdec.check_supported(registry.get_config(ARCH))
    mine = tdec.init_params(tcfg, torch.Generator().manual_seed(0))
    assert _leaf_names(mine) == _leaf_names(ref_params)
    mleaves, _ = tree_flatten(mine)
    jleaves, _ = tree_flatten(ref_params)
    assert [tuple(x.shape) for x in mleaves] == [x.shape for x in jleaves]
    assert {"cross_norm", "cross_attn"} <= set(mine["groups"][0])
    assert "cross_attn" not in mine["encoder"]["groups"][0]
    assert tree_leaves(mine["encoder"]["groups"][0])[0].shape[0] == tcfg.encoder.num_layers
    back = to_numpy_params(from_jax_params(ref_params))
    assert _leaf_names(back) == _leaf_names(ref_params)
    for a, b in zip(tree_flatten(back)[0], jleaves):
        np.testing.assert_array_equal(a, b)


def test_full_config_tree_has_the_reference_shapes(monkeypatch):
    """whisper_small's full tree, its vocab padded to 51,968, has the
    reference's leaves and shapes: 278,301,696 parameters (277.8 M by the
    config's count, which leaves out biases, norms and padding).  The
    shapes come from a factory that allocates nothing."""
    class Shapes(tdec.ParamFactory):
        def param(self, shape, axes, init="fan_in", scale=None, dtype=None):
            return torch.empty(tuple(int(s) for s in shape), dtype=dtype or self.dtype,
                               device="meta")

    cfg = registry.get_config(ARCH)
    assert cfg.padded_vocab() == 51968
    assert round(jget_config(ARCH).param_counts()["total"] / 1e6, 1) == 277.8
    monkeypatch.setattr(tdec, "ParamFactory", Shapes)
    mine = tdec.init_params(cfg, torch.Generator())
    from repro.models.factory import is_abstract_leaf
    ref = jdec.abstract_params(jget_config(ARCH))
    assert _leaf_names(mine) == _leaf_names(ref)
    shapes = [tuple(a.shape) for a in jax.tree.leaves(ref, is_leaf=is_abstract_leaf)]
    assert [tuple(x.shape) for x in tree_flatten(mine)[0]] == shapes
    assert sum(x.numel() for x in tree_leaves(mine)) == 278301696


def test_check_supported_takes_whisper_and_refuses_the_rest():
    """An encoder goes with GQA attention layers in sequential blocks; an
    audio frontend only beside an encoder."""
    cfg = registry.get_smoke_config(ARCH)
    tdec.check_supported(cfg)
    for bad in (cfg.replace(encoder=None),
                cfg.replace(parallel_block=True),
                registry.get_smoke_config("minicpm3_4b").replace(encoder=cfg.encoder),
                registry.get_smoke_config("rwkv6_3b").replace(encoder=cfg.encoder)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tdec.check_supported(bad)
    audio = FrontendConfig(kind="audio", num_prefix_tokens=0)
    with pytest.raises(NotImplementedError, match="audio frontend without an encoder"):
        tdec.check_supported(registry.get_smoke_config("starcoder2_3b").replace(frontend=audio))


# ------------------------------------------------------- plain attention ---

ATTN_CASES = [(16, 16, 4, 4), (77, 16, 4, 4), (77, 300, 4, 4), (77, 300, 4, 2)]


def _attn_inputs(seed, B, Sq, Sk, H, KV, hd=32):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, Sq, H, hd).astype(np.float32),
            rs.randn(B, Sk, KV, hd).astype(np.float32),
            rs.randn(B, Sk, KV, hd).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "q{}-k{}-h{}-kv{}".format(*c))
def test_plain_noncausal_attention_matches_reference_sdpa(case, dtype):
    """The plain version with causal=False, at Sq = Sk and at 77 queries
    over 16 and 300 keys (also GQA 4/2), is the reference's _sdpa with a
    mask of all ones; the wrapper's CPU route gives the same bits."""
    Sq, Sk, H, KV = case
    B = 2
    q, k, v = _attn_inputs(sum(case), B, Sq, Sk, H, KV)
    want = jattn._sdpa(*(jnp.asarray(x, JAX_DT[dtype]) for x in (q, k, v)),
                       jnp.ones((B, Sq, Sk), bool), 1.0 / 32 ** 0.5)
    tq, tk, tv = (torch.from_numpy(x).to(TORCH_DT[dtype]) for x in (q, k, v))
    got = fa_ref.gqa_attention(tq, tk, tv, causal=False)
    assert got.dtype == TORCH_DT[dtype] and tuple(got.shape) == (B, Sq, H, 32)
    scaled_close(got, want, 1e-5 if dtype == "float32" else 2e-2)
    assert torch.equal(fa_ops.gqa_flash_attention(tq, tk, tv, causal=False), got)


@pytest.mark.parametrize("window", [None, 5])
def test_plain_causal_route_is_unchanged(window):
    """causal (the default) still masks by position: the reference's _sdpa
    with its causal (and windowed) mask, and the wrapper's CPU route."""
    B, S, H, KV = 2, 23, 4, 2
    q, k, v = _attn_inputs(7, B, S, S, H, KV)
    pos = jnp.arange(S)
    mask = jnp.broadcast_to(jattn._causal_scores_mask(pos[None], pos[None], window), (B, S, S))
    want = jattn._sdpa(*(jnp.asarray(x) for x in (q, k, v)), mask, 1.0 / 32 ** 0.5)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = fa_ref.gqa_attention(tq, tk, tv, window=window)
    scaled_close(got, want, 1e-5)
    assert torch.equal(got, fa_ref.gqa_attention(tq, tk, tv, window=window, causal=True))
    assert torch.equal(fa_ops.gqa_flash_attention(tq, tk, tv, window=window), got)


def test_noncausal_gradient_on_the_cpu_matches_reference():
    """The Function's CPU backward in the non-causal mode at Sq != Sk is
    the gradient of the reference's _sdpa (fp32, 1e-5 of scale)."""
    B, Sq, Sk, H, KV = 2, 9, 21, 4, 2
    q, k, v = _attn_inputs(3, B, Sq, Sk, H, KV)
    do = np.random.RandomState(4).randn(B, Sq, H, 32).astype(np.float32)

    def f(q, k, v):
        return jnp.sum(jattn._sdpa(q, k, v, jnp.ones((B, Sq, Sk), bool), 1.0 / 32 ** 0.5) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    (fa_ops.gqa_flash_attention(tq, tk, tv, causal=False) * torch.from_numpy(do)).sum().backward()
    for t, j, name in zip((tq, tk, tv), want, "qkv"):
        scaled_close(t.grad, j, 1e-5, f"d{name}")


# ---------------------------------------------------- encoder and forward ---

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_reference(ref_params, dtype):
    """The encoder tower's output on 16 stub frames."""
    jcfg, tcfg = configs(dtype)
    e = _frames(0, jcfg, 2)
    want = jdec._encode(jcfg, ref_params, jnp.asarray(e))
    got = tdec._encode(tcfg, from_jax_params(ref_params), torch.from_numpy(e))
    assert got.dtype == TORCH_DT[dtype]
    scaled_close(got, want, 1e-4 if dtype == "float32" else 2e-2, "encoder output")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(ref_params, dtype):
    """forward(encoder_embeds=)'s logits at every position."""
    jcfg, tcfg = configs(dtype)
    toks, e = _tokens(2, jcfg, 2, 10), _frames(3, jcfg, 2)
    jf, _ = jdec.forward(jcfg, ref_params, jnp.asarray(toks), encoder_embeds=jnp.asarray(e))
    tf, aux = tdec.forward(tcfg, from_jax_params(ref_params), torch.from_numpy(toks).long(),
                           encoder_embeds=torch.from_numpy(e))
    assert float(aux) == 0.0
    scaled_close(tf, jf, 1e-4 if dtype == "float32" else 2e-2, "logits")


def test_forward_needs_encoder_embeds(ref_params):
    _, tcfg = configs()
    with pytest.raises(ValueError, match="encoder_embeds"):
        tdec.forward(tcfg, from_jax_params(ref_params), torch.zeros(1, 4, dtype=torch.long))


# ------------------------------------------------------- loss and gradient ---

@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_gradient_match_reference(ref_params, remat):
    """loss_fn at fp32 with masked labels, and its gradient on every leaf,
    the encoder's and the cross-attention's included, against
    jax.value_and_grad of the reference's loss_fn (1e-4 of each leaf's
    scale); remat (the encoder's layers checkpointed too) changes no
    number."""
    jcfg, tcfg = configs()
    toks, e = _tokens(4, jcfg, 2, 12), _frames(5, jcfg, 2)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :3] = -1
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
              "encoder_embeds": jnp.asarray(e)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jdec.loss_fn(jcfg, p, jbatch), has_aux=True)(
            jax.tree.map(jnp.asarray, ref_params))
    tbatch = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long(),
              "encoder_embeds": torch.from_numpy(e)}
    tloss, tgrads = value_and_grad(
        lambda p, b: tdec.loss_fn(tcfg, p, b, remat=remat), from_jax_params(ref_params), tbatch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    names = _leaf_names(tgrads)
    assert names == _leaf_names(jgrads)
    assert any(n.startswith("/encoder/") for n in names)
    assert any("/cross_attn/" in n for n in names)
    tl, jl = tree_flatten(tgrads)[0], tree_flatten(jgrads)[0]
    by_name = dict(zip(names, jl))
    for name, t, j in zip(names, tl, jl):
        if name.endswith("/bk"):
            # a key bias shifts every score of a query's row alike, which
            # the softmax cancels: its gradient is zero but for rounding,
            # held against its block's wk gradient's scale
            err = float(np.abs(_np(t) - _np(j)).max())
            assert err <= 1e-4 * float(np.abs(_np(by_name[name[:-2] + "wk"])).max()), name
        else:
            scaled_close(t, j, 1e-4, name)


# ------------------------------------------------------- prefill and decode ---

def _caches_close(tc, jc, exact_bf16, tol):
    jleaves, _ = tree_flatten(jax.tree.map(np.asarray, jc))
    tleaves, _ = tree_flatten(tc)
    assert _leaf_names(tc) == _leaf_names(jax.tree.map(np.asarray, jc))
    for name, t, j in zip(_leaf_names(tc), tleaves, jleaves):
        assert tuple(t.shape) == j.shape and t.dtype == TORCH_DT[str(j.dtype)], name
        if t.dtype == torch.bfloat16 and exact_bf16:
            bf16_cache_close(t, j, name)
        else:
            scaled_close(t, j, tol, name)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(ref_params, cache_dtype):
    """fp32 compute: prefill's last logits and every cache leaf, the cross
    caches included, then 8 decode steps' logits and the final cache,
    against the reference."""
    jcfg, tcfg = configs()
    tp = from_jax_params(ref_params)
    B, P, G, CL = 2, 12, 8, 40
    toks, e = _tokens(1, jcfg, B, P + G), _frames(6, jcfg, B)
    jl, jc, jpos = jdec.prefill(jcfg, ref_params, jnp.asarray(toks[:, :P]), CL,
                                encoder_embeds=jnp.asarray(e), cache_dtype=jnp.dtype(cache_dtype))
    tl, tc, tpos = tdec.prefill(tcfg, tp, torch.from_numpy(toks[:, :P]).long(), CL,
                                encoder_embeds=torch.from_numpy(e),
                                cache_dtype=TORCH_DT[cache_dtype])
    assert tpos == int(jpos) == P
    assert set(tc) == {"groups", "cross"} and set(tc["cross"][0]) == {"k", "v"}
    assert tuple(tc["cross"][0]["k"].shape) == (tcfg.num_layers, B, FRAMES,
                                                tcfg.num_kv_heads, tcfg.head_dim)
    scaled_close(tl, jl, 1e-4, "prefill logits")
    _caches_close(tc, jc, True, 1e-4)
    decode_tol = 1e-4 if cache_dtype == "float32" else 1e-2
    for t in range(P, P + G):
        jl, jc = jdec.decode_step(jcfg, ref_params, jc, jnp.asarray(toks[:, t:t + 1]),
                                  jnp.int32(t))
        tl, tc = tdec.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        scaled_close(tl, jl, decode_tol, f"decode logits at {t}")
    _caches_close(tc, jc, False, decode_tol)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_init_cache_cross_matches_reference(ref_params, cache_dtype):
    """init_cache(encoder_embeds=)'s cross k and v, and its empty groups."""
    jcfg, tcfg = configs()
    e = _frames(7, jcfg, 2)
    jc = jdec.init_cache(jcfg, ref_params, 2, 24, encoder_embeds=jnp.asarray(e),
                         dtype=jnp.dtype(cache_dtype))
    tc = tdec.init_cache(tcfg, from_jax_params(ref_params), 2, 24,
                         encoder_embeds=torch.from_numpy(e), dtype=TORCH_DT[cache_dtype])
    _caches_close(tc, jc, True, 1e-4)
    with pytest.raises(ValueError, match="encoder_embeds"):
        tdec.init_cache(tcfg, from_jax_params(ref_params), 2, 24)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_bf16_and_fp32_prefill_logits_match_reference(ref_params, compute):
    jcfg, tcfg = configs(compute)
    toks, e = _tokens(8, jcfg, 2, 10), _frames(9, jcfg, 2)
    jl, _, _ = jdec.prefill(jcfg, ref_params, jnp.asarray(toks), 32,
                            encoder_embeds=jnp.asarray(e))
    tl, _, _ = tdec.prefill(tcfg, from_jax_params(ref_params), torch.from_numpy(toks).long(), 32,
                            encoder_embeds=torch.from_numpy(e))
    scaled_close(tl, jl, 1e-4 if compute == "float32" else 2e-2, "prefill logits")


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_forward_matches_stepwise_decode(ref_params, compute):
    """The port against itself, as the reference's tests/test_decode.py
    holds its own: forward's logits at every position against decode_step
    from init_cache(encoder_embeds=), 2e-2 of scale."""
    _, tcfg = configs(compute)
    tp = from_jax_params(ref_params)
    B, T = 2, 8
    toks = torch.from_numpy(_tokens(10, tcfg, B, T)).long()
    e = torch.from_numpy(_frames(11, tcfg, B))
    full, _ = tdec.forward(tcfg, tp, toks, encoder_embeds=e)
    cache = tdec.init_cache(tcfg, tp, B, 64, encoder_embeds=e)
    outs = []
    for t in range(T):
        lg, cache = tdec.decode_step(tcfg, tp, cache, toks[:, t:t + 1], t)
        outs.append(lg[:, 0])
    scaled_close(torch.stack(outs, 1), full, 2e-2)


def test_prefill_then_decode_matches_stepwise():
    """The port against itself, as tests/test_prefill.py holds the
    reference: prefill of P tokens then decode equals decoding all from
    init_cache, on the port's own draw."""
    cfg = registry.get_smoke_config(ARCH)
    params = tdec.init_params(cfg, torch.Generator().manual_seed(0))
    B, P, G, CL = 2, 6, 4, 64
    toks = torch.from_numpy(_tokens(12, cfg, B, P + G)).long()
    e = torch.from_numpy(_frames(13, cfg, B))
    cache_a = tdec.init_cache(cfg, params, B, CL, encoder_embeds=e)
    logits_a = []
    for t in range(P + G):
        lg, cache_a = tdec.decode_step(cfg, params, cache_a, toks[:, t:t + 1], t)
        logits_a.append(lg[:, 0])
    lg, cache_b, pos = tdec.prefill(cfg, params, toks[:, :P], CL, encoder_embeds=e)
    assert pos == P
    logits_b = [lg[:, 0]]
    for t in range(P, P + G):
        lg, cache_b = tdec.decode_step(cfg, params, cache_b, toks[:, t:t + 1], t)
        logits_b.append(lg[:, 0])
    scaled_close(torch.stack(logits_b, 1), torch.stack(logits_a[P - 1:], 1), 3e-2)


# ------------------------------------------------------------------ serving ---

def test_serve_greedy_tokens_equal_reference(ref_params, monkeypatch):
    """serve() at fp32 compute: the port's greedy tokens are the
    reference's, from the same prompt, the reference's parameters and its
    stub frames (0.02 N(0, 1) from key 9, passed in)."""
    jcfg, tcfg = configs()
    B, T, G = 2, 10, 6
    monkeypatch.setattr(jserve, "get_smoke_config", lambda a: jcfg)
    want = jserve.serve(ARCH, smoke=True, batch=B, prompt_len=T, gen=G)
    enc = np.array(0.02 * jax.random.normal(jax.random.key(9),
                                            (B, jcfg.encoder.num_frames, jcfg.d_model)))
    stats = {}
    got = tserve.serve(ARCH, smoke=True, batch=B, prompt_len=T, gen=G, device="cpu", cfg=tcfg,
                       params=from_jax_params(ref_params), encoder_embeds=torch.from_numpy(enc),
                       stats=stats, verbose=False)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats["logits_finite"]


def test_serve_draws_its_own_frames_from_seed_9():
    """Without encoder_embeds, serve() draws 0.02 N(0, 1) frames from
    torch.Generator().manual_seed(9): the same tokens as passing them."""
    cfg = registry.get_smoke_config(ARCH)
    params = tdec.init_params(cfg, torch.Generator().manual_seed(0))
    kw = dict(smoke=True, batch=2, prompt_len=8, gen=4, device="cpu", params=params,
              verbose=False)
    enc = 0.02 * torch.randn((2, cfg.encoder.num_frames, cfg.d_model),
                             generator=torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(tserve.serve(ARCH, **kw),
                                  tserve.serve(ARCH, encoder_embeds=enc, **kw))


def test_prefill_step_with_encoder_embeds_matches_reference(ref_params):
    """make_prefill_step with batch["encoder_embeds"], both modes, then 4
    make_serve_step decodes, against the reference's steps at fp32
    compute: logits and the filled (bf16) cache, cross leaves included."""
    jcfg, tcfg = configs()
    B, T, G, CL = 2, 10, 4, 40
    toks, e = _tokens(14, jcfg, B, T + G), _frames(15, jcfg, B)
    tp = from_jax_params(ref_params)
    jl, jc = jsteps.make_prefill_step(jcfg, fill_cache=True, cache_len=CL)(
        ref_params, {"tokens": jnp.asarray(toks[:, :T]), "encoder_embeds": jnp.asarray(e)})
    tl, tc = make_prefill_step(tcfg, fill_cache=True, cache_len=CL)(
        tp, {"tokens": torch.from_numpy(toks[:, :T]).long(), "encoder_embeds": torch.from_numpy(e)})
    scaled_close(tl, jl, 1e-4, "prefill step logits")
    _caches_close(tc, jc, True, 1e-4)
    jstep, tstep = jsteps.make_serve_step(jcfg), make_serve_step(tcfg)
    for i in range(G):
        t = T + i
        jl, jc = jstep(ref_params, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl, tc = tstep(tp, tc, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        scaled_close(tl, jl, 1e-2, f"decode logits at {t}")
    last = make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks[:, :T]).long(),
                                        "encoder_embeds": torch.from_numpy(e)})
    jlast = jsteps.make_prefill_step(jcfg)(ref_params, {"tokens": jnp.asarray(toks[:, :T]),
                                                        "encoder_embeds": jnp.asarray(e)})
    scaled_close(last, jlast, 1e-4, "prefill step without a cache")


# ------------------------------------------------------------------ refusals ---

def test_kernel_refusals_are_raised_in_python():
    """Before any launch: the backward in the non-causal mode or at Sq !=
    Sk, the causal mode at Sq != Sk, a window without causal; on the CPU
    route the wrapper refuses the same modes."""
    q = torch.zeros(1, 7, 4, 64)
    fa_ops._check_launch(q, sk=300, causal=False)
    fa_ops._check_launch(q, causal=False)
    fa_ops._check_launch(q, backward=True)
    for kw in (dict(causal=False), dict(sk=300, causal=False)):
        with pytest.raises(ValueError, match="causal only"):
            fa_ops._check_launch(q, backward=True, **kw)
    with pytest.raises(ValueError, match="as many keys as queries"):
        fa_ops._check_launch(q, sk=300)
    with pytest.raises(ValueError, match="as many keys as queries"):
        fa_ops._check_launch(q, backward=True, sk=300)
    with pytest.raises(ValueError, match="window"):
        fa_ops._check_launch(q, window=4, causal=False)
    k = torch.zeros(1, 300, 4, 64)
    with pytest.raises(ValueError, match="as many keys as queries"):
        fa_ops.gqa_flash_attention(q, k, k)
    with pytest.raises(ValueError, match="window"):
        fa_ops.gqa_flash_attention(q, k, k, window=4, causal=False)


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


# (B, Sq, Sk, H, KV, hd): whisper's encoder and cross-attention shapes in
# serve(batch=4, prompt_len=224), a ragged Sq and Sk, and a GQA case
GPU_CASES = [(4, 1500, 1500, 12, 12, 64), (4, 224, 1500, 12, 12, 64),
             (2, 77, 300, 12, 12, 64), (2, 130, 99, 8, 2, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GPU_CASES, ids=lambda c: "b{}-q{}-k{}-h{}-kv{}-d{}".format(*c))
def test_gpu_noncausal_kernel_matches_plain(cuda, case, dtype):
    """The kernel's non-causal mode against its plain version on the card,
    at FA_TOL (bf16 2e-2, fp32 2e-5), one launch a call."""
    B, Sq, Sk, H, KV, hd = case
    dt = TORCH_DT[dtype]
    gen = torch.Generator(device=cuda).manual_seed(sum(case))
    q = torch.randn(B, Sq, H, hd, generator=gen, device=cuda).to(dt)
    k, v = (torch.randn(B, Sk, KV, hd, generator=gen, device=cuda).to(dt) for _ in range(2))
    before = fa_ops.launches
    with torch.no_grad():
        got = fa_ops.gqa_flash_attention(q, k, v, causal=False)
    want = fa_ref.gqa_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa_ops.launches - before == 1
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    assert tuple(got.shape) == (B, Sq, H, hd) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_gpu_whisper_prefill_matches_cpu_path(cuda, ref_params, compute):
    """The smoke whisper prefill on the card (6 flash_attention launches:
    2 encoder, 2 decoder self, 2 cross) against the CPU path with the same
    parameters: logits and cross caches at 1e-4 (fp32) or 2e-2 (bf16) of
    their scale; at fp32 the same greedy tokens from serve()."""
    _, tcfg = configs(compute)
    toks = torch.from_numpy(_tokens(16, tcfg, 2, 40)).long()
    e = torch.from_numpy(_frames(17, tcfg, 2))
    before = fa_ops.launches
    lg, cg, _ = tdec.prefill(tcfg, from_jax_params(ref_params, cuda), toks.to(cuda), 64,
                             encoder_embeds=e.to(cuda))
    torch.cuda.synchronize()
    assert fa_ops.launches - before == 3 * tcfg.num_layers
    lc, cc, _ = tdec.prefill(tcfg, from_jax_params(ref_params), toks, 64, encoder_embeds=e)
    tol = 2e-2 if compute == "bfloat16" else 1e-4
    scaled_close(lg.cpu(), lc, tol, "prefill logits")
    for name in ("k", "v"):
        scaled_close(cg["cross"][0][name].cpu(), cc["cross"][0][name], max(tol, 1e-2), name)
    if compute == "float32":
        kw = dict(smoke=True, batch=2, prompt_len=40, gen=6, cfg=tcfg, verbose=False,
                  encoder_embeds=e)
        got = tserve.serve(ARCH, device=cuda, params=from_jax_params(ref_params, cuda), **kw)
        want = tserve.serve(ARCH, device="cpu", params=from_jax_params(ref_params), **kw)
        np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_gpu_whisper_backward_refuses_before_any_launch(cuda, ref_params):
    """loss_fn(...).backward() on the card raises ValueError (the backward
    kernel is causal only) before any backward launch."""
    _, tcfg = configs("bfloat16")
    toks = torch.from_numpy(_tokens(18, tcfg, 2, 16)).long().to(cuda)
    leaves, treedef = tree_flatten(from_jax_params(ref_params, cuda))
    params = tree_unflatten(treedef, [x.requires_grad_(True) for x in leaves])
    batch = {"tokens": toks, "labels": toks,
             "encoder_embeds": torch.from_numpy(_frames(19, tcfg, 2)).to(cuda)}
    before = fa_ops.bwd_launches
    loss, _ = tdec.loss_fn(tcfg, params, batch)
    with pytest.raises(ValueError, match="causal only"):
        loss.backward()
    assert fa_ops.bwd_launches == before
