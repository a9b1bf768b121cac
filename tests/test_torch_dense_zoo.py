"""repro_torch's last three decoder-only models against repro's, at smoke
width: minicpm3_4b (Multi-head Latent Attention), llava_next_mistral_7b
(a Mistral backbone behind stub vision prefix embeddings) and
command_r_35b (Cohere's parallel attention and FFN block, bias-free
LayerNorm), on the same numpy inputs and the reference's own parameters
(carried over with from_jax_params).

Tolerances, as tests/test_torch_llm_serve.py states them: at fp32
compute logits and caches agree to 1e-4 of their scale (the packages
differ in the order of fp32 sums), decode over a bf16 cache to 1e-2 (an
entry may round one bf16 step apart); at bf16 compute 2e-2; a prefill
and its stepwise decode in the port alone 3e-2, as the reference holds
its own two paths (tests/test_prefill.py).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import EncoderConfig  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.models.registry import get_smoke_config as jget_smoke_config  # noqa: E402
from repro_torch.common.pytree import tree_flatten, tree_leaves  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ARCHS = ["minicpm3_4b", "llava_next_mistral_7b", "command_r_35b"]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PREFIX = 16     # llava_next_mistral_7b_smoke's num_prefix_tokens


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


def configs(arch, compute="float32", **kw):
    return (jget_smoke_config(arch).replace(compute_dtype=compute, **kw),
            registry.get_smoke_config(arch).replace(compute_dtype=compute, **kw))


def _tokens(seed, cfg, B, T):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(B, T)).astype(np.int32)


def _prefix(seed, cfg, B, P=PREFIX):
    """Stub vision embeddings as the reference draws them: 0.02 N(0, 1)."""
    return (0.02 * np.random.RandomState(seed).randn(B, P, cfg.d_model)).astype(np.float32)


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, x in enumerate(tree) for n in _leaf_names(x, f"{prefix}/{i}")]
    return [prefix]


@pytest.fixture(scope="module")
def ref_params():
    """The reference's parameters of each smoke model (seed 0), numpy."""
    return {arch: jax.tree.map(np.asarray, jdec.init_params(configs(arch)[0], jax.random.key(0)))
            for arch in ARCHS}


def _prefix_kw(arch, seed, cfg, B):
    """(jax kwargs, torch kwargs): llava's prefix embeddings, else none."""
    if arch != "llava_next_mistral_7b":
        return {}, {}
    p = _prefix(seed, cfg, B)
    return {"prefix_embeds": jnp.asarray(p)}, {"prefix_embeds": torch.from_numpy(p)}


# ------------------------------------------------------- config and params ---

@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_tree_match_reference(ref_params, arch):
    """The port's configs hold the reference's values, and its draw has the
    reference's tree leaf for leaf: MLA's seven leaves, no norm2 in a
    parallel block."""
    for t, j in ((registry.get_config(arch), jget_config(arch)),
                 (registry.get_smoke_config(arch), jget_smoke_config(arch))):
        assert vars(t).keys() == vars(j).keys()
        for k in vars(j):
            a, b = getattr(t, k), getattr(j, k)
            assert (vars(a) == vars(b)) if hasattr(b, "__dataclass_fields__") else a == b, k
    _, tcfg = configs(arch)
    tdec.check_supported(tcfg)
    mine = tdec.init_params(tcfg, torch.Generator().manual_seed(0))
    assert _leaf_names(mine) == _leaf_names(ref_params[arch])
    assert [tuple(x.shape) for x in tree_leaves(mine)] == \
        [x.shape for x in jax.tree.leaves(ref_params[arch])]
    layer = mine["groups"][0]
    assert ("norm2" in layer) != (arch == "command_r_35b")


def test_encoder_and_audio_frontend_still_raise():
    """whisper_small's encoder and its audio frontend are ported: its
    config passes check_supported.  An audio frontend without an encoder
    still raises naming ROADMAP.md, and so does an encoder beside
    command_r's parallel blocks (the reference's encoder layers read a
    norm2 that parallel blocks do not draw)."""
    tdec.check_supported(registry.get_config("whisper_small"))
    tdec.check_supported(registry.get_smoke_config("whisper_small"))
    cfg = registry.get_smoke_config("command_r_35b")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tdec.check_supported(cfg.replace(encoder=EncoderConfig(num_layers=2, num_frames=8)))
    audio = registry.get_smoke_config("llava_next_mistral_7b").frontend
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tdec.check_supported(cfg.replace(frontend=type(audio)(kind="audio",
                                                              num_prefix_tokens=4)))
    whisper = registry.get_smoke_config("whisper_small")
    with pytest.raises(NotImplementedError, match="audio frontend without an encoder"):
        tdec.check_supported(whisper.replace(encoder=None))


# ------------------------------------------------------- forward and loss ---

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(ref_params, arch, dtype):
    """forward's logits at every position (llava's with 16 prefix
    embeddings before 10 tokens)."""
    jcfg, tcfg = configs(arch, dtype)
    toks = _tokens(2, jcfg, 2, 10)
    jkw, tkw = _prefix_kw(arch, 3, jcfg, 2)
    jf, _ = jdec.forward(jcfg, ref_params[arch], jnp.asarray(toks), **jkw)
    tf, _ = tdec.forward(tcfg, from_jax_params(ref_params[arch]), torch.from_numpy(toks).long(),
                         **tkw)
    assert tf.shape[1] == 10 + (PREFIX if tkw else 0)
    scaled_close(tf, jf, 1e-4 if dtype == "float32" else 2e-2, "logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(ref_params, arch):
    """loss_fn at fp32 with masked labels; llava's 16 prefix positions
    carry no loss, so moving its prefix changes the loss only through the
    tokens' attention to it."""
    jcfg, tcfg = configs(arch)
    toks = _tokens(4, jcfg, 2, 12)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :3] = -1
    jkw, tkw = _prefix_kw(arch, 5, jcfg, 2)
    jloss, _ = jdec.loss_fn(jcfg, ref_params[arch],
                            {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels), **jkw})
    tloss, met = tdec.loss_fn(tcfg, from_jax_params(ref_params[arch]),
                              {"tokens": torch.from_numpy(toks).long(),
                               "labels": torch.from_numpy(labels).long(), **tkw})
    assert torch.equal(tloss, met["nll"])
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    if tkw:
        # the loss is the NLL of the token positions alone: the forward's
        # logits after the prefix, scored by hand
        logits, _ = tdec.forward(tcfg, from_jax_params(ref_params[arch]),
                                 torch.from_numpy(toks).long(), **tkw)
        logp = torch.log_softmax(logits[:, PREFIX:].float(), -1)
        lab = torch.from_numpy(labels).long()
        mask = lab >= 0
        nll = -logp.gather(-1, lab.clamp_min(0)[..., None])[..., 0]
        np.testing.assert_allclose(float(tloss), float(nll[mask].mean()), rtol=1e-5)


# ------------------------------------------------------- prefill and decode ---

@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(ref_params, arch, cache_dtype):
    """fp32 compute: prefill's last logits and every cache leaf, then 8
    decode steps' logits and the final cache, against the reference (llava
    text-only here; its prefix prefill is the test below)."""
    jcfg, tcfg = configs(arch)
    params = ref_params[arch]
    tp = from_jax_params(params)
    B, P, G, CL = 2, 12, 8, 40
    toks = _tokens(1, jcfg, B, P + G)
    jl, jc, jpos = jdec.prefill(jcfg, params, jnp.asarray(toks[:, :P]), CL,
                                cache_dtype=jnp.dtype(cache_dtype))
    tl, tc, tpos = tdec.prefill(tcfg, tp, torch.from_numpy(toks[:, :P]).long(), CL,
                                cache_dtype=TORCH_DT[cache_dtype])
    assert tpos == int(jpos) == P
    scaled_close(tl, jl, 1e-4, "prefill logits")
    decode_tol = 1e-4 if cache_dtype == "float32" else 1e-2

    def caches_close(tc, jc, after_prefill):
        jleaves, _ = tree_flatten(jax.tree.map(np.asarray, jc))
        tleaves, _ = tree_flatten(tc)
        assert len(jleaves) == len(tleaves)
        for name, t, j in zip(_leaf_names(tc), tleaves, jleaves):
            assert tuple(t.shape) == j.shape and t.dtype == TORCH_DT[str(j.dtype)], name
            if t.dtype == torch.bfloat16 and after_prefill:
                bf16_cache_close(t, j, name)
            else:
                scaled_close(t, j, 1e-4 if after_prefill else decode_tol, name)

    caches_close(tc, jc, True)
    for t in range(P, P + G):
        jl, jc = jdec.decode_step(jcfg, params, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl, tc = tdec.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        scaled_close(tl, jl, decode_tol, f"decode logits at {t}")
    caches_close(tc, jc, False)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_matches_reference(ref_params, arch):
    jcfg, tcfg = configs(arch, "bfloat16")
    toks = _tokens(6, jcfg, 2, 10)
    jkw, tkw = _prefix_kw(arch, 7, jcfg, 2)
    jl, _, _ = jdec.prefill(jcfg, ref_params[arch], jnp.asarray(toks), 32, **jkw)
    tl, _, _ = tdec.prefill(tcfg, from_jax_params(ref_params[arch]),
                            torch.from_numpy(toks).long(), 32, **tkw)
    scaled_close(tl, jl, 2e-2, "bf16 prefill logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_greedy_tokens_equal_reference(ref_params, arch, monkeypatch):
    """serve() at fp32 compute: the port's greedy tokens are the
    reference's, from the same prompt and the reference's parameters."""
    jcfg, tcfg = configs(arch)
    monkeypatch.setattr(jserve, "get_smoke_config", lambda a: jcfg)
    want = jserve.serve(arch, smoke=True, batch=2, prompt_len=10, gen=6)
    got = tserve.serve(arch, smoke=True, batch=2, prompt_len=10, gen=6, device="cpu",
                       cfg=tcfg, params=from_jax_params(ref_params[arch]))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_stepwise(arch):
    """The port against itself, as tests/test_prefill.py holds the
    reference: prefill of P tokens then decode equals decoding all."""
    cfg = registry.get_smoke_config(arch)
    params = tdec.init_params(cfg, torch.Generator().manual_seed(0))
    B, P, G, CL = 2, 6, 4, 64
    toks = torch.from_numpy(_tokens(3, cfg, B, P + G)).long()
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


# ----------------------------------------------------- llava's prefix path ---

def test_llava_prefix_prefill_step_matches_reference(ref_params):
    """make_prefill_step with 16 prefix embeddings and 10 tokens, then 4
    make_serve_step decodes from position 26, against the reference's
    steps at fp32 compute: logits and the filled cache."""
    arch = "llava_next_mistral_7b"
    jcfg, tcfg = configs(arch)
    B, T, G, CL = 2, 10, 4, 40
    toks = _tokens(8, jcfg, B, T + G)
    pre = _prefix(9, jcfg, B)
    jpre = jsteps.make_prefill_step(jcfg, fill_cache=True, cache_len=CL)
    tpre = make_prefill_step(tcfg, fill_cache=True, cache_len=CL)
    jl, jc = jpre(ref_params[arch], {"tokens": jnp.asarray(toks[:, :T]),
                                     "prefix_embeds": jnp.asarray(pre)})
    tp = from_jax_params(ref_params[arch])
    tl, tc = tpre(tp, {"tokens": torch.from_numpy(toks[:, :T]).long(),
                       "prefix_embeds": torch.from_numpy(pre)})
    scaled_close(tl, jl, 1e-4, "prefix prefill logits")
    for name, t, j in zip(_leaf_names(tc), tree_leaves(tc), jax.tree.leaves(jc)):
        bf16_cache_close(t, j, name)         # the steps keep the bf16 default cache
    jstep, tstep = jsteps.make_serve_step(jcfg), make_serve_step(tcfg)
    for i in range(G):
        t = PREFIX + T + i
        jl, jc = jstep(ref_params[arch], jc, jnp.asarray(toks[:, T + i:T + i + 1]), jnp.int32(t))
        tl, tc = tstep(tp, tc, torch.from_numpy(toks[:, T + i:T + i + 1]).long(), t)
        scaled_close(tl, jl, 1e-2, f"decode logits at {t}")
    # the prefill step without a cache: forward's last position
    last = make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks[:, :T]).long(),
                                        "prefix_embeds": torch.from_numpy(pre)})
    jlast = jsteps.make_prefill_step(jcfg)(ref_params[arch], {
        "tokens": jnp.asarray(toks[:, :T]), "prefix_embeds": jnp.asarray(pre)})
    scaled_close(last, jlast, 1e-4, "prefill step without a cache")


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_llava_prefix_prefill_plus_one_step_equals_longer_prefill(cache_dtype):
    """The port against itself: a prefix prefill of n - 1 tokens and one
    decode_step at position P + n - 1 give the last logits of one prefix
    prefill of all n tokens (chip_smoke.py's gate at full width)."""
    cfg = registry.get_smoke_config("llava_next_mistral_7b").replace(compute_dtype="float32")
    params = tdec.init_params(cfg, torch.Generator().manual_seed(0))
    n, B = 9, 2
    toks = torch.from_numpy(_tokens(10, cfg, B, n)).long()
    pre = torch.from_numpy(_prefix(11, cfg, B))
    dt = TORCH_DT[cache_dtype]
    whole, _, pos = tdec.prefill(cfg, params, toks, 32, prefix_embeds=pre, cache_dtype=dt)
    assert pos == PREFIX + n
    _, cache, pos = tdec.prefill(cfg, params, toks[:, :-1], 32, prefix_embeds=pre,
                                 cache_dtype=dt)
    step, _ = tdec.decode_step(cfg, params, cache, toks[:, -1:], pos)
    scaled_close(step, whole, 1e-4 if cache_dtype == "float32" else 1e-2, "logits")


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
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_gpu_serve_matches_cpu_path(cuda, ref_params, arch, compute):
    """The smoke-width serve on the card, through the kernel (one launch a
    layer), against the CPU path with the same parameters: the same greedy
    tokens at fp32 compute; the prefill logits at 2e-2 of their scale at
    bf16 (1e-4 at fp32)."""
    _, tcfg = configs(arch, compute)
    params = from_jax_params(ref_params[arch])
    before = fa_ops.launches
    kw = dict(smoke=True, batch=2, prompt_len=40, gen=6, cfg=tcfg, verbose=False)
    stats = {}
    got = tserve.serve(arch, device=cuda, params=from_jax_params(ref_params[arch], cuda),
                       stats=stats, **kw)
    assert fa_ops.launches - before == tcfg.num_layers and stats["logits_finite"]
    want = tserve.serve(arch, device="cpu", params=params, **kw)
    if compute == "float32":
        np.testing.assert_array_equal(got, want)
    toks = torch.from_numpy(_tokens(5, tcfg, 2, 40)).long()
    _, tkw = _prefix_kw(arch, 12, tcfg, 2)
    lg, _, _ = tdec.prefill(tcfg, from_jax_params(ref_params[arch], cuda), toks.to(cuda), 64,
                            **{k: v.to(cuda) for k, v in tkw.items()})
    lc, _, _ = tdec.prefill(tcfg, params, toks, 64, **tkw)
    scaled_close(lg.cpu(), lc, 2e-2 if compute == "bfloat16" else 1e-4)
