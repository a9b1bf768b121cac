"""repro_torch's Multi-head Latent Attention (minicpm3_4b) and the
flash_attention kernel at unequal q.k and v head dims, against repro's,
on the same numpy inputs and the reference's own parameters (carried
over with from_jax_params).

Tolerances, as tests/test_torch_llm_serve.py states them: at fp32
compute the packages differ only in the order of fp32 sums (1e-4 of the
output's scale; 1e-5 for the attention alone); at bf16 they round at
different places (the reference rounds the scores to bf16, the port's
kernel and its plain version keep them in fp32), 2e-2 of the scale.
The ``gpu`` tests hold the kernel against its plain version on the card
at the tolerances chip_smoke.py uses (2e-2 bf16, 2e-5 fp32).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import ref as jfa_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.models.factory import ParamFactory as JParamFactory  # noqa: E402
from repro.models.registry import get_smoke_config as jget_smoke_config  # noqa: E402
from repro_torch.common.pytree import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.factory import ParamFactory  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ARCH = "minicpm3_4b"
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


def rnd(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def both(x, dtype="float32"):
    return jnp.asarray(x, dtype), torch.from_numpy(np.array(x)).to(TORCH_DT[dtype])


def configs(compute="float32", **kw):
    return (jget_smoke_config(ARCH).replace(compute_dtype=compute, **kw),
            registry.get_smoke_config(ARCH).replace(compute_dtype=compute, **kw))


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, x in enumerate(tree) for n in _leaf_names(x, f"{prefix}/{i}")]
    return [prefix]


@pytest.fixture(scope="module")
def ref_params():
    """The reference's minicpm3_4b_smoke parameters (seed 0), numpy."""
    jcfg, _ = configs()
    return jax.tree.map(np.asarray, jdec.init_params(jcfg, jax.random.key(0)))


def mla0(params):
    """Layer 0's MLA block of a numpy parameter tree."""
    return jax.tree.map(lambda x: x[0], params["groups"][0])["attn"]


def cast_pair(ptree, dtype):
    return (jax.tree.map(lambda x: jnp.asarray(x, dtype), ptree),
            tree_map(lambda x: x.to(TORCH_DT[dtype]), from_jax_params(ptree)))


# ----------------------------------------------------------------- layout ---

def test_init_mla_tree_layout(ref_params):
    """init_mla draws the reference's seven leaves with their shapes, and
    the whole minicpm3_4b_smoke tree matches the reference's leaf for leaf."""
    jcfg, tcfg = configs()
    mine = tattn.init_mla(ParamFactory(torch.Generator().manual_seed(0)), tcfg)
    ref = jattn.init_mla(JParamFactory(key=jax.random.key(0)), jcfg)
    assert sorted(mine) == sorted(ref) == sorted(
        ["wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"])
    for k in ref:
        assert tuple(mine[k].shape) == ref[k].shape, k
    for k in ("q_norm", "kv_norm"):
        assert torch.equal(mine[k], torch.ones_like(mine[k]))
    tree = tdec.init_params(tcfg, torch.Generator().manual_seed(0))
    assert _leaf_names(tree) == _leaf_names(ref_params)
    assert [tuple(x.shape) for x in tree_leaves(tree)] == \
        [x.shape for x in jax.tree.leaves(ref_params)]


def test_check_launch_takes_the_unequal_pairs_forward_only():
    """The forward takes (96, 64) and (48, 32) besides the equal dims;
    any other pair, and the backward at an unequal pair, raise before a
    launch."""
    assert fa_ops.UNEQUAL_HEAD_DIMS == ((96, 64), (48, 32))
    for hd, dv in fa_ops.UNEQUAL_HEAD_DIMS:
        fa_ops._check_launch(torch.zeros(1, 1, 1, hd), dv=dv)
        with pytest.raises(ValueError, match="equal q.k and v"):
            fa_ops._check_launch(torch.zeros(1, 1, 1, hd), backward=True, dv=dv)
    for hd, dv in ((96, 96), (96, 32), (64, 32), (128, 64)):
        with pytest.raises(ValueError, match="head.dim"):
            fa_ops._check_launch(torch.zeros(1, 1, 1, hd), dv=dv)


# -------------------------------------------------------------- attention ---

@pytest.mark.parametrize("H,KV,window", [(4, 4, None), (8, 2, None), (4, 4, 5)])
def test_plain_attention_at_48_32_matches_reference(H, KV, window):
    """The wrapper's CPU route at q.k 48 / v 32 (minicpm3_4b_smoke's MLA)
    is the reference's: its expanded MLA scores (scale 1/sqrt(48), causal
    mask, fp32 softmax) for the MLA layout, and the flash_attention
    oracle's function, per (batch, head), under GQA and a window."""
    B, S = 2, 13
    q, k, v = rnd(60, (B, S, H, 48)), rnd(61, (B, S, KV, 48)), rnd(62, (B, S, KV, 32))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    before = fa_ops.launches
    got = fa_ops.gqa_flash_attention(tq, tk, tv, window=window)
    assert fa_ops.launches == before and tuple(got.shape) == (B, S, H, 32)
    scaled_close(got, fa_ref.gqa_attention(tq, tk, tv, window=window), 0, "plain version")
    G = H // KV
    kq, vq = np.repeat(k, G, axis=2), np.repeat(v, G, axis=2)
    if window is None and KV == H:
        pos = jnp.arange(S, dtype=jnp.int32)
        mask = jattn._causal_scores_mask(pos, pos, None)[None]
        scores = jnp.einsum("bqhd,bshd->bhqs", q, kq) * (1.0 / 48 ** 0.5)
        probs = jax.nn.softmax(jnp.where(mask[:, None], scores, jattn.NEG_INF), axis=-1)
        scaled_close(got, jnp.einsum("bhqs,bshd->bqhd", probs, vq), 1e-5, "MLA scores")

    def to_bh(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, S, x.shape[-1])

    want = jfa_ref.attention(to_bh(q), to_bh(kq), to_bh(vq), window=window)
    scaled_close(got, np.asarray(want).reshape(B, H, S, 32).transpose(0, 2, 1, 3), 1e-5,
                 "flash_attention oracle")


def test_plain_attention_gradient_at_48_32():
    """On the CPU the Function's backward (autograd through the plain
    version) gives the reference's gradient at unequal dims."""
    B, S, H = 2, 9, 4
    q, k, v, do = (rnd(70 + i, (B, S, H, d)) for i, d in enumerate((48, 48, 32, 32)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    fa_ops.gqa_flash_attention(tq, tk, tv).backward(torch.from_numpy(do))

    def f(q, k, v):
        def to_bh(x):
            return x.transpose(0, 2, 1, 3).reshape(B * H, S, x.shape[-1])
        o = jfa_ref.attention(to_bh(q), to_bh(k), to_bh(v))
        return o.reshape(B, H, S, 32).transpose(0, 2, 1, 3)

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    for got, want, name in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(do)), "qkv"):
        scaled_close(got, want, 1e-5, f"d{name}")


# -------------------------------------------------------------------- MLA ---

@pytest.mark.parametrize("return_ckv", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_forward(ref_params, dtype, return_ckv):
    jcfg, tcfg = configs(dtype)
    jp, tp = cast_pair(mla0(ref_params), dtype)
    S = 21                                   # ragged: no multiple of any tile
    jx, tx = both(rnd(80, (2, S, jcfg.d_model)), dtype)
    pos = np.arange(S, dtype=np.int32)
    before = fa_ops.launches
    got = tattn.mla_forward(tp, tcfg, tx, torch.from_numpy(pos), return_ckv=return_ckv)
    assert fa_ops.launches == before          # CPU tensors: the plain version
    want = jattn.mla_forward(jp, jcfg, jx, jnp.asarray(pos), return_ckv=return_ckv)
    if not return_ckv:
        scaled_close(got, want, TOL[dtype], "y")
        return
    (y, (ckv, krope)), (jy, (jckv, jkrope)) = got, want
    assert ckv.dtype == krope.dtype == TORCH_DT[dtype]
    scaled_close(y, jy, TOL[dtype], "y")
    scaled_close(ckv, jckv, TOL[dtype], "ckv")
    scaled_close(krope, jkrope, TOL[dtype], "krope")


def test_mla_forward_gradient(ref_params):
    """MLA trains on the CPU: the gradient of the expanded form through the
    attention Function equals the reference's, every leaf and the input."""
    jcfg, tcfg = configs()
    p = mla0(ref_params)
    x, dy = rnd(81, (2, 11, jcfg.d_model)), rnd(82, (2, 11, jcfg.d_model))
    pos = np.arange(11, dtype=np.int32)
    tp = {k: v.requires_grad_(True) for k, v in from_jax_params(p).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tattn.mla_forward(tp, tcfg, tx, torch.from_numpy(pos)).backward(torch.from_numpy(dy))
    _, vjp = jax.vjp(lambda pp, xx: jattn.mla_forward(pp, jcfg, xx, jnp.asarray(pos)),
                     jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(dy))
    scaled_close(tx.grad, gx, 1e-4, "dx")
    for k in p:
        scaled_close(tp[k].grad, gp[k], 1e-4, f"d{k}")


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 9, 15])
def test_mla_decode_over_a_filled_cache(ref_params, cache_dtype, pos):
    """The absorbed decode against the reference's, from a cache filled
    with random latents: the output, and the cache with this position's
    latent written (the input cache untouched)."""
    jcfg, tcfg = configs()
    jp, tp = cast_pair(mla0(ref_params), "float32")
    C, m = 16, jcfg.mla
    cache = {"ckv": rnd(83, (2, C, m.kv_lora_rank)), "krope": rnd(84, (2, C, m.qk_rope_head_dim))}
    jc = {k: jnp.asarray(v, cache_dtype) for k, v in cache.items()}
    tc = {k: torch.from_numpy(v).to(TORCH_DT[cache_dtype]) for k, v in cache.items()}
    jx, tx = both(rnd(85, (2, 1, jcfg.d_model)))
    got, new = tattn.mla_decode(tp, tcfg, tx, tc, pos)
    want, jnew = jattn.mla_decode(jp, jcfg, jx, jc, jnp.int32(pos))
    scaled_close(got, want, 1e-4, "y")
    for key in ("ckv", "krope"):
        assert new[key].dtype == TORCH_DT[cache_dtype]
        # the new entry rounds from fp32 values that may differ in the last bits
        scaled_close(new[key], jnew[key], 1e-4 if cache_dtype == "float32" else 2 ** -8, key)
        assert torch.equal(tc[key], torch.from_numpy(cache[key]).to(TORCH_DT[cache_dtype]))


def test_mla_cache_init_and_prefill_fill(ref_params):
    """init_cache's MLA leaves are full length (cache_len, not the serve
    window) in the given dtype; prefill fills the first S slots with the
    reference's latents and leaves the rest zero."""
    jcfg, tcfg = configs(serve_window=8)
    tp = from_jax_params(ref_params)
    c = tdec.init_cache(tcfg, tp, 2, 24, dtype=torch.float32)
    jc = jdec.init_cache(jcfg, ref_params, 2, 24, dtype=jnp.float32)
    assert [tuple(x.shape) for x in tree_leaves(c)] == [x.shape for x in jax.tree.leaves(jc)]
    assert tuple(c["groups"][0]["ckv"].shape) == (tcfg.num_layers, 2, 24, tcfg.mla.kv_lora_rank)
    toks = np.random.RandomState(86).randint(0, jcfg.vocab_size, size=(2, 10)).astype(np.int32)
    _, tcache, _ = tdec.prefill(tcfg, tp, torch.from_numpy(toks).long(), 24,
                                cache_dtype=torch.float32)
    _, jcache, _ = jdec.prefill(jcfg, ref_params, jnp.asarray(toks), 24, cache_dtype=jnp.float32)
    for key in ("ckv", "krope"):
        got, want = tcache["groups"][0][key], jcache["groups"][0][key]
        scaled_close(got, want, 1e-4, key)
        assert not bool(got[:, :, 10:].any())


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


GPU_TOL = {"bfloat16": 2e-2, "float32": 2e-5}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,S,H,KV,dqk,dv,window", [
    (2, 2048, 40, 40, 96, 64, None),     # minicpm3_4b's MLA, batch cut
    (2, 1000, 40, 40, 96, 64, None),     # ragged S
    (2, 333, 8, 2, 96, 64, 100),         # GQA and a window
    (2, 77, 4, 4, 48, 32, None),         # minicpm3_4b_smoke's MLA
    (2, 300, 4, 2, 48, 32, 64)])
def test_gpu_kernel_at_unequal_dims_matches_plain(cuda, dtype, B, S, H, KV, dqk, dv, window):
    """The forward kernel at (96, 64) and (48, 32), both routes, against
    its plain version on the card; v read in place as a slice of a wider
    tensor, as MLA's layer hands it over."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(B, S, H, dqk, generator=gen, device=cuda).to(dt)
    k = torch.randn(B, S, KV, dqk, generator=gen, device=cuda).to(dt)
    v = torch.randn(B, S, KV, dqk + dv, generator=gen, device=cuda).to(dt)[..., dqk:]
    assert not fa_ops.needs_copy(v)
    before = fa_ops.launches
    with torch.no_grad():
        got = fa_ops.gqa_flash_attention(q, k, v, window=window)
    assert fa_ops.launches == before + 1 and tuple(got.shape) == (B, S, H, dv)
    want = fa_ref.gqa_attention(q, k, v, window=window)
    tol = GPU_TOL[dtype]
    assert bool(torch.isfinite(got).all())
    assert torch.allclose(got.float(), want.float(), rtol=tol, atol=tol), \
        float((got.float() - want.float()).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dqk,dv", [(96, 64), (48, 32)])
def test_gpu_backward_at_unequal_dims_raises(cuda, dqk, dv):
    """With grad enabled on the card the forward runs (keeping lse) and
    the backward refuses the unequal pair with a ValueError before any
    launch: MLA training on the card waits for a backward kernel."""
    q = torch.randn(2, 64, 4, dqk, device=cuda, requires_grad=True)
    k = torch.randn(2, 64, 4, dqk, device=cuda, requires_grad=True)
    v = torch.randn(2, 64, 4, dv, device=cuda, requires_grad=True)
    o = fa_ops.gqa_flash_attention(q, k, v)
    before = fa_ops.bwd_launches
    with pytest.raises(ValueError, match="equal q.k and v"):
        o.sum().backward()
    assert fa_ops.bwd_launches == before


@pytest.mark.gpu
def test_gpu_minicpm3_smoke_prefill_matches_cpu_path(cuda, ref_params):
    """minicpm3_4b_smoke's prefill on the card (one kernel launch a layer)
    against the CPU path at fp32, logits and caches."""
    _, tcfg = configs()
    toks = torch.from_numpy(np.random.RandomState(87).randint(
        0, tcfg.vocab_size, size=(2, 40))).long()
    before = fa_ops.launches
    with torch.no_grad():
        lg, cg, _ = tdec.prefill(tcfg, from_jax_params(ref_params, cuda), toks.to(cuda), 48,
                                 cache_dtype=torch.float32)
    assert fa_ops.launches - before == tcfg.num_layers
    lc, cc, _ = tdec.prefill(tcfg, from_jax_params(ref_params), toks, 48,
                             cache_dtype=torch.float32)
    scaled_close(lg.cpu(), lc, 1e-4, "logits")
    for a, b in zip(tree_leaves(cg), tree_leaves(cc)):
        scaled_close(a.cpu(), b, 1e-4, "cache")
