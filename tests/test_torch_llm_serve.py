"""repro_torch's serving path (layers, GQA attention, RWKV6, decoder,
prefill, decode_step, serve) against repro's, on the same numpy inputs
and the reference's own parameters (carried over with from_jax_params).

Tolerances: at fp32 compute the two packages differ only in the order
of fp32 sums, so layer outputs and logits agree to 1e-4 of their scale;
at bf16 compute the packages round at different places (the reference
rounds attention scores and probabilities to bf16, the port's kernel and
its plain version keep them in fp32), so they agree to 2e-2 of their
scale, as tests/test_prefill.py holds the reference's own two paths.
The decode caches are bf16 in both packages (as the reference keeps
them), so their entries may sit one bf16 step (2^-8 relative) apart
when the fp32 values they round from differ in the last bits.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import recurrence as jrec  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.models.registry import get_smoke_config as jget_smoke_config  # noqa: E402
from repro_torch.common.pytree import tree_flatten, tree_leaves, tree_map  # noqa: E402
from repro_torch.configs.base import EncoderConfig  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.linear_scan import ops as ls_ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import recurrence as trec  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.factory import ParamFactory  # noqa: E402
from repro_torch.weights import from_jax_params, to_numpy_params  # noqa: E402

ARCHS = ["minicpm_2b", "starcoder2_3b", "rwkv6_3b"]
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


def bf16_cache_close(got, want, what=""):
    """bf16 cache entries: equal, or one bf16 step apart where the fp32
    values they were rounded from straddle a rounding boundary."""
    g, w = _np(got), _np(want)
    big = np.maximum(np.maximum(np.abs(g), np.abs(w)), 2.0 ** -126)
    step = 2.0 ** (np.floor(np.log2(big)) - 7)        # bf16 keeps 8 significant bits
    assert (np.abs(g - w) <= step).all(), (what, float(np.abs(g - w).max()))


def rnd(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def both(x, dtype="float32"):
    """One numpy array -> (jax array, torch tensor) of ``dtype``."""
    return jnp.asarray(x, dtype), torch.from_numpy(np.array(x)).to(TORCH_DT[dtype])


def configs(arch, compute="float32", **kw):
    return (jget_smoke_config(arch).replace(compute_dtype=compute, **kw),
            registry.get_smoke_config(arch).replace(compute_dtype=compute, **kw))


@pytest.fixture(scope="module")
def ref_params():
    """The reference's parameters of each smoke model (seed 0), numpy."""
    out = {}
    for arch in ARCHS:
        jcfg, _ = configs(arch)
        out[arch] = jax.tree.map(np.asarray, jdec.init_params(jcfg, jax.random.key(0)))
    return out


def layer0(params, key):
    """Group 0, layer 0's sub-tree ``key`` of a numpy parameter tree."""
    return jax.tree.map(lambda x: x[0], params["groups"][0])[key]


def cast_pair(ptree, dtype):
    """A numpy parameter tree -> (jax tree, torch tree) of ``dtype``."""
    return (jax.tree.map(lambda x: jnp.asarray(x, dtype), ptree),
            tree_map(lambda x: x.to(TORCH_DT[dtype]), from_jax_params(ptree)))


# ------------------------------------------------------------------ layers ---

class TestLayers:
    @pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_apply_norm(self, kind, dtype):
        p = {"scale": rnd(1, (64,)), "bias": rnd(2, (64,))}
        if kind == "rmsnorm":
            del p["bias"]
        jp, tp = cast_pair(p, dtype)
        jx, tx = both(rnd(0, (2, 5, 64)) * 3 + 1, dtype)
        got = tlayers.apply_norm(tp, tx, kind, 1e-5)
        assert got.dtype == TORCH_DT[dtype]
        scaled_close(got, jlayers.apply_norm(jp, jx, kind, 1e-5), TOL[dtype])

    def test_group_norm_and_rms_normalize(self):
        p = {"scale": rnd(3, (4, 16)), "bias": rnd(4, (4, 16))}
        jx, tx = both(rnd(5, (2, 3, 4, 16)))
        scaled_close(tlayers.apply_group_norm(from_jax_params(p), tx),
                     jlayers.apply_group_norm(jax.tree.map(jnp.asarray, p), jx), 1e-5)
        scaled_close(tlayers.rms_normalize(tx), jlayers.rms_normalize(jx), 1e-5)

    @pytest.mark.parametrize("batched_positions", [False, True])
    def test_apply_rope(self, batched_positions):
        jx, tx = both(rnd(6, (2, 9, 4, 32)))
        pos = np.arange(9, dtype=np.int32) + 5
        if batched_positions:
            pos = np.stack([pos, pos * 3])
        got = tlayers.apply_rope(tx, torch.from_numpy(pos), 1e5)
        scaled_close(got, jlayers.apply_rope(jx, jnp.asarray(pos), 1e5), 1e-5)

    @pytest.mark.parametrize("activation", ["gelu", "silu"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_apply_mlp(self, activation, dtype):
        d, ff = 32, 64
        p = {"w_up": rnd(7, (d, ff)) / 6, "w_down": rnd(8, (ff, d)) / 8, "b_down": rnd(9, (d,))}
        if activation == "silu":
            p["w_gate"] = rnd(10, (d, ff)) / 6
        else:
            p["b_up"] = rnd(11, (ff,))
        jp, tp = cast_pair(p, dtype)
        jx, tx = both(rnd(12, (2, 5, d)), dtype)
        scaled_close(tlayers.apply_mlp(tp, tx, activation),
                     jlayers.apply_mlp(jp, jx, activation), TOL[dtype])

    def test_embedding_and_unembed(self):
        table, w = rnd(13, (50, 16)), rnd(14, (16, 50))
        toks = np.array([[1, 7, 49], [0, 3, 3]], np.int32)
        e = tlayers.embed_tokens({"table": torch.from_numpy(table)}, torch.from_numpy(toks))
        np.testing.assert_array_equal(e.numpy(), table[toks])
        scaled_close(tlayers.unembed({"w": torch.from_numpy(w)}, e),
                     jlayers.unembed({"w": jnp.asarray(w)}, jnp.asarray(table[toks])), 1e-5)
        scaled_close(tlayers.unembed(None, e, tied_table=torch.from_numpy(table)),
                     jnp.asarray(table[toks]) @ jnp.asarray(table).T, 1e-5)


class TestAttention:
    @pytest.mark.parametrize("window", [None, 8])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_attention_forward(self, ref_params, window, dtype):
        jcfg, tcfg = configs("starcoder2_3b", dtype)
        jp, tp = cast_pair(layer0(ref_params["starcoder2_3b"], "attn"), dtype)
        S = 21                                   # ragged: no multiple of any tile
        jx, tx = both(rnd(20, (2, S, jcfg.d_model)), dtype)
        pos = np.arange(S, dtype=np.int32)
        before = fa_ops.launches
        got, (k, v) = tattn.attention_forward(tp, tcfg, tx, torch.from_numpy(pos),
                                              window=window, return_kv=True)
        assert fa_ops.launches == before          # CPU tensors: the plain version
        want, (jk, jv) = jattn.attention_forward(jp, jcfg, jx, jnp.asarray(pos), window=window,
                                                 return_kv=True)
        scaled_close(got, want, TOL[dtype])
        scaled_close(k, jk, TOL[dtype])
        scaled_close(v, jv, TOL[dtype])

    @pytest.mark.parametrize("pos", [3, 13])
    def test_attention_decode_rotating_window(self, ref_params, pos):
        jcfg, tcfg = configs("starcoder2_3b")
        jp, tp = cast_pair(layer0(ref_params["starcoder2_3b"], "attn"), "float32")
        C = 8
        cache = {"k": rnd(21, (2, C, jcfg.num_kv_heads, jcfg.head_dim)),
                 "v": rnd(22, (2, C, jcfg.num_kv_heads, jcfg.head_dim))}
        jc = {k: jnp.asarray(v, jnp.bfloat16) for k, v in cache.items()}
        tc = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in cache.items()}
        jx, tx = both(rnd(23, (2, 1, jcfg.d_model)))
        got, new = tattn.attention_decode(tp, tcfg, tx, tc, pos, window=C)
        want, jnew = jattn.attention_decode(jp, jcfg, jx, jc, jnp.int32(pos), window=C)
        scaled_close(got, want, 1e-4)
        for key in ("k", "v"):
            bf16_cache_close(new[key], jnew[key], key)
            assert torch.equal(tc[key], torch.from_numpy(cache[key]).to(torch.bfloat16))

    def test_cross_attention_raises(self, ref_params):
        """Cross-attention is ported (whisper_small): starcoder2_3b's layer
        with kv_override, 11 queries over 29 keys (GQA), is the
        reference's; k and v that do not form GQA groups with q raise,
        and so does causal attention over unequal lengths."""
        jcfg, tcfg = configs("starcoder2_3b")
        jp, tp = cast_pair(layer0(ref_params["starcoder2_3b"], "attn"), "float32")
        jx, tx = both(rnd(24, (2, 11, jcfg.d_model)))
        KV, hd = jcfg.num_kv_heads, jcfg.head_dim
        jk, tk = both(rnd(25, (2, 29, KV, hd)))
        jv, tv = both(rnd(26, (2, 29, KV, hd)))
        pos = np.arange(11, dtype=np.int32)
        got = tattn.attention_forward(tp, tcfg, tx, torch.from_numpy(pos), kv_override=(tk, tv))
        want = jattn.attention_forward(jp, jcfg, jx, jnp.asarray(pos), kv_override=(jk, jv))
        scaled_close(got, want, 1e-4)
        bad = torch.zeros(2, 29, KV, hd + 8)
        with pytest.raises(ValueError, match="GQA groups"):
            tattn.attention_forward(tp, tcfg, tx, torch.from_numpy(pos), kv_override=(bad, bad))
        q = torch.zeros(2, 11, tcfg.num_heads, hd)
        with pytest.raises(ValueError, match="as many keys as queries"):
            fa_ops.gqa_flash_attention(q, tk, tv)


class TestRWKV6:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_time_mix_prefill_then_decode(self, ref_params, dtype):
        jcfg, tcfg = configs("rwkv6_3b", dtype)
        jp, tp = cast_pair(layer0(ref_params["rwkv6_3b"], "tm"), dtype)
        jx, tx = both(rnd(30, (2, 11, jcfg.d_model)), dtype)
        before = ls_ops.launches
        got, (sh, wkv) = trec.rwkv6_time_mix(tp, tcfg, tx)
        assert ls_ops.launches == before
        want, (jsh, jwkv) = jrec.rwkv6_time_mix(jp, jcfg, jx)
        scaled_close(got, want, TOL[dtype], "y")
        scaled_close(sh, jsh, TOL[dtype], "shift")
        scaled_close(wkv, jwkv, TOL[dtype], "wkv")
        # one decode step from the state the prompt left
        jx1, tx1 = both(rnd(31, (2, 1, jcfg.d_model)), dtype)
        got1, (_, wkv1) = trec.rwkv6_time_mix(tp, tcfg, tx1, shift_state=sh, wkv_state=wkv)
        want1, (_, jwkv1) = jrec.rwkv6_time_mix(jp, jcfg, jx1, shift_state=jsh, wkv_state=jwkv)
        scaled_close(got1, want1, TOL[dtype], "y decode")
        scaled_close(wkv1, jwkv1, TOL[dtype], "wkv decode")

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_channel_mix(self, ref_params, dtype):
        jcfg, _ = configs("rwkv6_3b", dtype)
        jp, tp = cast_pair(layer0(ref_params["rwkv6_3b"], "tm"), dtype)
        jx, tx = both(rnd(32, (2, 6, jcfg.d_model)), dtype)
        js, ts = both(rnd(33, (2, jcfg.d_model)), dtype)
        got, sh = trec.rwkv6_channel_mix(tp, tx, shift_state=ts)
        want, jsh = jrec.rwkv6_channel_mix(jp, jx, shift_state=js)
        scaled_close(got, want, TOL[dtype])
        scaled_close(sh, jsh, 0)

    def test_bf16_smoke_model_layer_by_layer(self, ref_params, capsys):
        """The smoke model at bf16 compute, stage by stage.  Fed the same
        input (the reference's residual stream), every time-mix and
        channel-mix agrees with the reference's at 2e-2 of its scale; the
        whole prefill's last-position logits agree at 3e-2, the tolerance
        the reference holds its own bf16 prefill and stepwise decode to
        (tests/test_prefill.py).  Fed each package's own stream, a
        layer's time-mix can move far more than its input: ln_x divides
        each head's wkv output by its spread, which at some positions is
        small beside the terms that cancel in it.  Both readings are
        printed per stage."""
        jcfg, tcfg = configs("rwkv6_3b", "bfloat16")
        jp, tp = cast_pair(ref_params["rwkv6_3b"], "bfloat16")
        toks = _tokens(2, jcfg, 2, 10)
        rs = tdec._residual_scale(tcfg)

        def to_t(a):
            return torch.from_numpy(np.array(_np(a))).to(torch.bfloat16)

        def gap(got, want):
            g, w = _np(got), _np(want)
            return float(np.abs(g - w).max() / (np.abs(w).max() + 1e-6))

        jx = (jlayers.embed_tokens(jp["embed"], jnp.asarray(toks)) * jcfg.scale_emb
              ).astype(jnp.bfloat16)
        tx = tdec._embed(tcfg, tp, torch.from_numpy(toks).long())      # the port's own stream
        scaled_close(tx, jx, 0, "embedding")
        lines = []
        for i in range(tcfg.num_layers):
            jl = jax.tree.map(lambda x: x[i], jp["groups"][0])
            tl = tree_map(lambda x: x[i], tp["groups"][0])
            for stage, norm in (("time-mix", "norm1"), ("channel-mix", "norm2")):
                jh = jlayers.apply_norm(jl[norm], jx, jcfg.norm, jcfg.norm_eps)
                th = tlayers.apply_norm(tl[norm], tx, tcfg.norm, tcfg.norm_eps)
                if stage == "time-mix":
                    jy, _ = jrec.rwkv6_time_mix(jl["tm"], jcfg, jh)
                    same, _ = trec.rwkv6_time_mix(tl["tm"], tcfg, to_t(jh))
                    own, _ = trec.rwkv6_time_mix(tl["tm"], tcfg, th)
                else:
                    jy, _ = jrec.rwkv6_channel_mix(jl["tm"], jh)
                    same, _ = trec.rwkv6_channel_mix(tl["tm"], to_t(jh))
                    own, _ = trec.rwkv6_channel_mix(tl["tm"], th)
                scaled_close(same, jy, 2e-2, f"layer {i} {stage}, the same input")
                lines.append(f"layer {i} {stage}: same input {gap(same, jy):.4f}; own stream "
                             f"{gap(own, jy):.4f} from an input {gap(th, jh):.4f} apart")
                jx, tx = jx + jy * rs, tx + own * rs
        jl_, _, _ = jdec.prefill(jcfg, ref_params["rwkv6_3b"], jnp.asarray(toks), 16)
        tl_, _, _ = tdec.prefill(tcfg, from_jax_params(ref_params["rwkv6_3b"]),
                                 torch.from_numpy(toks).long(), 16)
        lines.append(f"prefill last-position logits: {gap(tl_, jl_):.4f}")
        with capsys.disabled():
            print("\nrwkv6_3b smoke, bf16, port against reference, max abs gap over scale:")
            print("\n".join(lines))
        scaled_close(tl_, jl_, 3e-2, "bf16 prefill logits")

    def test_mamba_decay_raises(self):
        """Per-head decay (Mamba2) no longer raises: it is held against the
        reference's chunked per-head path, unclamped (log-decays down to
        -12, below the per-dim clamp of -8)."""
        rs = np.random.RandomState(35)
        q, k, v = (rs.randn(1, 9, 2, 8).astype(np.float32) for _ in range(3))
        la = (-12.0 * rs.rand(1, 9, 2)).astype(np.float32)
        got, gs = trec.linear_recurrence(*(torch.from_numpy(x) for x in (q, k, v, la)),
                                         decay_per="head")
        want, ws = jrec.linear_recurrence(*(jnp.asarray(x) for x in (q, k, v, la)), chunk=4,
                                          decay_per="head")
        scaled_close(got, want, 1e-4)
        scaled_close(gs, ws, 1e-4)

    def test_scan_reference_is_unclamped(self):
        """linear_recurrence_scan is the exact oracle, without the clamp."""
        rs = np.random.RandomState(34)
        q, k, v = (rs.randn(1, 5, 2, 4).astype(np.float32) for _ in range(3))
        la = np.full((1, 5, 2, 4), -9.0, np.float32)
        got, gs = trec.linear_recurrence_scan(*(torch.from_numpy(x) for x in (q, k, v, la)))
        want, ws = jrec.linear_recurrence_scan(*(jnp.asarray(x) for x in (q, k, v, la)))
        scaled_close(got, want, 1e-5)
        scaled_close(gs, ws, 1e-5)


# ------------------------------------------------------------ whole slice ---

def _tokens(seed, cfg, B, T):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(B, T)).astype(np.int32)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(ref_params, arch, cache_dtype):
    """fp32 compute: prefill's last logits and every cache leaf, then 8
    decode steps' logits and the final cache, against the reference.
    With the default bf16 KV cache an entry may round one bf16 step apart
    in the two packages, which moves later logits by about 1e-3 of their
    scale; with an fp32 cache everything agrees to 1e-4."""
    jcfg, tcfg = configs(arch)
    params = ref_params[arch]
    tp = from_jax_params(params)
    B, P, G, CL = 2, 12, 8, 24 if arch == "rwkv6_3b" else 40
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


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, x in enumerate(tree) for n in _leaf_names(x, f"{prefix}/{i}")]
    return [prefix]


def test_bf16_prefill_and_forward_match_reference(ref_params):
    """bf16 compute, the dense model: logits at 2e-2 of their scale.
    RWKV6 at bf16 is held stage by stage and at its last position
    (TestRWKV6.test_bf16_smoke_model_layer_by_layer): its logits at the
    other positions move far on a small difference in a layer's input."""
    jcfg, tcfg = configs("starcoder2_3b", "bfloat16")
    params = ref_params["starcoder2_3b"]
    tp = from_jax_params(params)
    toks = _tokens(2, jcfg, 2, 10)
    jl, _, _ = jdec.prefill(jcfg, params, jnp.asarray(toks), 16)
    tl, _, _ = tdec.prefill(tcfg, tp, torch.from_numpy(toks).long(), 16)
    scaled_close(tl, jl, 2e-2, "bf16 prefill logits")
    jf, _ = jdec.forward(jcfg, params, jnp.asarray(toks))
    tf, _ = tdec.forward(tcfg, tp, torch.from_numpy(toks).long())
    scaled_close(tf, jf, 2e-2, "bf16 forward logits")


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


def test_prefill_rotating_window_layout():
    """Prompt longer than the window: the rotating buffer holds the last
    `window` tokens at slots pos % window, as stepwise decode leaves it."""
    cfg = registry.get_smoke_config("starcoder2_3b").replace(sliding_window=8, serve_window=8)
    params = tdec.init_params(cfg, torch.Generator().manual_seed(0))
    B, P = 1, 20
    toks = torch.from_numpy(_tokens(4, cfg, B, P + 1)).long()
    cache_a = tdec.init_cache(cfg, params, B, P + 4)
    assert cache_a["groups"][0]["k"].shape[2] == 8
    for t in range(P):
        _, cache_a = tdec.decode_step(cfg, params, cache_a, toks[:, t:t + 1], t)
    _, cache_b, _ = tdec.prefill(cfg, params, toks[:, :P], P + 4)
    scaled_close(cache_b["groups"][0]["k"], cache_a["groups"][0]["k"], 2e-2)
    la, _ = tdec.decode_step(cfg, params, cache_a, toks[:, P:P + 1], P)
    lb, _ = tdec.decode_step(cfg, params, cache_b, toks[:, P:P + 1], P)
    scaled_close(lb, la, 2e-2)


def test_padded_vocab_and_prefill_step(ref_params):
    """A vocab that is no multiple of pad_vocab_to: the padded logit
    columns are masked to -1e30 as in the reference, and the prefill step
    without a cache returns forward's last-position logits."""
    jcfg, tcfg = configs("starcoder2_3b", vocab_size=500)
    params = jax.tree.map(np.asarray, jdec.init_params(jcfg, jax.random.key(1)))
    toks = _tokens(7, jcfg, 2, 9)
    jf, _ = jdec.forward(jcfg, params, jnp.asarray(toks))
    tf, _ = tdec.forward(tcfg, from_jax_params(params), torch.from_numpy(toks).long())
    assert tf.shape[-1] == 512 and bool((tf[..., 500:] == -1e30).all())
    scaled_close(tf[..., :500], jf[..., :500], 1e-4)
    last = make_prefill_step(tcfg)(from_jax_params(params), {"tokens": torch.from_numpy(toks)})
    assert torch.equal(last, tf[:, -1])


# ------------------------------------------------- config, params, entry ---

def assert_same_config(t, j):
    """The port's config holds the reference's values, field by field."""
    assert vars(t).keys() == vars(j).keys()
    for k in vars(j):
        a, b = getattr(t, k), getattr(j, k)
        assert (vars(a) == vars(b)) if hasattr(b, "__dataclass_fields__") else a == b, k


def test_registry_serves_the_ported_archs_only():
    assert set(registry.PORTED) == set(ARCHS) | {"zamba2_7b", "granite_moe_3b_a800m",
                                                  "qwen3_moe_30b_a3b", "minicpm3_4b",
                                                  "llava_next_mistral_7b", "command_r_35b",
                                                  "whisper_small"}
    assert set(registry.PORTED) == set(registry.ARCH_IDS)
    for arch in registry.PORTED:
        assert_same_config(registry.get_config(arch), jget_config(arch))
        assert_same_config(registry.get_smoke_config(arch.replace("_", "-")),
                           jget_smoke_config(arch))
    for arch in set(registry.ARCH_IDS) - set(registry.PORTED):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            registry.get_config(arch)
    with pytest.raises(ValueError):
        registry.get_config("gpt2")
    cfg = registry.get_smoke_config("starcoder2_3b")
    tdec.check_supported(cfg.replace(qk_norm=True))
    tdec.check_supported(cfg.replace(parallel_block=True))
    tdec.check_supported(registry.get_smoke_config("minicpm3_4b"))
    tdec.check_supported(registry.get_smoke_config("whisper_small"))
    tdec.check_supported(cfg.replace(encoder=EncoderConfig(num_layers=2, num_frames=8)))
    whisper = registry.get_smoke_config("whisper_small")
    with pytest.raises(NotImplementedError, match="audio frontend without an encoder"):
        tdec.check_supported(whisper.replace(encoder=None))


def test_param_tree_matches_reference_layout_and_round_trips(ref_params):
    for arch in ARCHS:
        _, tcfg = configs(arch)
        mine = tdec.init_params(tcfg, torch.Generator().manual_seed(0))
        ref = ref_params[arch]
        assert _leaf_names(mine) == _leaf_names(ref)
        assert [tuple(x.shape) for x in tree_leaves(mine)] == \
            [x.shape for x in jax.tree.leaves(ref)]
        back = to_numpy_params(from_jax_params(ref))
        assert _leaf_names(back) == _leaf_names(ref)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, b)


def test_factory_initializers():
    fac = ParamFactory(torch.Generator().manual_seed(5))
    assert torch.equal(fac.param((3, 2), (None, None), init="ones"), torch.ones(3, 2))
    assert torch.equal(fac.param((4,), (None,), init="constant", scale=-0.6),
                       torch.full((4,), -0.6))
    u = fac.param((1000,), (None,), init="uniform", scale=0.5)
    assert float(u.min()) >= -0.5 and float(u.max()) <= 0.5 and float(u.std()) > 0.25
    w = fac.param((400,), (None,), init="uniform")
    assert float(w.abs().max()) <= 400 ** -0.5
    with pytest.raises(ValueError):
        fac.param((2,), (None, None))


def test_serve_cli_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "rwkv6_3b", "--smoke", "--device",
                                     "cpu", "--batch", "2", "--prompt-len", "5", "--gen", "3"])
    tserve.main()
    out = capsys.readouterr().out
    assert "prefill 2x5" in out and "sample:" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.serve("rwkv6_3b", smoke=True, batch=1, prompt_len=2, gen=1)


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
    """The smoke-width serve on the card, through the kernels, against the
    CPU path with the same parameters: the same greedy tokens at fp32
    compute; at bf16 the card's and the CPU's bf16 products round
    differently, so the prefill logits are held at 2e-2 of their scale."""
    _, tcfg = configs(arch, compute)
    params = from_jax_params(ref_params[arch])
    kernel = ls_ops if arch == "rwkv6_3b" else fa_ops
    before = kernel.launches
    kw = dict(smoke=True, batch=2, prompt_len=40, gen=6, cfg=tcfg, verbose=False)
    stats = {}
    got = tserve.serve(arch, device=cuda, params=from_jax_params(ref_params[arch], cuda),
                       stats=stats, **kw)
    assert kernel.launches - before == tcfg.num_layers and stats["logits_finite"]
    want = tserve.serve(arch, device="cpu", params=params, **kw)
    if compute == "float32":
        np.testing.assert_array_equal(got, want)
    toks = torch.from_numpy(_tokens(5, tcfg, 2, 40)).long()
    lg, _, _ = tdec.prefill(tcfg, from_jax_params(ref_params[arch], cuda), toks.to(cuda), 46)
    lc, _, _ = tdec.prefill(tcfg, params, toks, 46)
    scaled_close(lg.cpu(), lc, TOL[compute] if compute == "bfloat16" else 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_gpu_full_width_prefill_matches_reference(cuda, arch):
    """The published configuration at fp32 compute: the port's prefill on
    the card (through the kernel) against the reference's on the CPU,
    with the reference's parameters.  The stacks are 30 and 32 layers
    deep and 2560-3072 wide, and the port's own prefill and stepwise
    decode, which differ only in the order of fp32 sums, sit 8.3e-4 of
    the logits' scale apart at this width (chip_smoke.py), so the two
    packages are held at 1e-2 of it."""
    jcfg = jget_config(arch).replace(compute_dtype="float32")
    tcfg = registry.get_config(arch).replace(compute_dtype="float32")
    params = jdec.init_params(jcfg, jax.random.key(0))
    toks = _tokens(6, jcfg, 1, 16)
    jl, _, _ = jax.jit(lambda p, t: jdec.prefill(jcfg, p, t, 16))(params, jnp.asarray(toks))
    tp = from_jax_params(jax.tree.map(np.asarray, params), cuda)
    del params
    kernel = ls_ops if arch == "rwkv6_3b" else fa_ops
    before = kernel.launches
    with torch.no_grad():
        tl, _, _ = tdec.prefill(tcfg, tp, torch.from_numpy(toks).long().to(cuda), 16)
    assert kernel.launches - before == tcfg.num_layers
    scaled_close(tl.cpu(), jl, 1e-2, f"{arch} full-width prefill logits")


@pytest.mark.gpu
def test_gpu_full_width_rwkv6_bf16_prefill_against_stepwise(cuda):
    """rwkv6_3b at its published width and bf16 compute, depth cut to 2
    layers and whole: a prefill of 16 tokens against 16 decode steps in
    each package (the reference on the CPU, the port on the card through
    the kernel), and the port's prefill against the reference's.  With
    random weights the two paths of either package drift apart with
    depth (the ln_x reading of TestRWKV6), so the gate is at depth 2: the
    port's own two paths within 2e-2 of the logits' scale, and its
    prefill within 3e-2 of the reference's, the tolerance the reference
    holds its own two bf16 paths to (tests/test_prefill.py).  At full
    depth the readings are printed beside the reference's own."""
    P = 16
    jfull = jget_config("rwkv6_3b")
    tfull = registry.get_config("rwkv6_3b")
    assert jfull.compute_dtype == tfull.compute_dtype == "bfloat16"
    params = jdec.init_params(jfull, jax.random.key(0))
    tparams = tdec.cast_params(tfull, from_jax_params(jax.tree.map(np.asarray, params), cuda))
    params = jdec._cast_params(jfull, params)            # bf16 once, as serve() does
    toks = _tokens(7, jfull, 1, P)

    def gap(a, b):
        a, b = _np(a), _np(b)
        return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-6))

    lines = []
    for depth in (2, jfull.num_layers):
        jcfg = jfull.replace(num_layers=depth, layer_pattern=("rwkv6",) * depth)
        tcfg = tfull.replace(num_layers=depth, layer_pattern=("rwkv6",) * depth)
        jp = dict(params, groups=[jax.tree.map(lambda x: x[:depth], params["groups"][0])])
        tp = dict(tparams, groups=[tree_map(lambda x: x[:depth], tparams["groups"][0])])
        jpre = jax.jit(lambda p, t: jdec.prefill(jcfg, p, t, P)[0])(jp, jnp.asarray(toks))
        jstep = jax.jit(lambda p, c, t, i: jdec.decode_step(jcfg, p, c, t, i))
        jc = jdec.init_cache(jcfg, jp, 1, P)
        for t in range(P):
            js, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        ttoks = torch.from_numpy(toks).long().to(cuda)
        before = ls_ops.launches
        with torch.no_grad():
            tpre, _, _ = tdec.prefill(tcfg, tp, ttoks, P)
            assert ls_ops.launches - before == depth
            tc = tdec.init_cache(tcfg, tp, 1, P)
            for t in range(P):
                ts, tc = tdec.decode_step(tcfg, tp, tc, ttoks[:, t:t + 1], t)
        assert all(bool(np.isfinite(_np(x)).all()) for x in (jpre, js, tpre, ts))
        own, ref_own, across = gap(tpre, ts), gap(jpre, js), gap(tpre, jpre)
        lines.append(f"depth {depth}: port prefill vs stepwise {own:.4f}, reference prefill "
                     f"vs stepwise {ref_own:.4f}, port prefill vs reference prefill {across:.4f}")
        if depth == 2:
            assert own <= 2e-2, lines[-1]
            assert across <= 3e-2, lines[-1]
    print("\nrwkv6_3b full width, bf16, last-position logits, max abs gap over scale:")
    print("\n".join(lines))
