"""repro_torch's two kernels against repro's, and against their plain
versions on the card.

On the CPU the port's wrappers take the plain PyTorch versions; those
are held to the reference's Pallas kernels (interpret mode) and oracles
on the same numpy inputs: grad_diff_norm at the reference's rtol,
topk_quant and the topk_int8 payload bit for bit.  The tests marked
``gpu`` hold the CUDA kernels to the plain versions on an H100, and the
card's run of a small federation to the CPU path; they skip themselves
(inside the ``cuda`` fixture) on a host without a Hopper card and nvcc:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_*.py
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.compress.composed import TopKQuantCodec as JTopKQuantCodec  # noqa: E402
from repro.kernels.grad_diff_norm import ops as jgd_ops  # noqa: E402
from repro.kernels.topk_quant import ops as jtq_ops, ref as jtq_ref  # noqa: E402
from repro_torch.common.pytree import tree_leaves  # noqa: E402
from repro_torch.compress import get_codec  # noqa: E402
from repro_torch.compress.composed import TopKQuantCodec  # noqa: E402
from repro_torch.compress.sparsify import flatten_tree  # noqa: E402
from repro_torch.core.client import LocalSpec  # noqa: E402
from repro_torch.core.federation import Federation  # noqa: E402
from repro_torch.data.partition import iid_partition  # noqa: E402
from repro_torch.data.synthetic import synthetic_mnist  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.grad_diff_norm import ops as gd_ops, ref as gd_ref  # noqa: E402
from repro_torch.kernels.topk_quant import ops as tq_ops, ref as tq_ref  # noqa: E402
from repro_torch.models.cnn import (  # noqa: E402
    CNNConfig, MLPConfig, cnn_forward, cnn_init, mlp_forward, mlp_init)
from repro_torch.weights import from_jax_params  # noqa: E402


def np_tree(shapes, seed):
    rng = np.random.RandomState(seed)
    return {f"p{i}": rng.randn(*s).astype(np.float32) for i, s in enumerate(shapes)}


def pad_2d(flat):
    """The reference's padded (M, 128) layout of a flat numpy vector."""
    return np.asarray(jtq_ops.pad_2d(jnp.asarray(flat)))


# ------------------------------------------------------- grad_diff_norm ---

class TestGradDiffNorm:
    @pytest.mark.parametrize("shapes", [
        [(17,), (33, 5)], [(1000, 37)], [(4,), (4,), (4,)], [(100_001,)],
    ])
    def test_tree_matches_reference_kernel(self, shapes):
        ta, tb = np_tree(shapes, 0), np_tree(shapes, 100)
        want = float(jgd_ops.tree_grad_diff_sq_norm(ta, tb))   # Pallas, interpret mode
        stack = lambda t: from_jax_params({k: v[None] for k, v in t.items()})  # noqa: E731
        got = gd_ops.tree_grad_diff_sq_norm(stack(ta), stack(tb))
        assert got.shape == (1,) and got.dtype == torch.float32
        np.testing.assert_allclose(float(got[0]), want, rtol=1e-5)

    @pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-3)])
    def test_rows_match_reference(self, dtype, rtol):
        rng = np.random.RandomState(1)
        a, b = rng.randn(3, 256 * 128).astype(np.float32), rng.randn(3, 256 * 128).astype(np.float32)
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        want = [float(jgd_ops.grad_diff_sq_norm_2d(jnp.asarray(a[w].reshape(-1, 128), jdt),
                                                   jnp.asarray(b[w].reshape(-1, 128), jdt)))
                for w in range(3)]
        ta, tb = torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype)
        np.testing.assert_allclose(gd_ops.grad_diff_sq_norm_2d(ta, tb).numpy(), want, rtol=rtol)
        np.testing.assert_allclose(gd_ref.grad_diff_sq_norm_2d(ta, tb).numpy(), want, rtol=rtol)

    def test_flatten_stacked_order_and_mixed_dtypes(self):
        s = {"b": torch.ones(2, 3, dtype=torch.bfloat16), "a": torch.arange(4.0).reshape(2, 2)}
        flat = gd_ops.flatten_stacked(s)
        assert flat.dtype == torch.float32 and flat.shape == (2, 5)
        np.testing.assert_array_equal(flat[1].numpy(), [2, 3, 1, 1, 1])

    def test_rejects_mismatched_operands(self):
        with pytest.raises(ValueError):
            gd_ops.grad_diff_sq_norm_2d(torch.zeros(2, 3), torch.zeros(3, 2))
        with pytest.raises(ValueError):
            gd_ops.grad_diff_sq_norm_2d(torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.float64))

    def test_blocks_per_row_depends_on_p_alone(self):
        assert gd_ops.blocks_per_row(1) == 1
        assert gd_ops.blocks_per_row(42698) == 21
        assert gd_ops.blocks_per_row(2 ** 24 + 123) == 1024


# ----------------------------------------------------------- topk_quant ---

class TestTopkQuant:
    @pytest.mark.parametrize("seed", [0, 123456789, 0xFFFFFFFF])
    def test_hash_bitexact(self, seed):
        idx = np.arange(0, 1 << 22, 7, dtype=np.uint32)
        want = np.asarray(jtq_ref.hash_uniform(jnp.asarray(idx), jnp.uint32(seed)))
        got = tq_ref.hash_uniform(torch.from_numpy(idx.astype(np.int64)), seed).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("n,k,seed", [(42698, 4270, 11), (256 * 128, 256 * 13, 0),
                                          (1000, 1, 0xDEADBEEF)])
    def test_quant_bitexact_vs_reference(self, n, k, seed):
        flat = np.random.RandomState(n).randn(n).astype(np.float32)
        x2d = pad_2d(flat)
        jthr, jscale = jtq_ops.topk_threshold_scale(jnp.asarray(x2d), n, k)
        jq, jm = jtq_ops.topk_quant(jnp.asarray(x2d), jthr, jscale, seed)  # Pallas, interpret
        oq, om = jtq_ref.topk_quant_2d(jnp.asarray(x2d), jthr, jscale, jnp.uint32(seed))
        thr, scale = tq_ops.topk_threshold_scale(torch.from_numpy(flat), k)
        assert float(thr) == float(jthr) and float(scale) == float(jscale)
        q, m = tq_ops.topk_quant(torch.from_numpy(flat), thr, scale, seed)
        for ref_q, ref_m in ((jq, jm), (oq, om)):
            np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q).ravel()[:n])
            np.testing.assert_array_equal(m.numpy(), np.asarray(ref_m).ravel()[:n])

    @pytest.mark.parametrize("frac", [0.1, 0.01])
    def test_codec_payload_bitexact_vs_reference(self, frac):
        """Same tree and seed: identical idx/val planes, scale and nbytes."""
        tree = np_tree([(130, 37), (51,), (3, 3, 1, 16)], 5)
        want = JTopKQuantCodec(frac).encode(jax.tree.map(jnp.asarray, tree), seed=2 ** 33 + 5)
        got = TopKQuantCodec(frac).encode(from_jax_params(tree), seed=2 ** 33 + 5)
        for plane in ("idx", "val"):
            assert got.planes[plane].dtype == want.planes[plane].dtype
            np.testing.assert_array_equal(got.planes[plane], want.planes[plane])
        assert got.meta["scale"] == want.meta["scale"]
        assert got.nbytes == want.nbytes == 5 * len(want.planes["idx"]) + 4
        dec_ref = jax.tree.map(np.asarray, JTopKQuantCodec(frac).decode(want))
        dec = TopKQuantCodec(frac).decode(got)
        for key in tree:
            np.testing.assert_array_equal(dec[key].numpy(), dec_ref[key])

    def test_codec_spec_grammar(self):
        assert get_codec("topk0.05_int8").name == "topk0.05_int8"
        assert get_codec("topk").name == "topk0.1" and get_codec(None).is_identity
        for spec in ("int8", "int4"):   # the dense codecs (compress/quantize.py)
            assert get_codec(spec).name == spec
        with pytest.raises(ValueError):
            get_codec("topk1.5")

    def test_flatten_tree_order(self):
        tree = {"b": torch.ones(2), "a": [torch.zeros(3), None]}
        flat, _, shapes, _ = flatten_tree(tree)
        np.testing.assert_array_equal(flat.numpy(), [0, 0, 0, 1, 1])
        assert shapes == [(3,), (2,)]


# ----------------------------------------------------------- the loader ---

def test_loader_raises_without_card_or_nvcc():
    """The loader never hands back None for a caller to fall back on."""
    try:
        build.nvcc_path()
        build.require_hopper()
    except RuntimeError:
        with pytest.raises(RuntimeError):
            build.library("grad_diff_norm")
        with pytest.raises(RuntimeError):
            build.build()
    else:
        assert build.library("grad_diff_norm") is not None


# ------------------------------------------------------------ on the card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on an H100 host)")
    try:
        build.nvcc_path()
        build.require_hopper()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("w,p", [(7, 42698), (1, 2 ** 20 + 123), (3, 5)])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-3)])
def test_gpu_grad_diff_norm_matches_plain(cuda, w, p, dtype, rtol):
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(w, p, generator=g, device=cuda).to(dtype)
    b = torch.randn(w, p, generator=g, device=cuda).to(dtype)
    before = gd_ops.launches
    got = gd_ops.grad_diff_sq_norm_2d(a, b)
    again = gd_ops.grad_diff_sq_norm_2d(a, b)
    torch.cuda.synchronize()
    assert gd_ops.launches == before + 2
    torch.testing.assert_close(got, gd_ref.grad_diff_sq_norm_2d(a, b), rtol=rtol, atol=0)
    assert torch.equal(got, again)   # two-stage reduction: reruns are bit-identical


@pytest.mark.gpu
@pytest.mark.parametrize("n", [42698, 2 ** 20 + 123, 3])
def test_gpu_topk_quant_bitexact_vs_plain(cuda, n):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(n, generator=g, device=cuda)
    thr, scale = tq_ops.topk_threshold_scale(x, max(1, n // 10))
    before = tq_ops.launches
    q, m = tq_ops.topk_quant(x, thr, scale, 0xC0FFEE)
    torch.cuda.synchronize()
    assert tq_ops.launches == before + 1
    rq, rm = tq_ref.topk_quant(x, thr, scale, 0xC0FFEE)
    assert torch.equal(q, rq) and torch.equal(m, rm)


@pytest.mark.gpu
def test_gpu_codec_planes_match_cpu(cuda):
    tree = from_jax_params(np_tree([(130, 37), (51,), (3, 3, 1, 16)], 5))
    cpu = TopKQuantCodec(0.1).encode(tree, seed=9)
    gpu = TopKQuantCodec(0.1).encode({k: v.to(cuda) for k, v in tree.items()}, seed=9)
    for plane in ("idx", "val"):
        np.testing.assert_array_equal(gpu.planes[plane], cpu.planes[plane])
    assert gpu.nbytes == cpu.nbytes and gpu.meta["scale"] == cpu.meta["scale"]


@pytest.mark.gpu
@pytest.mark.parametrize("codec", ["identity", "topk0.1_int8"])
@pytest.mark.parametrize("model", ["mlp", "cnn"])
def test_gpu_federation_matches_cpu_path(cuda, model, codec):
    """A small vafl federation on the card and on the CPU, with the same
    initial model and permutations: the same selections and CommStats,
    and close final models.  torch's process-wide flags stay at their
    defaults (cuDNN TF32 on), as a user's would: the port's CNN runs its
    own convolutions in full fp32 and leaves the flags as it found them.
    A last-bit difference (cuDNN against the CPU convolution) can tip one
    entry's stochastic rounding across an integer, which moves it by one
    int8 step (~1e-4 here), so under topk0.1_int8 all but 0.1 % of the
    entries agree to 1e-4, as in tests/test_torch_system.py."""
    xtr, ytr, xte, yte = synthetic_mnist(600, 200, seed=1)
    data = iid_partition(xtr, ytr, 3, samples_per_client=160, seed=1)
    gen = np.random.RandomState(2)
    perms = {(i, t, 0): torch.from_numpy(gen.permutation(160)) for t in (1, 2) for i in range(3)}
    if model == "mlp":
        cfg, fwd = MLPConfig(hidden=(64,)), mlp_forward
        init = mlp_init(cfg, torch.Generator().manual_seed(3))
    else:
        cfg, fwd = CNNConfig(channels=(8, 16), num_blocks=1), cnn_forward
        init = cnn_init(cfg, torch.Generator().manual_seed(3))
    assert torch.backends.cudnn.allow_tf32      # torch's default, untouched
    out = {}
    for device in ("cuda", "cpu"):
        seen = {}
        fed = Federation(model=(fwd, lambda c, g: init, cfg), data=data,
                         test_data=(xte, yte), algorithm="vafl", compressor=codec,
                         local=LocalSpec(32, 1, 1, 0.1), device=device)
        evaluate = fed.evaluate_fn

        def capture(p, evaluate=evaluate, seen=seen):
            seen["params"] = p
            return evaluate(p)
        fed.evaluate_fn = capture
        g0, t0 = gd_ops.launches, tq_ops.launches
        res = fed.run(rounds=2, perm_fn=lambda i, t, e, m: perms[(i, t, e)])
        out[device] = (res, gd_ops.launches - g0, tq_ops.launches - t0,
                       torch.cat([x.detach().cpu().ravel() for x in tree_leaves(seen["params"])]))
    assert torch.backends.cudnn.allow_tf32
    (rg, gg, tg, pg), (rc, gc, tc, pc) = out["cuda"], out["cpu"]
    assert (gg, gc) == (2, 0) and tc == 0
    assert tg == (rg.comm.model_uploads if codec == "topk0.1_int8" else 0)
    assert [r.selected for r in rg.records] == [r.selected for r in rc.records]
    assert vars(rg.comm) == vars(rc.comm)
    diff = (pg - pc).abs()
    if codec == "identity":
        assert float(diff.max()) <= 1e-4, float(diff.max())
    else:
        assert float((diff > 1e-4).float().mean()) <= 1e-3 and float(diff.max()) <= 1e-3, \
            float(diff.max())
