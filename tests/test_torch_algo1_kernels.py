"""The Algorithm 1 kernels' device-side designs: the topk_int8 encode
(radix select, quantization and compaction on the device) and the
one-launch grad_diff_norm over stacked leaves.

On the CPU: the wrappers' leaf tables against ``flatten_tree`` and
``flatten_stacked``, the plain model of the encode's radix select
(``ref.radix_threshold_scale``) bit-equal to the reference's
``topk_threshold_scale``, and the codec's CPU planes against the
reference's codec (Pallas in interpret mode) on tie-heavy and zero
inputs.  The tests marked ``gpu`` hold the CUDA routes to the plain
ones on an H100, and two card runs of Algorithm 1 from one seed to each
other; they skip themselves (inside the ``cuda`` fixture) elsewhere:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_algo1_kernels.py
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.compress.composed import TopKQuantCodec as JTopKQuantCodec  # noqa: E402
from repro.kernels.topk_quant import ops as jtq_ops  # noqa: E402
from repro_torch.common.pytree import tree_leaves, tree_map  # noqa: E402
from repro_torch.compress.composed import TopKQuantCodec  # noqa: E402
from repro_torch.compress.sparsify import flatten_tree  # noqa: E402
from repro_torch.core.client import LocalSpec  # noqa: E402
from repro_torch.core.federation import Federation  # noqa: E402
from repro_torch.data.partition import paper_noniid_partition  # noqa: E402
from repro_torch.data.synthetic import synthetic_mnist  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.grad_diff_norm import ops as gd_ops, ref as gd_ref  # noqa: E402
from repro_torch.kernels.topk_quant import ops as tq_ops, ref as tq_ref  # noqa: E402
from repro_torch.models.cnn import CNNConfig, MLPConfig, cnn_init, mlp_init  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

# the CNN's and the MLP's leaves in tree-flatten order (CNNConfig(), MLPConfig())
CNN_SHAPES = [tuple(x.shape) for x in tree_leaves(cnn_init(CNNConfig(), torch.Generator()))]
MLP_SHAPES = [tuple(x.shape) for x in tree_leaves(mlp_init(MLPConfig(), torch.Generator()))]
RESIDENT_LIMIT = tq_ops.MAX_CLUSTER * tq_ops.RESIDENT_GROUPS * 4   # elements, one leaf


def inputs(kind: str, n: int, seed: int = 0) -> np.ndarray:
    """Flat fp32 test updates: randn, tie-heavy (7 magnitudes), mostly
    zero (the k-th magnitude at frac 0.1 is 0), mostly below the 1e-12
    clamp (the k-th magnitude is, and the clamp decides), all zero, and
    randn with -0.0 in most places."""
    rng = np.random.RandomState(seed)
    if kind == "randn":
        x = rng.randn(n)
    elif kind == "ties":
        x = rng.randint(-3, 4, size=n) / 4
    elif kind == "sparse":
        x = np.where(rng.rand(n) < 0.03, rng.randn(n), 0.0)
    elif kind == "tiny":
        x = np.where(rng.rand(n) < 0.05, rng.randn(n), 1e-20 * rng.randn(n))
    elif kind == "zeros":
        x = np.zeros(n)
    elif kind == "negzero":
        x = np.where(rng.rand(n) < 0.95, -0.0, rng.randn(n))
    else:
        raise ValueError(kind)
    return x.astype(np.float32)


def split(flat: np.ndarray, shapes):
    """A flat vector as a tree of leaves of ``shapes`` (dict keys p00,
    p01, ... keep tree-flatten order)."""
    out, off = {}, 0
    for i, s in enumerate(shapes):
        m = int(np.prod(s))
        out[f"p{i:02d}"] = flat[off:off + m].reshape(s)
        off += m
    assert off == flat.size
    return out


# ---------------------------------------------------------- leaf tables ---

class TestLeafTables:
    def test_encode_table_matches_flatten_tree(self):
        tree = from_jax_params(split(inputs("randn", 42698), CNN_SHAPES))
        tree["p03"] = tree["p03"].to(torch.bfloat16)     # widened to fp32
        tree["empty"] = torch.zeros(0)                      # dropped
        flat, offsets = tq_ops.leaf_table(tree_leaves(tree))
        want = flatten_tree(tree)[0]
        assert all(x.dtype == torch.float32 and x.is_contiguous() for x in flat)
        assert flat[4] is tree["p04"]                       # read in place, no copy
        assert len(flat) == 22 and offsets[0] == 0 and offsets[-1] == want.numel()
        assert offsets[1:] == list(np.cumsum([x.numel() for x in flat]))
        assert torch.equal(torch.cat([x.reshape(-1) for x in flat]), want)

    @pytest.mark.parametrize("leaves", [64, 65])
    def test_encode_table_concatenates_above_the_limit(self, leaves):
        tree = {f"p{i:03d}": torch.full((i % 5 + 1,), float(i)) for i in range(leaves)}
        flat, offsets = tq_ops.leaf_table(tree_leaves(tree))
        assert len(flat) == (leaves if leaves <= tq_ops.MAX_LEAVES else 1)
        assert torch.equal(torch.cat([x.reshape(-1) for x in flat]), flatten_tree(tree)[0])
        assert offsets[-1] == sum(i % 5 + 1 for i in range(leaves))

    def test_encode_routes(self):
        cnn = [int(np.prod(s)) for s in CNN_SHAPES]
        mlp = [int(np.prod(s)) for s in MLP_SHAPES]
        # ragged leaves: the (10,) leaf and the (32, 10) leaf end in short groups
        assert tq_ops.groups(cnn) == sum(-(-n // 4) for n in cnn) > 42698 // 4
        assert tq_ops.encode_route(cnn) == ("resident", 4)
        assert tq_ops.encode_route(mlp) == ("resident", 4)
        assert tq_ops.encode_route([8192]) == ("resident", 1)
        assert tq_ops.encode_route([8193]) == ("resident", 2)
        assert tq_ops.encode_route([4 * tq_ops.RESIDENT_GROUPS * 4 + 1]) == ("resident", 8)
        assert tq_ops.encode_route([RESIDENT_LIMIT]) == ("resident", 8)
        assert tq_ops.encode_route([RESIDENT_LIMIT + 1])[0] == "streaming"
        assert tq_ops.encode_route([2 ** 24 + 123]) == ("streaming", 1025)
        assert tq_ops.cuda_launches_per_encode(cnn) == 1
        assert tq_ops.cuda_launches_per_encode([2 ** 24 + 123]) == 5

    def test_grad_table_matches_flatten_stacked(self):
        rng = np.random.RandomState(3)
        shapes = CNN_SHAPES + [(0,)]
        sa = {f"p{i:02d}": torch.from_numpy(rng.randn(7, *s).astype(np.float32))
              for i, s in enumerate(shapes)}
        sb = tree_map(lambda x: x + 1, sa)
        sa["p05"] = sa["p05"].transpose(1, 2)                 # a strided view: copied
        sb["p05"] = sb["p05"].transpose(1, 2)
        la, lb, numel = gd_ops.leaf_table(gd_ops.stacked_leaves(sa), gd_ops.stacked_leaves(sb))
        assert len(la) == 22 and sum(numel) == 42698
        assert numel == [int(np.prod(x.shape[1:])) for x in la]
        assert all(x.shape[0] == 7 and x.is_contiguous() for x in la + lb)
        assert la[0] is sa["p00"]                            # read in place, no copy
        assert torch.equal(torch.cat([x.reshape(7, -1) for x in la], 1),
                           gd_ops.flatten_stacked(sa))
        assert torch.equal(torch.cat([x.reshape(7, -1) for x in lb], 1),
                           gd_ops.flatten_stacked(sb))

    def test_grad_table_widens_mixed_dtypes_and_concatenates(self):
        mixed = {"a": torch.ones(2, 3, dtype=torch.bfloat16), "b": torch.arange(4.0).reshape(2, 2)}
        leaves = gd_ops.stacked_leaves(mixed)
        assert [x.dtype for x in leaves] == [torch.float32, torch.float32]
        bf = {"a": torch.ones(2, 3, dtype=torch.bfloat16), "b": torch.ones(2, 1, dtype=torch.bfloat16)}
        assert {x.dtype for x in gd_ops.stacked_leaves(bf)} == {torch.bfloat16}
        many = {f"p{i:03d}": torch.full((2, 3), float(i)) for i in range(65)}
        la, lb, numel = gd_ops.leaf_table(gd_ops.stacked_leaves(many),
                                          gd_ops.stacked_leaves(many))
        assert len(la) == len(lb) == 1 and numel == [195]
        assert torch.equal(la[0], gd_ops.flatten_stacked(many))

    def test_tree_norm_rejects_mismatched_trees(self):
        with pytest.raises(ValueError):
            gd_ops.tree_grad_diff_sq_norm({"a": torch.zeros(2, 3)}, {"a": torch.zeros(2, 4)})
        with pytest.raises(ValueError):
            gd_ops.tree_grad_diff_sq_norm({"a": torch.zeros(2, 3)},
                                          {"a": torch.zeros(2, 3, dtype=torch.bfloat16)})


# ----------------------------------------------------- radix select model ---

@pytest.mark.parametrize("kind", ["randn", "ties", "sparse", "tiny", "zeros", "negzero"])
@pytest.mark.parametrize("n,frac", [(42698, 0.1), (5003, 0.01), (1000, 1.0), (7, 0.1)])
def test_radix_model_bitexact_vs_reference(kind, n, frac):
    """The kernel's select, modelled on the CPU, against lax.top_k's
    threshold and scale on the reference's padded layout."""
    x = inputs(kind, n, seed=n)
    k = tq_ops.encode_k(frac, n)
    jthr, jscale = jtq_ops.topk_threshold_scale(jtq_ops.pad_2d(jnp.asarray(x)), n, k)
    thr, scale = tq_ref.radix_threshold_scale(torch.from_numpy(x), k, tq_ops._INV_QMAX)
    assert thr.dtype == scale.dtype == torch.float32
    assert np.float32(thr).tobytes() == np.asarray(jthr).tobytes()
    assert np.float32(scale).tobytes() == np.asarray(jscale).tobytes()


@pytest.mark.parametrize("kind", ["ties", "sparse", "tiny", "zeros", "negzero"])
def test_codec_cpu_planes_vs_reference(kind):
    """The codec's CPU route against the reference's codec (Pallas in
    interpret mode): identical planes, scale and nbytes, with ties at the
    threshold (more than k kept) and a k-th magnitude of 0 (fewer)."""
    tree = split(inputs(kind, 4417, seed=7), [(3, 3, 1, 16), (10,), (4263,)])
    want = JTopKQuantCodec(0.1).encode(jax.tree.map(jnp.asarray, tree), seed=77)
    got = TopKQuantCodec(0.1).encode(from_jax_params(tree), seed=77)
    for plane in ("idx", "val"):
        assert got.planes[plane].dtype == want.planes[plane].dtype
        np.testing.assert_array_equal(got.planes[plane], want.planes[plane])
    assert got.meta["scale"] == want.meta["scale"] and got.nbytes == want.nbytes
    k = tq_ops.encode_k(0.1, 4417)
    kept = len(want.planes["idx"])
    assert {"ties": kept > k, "sparse": kept < k, "tiny": kept < k, "zeros": kept == 0,
            "negzero": kept < k}[kind]


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


# (layout, input): the CNN's and MLP's trees; one leaf of n randn values
# around the route limits; a streaming-size leaf of each kind of input
# (ties overflow the candidates, sparse and tiny updates are clamped)
ENCODE_CASES = [("cnn", "randn"), ("mlp", "randn"), ("one", RESIDENT_LIMIT),
                ("one", RESIDENT_LIMIT + 1), ("one", 2 ** 24 + 123), ("cnn", "ties"),
                ("cnn", "sparse"), ("cnn", "zeros"), ("one", 8192), ("one", 8193),
                ("misaligned", "randn"), ("big", "ties"), ("big", "sparse"), ("big", "tiny"),
                ("big", "negzero")]


def encode_tree(case, cuda):
    layout, what = case
    if layout == "one":
        g = torch.Generator(device=cuda).manual_seed(what)
        return {"x": torch.randn(what, generator=g, device=cuda)}
    if layout == "big":
        return {"x": torch.from_numpy(inputs(what, 2 ** 20 + 3, seed=3)).to(cuda)}
    if layout == "misaligned":   # leaves that are views 4 bytes past a 16-byte boundary
        base = torch.from_numpy(inputs("randn", 42698 + 1, seed=5)).to(cuda)
        return {"a": base[1:20001], "b": base[20001:].reshape(-1, 2)}
    shapes = CNN_SHAPES if layout == "cnn" else MLP_SHAPES
    n = sum(int(np.prod(s)) for s in shapes)
    return tree_map(lambda x: x.to(cuda), from_jax_params(split(inputs(what, n, seed=n), shapes)))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ENCODE_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_gpu_encode_bitexact_vs_plain(cuda, case):
    tree = encode_tree(case, cuda)
    before = tq_ops.launches
    got = TopKQuantCodec(0.1).encode(tree, seed=2 ** 32 + 99)
    assert tq_ops.launches == before + 1
    want = TopKQuantCodec(0.1, use_kernel=False).encode(tree, seed=2 ** 32 + 99)
    for plane in ("idx", "val"):
        assert got.planes[plane].dtype == want.planes[plane].dtype
        np.testing.assert_array_equal(got.planes[plane], want.planes[plane])
    assert got.meta["scale"] == want.meta["scale"] and got.nbytes == want.nbytes
    again = TopKQuantCodec(0.1).encode(tree, seed=2 ** 32 + 99)
    np.testing.assert_array_equal(again.planes["val"], got.planes["val"])


@pytest.mark.gpu
def test_gpu_encode_reaches_no_topk_nonzero_or_cat(cuda, monkeypatch):
    """The main path's encode on the card: no torch.topk, torch.nonzero
    or torch.cat (flatten_tree's) anywhere on it."""
    trees = [encode_tree(("cnn", "randn"), cuda), encode_tree(("one", 2 ** 20 + 3), cuda)]
    want = [TopKQuantCodec(0.1, use_kernel=False).encode(t, seed=5) for t in trees]

    def refuse(*args, **kwargs):
        raise AssertionError("the device encode reached a refused torch function")
    for name in ("topk", "nonzero", "cat"):
        monkeypatch.setattr(torch, name, refuse)
    got = [TopKQuantCodec(0.1).encode(t, seed=5) for t in trees]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.planes["idx"], w.planes["idx"])
        np.testing.assert_array_equal(g.planes["val"], w.planes["val"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-3)])
@pytest.mark.parametrize("layout", ["cnn", "big"])
def test_gpu_tree_grad_diff_norm_matches_plain(cuda, monkeypatch, layout, dtype, rtol):
    g = torch.Generator(device=cuda).manual_seed(4)
    if layout == "cnn":
        shapes, w = CNN_SHAPES, 7
    else:
        shapes, w = [(2 ** 24 + 123,)], 1
    sa = {f"p{i:02d}": torch.randn((w,) + s, generator=g, device=cuda).to(dtype)
          for i, s in enumerate(shapes)}
    sb = {f"p{i:02d}": torch.randn((w,) + s, generator=g, device=cuda).to(dtype)
          for i, s in enumerate(shapes)}
    want = gd_ref.grad_diff_sq_norm_2d(gd_ops.flatten_stacked(sa), gd_ops.flatten_stacked(sb))
    before = gd_ops.launches

    def refuse(*args, **kwargs):
        raise AssertionError("tree_grad_diff_sq_norm concatenated on the card")
    monkeypatch.setattr(torch, "cat", refuse)
    got = gd_ops.tree_grad_diff_sq_norm(sa, sb)
    again = gd_ops.tree_grad_diff_sq_norm(sa, sb)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert gd_ops.launches == before + 2
    torch.testing.assert_close(got, want, rtol=rtol, atol=0)
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_gpu_algorithm1_reproducible_from_a_seed(cuda):
    """Algorithm 1 on the card, twice from one seed in one process: the
    same selections, byte ledgers and final parameters, bit for bit
    (chip_smoke.py's configuration; before the CNN's cuDNN scope was made
    deterministic, afl's upload bytes came out 448,434 and 448,439)."""
    xtr, ytr, xte, yte = synthetic_mnist(7000, 2000, seed=0)
    data = paper_noniid_partition(xtr, ytr, 7, samples_per_client=1000, seed=0)
    fed = Federation(model="cnn", data=data, test_data=(xte, yte), algorithm="vafl",
                     compressor="topk0.1_int8", local=LocalSpec(32, 1, 1, 0.1), device="cuda")
    seen = {}
    evaluate = fed.evaluate_fn

    def capture(p):
        seen["params"] = p
        return evaluate(p)
    fed.evaluate_fn = capture
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    for alg in ("vafl", "afl"):
        runs = []
        for _ in range(2):
            res = fed.run(rounds=3, algorithm=alg)
            runs.append(([r.selected for r in res.records], vars(res.comm),
                         [x.detach().cpu() for x in tree_leaves(seen["params"])]))
        (sel0, comm0, p0), (sel1, comm1, p1) = runs
        assert sel0 == sel1 and comm0 == comm1, alg
        assert all(torch.equal(a, b) for a, b in zip(p0, p1)), alg
    assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) == flags
