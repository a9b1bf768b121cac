"""repro_torch against repro on the CPU: trees, the paper's Eq. 1-3 and
the masked FedAvg.  Inputs are numpy arrays from fixed seeds, handed to
both packages."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.common import pytree as jpt  # noqa: E402
from repro.core import aggregation as jagg, value as jval  # noqa: E402
from repro.data import partition as jpart, synthetic as jsyn  # noqa: E402
from repro.models.cnn import CNNConfig, cnn_init  # noqa: E402
from repro_torch.common import pytree as tpt  # noqa: E402
from repro_torch.core import aggregation as tagg, value as tval  # noqa: E402
from repro_torch.data import partition as tpart, synthetic as tsyn  # noqa: E402
from repro_torch.weights import from_jax_params, to_numpy_params  # noqa: E402


def np_tree(seed, n=None):
    """A small mixed tree (dict, list, None, 0-d leaf), optionally stacked."""
    rng = np.random.RandomState(seed)
    lead = () if n is None else (n,)
    f = lambda *s: np.asarray(rng.randn(*(lead + s)), np.float32)  # noqa: E731
    return {"z": f(3, 2), "a": [f(5), {"k": f(4, 1), "none": None}], "s": f(), "e": []}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


class TestTree:
    def test_flatten_and_map_free_the_tree_without_the_cycle_collector(self):
        """tree_flatten, tree_unflatten and tree_map keep no reference to a
        tree once their results are dropped: a full-width model's
        parameters must go when its last name does, not at the cyclic
        collector's next pass (chip_smoke.py's serve phases draw 13 GB and
        then 61 GB trees one after another)."""
        import gc
        import weakref
        tree = {"a": [torch.ones(3), {"b": torch.zeros(2), "n": None}], "c": (torch.ones(1),)}
        refs = [weakref.ref(x) for x in tpt.tree_leaves(tree)]
        enabled = gc.isenabled()
        gc.disable()
        try:
            gc.collect()
            leaves, treedef = tpt.tree_flatten(tree)
            copy = tpt.tree_unflatten(treedef, leaves)
            doubled = tpt.tree_map(lambda x: x * 2, copy)
            assert float(doubled["c"][0]) == 2.0
            del tree, leaves, copy, doubled
            assert all(r() is None for r in refs)
        finally:
            if enabled:
                gc.enable()

    def test_cnn_flatten_order_matches_jax(self):
        """Leaf i of the reference's CNN tree holds the value i: the port's
        flatten must hand the leaves back in that order."""
        shapes, jdef = jax.tree.flatten(
            jax.eval_shape(lambda k: cnn_init(CNNConfig(), k), jax.random.key(0)))
        params = jax.tree.unflatten(jdef, [np.full(s.shape, i, np.float32)
                                           for i, s in enumerate(shapes)])
        jleaves, _ = jax.tree.flatten(params)
        tleaves, treedef = tpt.tree_flatten(from_jax_params(params))
        assert len(tleaves) == len(jleaves) == 22
        for a, b in zip(jleaves, tleaves):
            np.testing.assert_array_equal(a, b.numpy())
        back = to_numpy_params(tpt.tree_unflatten(treedef, tleaves))
        assert jax.tree.structure(back) == jax.tree.structure(params)
        assert tpt.count_params(from_jax_params(params)) == jpt.count_params(params) == 42698

    def test_mixed_tree_roundtrip_and_sizes(self):
        t = np_tree(0)
        jleaves = jax.tree.leaves(t)
        tt = from_jax_params(t)
        for a, b in zip(jleaves, tpt.tree_leaves(tt)):
            np.testing.assert_array_equal(a, b.numpy())
        assert tpt.tree_bytes(tt) == jpt.tree_bytes(t)
        assert tpt.tree_map(lambda x: x, tt)["a"][1]["none"] is None

    def test_norms_match(self):
        a, b = np_tree(1), np_tree(2)
        np.testing.assert_allclose(float(tpt.tree_sq_norm(from_jax_params(a))),
                                   float(jpt.tree_sq_norm(to_jax(a))), rtol=1e-6)
        np.testing.assert_allclose(
            float(tpt.tree_sq_diff_norm(from_jax_params(a), from_jax_params(b))),
            float(jpt.tree_sq_diff_norm(to_jax(a), to_jax(b))), rtol=1e-6)

    def test_stack_scatter_index(self):
        s = np_tree(3, n=4)
        rows = np_tree(4, n=2)
        want = jpt.tree_scatter(to_jax(s), jnp.asarray([3, 1]), to_jax(rows))
        got = tpt.tree_scatter(from_jax_params(s), [3, 1], from_jax_params(rows))
        for a, b in zip(jax.tree.leaves(want), tpt.tree_leaves(got)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        row = tpt.stacked_index(tpt.tree_stack([from_jax_params(np_tree(5))] * 2), 1)
        for a, b in zip(jax.tree.leaves(np_tree(5)), tpt.tree_leaves(row)):
            np.testing.assert_array_equal(a, b.numpy())


class TestEq1:
    @pytest.mark.parametrize("acc,n", [(0.0, 7), (0.37, 7), (0.93, 1000)])
    def test_communication_value(self, acc, n):
        a, b = np_tree(6), np_tree(7)
        want = float(jval.communication_value(to_jax(a), to_jax(b), acc, n))
        got = float(tval.communication_value(from_jax_params(a), from_jax_params(b), acc, n))
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_stacked_values(self):
        gp, gc = np_tree(8, n=5), np_tree(9, n=5)
        accs = np.random.RandomState(10).rand(5).astype(np.float32)
        want = np.asarray(jval.communication_values_stacked(to_jax(gp), to_jax(gc),
                                                            jnp.asarray(accs), 5))
        got = tval.communication_values_stacked(from_jax_params(gp), from_jax_params(gc),
                                                torch.from_numpy(accs), 5).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)

    @pytest.mark.parametrize("values", [
        [1.0, 2.0, 3.0, 4.0], [5.0, 5.0, 5.0], [0.0, 0.0, 1e-30],
        # fp32 mean rounds above every element: the max-keep guard
        [16777216.0, 16777218.0, 16777218.0, 16777218.0, 16777218.0],
    ])
    def test_vafl_mask(self, values):
        v = np.asarray(values, np.float32)
        want = np.asarray(jval.vafl_mask(jnp.asarray(v)))
        got = tval.vafl_mask(torch.from_numpy(v)).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.any()

    def test_eaflm_threshold_and_mask(self):
        d0, d1 = np_tree(11), np_tree(12)
        want = float(jval.eaflm_threshold([to_jax(d0), to_jax(d1)], 0.98, 1e-2, 3))
        got = float(tval.eaflm_threshold([from_jax_params(d0), from_jax_params(d1)],
                                         0.98, 1e-2, 3))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        grads = np_tree(13, n=6)
        thr = float(np.median(np.asarray(jax.vmap(jpt.tree_sq_norm)(to_jax(grads)))))
        np.testing.assert_array_equal(
            tval.eaflm_mask_stacked(from_jax_params(grads), thr).numpy(),
            np.asarray(jval.eaflm_mask_stacked(to_jax(grads), thr)))


class TestAggregation:
    @pytest.mark.parametrize("mask,counts", [
        ([True, False, True, True], [100, 300, 50, 7]),
        ([False, False, False, False], [1, 2, 3, 4]),
        ([False, True, False, False], [10, 0, 5, 5]),   # zero total weight: keep
    ])
    def test_aggregate_or_keep(self, mask, counts):
        g, s = np_tree(14), np_tree(15, n=4)
        m = np.asarray(mask)
        c = np.asarray(counts, np.float32)
        want = jagg.aggregate_or_keep(to_jax(g), to_jax(s), jnp.asarray(m), jnp.asarray(c))
        got = tagg.aggregate_or_keep(from_jax_params(g), from_jax_params(s),
                                     torch.from_numpy(m), torch.from_numpy(c))
        for a, b in zip(jax.tree.leaves(want), tpt.tree_leaves(got)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            tagg.aggregation_weights(torch.from_numpy(m), torch.from_numpy(c)).numpy(),
            np.asarray(jagg.aggregation_weights(jnp.asarray(m), jnp.asarray(c))), rtol=1e-6)


class TestDataCopies:
    def test_synthetic_and_partitions_bit_identical(self):
        ref = jsyn.synthetic_mnist(600, 100, seed=3)
        got = tsyn.synthetic_mnist(600, 100, seed=3)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)
        xtr, ytr = ref[0], ref[1]
        for name in ("iid_partition", "paper_noniid_partition", "dirichlet_partition"):
            kw = {} if name == "dirichlet_partition" else {"samples_per_client": 80}
            a = getattr(jpart, name)(xtr, ytr, 5, seed=1, **kw)
            b = getattr(tpart, name)(xtr, ytr, 5, seed=1, **kw)
            for f in ("images", "labels", "mask", "counts"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
