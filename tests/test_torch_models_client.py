"""repro_torch's client models, local update and evaluator against
repro's on the CPU, with the reference's parameters carried across and
its batch permutations injected."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import client as jclient  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.common import fp32  # noqa: E402
from repro_torch.common.pytree import tree_leaves  # noqa: E402
from repro_torch.core import client as tclient  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.weights import from_jax_params, to_numpy_params  # noqa: E402

MODELS = {
    "mlp": (jcnn.MLPConfig(hidden=(32, 16)), tcnn.MLPConfig(hidden=(32, 16)),
            jcnn.mlp_init, jcnn.mlp_forward, tcnn.mlp_forward),
    "cnn": (jcnn.CNNConfig(channels=(4, 8), num_blocks=1),
            tcnn.CNNConfig(channels=(4, 8), num_blocks=1),
            jcnn.cnn_init, jcnn.cnn_forward, tcnn.cnn_forward),
}


def images(n, seed, size=28):
    return np.random.RandomState(seed).randn(n, size, size).astype(np.float32)


def ref_params(name, seed=0):
    """Parameters as the numpy tree both packages take (drawn with the
    port's initializer: the reference's eager init costs seconds)."""
    _, tcfg, _, _, _ = MODELS[name]
    init = tcnn.mlp_init if name == "mlp" else tcnn.cnn_init
    return to_numpy_params(init(tcfg, torch.Generator().manual_seed(seed)))


@pytest.mark.parametrize("name", ["mlp", "cnn"])
@pytest.mark.parametrize("nhwc", [False, True])
def test_forward_matches_reference(name, nhwc):
    jcfg, tcfg, _, jfwd, tfwd = MODELS[name]
    params = ref_params(name)
    x = images(6, 1)
    if nhwc:
        x = x[..., None]
    want = np.asarray(jfwd(jcfg, jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    got = tfwd(tcfg, from_jax_params(params), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_full_width_cnn_forward_matches_reference():
    """The paper's CNN at its only published width (channels (16, 32),
    2 blocks per stage), including the stride-2 stage change whose XLA
    "SAME" padding is (0, 1)."""
    jcfg, tcfg = jcnn.CNNConfig(), tcnn.CNNConfig()
    params = to_numpy_params(tcnn.cnn_init(tcfg, torch.Generator().manual_seed(3)))
    x = images(4, 2)
    want = np.asarray(jcnn.cnn_forward(jcfg, jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    got = tcnn.cnn_forward(tcfg, from_jax_params(params), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_init_layout_matches_reference():
    """Same tree, shapes and dtypes (the draws come from torch's RNG)."""
    for name in ("mlp", "cnn"):
        jcfg, tcfg, jinit, _, _ = MODELS[name]
        init = tcnn.mlp_init if name == "mlp" else tcnn.cnn_init
        mine = to_numpy_params(init(tcfg, torch.Generator().manual_seed(0)))
        ref = jax.eval_shape(lambda k: jinit(jcfg, k), jax.random.key(0))
        assert jax.tree.structure(mine) == jax.tree.structure(ref)
        assert [(x.shape, x.dtype) for x in jax.tree.leaves(mine)] == \
            [(x.shape, x.dtype) for x in jax.tree.leaves(ref)]


@pytest.mark.parametrize("name", ["mlp", "cnn"])
@pytest.mark.parametrize("prox_mu,dp_clip", [(0.0, 0.0), (0.05, 0.5)])
def test_local_update_matches_reference(name, prox_mu, dp_clip):
    """One local round of 2 clients (ragged shards, 2 epochs), the
    reference's permutations injected: params, eff_grad and loss; plain,
    and with FedProx plus the DP clip (noise 0, so neither draws)."""
    jcfg, tcfg, _, jfwd, tfwd = MODELS[name]
    n, m = 2, 40
    rng = np.random.RandomState(4)
    data = {"images": images(n * m, 5).reshape(n, m, 28, 28),
            "labels": rng.randint(0, 10, size=(n, m)).astype(np.int32),
            "mask": np.ones((n, m), np.float32)}
    data["mask"][1, 25:] = 0.0
    spec = dict(batch_size=16, local_epochs=2, local_rounds=1, lr=0.1, prox_mu=prox_mu,
                dp_clip=dp_clip)
    params = ref_params(name)
    stacked = jax.tree.map(lambda x: np.broadcast_to(x, (n,) + x.shape).copy(), params)
    key = jax.random.key(7)

    jupdate = jclient.make_local_update(jclient.make_weighted_classifier_loss(jfwd, jcfg),
                                        jclient.LocalSpec(**spec))
    jp, jg, jl = jupdate(jax.tree.map(jnp.asarray, stacked),
                         jax.tree.map(jnp.asarray, data), key)
    # the permutations the reference drew inside its vmapped update
    perms = {}
    for i, ck in enumerate(jax.random.split(key, n)):
        for e, ek in enumerate(jax.random.split(ck, 3)[:2]):
            perms[(i, e)] = np.asarray(jax.random.permutation(ek, m)).astype(np.int64)

    tupdate = tclient.make_local_update(
        tclient.make_weighted_classifier_loss(tfwd, tcfg), tclient.LocalSpec(**spec),
        perm_fn=lambda i, step, e, M: torch.from_numpy(perms[(i, e)]))
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    tdata["labels"] = tdata["labels"].long()
    tp, tg, tl = tupdate(from_jax_params(stacked), tdata, torch.Generator(), 1)
    # eff_grad = (p0 - p) / lr carries the params' error times 1/lr
    for want, got, atol in ((jp, tp, 1e-5), (jg, tg, 1e-5 / spec["lr"])):
        for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)


def test_local_update_own_rng_is_seeded():
    _, tcfg, _, _, tfwd = MODELS["mlp"]
    params = from_jax_params(jax.tree.map(lambda x: x[None], ref_params("mlp")))
    data = {"images": torch.from_numpy(images(30, 6)).reshape(1, 30, 28, 28),
            "labels": torch.arange(30).remainder(10).reshape(1, 30),
            "mask": torch.ones(1, 30)}
    upd = tclient.make_local_update(tclient.make_weighted_classifier_loss(tfwd, tcfg),
                                    tclient.LocalSpec(batch_size=8, local_rounds=2))
    a = upd(params, data, torch.Generator().manual_seed(3), 1)[0]
    b = upd(params, data, torch.Generator().manual_seed(3), 1)[0]
    c = upd(params, data, torch.Generator().manual_seed(4), 1)[0]
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert not all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(c)))


@pytest.mark.parametrize("n,batch,subsample", [(250, 100, 0), (37, 100, 0), (250, 64, 90)])
def test_evaluator_matches_reference(n, batch, subsample):
    """Padded tail, division by the true count, the same subsample."""
    jcfg, tcfg, _, jfwd, tfwd = MODELS["mlp"]
    params = ref_params("mlp", 1)
    x = images(n, 8)
    y = np.random.RandomState(9).randint(0, 10, size=n).astype(np.int32)
    want = float(jclient.make_evaluator(jfwd, jcfg, x, y, batch=batch, subsample=subsample,
                                        subsample_seed=2)(jax.tree.map(jnp.asarray, params)))
    got = float(tclient.make_evaluator(tfwd, tcfg, x, y, batch=batch, subsample=subsample,
                                       subsample_seed=2)(from_jax_params(params)))
    assert got == want


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("need_x", [False, True])
def test_fp32_conv_function_matches_conv2d(stride, need_x, monkeypatch):
    """The CNN's card-side convolution (the im2col GEMM, ``_conv_gemm``)
    computes the CPU side's padded F.conv2d and its gradients, alone and
    under ``torch.func.vmap`` over three clients' weights, as the batched
    local update runs it.  10 x 10 inputs give "SAME" padding (1, 1) at
    stride 1 and the asymmetric (0, 1) at stride 2; the 1 x 1 projection
    takes none."""
    rs = np.random.RandomState(4)
    for k in (3, 1):
        x0, w0, b0 = (torch.from_numpy(rs.randn(*s).astype(np.float32))
                      for s in ((3, 3, 4, 10, 10), (3, k, k, 4, 8), (3, 8)))
        side = 10 if stride == 1 else 5
        gy = torch.from_numpy(rs.randn(3, 3, 8, side, side).astype(np.float32))
        outs = []
        for route, batched in ((True, False), (True, True), (False, False)):
            monkeypatch.setattr(tcnn, "_gemm_route", lambda x, route=route: route)
            x = x0.clone().requires_grad_(need_x)
            w, b = w0.clone().requires_grad_(), b0.clone().requires_grad_()
            if batched:
                y = torch.func.vmap(lambda w_, b_, x_: tcnn._conv({"w": w_, "b": b_}, x_,
                                                                   stride))(w, b, x)
            else:
                y = torch.stack([tcnn._conv({"w": w[i], "b": b[i]}, x[i], stride)
                                 for i in range(3)])
            grads = torch.autograd.grad(y, [t for t in (x, w, b) if t.requires_grad], gy)
            outs.append([y.detach()] + list(grads))
        for got_a, got_b, want in zip(*outs):
            torch.testing.assert_close(got_a, want, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(got_b, want, rtol=1e-5, atol=1e-5)


def test_card_route_forward_and_update_match_reference(monkeypatch):
    """The card's whole GEMM route, taken on the CPU: the full-width
    forward against the reference (the forward test's 1e-5), and a
    batched local update of 3 clients against the CPU route's (the
    round-runtime parity test's atol 1e-4: one SGD step of the full CNN
    moves some weights by 1.4e-5 between the two summation orders)."""
    jcfg, tcfg = jcnn.CNNConfig(), tcnn.CNNConfig()
    params = to_numpy_params(tcnn.cnn_init(tcfg, torch.Generator().manual_seed(3)))
    x = images(4, 2)
    want = np.asarray(jcnn.cnn_forward(jcfg, jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    rs = np.random.RandomState(6)
    data = {"images": torch.from_numpy(images(3 * 40, 7).reshape(3, 40, 28, 28)),
            "labels": torch.from_numpy(rs.randint(0, 10, (3, 40))).long(),
            "mask": torch.ones(3, 40)}
    stacked = from_jax_params(jax.tree.map(lambda a: np.stack([a] * 3), params))
    upd = tclient.make_local_update(tclient.make_weighted_classifier_loss(tcnn.cnn_forward, tcfg),
                                    tclient.LocalSpec(16, 1, 1, 0.1))
    plain = upd(stacked, data, torch.Generator().manual_seed(1), 0)[0]
    monkeypatch.setattr(tcnn, "_gemm_route", lambda x: True)
    got = tcnn.cnn_forward(tcfg, from_jax_params(params), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    card = upd(stacked, data, torch.Generator().manual_seed(1), 0)[0]
    for a, b in zip(tree_leaves(plain), tree_leaves(card)):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


def test_ieee_scope_is_shared_across_threads():
    """Two threads whose ieee() scopes interleave (A enters, B enters, A
    leaves, B leaves), with the caller at "high": neither sees TF32
    while inside, and the caller's setting is back after both left.
    (With save-and-restore per scope, B read "high" after A left and the
    process was left at "highest".)"""
    import threading
    cudnn = torch.backends.cudnn

    def flags():
        return (torch.get_float32_matmul_precision(), cudnn.allow_tf32, cudnn.deterministic)

    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen, errors = {}, []

    def thread_a():
        try:
            with fp32.ieee():
                seen["a"] = flags()
                a_in.set()
                assert b_in.wait(10)
        except Exception as e:   # noqa: BLE001: reported below
            errors.append(e)
        finally:
            a_out.set()

    def thread_b():
        try:
            assert a_in.wait(10)
            with fp32.ieee():
                seen["b"] = flags()
                b_in.set()
                assert a_out.wait(10)
                seen["b after a left"] = flags()
        except Exception as e:   # noqa: BLE001: reported below
            errors.append(e)

    prev = torch.get_float32_matmul_precision()
    prev_tf32 = cudnn.allow_tf32
    try:
        torch.set_float32_matmul_precision("high")
        cudnn.allow_tf32 = True
        threads = [threading.Thread(target=f) for f in (thread_a, thread_b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors, errors
        assert seen == {k: ("highest", False, True) for k in ("a", "b", "b after a left")}
        assert flags()[:2] == ("high", True)
    finally:
        torch.set_float32_matmul_precision(prev)
        cudnn.allow_tf32 = prev_tf32


def test_model_runs_in_ieee_fp32_whatever_the_flags(monkeypatch):
    """Under process-wide TF32 flags (``set_float32_matmul_precision
    ("high")``, cuDNN's ``allow_tf32``), the card's GEMM route (taken on
    the CPU here) runs its forward, the local update its backward and the
    evaluator its forward in IEEE fp32 with deterministic cuDNN, and the
    caller's flags come back afterwards; the update's values do not move."""
    _, tcfg, _, _, tfwd = MODELS["cnn"]
    cudnn = torch.backends.cudnn
    stacked = from_jax_params(jax.tree.map(lambda a: np.stack([a] * 2), ref_params("cnn")))
    data = {"images": torch.from_numpy(images(2 * 16, 8).reshape(2, 16, 28, 28)),
            "labels": torch.arange(32).remainder(10).reshape(2, 16),
            "mask": torch.ones(2, 16)}
    upd = tclient.make_local_update(tclient.make_weighted_classifier_loss(tfwd, tcfg),
                                    tclient.LocalSpec(8, 1, 1, 0.1))
    evaluate = tclient.make_evaluator(tfwd, tcfg, images(20, 9), np.arange(20) % 10, batch=10)
    monkeypatch.setattr(tcnn, "_gemm_route", lambda x: True)
    want = upd(stacked, data, torch.Generator().manual_seed(1), 0)[0]
    seen = []

    def flags():
        return (torch.get_float32_matmul_precision(), cudnn.allow_tf32, cudnn.deterministic)

    def spy(orig, where):
        def call(*args, **kwargs):
            seen.append((where, flags()))
            return orig(*args, **kwargs)
        return call
    monkeypatch.setattr(torch, "bmm", spy(torch.bmm, "forward"))
    monkeypatch.setattr(torch.autograd, "grad", spy(torch.autograd.grad, "backward"))
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        cudnn.allow_tf32 = True
        got = upd(stacked, data, torch.Generator().manual_seed(1), 0)[0]
        evaluate(from_jax_params(ref_params("cnn")))
        assert flags() == ("high", True, False)
    finally:
        torch.set_float32_matmul_precision(prev)
    assert {w for w, _ in seen} == {"forward", "backward"}
    assert all(f == ("highest", False, True) for _, f in seen), set(seen)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(want), tree_leaves(got)))
