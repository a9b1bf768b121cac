"""repro_torch's Algorithm 1 as a whole, against repro on the CPU.

With the reference's initial parameters carried across
(``from_jax_params``) and its batch permutations injected, the port must
select the same clients every round, keep the same CommStats field for
field, and end at the same global model (atol 1e-4; under topk0.1_int8
up to 0.1 % of the entries may sit one int8 step away), for vafl, afl and
eaflm, on the MLP and a narrow CNN, with the identity codec and with
topk0.1_int8.  On torch's own RNG it is held to the statistical bars of
tests/test_system.py.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import FLRunConfig as JConfig, run_round_based as j_run  # noqa: E402
from repro.core import client as jclient  # noqa: E402
from repro.data.partition import iid_partition, paper_noniid_partition  # noqa: E402
from repro.data.synthetic import synthetic_mnist  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.common.pytree import tree_leaves  # noqa: E402
from repro_torch.core import client as tclient  # noqa: E402
from repro_torch.core.config import FLRunConfig as TConfig  # noqa: E402
from repro_torch.core.federation import Federation  # noqa: E402
from repro_torch.core.metrics import ccr  # noqa: E402
from repro_torch.core.runtimes import run_round_based as t_run  # noqa: E402
from repro_torch.kernels.grad_diff_norm import ref as gd_ref  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

N, ROUNDS, SEED = 3, 3, 0
SPEC = dict(batch_size=32, local_epochs=1, local_rounds=1, lr=0.1)

MODELS = {   # name -> (ref cfg, port cfg, ref init, ref fwd, port fwd, samples per client)
    "mlp": (jcnn.MLPConfig(hidden=(64,)), tcnn.MLPConfig(hidden=(64,)),
            jcnn.mlp_init, jcnn.mlp_forward, tcnn.mlp_forward, 300),
    "cnn": (jcnn.CNNConfig(channels=(4, 8), num_blocks=1),
            tcnn.CNNConfig(channels=(4, 8), num_blocks=1),
            jcnn.cnn_init, jcnn.cnn_forward, tcnn.cnn_forward, 160),
}


@pytest.fixture(scope="module")
def data():
    """tests/test_system.py's fixture data."""
    return synthetic_mnist(4000, 1000, seed=0)


@pytest.fixture(scope="module")
def ref_fns():
    """One reference loss/evaluator per model, so its jitted local update
    compiles once per model for the whole module."""
    out = {}

    def get(name, xte, yte):
        if name not in out:
            jcfg, _, _, jfwd, _, _ = MODELS[name]
            out[name] = (jclient.make_weighted_classifier_loss(jfwd, jcfg),
                         jclient.make_evaluator(jfwd, jcfg, xte, yte, batch=500))
        return out[name]
    return get


def ref_permutations(m):
    """The permutations the reference draws: rng = key(seed) split once
    for init, then per round split -> per-client split -> per-epoch split
    (repro/core/runtimes/rounds.py and repro/core/client.py)."""
    n_ep = SPEC["local_epochs"] * SPEC["local_rounds"]
    rng, _ = jax.random.split(jax.random.key(SEED))
    perms = {}
    for t in range(1, ROUNDS + 1):
        rng, urng = jax.random.split(rng)
        for i, ck in enumerate(jax.random.split(urng, N)):
            for e, ek in enumerate(jax.random.split(ck, n_ep + 1)[:n_ep]):
                perms[(i, t, e)] = np.asarray(jax.random.permutation(ek, m)).astype(np.int64)
    return perms


@pytest.mark.parametrize("codec", ["identity", "topk0.1_int8"])
@pytest.mark.parametrize("model", ["mlp", "cnn"])
@pytest.mark.parametrize("alg", ["vafl", "afl", "eaflm"])
def test_round_runtime_matches_reference(data, ref_fns, alg, model, codec):
    xtr, ytr, xte, yte = data
    jcfg, tcfg, jinit, _, tfwd, spc = MODELS[model]
    fed = iid_partition(xtr, ytr, N, samples_per_client=spc, seed=0)
    jloss, jeval = ref_fns(model, xte, yte)
    seen = {}

    def jinit_capture(k):
        p = jinit(jcfg, k)
        seen["init"] = jax.tree.map(np.asarray, p)
        return p

    def jeval_capture(p):
        seen["ref_final"] = jax.tree.map(np.asarray, p)
        return jeval(p)

    ref = j_run(JConfig(algorithm=alg, num_clients=N, rounds=ROUNDS,
                        local=jclient.LocalSpec(**SPEC), compressor=codec),
                init_params_fn=jinit_capture, loss_fn=jloss, fed_data=fed,
                evaluate_fn=jeval_capture, client_eval_fn=jeval)

    perms = ref_permutations(fed.labels.shape[1])
    teval = tclient.make_evaluator(tfwd, tcfg, xte, yte, batch=500)

    def teval_capture(p):
        seen["port_final"] = p
        return teval(p)

    res = t_run(TConfig(algorithm=alg, num_clients=N, rounds=ROUNDS,
                        local=tclient.LocalSpec(**SPEC), compressor=codec),
                init_params_fn=lambda g: from_jax_params(seen["init"]),
                loss_fn=tclient.make_weighted_classifier_loss(tfwd, tcfg), fed_data=fed,
                evaluate_fn=teval_capture, client_eval_fn=teval, device="cpu",
                perm_fn=lambda i, t, e, m: torch.from_numpy(perms[(i, t, e)]))

    assert [r.selected for r in res.records] == [r.selected for r in ref.records]
    assert dataclasses.asdict(res.comm) == dataclasses.asdict(ref.comm)
    assert res.client_uplink_bytes == ref.client_uplink_bytes
    assert res.client_downlink_bytes == ref.client_downlink_bytes
    # a value is ||g_prev - g_cur||^2 of two nearly equal gradients, so
    # the last-bit differences of the two frameworks' local SGD grow
    # through the cancellation: rtol 1e-3, not the kernel's 1e-5
    for r_port, r_ref in zip(res.records, ref.records):
        if r_ref.values is not None:
            np.testing.assert_allclose(r_port.values, r_ref.values, rtol=1e-3)
    diff = np.concatenate([np.abs(b.numpy() - a).ravel() for a, b in zip(
        jax.tree.leaves(seen["ref_final"]), tree_leaves(seen["port_final"]))])
    if codec == "identity":
        assert diff.max() <= 1e-4, diff.max()
    else:
        # a last-bit difference can tip one entry's stochastic rounding
        # across an integer, which moves it by a whole int8 step
        # (max|delta| / 127, ~2e-4 here; seen on 5 of 50,176 MLP entries
        # with one torch thread): all but 0.1 % of the entries within
        # 1e-4, and none beyond a few steps
        assert (diff > 1e-4).mean() <= 1e-3 and diff.max() <= 1e-3, diff.max()


# -------------------------------------------- torch's own RNG: the bars ---

def _run(data, alg, rounds, noniid=False, **kw):
    xtr, ytr, xte, yte = data
    part = paper_noniid_partition if noniid else iid_partition
    fed = part(xtr, ytr, N, samples_per_client=1000, seed=0)
    mcfg = tcnn.MLPConfig(hidden=(64,))
    return t_run(TConfig(algorithm=alg, num_clients=N, rounds=rounds,
                         local=tclient.LocalSpec(**SPEC), target_acc=0.90, **kw),
                 init_params_fn=lambda g: tcnn.mlp_init(mcfg, g),
                 loss_fn=tclient.make_weighted_classifier_loss(tcnn.mlp_forward, mcfg),
                 fed_data=fed, device="cpu",
                 evaluate_fn=tclient.make_evaluator(tcnn.mlp_forward, mcfg, xte, yte, batch=500))


class TestOwnRNG:
    def test_vafl_converges_iid(self, data):
        res = _run(data, "vafl", rounds=15)
        assert res.best_acc > 0.90, res.best_acc

    def test_vafl_compresses_vs_afl(self, data):
        afl = _run(data, "afl", rounds=10)
        vafl = _run(data, "vafl", rounds=10)
        assert vafl.comm.model_uploads < afl.comm.model_uploads
        rate = ccr(afl.comm.model_uploads, vafl.comm.model_uploads)
        assert 0.1 < rate < 0.9, rate
        assert vafl.best_acc > afl.best_acc - 0.06
        assert vafl.comm.scalar_reports == 10 * N

    def test_same_seed_same_history_and_ref_backend(self, data):
        """Reruns are identical, and the plain value backend selects the
        same clients as the default (kernel-wrapper) backend."""
        a = _run(data, "vafl", rounds=4)
        b = _run(data, "vafl", rounds=4)
        c = _run(data, "vafl", rounds=4,
                 value_backend=lambda x, y: gd_ref.grad_diff_sq_norm_2d(
                     *(torch.cat([t.reshape(N, -1) for t in tree_leaves(s)], 1)
                       for s in (x, y))))
        assert [r.global_acc for r in a.records] == [r.global_acc for r in b.records]
        assert [r.selected for r in a.records] == [r.selected for r in b.records] == \
            [r.selected for r in c.records]


# ----------------------------------------------- entry points and rules ---

def _fed(data, model="cnn", **kw):
    xtr, ytr, xte, yte = data
    fed = paper_noniid_partition(xtr, ytr, N, samples_per_client=60, seed=0)
    return Federation(model=model, data=fed, test_data=(xte[:50], yte[:50]),
                      local=tclient.LocalSpec(**SPEC), **kw)


def test_federation_runs_on_cuda_unless_asked(data):
    """No device= means the card; without one it raises, never falling
    back to the CPU on its own."""
    if torch.cuda.is_available():
        assert _fed(data).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            _fed(data)


def test_federation_cnn_topk_on_cpu(data):
    fed = _fed(data, algorithm="vafl", compressor="topk0.1_int8", device="cpu")
    res = fed.run(rounds=2)
    assert len(res.records) == 2 and res.comm.scalar_reports == 2 * N
    assert 0 < res.comm.upload_payload_bytes < res.comm.model_uploads * res.comm.model_bytes
    afl = fed.run(rounds=2, algorithm="afl")
    assert afl.comm.model_uploads == 2 * N >= res.comm.model_uploads
    sub = fed.run(rounds=1, eval_subsample=20)   # per-client Eq. 1 accs on 20 samples
    assert all(abs(a * 20 - round(a * 20)) < 1e-5 for a in sub.records[0].client_accs)


@pytest.mark.parametrize("field,value", [("shard_clients", True)])
def test_config_rejects_unported_fields(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TConfig(**{field: value})


@pytest.mark.parametrize("field,value", [("engine", "batched"), ("eval_cache", 2)])
def test_config_accepts_the_batched_engine_fields(field, value):
    assert getattr(TConfig(**{field: value}), field) == value


def test_event_mode_and_unknown_names_raise(data):
    fed = _fed(data, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fed.run(rounds=1, mode="event", engine="batched", shard_clients=True)
    with pytest.raises(ValueError, match="unknown engine"):
        fed.run(rounds=1, mode="event", engine="warp-drive")
    with pytest.raises(ValueError, match="unknown mode"):
        fed.run(rounds=1, mode="window")
    with pytest.raises(ValueError, match="registered algorithms"):
        TConfig(algorithm="fedasync_nope")
    with pytest.raises(ValueError):
        _fed(data, device="cpu", model="resnet")
