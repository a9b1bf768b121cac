"""repro_torch's round runtime (``run(mode="round")``) under a scenario,
against repro on the CPU.

Under an active ``scenario=`` the round runtime simulates a clock: each
round costs its slowest participant's service time plus the byte-aware
link delay, and availability failures discard uploads mid-round.  With
the reference's initial parameters carried across (``from_jax_params``)
and its permutations injected, the port gives the reference's record
times, ``selected``, ``client_failed_rounds``, byte ledgers,
``sim_time``, ``idle_fraction`` and ``client_idle`` bit for bit under
``paper_testbed``, ``mobile_fleet`` and ``flaky_edge`` (whose
availability model fails rounds), and parameters within the round
runtime's bounds (atol 1e-4; under topk0.1_int8 up to 0.1 % of the
entries one int8 step away).

Before the repair the port ignored ``scenario`` here: it stamped each
record with the round index ([1.0, 2.0, 3.0]) and reported no failures.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import FLRunConfig as JConfig, run_round_based as j_run  # noqa: E402
from repro.core import Federation as JFederation  # noqa: E402
from repro.core import client as jclient  # noqa: E402
from repro.data.partition import iid_partition, paper_noniid_partition  # noqa: E402
from repro.data.synthetic import synthetic_mnist  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.common.pytree import tree_leaves  # noqa: E402
from repro_torch.core import client as tclient  # noqa: E402
from repro_torch.core.config import FLRunConfig as TConfig  # noqa: E402
from repro_torch.core.federation import Federation  # noqa: E402
from repro_torch.core.runtimes import run_round_based as t_run  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

N, ROUNDS, SEED = 5, 4, 0
SPEC = dict(batch_size=32, local_epochs=1, local_rounds=1, lr=0.1)
N_EP = SPEC["local_epochs"] * SPEC["local_rounds"]
JCFG, TCFG = jcnn.MLPConfig(hidden=(64,)), tcnn.MLPConfig(hidden=(64,))


@pytest.fixture(scope="module")
def data():
    xtr, ytr, xte, yte = synthetic_mnist(4000, 1000, seed=0)
    return iid_partition(xtr, ytr, N, samples_per_client=200, seed=0), xte, yte


@pytest.fixture(scope="module")
def ref_fns(data):
    _, xte, yte = data
    return (jclient.make_weighted_classifier_loss(jcnn.mlp_forward, JCFG),
            jclient.make_evaluator(jcnn.mlp_forward, JCFG, xte, yte, batch=500))


def ref_round_perms(m, rounds):
    """The reference round runtime's permutations, keyed (client, round,
    epoch): rng = key(seed) split once for init, then per round split ->
    per-client split -> per-epoch split."""
    rng, _ = jax.random.split(jax.random.key(SEED))
    perms = {}
    for t in range(1, rounds + 1):
        rng, urng = jax.random.split(rng)
        for i, ck in enumerate(jax.random.split(urng, N)):
            for e, ek in enumerate(jax.random.split(ck, N_EP + 1)[:N_EP]):
                perms[(i, t, e)] = np.asarray(jax.random.permutation(ek, m)).astype(np.int64)
    return perms


def round_pair(data, ref_fns, **cfg):
    """The reference and the port's round runtime on one configuration;
    returns (ref result, port result, flat final parameters of each)."""
    fed, xte, yte = data
    jloss, jeval = ref_fns
    seen = {}
    cfg = dict(num_clients=N, rounds=ROUNDS, seed=SEED, **cfg)

    def jinit(k):
        p = jcnn.mlp_init(JCFG, k)
        seen["init"] = jax.tree.map(np.asarray, p)
        return p

    def jeval_capture(p):
        seen["ref_final"] = jax.tree.map(np.asarray, p)
        return jeval(p)

    ref = j_run(JConfig(local=jclient.LocalSpec(**SPEC), **cfg), init_params_fn=jinit,
                loss_fn=jloss, fed_data=fed, evaluate_fn=jeval_capture, client_eval_fn=jeval)
    perms = ref_round_perms(fed.labels.shape[1], cfg["rounds"])
    teval = tclient.make_evaluator(tcnn.mlp_forward, TCFG, xte, yte, batch=500)

    def teval_capture(p):
        seen["port_final"] = p
        return teval(p)

    res = t_run(TConfig(local=tclient.LocalSpec(**SPEC), **cfg),
                init_params_fn=lambda g: from_jax_params(seen["init"]),
                loss_fn=tclient.make_weighted_classifier_loss(tcnn.mlp_forward, TCFG),
                fed_data=fed, evaluate_fn=teval_capture, client_eval_fn=teval, device="cpu",
                perm_fn=lambda i, t, e, _: torch.from_numpy(perms[(i, t, e)]))
    flat = (np.concatenate([np.ravel(x) for x in jax.tree.leaves(seen["ref_final"])]),
            np.concatenate([x.numpy().ravel() for x in tree_leaves(seen["port_final"])]))
    return ref, res, flat


SIM_FIELDS = ("sim_time", "idle_fraction", "client_idle", "client_uplink_bytes",
              "client_downlink_bytes", "client_failed_rounds")


def assert_round_parity(ref, res, flat, lossy=False):
    assert dataclasses.asdict(res.comm) == dataclasses.asdict(ref.comm)
    for field in SIM_FIELDS:
        assert getattr(res, field) == getattr(ref, field), field
    assert ([(r.round, r.time, r.uploads_so_far, r.selected) for r in res.records]
            == [(r.round, r.time, r.uploads_so_far, r.selected) for r in ref.records])
    diff = np.abs(flat[1] - flat[0])
    if not lossy:
        assert diff.max() <= 1e-4, diff.max()
    else:
        # a last-bit difference can tip one entry's stochastic rounding
        # across an integer (tests/test_torch_system.py)
        assert (diff > 1e-4).mean() <= 1e-3 and diff.max() <= 1e-3, diff.max()


CASES = [("vafl", "identity", "paper_testbed", 1.0), ("afl", "identity", "paper_testbed", 1.0),
         ("vafl", "identity", "mobile_fleet", 1.0), ("eaflm", "topk0.1_int8", "mobile_fleet", 1.0),
         ("vafl", "topk0.1_int8", "flaky_edge", 1.0), ("afl", "identity", "flaky_edge", 0.6)]


@pytest.mark.parametrize("alg,codec,scenario,participation", CASES)
def test_round_runtime_scenario_matches_reference(data, ref_fns, alg, codec, scenario,
                                                  participation):
    ref, res, flat = round_pair(data, ref_fns, algorithm=alg, compressor=codec,
                                scenario=scenario, participation=participation)
    assert_round_parity(ref, res, flat, lossy=codec != "identity")
    assert res.sim_time > 0 and [r.time for r in res.records] != [1.0, 2.0, 3.0, 4.0]
    if scenario == "flaky_edge":
        assert sum(res.client_failed_rounds) > 0     # the availability model fired
        lost = [c for c, f in enumerate(res.client_failed_rounds) if f]
        assert lost


def test_round_scenario_clock_of_the_fault_report():
    """The case the fault was found on: ``Federation(model="mlp",
    algorithm="afl", scenario="mobile_fleet")`` on a 7-client
    paper_noniid_partition (60 samples a client), 3 rounds.  The
    reference stamps records at 8.8806, 16.7812 and 24.7863 (its clock);
    the port, which once gave [1.0, 2.0, 3.0], now gives the same times
    bit for bit, and the same idle fraction and ledgers."""
    xtr, ytr, xte, yte = synthetic_mnist(4000, 1000, seed=0)
    fed = paper_noniid_partition(xtr, ytr, 7, samples_per_client=60, seed=0)
    kw = dict(model="mlp", data=fed, test_data=(xte, yte), algorithm="afl",
              scenario="mobile_fleet")
    ref = JFederation(local=jclient.LocalSpec(32, 1, 1, 0.1), **kw).run(rounds=3, mode="round")
    res = Federation(local=tclient.LocalSpec(32, 1, 1, 0.1), device="cpu", **kw).run(
        rounds=3, mode="round")
    ref_times = [r.time for r in ref.records]
    assert [round(t, 4) for t in ref_times] == [8.8806, 16.7812, 24.7863]
    assert [r.time for r in res.records] == ref_times
    for field in SIM_FIELDS:
        assert getattr(res, field) == getattr(ref, field), field


def test_round_runtime_without_scenario_keeps_round_index(data):
    """The default scenario is the legacy path: record time = round index,
    no simulated clock on the result."""
    fed, xte, yte = data
    f = Federation(model=(tcnn.mlp_forward, tcnn.mlp_init, TCFG), data=fed,
                   test_data=(xte[:200], yte[:200]), local=tclient.LocalSpec(**SPEC),
                   device="cpu")
    res = f.run(rounds=2, mode="round", algorithm="afl")
    assert [r.time for r in res.records] == [1.0, 2.0]
    assert res.sim_time is None and res.idle_fraction is None
    assert res.client_failed_rounds == [0] * N
    default = f.run(rounds=2, mode="round", algorithm="afl", scenario="default")
    assert [r.time for r in default.records] == [1.0, 2.0]
