"""repro_torch's event runtime (``run(mode="event")``: the sequential
loop, the fedavg round barrier, scenarios) against repro on the CPU.

* Aggregation: the 4096-entry staleness table equals the reference's bit
  for bit for every kind, and the asynchronous mix equals the
  reference's compiled mix bit for bit on 2^20 entries; Eq. 1's value of
  one event equals the reference's where the norm's sum is exact.
* Whole runs, with the reference's initial parameters carried across
  (``from_jax_params``) and its permutations injected: the same pop
  order, staleness, CommStats, byte ledgers, simulated clock and idle
  fractions, bit for bit, and final parameters within the round-runtime
  parity test's bounds (atol 1e-4; under topk0.1_int8 up to 0.1 % of
  the entries one int8 step away).
* On torch's own RNG the port holds ``tests/test_system.py``'s
  ``TestEventDriven`` bars.

The tests marked ``gpu`` run the event path on the card against the CPU
path; they skip themselves on a host without a Hopper card and nvcc.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.algorithms.base import Aggregator as JAggregator  # noqa: E402
from repro.core import FLRunConfig as JConfig, run_event_driven as j_run  # noqa: E402
from repro.core import client as jclient  # noqa: E402
from repro.core.aggregation import async_mix_jit, staleness_weight as j_stale  # noqa: E402
from repro.core.runtimes import common as jcommon  # noqa: E402
from repro.core.scheduler import EventScheduler as JScheduler  # noqa: E402
from repro.data.partition import iid_partition, paper_noniid_partition  # noqa: E402
from repro.data.synthetic import synthetic_mnist  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.algorithms.base import Aggregator as TAggregator  # noqa: E402
from repro_torch.common.pytree import tree_leaves  # noqa: E402
from repro_torch.core import client as tclient  # noqa: E402
from repro_torch.core.aggregation import async_mix, staleness_weight  # noqa: E402
from repro_torch.core.config import FLRunConfig as TConfig  # noqa: E402
from repro_torch.core.federation import Federation  # noqa: E402
from repro_torch.core.runtimes import common as tcommon  # noqa: E402
from repro_torch.core.runtimes import run_event_driven as t_run  # noqa: E402
from repro_torch.core.scheduler import EventScheduler as TScheduler  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.grad_diff_norm import ops as gd_ops  # noqa: E402
from repro_torch.kernels.topk_quant import ops as tq_ops  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.sim import ScenarioConfig  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

N, ROUNDS, SEED = 3, 3, 0
SPEC = dict(batch_size=32, local_epochs=1, local_rounds=1, lr=0.1)
N_EP = SPEC["local_epochs"] * SPEC["local_rounds"]

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


# ------------------------------------------------------------ aggregation ---

def test_staleness_table_poly_needs_powf():
    """Why the port raises with the C library's powf: float64 pow rounded
    to fp32, the nearest form in torch, misses the reference's table at
    four near-ties, which the table test below would catch."""
    taus = np.arange(4096)
    ref = np.asarray(j_stale(taus, "poly"))
    f64 = np.power(1.0 + taus, -0.5).astype(np.float32)
    assert np.flatnonzero(f64 != ref).tolist() == [1057, 1249, 1457, 4049]


@pytest.mark.parametrize("kind,kw", [("poly", {}), ("poly", {"a": 0.3}), ("const", {}),
                                     ("hinge", {}), ("hinge", {"a": 10.0, "b": 6.0})])
def test_staleness_table_matches_reference(kind, kw):
    """tau = 0..4095, every entry bit-equal: no tau is a known difference."""
    taus = np.arange(4096)
    want = np.asarray(j_stale(taus, kind, **kw))
    got = staleness_weight(taus, kind, **kw)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("kind", ["poly", "const", "hinge"])
def test_stale_weight_beyond_the_table(kind):
    cfg = dict(staleness_kind=kind, mix_rate=0.5)
    jagg, tagg = JAggregator(JConfig(**cfg)), TAggregator(TConfig(**cfg))
    for tau in (0, 5, 1249, 4095, 4096, 5000, 123_457):
        assert tagg.stale_weight(tau) == jagg.stale_weight(tau), tau
    assert tagg.mix_rate == 0.5


@pytest.mark.parametrize("rho_s", ["0.5*s(5)", "0.5"])
def test_async_mix_matches_compiled_reference(rho_s):
    """The port's mix equals ``async_mix_jit`` (one rounding for the
    multiply-add on XLA's CPU) on 2^20 randn entries, where torch's two
    roundings differ at some 30 % of them."""
    rho = 0.5 * float(j_stale(5)) if rho_s == "0.5*s(5)" else 0.5
    rng = np.random.RandomState(7)
    g = {"w": rng.randn(2 ** 19, 2).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    c = {"w": rng.randn(2 ** 19, 2).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    want = async_mix_jit(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, c), rho)
    got = async_mix(from_jax_params(g), from_jax_params(c), rho)
    for k in ("w", "b"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy().view(np.int32),
                                      np.asarray(want[k]).view(np.int32))
    if rho_s == "0.5*s(5)":
        r = torch.tensor(np.float32(rho))
        twice = ((1 - r) * from_jax_params(g)["w"] + r * from_jax_params(c)["w"]).numpy()
        assert (twice != np.asarray(want["w"])).mean() > 0.2


@pytest.mark.parametrize("n", [3, 7])
def test_event_value_matches_reference(n):
    """Eq. 1 as the event runtime computes it, a size-1 stack at a time,
    against the reference's event helper: bit-equal where the squared
    norm's sum is exact (entries on a 1/8 grid), at 200 accuracies; and
    the amplifier (1 + N/1e3)^acc bit-equal at 2001 accuracies."""
    rng = np.random.RandomState(n)
    shapes = [(30, 7), (11,), (2, 3, 4)]
    jcfg, tcfg = JConfig(num_clients=n), TConfig(num_clients=n)
    jvals = jcommon._event_helpers(jcfg, lambda p: 0.0, jcommon._value_fn(jcfg))[1]
    tvals = tcommon._event_helpers(tcfg, None, tcommon._value_fn(tcfg))[1]
    for k in range(200):
        gp, gc = ({f"p{j}": (rng.randint(-8, 9, (1,) + s) / 8).astype(np.float32)
                   for j, s in enumerate(shapes)} for _ in range(2))
        acc = np.asarray([rng.randint(0, 1001) / 1000], np.float32)
        want = np.asarray(jvals(jax.tree.map(jnp.asarray, gp), jax.tree.map(jnp.asarray, gc),
                                jnp.asarray(acc)))
        got = tvals(from_jax_params(gp), from_jax_params(gc), torch.from_numpy(acc)).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    accs = np.arange(2001, dtype=np.float32) * np.float32(1 / 2000)
    ones = np.ones((2001, 1), np.float32)
    want = np.asarray(jvals({"x": jnp.asarray(ones)}, {"x": jnp.zeros((2001, 1))},
                            jnp.asarray(accs)))
    got = tvals({"x": torch.from_numpy(ones)}, {"x": torch.zeros(2001, 1)},
                torch.from_numpy(accs)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ------------------------------------------------------------- whole runs ---

def ref_event_permutations(m, events):
    """The permutations the reference's event loop draws: rng = key(seed)
    split once for init, then per event split -> one client key
    (split(., 1)) -> per-epoch split (repro/core/runtimes/events.py and
    repro/core/client.py).  Keyed (event, epoch)."""
    rng, _ = jax.random.split(jax.random.key(SEED))
    perms = {}
    for ev in range(events):
        rng, urng = jax.random.split(rng)
        ck = jax.random.split(urng, 1)[0]
        for e, ek in enumerate(jax.random.split(ck, N_EP + 1)[:N_EP]):
            perms[(ev, e)] = np.asarray(jax.random.permutation(ek, m)).astype(np.int64)
    return perms


def ref_round_permutations(m, rounds):
    """The barrier's: per round split -> per-client split -> per-epoch
    split (repro/core/runtimes/sync.py).  Keyed (client, round, epoch)."""
    rng, _ = jax.random.split(jax.random.key(SEED))
    perms = {}
    for t in range(1, rounds + 1):
        rng, urng = jax.random.split(rng)
        for i, ck in enumerate(jax.random.split(urng, N)):
            for e, ek in enumerate(jax.random.split(ck, N_EP + 1)[:N_EP]):
                perms[(i, t, e)] = np.asarray(jax.random.permutation(ek, m)).astype(np.int64)
    return perms


def _record_pops_and_staleness(monkeypatch):
    """Wrap both packages' scheduler pops and staleness lookups so a run
    leaves its pop order and the staleness of each accepted upload."""
    seen = {"ref": ([], []), "port": ([], [])}
    for side, sched, agg in (("ref", JScheduler, JAggregator), ("port", TScheduler, TAggregator)):
        pops, stales = seen[side]

        def pop(self, _orig=sched.pop, _pops=pops):
            out = _orig(self)
            _pops.append(out)
            return out

        def stale_weight(self, tau, _orig=agg.stale_weight, _stales=stales):
            _stales.append(int(tau))
            return _orig(self, tau)
        monkeypatch.setattr(sched, "pop", pop)
        monkeypatch.setattr(agg, "stale_weight", stale_weight)
    return seen


CASES = [("afl", "identity", None, "mlp"), ("vafl", "identity", None, "mlp"),
         ("eaflm", "identity", None, "mlp"), ("afl", "topk0.1_int8", None, "mlp"),
         ("vafl", "topk0.1_int8", None, "mlp"), ("eaflm", "topk0.1_int8", None, "mlp"),
         ("vafl", "identity", "paper_testbed", "mlp"), ("vafl", "identity", "mobile_fleet", "mlp"),
         ("vafl", "topk0.1_int8", "mobile_fleet", "cnn"),
         ("fedavg", "identity", None, "mlp"), ("fedavg", "topk0.1_int8", None, "mlp")]


@pytest.mark.parametrize("alg,codec,scenario,model", CASES)
def test_event_runtime_matches_reference(data, ref_fns, monkeypatch, alg, codec, scenario,
                                         model):
    xtr, ytr, xte, yte = data
    jcfg, tcfg, jinit, _, tfwd, spc = MODELS[model]
    fed = iid_partition(xtr, ytr, N, samples_per_client=spc, seed=0)
    jloss, jeval = ref_fns(model, xte, yte)
    seen = _record_pops_and_staleness(monkeypatch)

    def jinit_capture(k):
        p = jinit(jcfg, k)
        seen["init"] = jax.tree.map(np.asarray, p)
        return p

    def jeval_capture(p):
        seen["ref_final"] = jax.tree.map(np.asarray, p)
        return jeval(p)

    cfg = dict(algorithm=alg, num_clients=N, rounds=ROUNDS, compressor=codec,
               scenario=scenario, events_per_eval=N)
    ref = j_run(JConfig(local=jclient.LocalSpec(**SPEC), **cfg),
                init_params_fn=jinit_capture, loss_fn=jloss, fed_data=fed,
                evaluate_fn=jeval_capture, client_eval_fn=jeval)

    m = fed.labels.shape[1]
    if alg == "fedavg":
        perms = ref_round_permutations(m, ROUNDS)
        perm_fn = lambda i, t, e, _: torch.from_numpy(perms[(i, t, e)])  # noqa: E731
    else:
        perms = ref_event_permutations(m, ROUNDS * N)
        perm_fn = lambda i, ev, e, _: torch.from_numpy(perms[(ev, e)])  # noqa: E731
    teval = tclient.make_evaluator(tfwd, tcfg, xte, yte, batch=500)

    def teval_capture(p):
        seen["port_final"] = p
        return teval(p)

    res = t_run(TConfig(local=tclient.LocalSpec(**SPEC), **cfg),
                init_params_fn=lambda g: from_jax_params(seen["init"]),
                loss_fn=tclient.make_weighted_classifier_loss(tfwd, tcfg), fed_data=fed,
                evaluate_fn=teval_capture, client_eval_fn=teval, device="cpu",
                perm_fn=perm_fn)

    assert seen["port"] == seen["ref"]          # pop order and times, staleness
    if alg != "fedavg":
        assert len(seen["port"][0]) == ROUNDS * N
    assert dataclasses.asdict(res.comm) == dataclasses.asdict(ref.comm)
    for field in ("client_uplink_bytes", "client_downlink_bytes", "client_failed_rounds",
                  "sim_time", "idle_fraction", "client_idle"):
        assert getattr(res, field) == getattr(ref, field), field
    assert ([(r.round, r.time, r.uploads_so_far, r.selected) for r in res.records]
            == [(r.round, r.time, r.uploads_so_far, r.selected) for r in ref.records])
    diff = np.concatenate([np.abs(b.numpy() - a).ravel() for a, b in zip(
        jax.tree.leaves(seen["ref_final"]), tree_leaves(seen["port_final"]))])
    if codec == "identity":
        assert diff.max() <= 1e-4, diff.max()
    else:
        # a last-bit difference can tip one entry's stochastic rounding
        # across an integer (tests/test_torch_system.py)
        assert (diff > 1e-4).mean() <= 1e-3 and diff.max() <= 1e-3, diff.max()


# ------------------------------------------ torch's own RNG: the bars ---

def _own(data, alg, rounds):
    """tests/test_system.py's ``_run(..., mode="event")`` on the port."""
    xtr, ytr, xte, yte = data
    fed = iid_partition(xtr, ytr, N, samples_per_client=1000, seed=0)
    mcfg = tcnn.MLPConfig(hidden=(64,))
    return t_run(TConfig(algorithm=alg, num_clients=N, rounds=rounds,
                         local=tclient.LocalSpec(**SPEC), target_acc=0.90, events_per_eval=N),
                 init_params_fn=lambda g: tcnn.mlp_init(mcfg, g),
                 loss_fn=tclient.make_weighted_classifier_loss(tcnn.mlp_forward, mcfg),
                 fed_data=fed, device="cpu",
                 evaluate_fn=tclient.make_evaluator(tcnn.mlp_forward, mcfg, xte, yte, batch=500))


class TestEventDriven:
    def test_async_beats_sync_on_wallclock(self, data):
        afl = _own(data, "afl", 12)
        sync = _own(data, "fedavg", 12)
        assert afl.records[-1].time < sync.records[-1].time
        assert sync.idle_fraction > 0.15 >= afl.idle_fraction

    def test_event_vafl_gates(self, data):
        afl = _own(data, "afl", 10)
        vafl = _own(data, "vafl", 10)
        assert vafl.comm.model_uploads < afl.comm.model_uploads


# ----------------------------------------------- entry points and rules ---

def _fed(data, **kw):
    xtr, ytr, xte, yte = data
    fed = paper_noniid_partition(xtr, ytr, N, samples_per_client=60, seed=0)
    return Federation(model="mlp", data=fed, test_data=(xte[:50], yte[:50]),
                      local=tclient.LocalSpec(**SPEC), **kw)


@pytest.mark.parametrize("field,value", [("shard_clients", True)])
def test_event_mode_rejects_unported_settings(data, field, value):
    fed = _fed(data, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fed.run(rounds=1, mode="event", **{field: value})


def test_event_mode_runs_on_cuda_unless_asked(data):
    """run_event_driven's default device is the card; without one it
    raises, never falling back to the CPU on its own."""
    fed = _fed(data, device="cuda" if torch.cuda.is_available() else "cpu")
    kw = dict(init_params_fn=fed.init_params_fn, loss_fn=fed.loss_fn, fed_data=fed.data,
              evaluate_fn=fed.evaluate_fn)
    if torch.cuda.is_available():
        assert t_run(dataclasses.replace(fed.config, rounds=1), **kw).sim_time > 0
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            t_run(fed.config, **kw)


def test_federation_scenario_and_speed(data):
    """``scenario=`` resolves through repro_torch.sim (a name or a
    ScenarioConfig; an unknown name raises), a scenario moves the
    simulated clock, and an explicit ``speed`` model wins over the
    scenario's fleet."""
    from repro_torch.core.scheduler import SpeedModel
    fed = _fed(data, device="cpu", scenario="mobile_fleet")
    assert isinstance(fed.config.scenario, ScenarioConfig)
    assert fed.config.scenario.name == "mobile_fleet"
    with pytest.raises(ValueError, match="registered scenarios"):
        _fed(data, device="cpu", scenario="moon_base")
    mobile = fed.run(rounds=1, mode="event", algorithm="afl")
    plain = fed.run(rounds=1, mode="event", algorithm="afl", scenario=None)
    assert mobile.sim_time != plain.sim_time and mobile.idle_fraction > 0
    even = SpeedModel(np.full(N, 2.0), sigma=0.0)
    fixed = fed.run(rounds=1, mode="event", algorithm="afl", scenario=None, speed=even)
    assert fixed.sim_time == 2.0 and fixed.idle_fraction == 0.0


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
def test_gpu_async_mix_matches_cpu_route(cuda):
    """The same float64 form on the card: bit-equal to the CPU route
    (within 1 ulp is the bound asked; it is exact)."""
    rng = np.random.RandomState(11)
    g, c = ({"w": torch.from_numpy(rng.randn(2 ** 20).astype(np.float32))} for _ in range(2))
    rho = 0.5 * float(staleness_weight(5))
    cpu = async_mix(g, c, rho)["w"]
    dev = async_mix({"w": g["w"].to(cuda)}, {"w": c["w"].to(cuda)}, rho)["w"].cpu()
    ulps = (dev.view(torch.int32).long() - cpu.view(torch.int32).long()).abs()
    assert int(ulps.max()) <= 1 and torch.equal(dev, cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("codec", ["identity", "topk0.1_int8"])
def test_gpu_event_mode_matches_cpu_path(cuda, codec):
    """Event-mode vafl on the card and on the CPU with the same initial
    model and permutations: the same pop order, staleness, CommStats,
    byte ledgers and clock, and close final models (the bounds of
    tests/test_torch_kernels.py::test_gpu_federation_matches_cpu_path).
    On the card grad_diff_norm launches once per event and the encode
    once per accepted upload; on the CPU neither launches."""
    xtr, ytr, xte, yte = synthetic_mnist(600, 200, seed=1)
    data = iid_partition(xtr, ytr, 3, samples_per_client=160, seed=1)
    gen = np.random.RandomState(2)
    events = 3 * 3
    perms = {(ev, 0): torch.from_numpy(gen.permutation(160)) for ev in range(events)}
    cfg = tcnn.MLPConfig(hidden=(64,))
    init = tcnn.mlp_init(cfg, torch.Generator().manual_seed(3))
    out = {}
    for device in ("cuda", "cpu"):
        seen, pops = {}, []
        fed = Federation(model=(tcnn.mlp_forward, lambda c, g: init, cfg), data=data,
                         test_data=(xte, yte), algorithm="vafl", compressor=codec,
                         local=tclient.LocalSpec(32, 1, 1, 0.1), device=device)
        evaluate = fed.evaluate_fn

        def capture(p, evaluate=evaluate, seen=seen):
            seen["params"] = p
            return evaluate(p)
        fed.evaluate_fn = capture
        g0, t0 = gd_ops.launches, tq_ops.launches
        res = fed.run(rounds=3, mode="event", perm_fn=lambda i, ev, e, m: perms[(ev, e)])
        out[device] = (res, gd_ops.launches - g0, tq_ops.launches - t0,
                       torch.cat([x.detach().cpu().ravel() for x in tree_leaves(seen["params"])]))
    (rg, gg, tg, pg), (rc, gc, tc, pc) = out["cuda"], out["cpu"]
    assert (gg, gc) == (events, 0) and tc == 0
    assert tg == (rg.comm.model_uploads if codec == "topk0.1_int8" else 0)
    assert vars(rg.comm) == vars(rc.comm)
    for field in ("client_uplink_bytes", "client_downlink_bytes", "sim_time", "client_idle"):
        assert getattr(rg, field) == getattr(rc, field), field
    assert ([(r.time, r.uploads_so_far) for r in rg.records]
            == [(r.time, r.uploads_so_far) for r in rc.records])
    diff = (pg - pc).abs()
    if codec == "identity":
        assert float(diff.max()) <= 1e-4, float(diff.max())
    else:
        assert float((diff > 1e-4).float().mean()) <= 1e-3 and float(diff.max()) <= 1e-3, \
            float(diff.max())


@pytest.mark.gpu
def test_gpu_event_vafl_reproducible_from_a_seed(cuda):
    """Event-mode vafl on the card, twice from one seed in one process, on
    chip_smoke.py's federation (the CNN, 7 clients of 1,000 samples,
    topk0.1_int8): the same CommStats, ledgers, clock and final
    parameters, bit for bit."""
    xtr, ytr, xte, yte = synthetic_mnist(7000, 2000, seed=0)
    data = paper_noniid_partition(xtr, ytr, 7, samples_per_client=1000, seed=0)
    fed = Federation(model="cnn", data=data, test_data=(xte, yte), algorithm="vafl",
                     compressor="topk0.1_int8", local=tclient.LocalSpec(32, 1, 1, 0.1),
                     device="cuda")
    seen = {}
    evaluate = fed.evaluate_fn

    def capture(p):
        seen["params"] = p
        return evaluate(p)
    fed.evaluate_fn = capture
    runs = []
    for _ in range(2):
        res = fed.run(rounds=3, mode="event")
        runs.append((vars(res.comm), res.client_uplink_bytes, res.sim_time,
                     [r.uploads_so_far for r in res.records],
                     [x.detach().cpu() for x in tree_leaves(seen["params"])]))
    (c0, u0, s0, r0, p0), (c1, u1, s1, r1, p1) = runs
    assert (c0, u0, s0, r0) == (c1, u1, s1, r1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
