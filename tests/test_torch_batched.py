"""repro_torch's batched event engine (``run(mode="event",
engine="batched")``), its FedBuff flush and its scheduler window API,
against repro on the CPU.

* The window API (``pop_window``, ``account_bytes``, ``reactive``)
  driven as the engine drives it: the same times, ids, byte ledgers and
  idle fractions, exactly.
* The flush: ``buffered_coefs`` equal, and ``buffered_mix`` and
  ``flush_mix`` bit-equal to the reference's on 2^18 entries for K = 2,
  3, 4 and 16 (plain torch's two roundings differ at about 30 % of
  them); K = 1 is ``async_mix`` bit for bit; the commit over
  materialised reconstructions (``_flush_reconstructions``) bit-equal.
* Eq. 1 as the engine computes it, its amplifier on the host after the
  window's one read: bit-equal to the reference's stacked values.
* Whole runs, with the reference's initial parameters carried across
  (``from_jax_params``) and the permutations its batched engine draws
  injected (per window: one split of the run key, one key per arrival
  position, one per epoch; a window passes its first event index as the
  step): the same windows, staleness, CommStats, byte ledgers, clock,
  idle fractions and record rounds, times and upload counts, bit for
  bit; parameters within the round-runtime parity test's bounds (atol
  1e-4; under a stochastic codec up to 0.1 % of the entries one codec
  step away).  The cases cover the full-window fast path, gathered
  windows with a K = 2 flush, the folded final flush, the reactive
  scheduler (``mobile_fleet``), FedAsync on all three runtimes and the
  dense int8/int4 codecs.
* The engine contract on the port: at ``max_batch=1, buffer_size=1`` the
  batched engine is the sequential loop exactly.

The tests marked ``gpu`` run the engine on the card against the CPU
path; they skip themselves on a host without a Hopper card and nvcc.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.sim as jsim  # noqa: E402
from repro.algorithms.base import Aggregator as JAggregator  # noqa: E402
from repro.core import FLRunConfig as JConfig, client as jclient  # noqa: E402
from repro.core import run_event_driven as j_event, run_round_based as j_round  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core.runtimes import common as jcommon  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.data.partition import iid_partition  # noqa: E402
from repro.data.synthetic import synthetic_mnist  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.algorithms.base import Aggregator as TAggregator  # noqa: E402
from repro_torch.common.pytree import tree_leaves  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import client as tclient  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core.config import FLRunConfig as TConfig  # noqa: E402
from repro_torch.core.federation import Federation  # noqa: E402
from repro_torch.core.runtimes import run_event_driven as t_event  # noqa: E402
from repro_torch.core.runtimes import common as tcommon  # noqa: E402
from repro_torch.core.runtimes import run_round_based as t_round  # noqa: E402
from repro_torch.core import value as tvalue  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.grad_diff_norm import ops as gd_ops  # noqa: E402
from repro_torch.kernels.topk_quant import ops as tq_ops  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

N, ROUNDS, SEED = 3, 3, 0
SPEC = dict(batch_size=32, local_epochs=1, local_rounds=1, lr=0.1)
N_EP = SPEC["local_epochs"] * SPEC["local_rounds"]
JCFG, TCFG = jcnn.MLPConfig(hidden=(64,)), tcnn.MLPConfig(hidden=(64,))


@pytest.fixture(scope="module")
def data():
    """tests/test_system.py's fixture data, split as the event parity
    tests split it."""
    xtr, ytr, xte, yte = synthetic_mnist(4000, 1000, seed=0)
    return iid_partition(xtr, ytr, N, samples_per_client=300, seed=0), xte, yte


@pytest.fixture(scope="module")
def ref_fns(data):
    _, xte, yte = data
    return (jclient.make_weighted_classifier_loss(jcnn.mlp_forward, JCFG),
            jclient.make_evaluator(jcnn.mlp_forward, JCFG, xte, yte, batch=500))


# ------------------------------------------------------ scheduler windows ---

UP, DOWN = 48_431, 170_792     # a topk0.1_int8 upload and an fp32 broadcast of the CNN


def _scheduler(sim, sched_mod, scenario, n=7, seed=3):
    if scenario is None:
        return sched_mod.EventScheduler(n, sched_mod.SpeedModel.paper_testbed(n, seed))
    compute, net, avail = sim.get_scenario(scenario).build(n, seed)
    return sched_mod.EventScheduler(n, compute, network=net, availability=avail)


def _drive_windows(sched, pops, width):
    """The batched engine's use of the window API: pop a window,
    reschedule each client from its own completion time (with its bytes
    when the scheduler is reactive, else ledger them after), until
    ``pops`` events have popped."""
    trace, k = [], 0
    while k < pops:
        times, ids = sched.pop_window(min(width, pops - k))
        trace.append((times.tolist(), ids.tolist(), float(sched.now)))
        for j, c in enumerate(ids):
            up, down = UP + 17 * ((k + j) % 5), DOWN
            if sched.reactive:
                sched.schedule(int(c), start=float(times[j]), upload_bytes=up,
                               download_bytes=down)
            else:
                sched.schedule(int(c), start=float(times[j]))
                sched.account_bytes(int(c), up, down)
        k += len(ids)
    return trace


@pytest.mark.parametrize("scenario", [None, "mobile_fleet"])
@pytest.mark.parametrize("width", [1, 3, 7])
def test_window_api_matches_reference(scenario, width):
    ref, port = _scheduler(jsim, jsched, scenario), _scheduler(tsim, tsched, scenario)
    assert port.reactive == ref.reactive == (scenario is not None)
    assert _drive_windows(port, 200, width) == _drive_windows(ref, 200, width)
    for field in ("busy_until", "client_busy_time", "client_net_delay", "client_up_bytes",
                  "client_down_bytes", "client_failed_rounds"):
        assert getattr(port, field).tolist() == getattr(ref, field).tolist(), field
    assert port.idle_fraction().tolist() == ref.idle_fraction().tolist()


# -------------------------------------------------------------- the flush ---

def _buffer(k, n=2 ** 18):
    rs = np.random.RandomState(k)
    g = {"w": rs.randn(n).astype(np.float32), "b": rs.randn(3).astype(np.float32)}
    recons = [{"w": rs.randn(n).astype(np.float32), "b": rs.randn(3).astype(np.float32)}
              for _ in range(k)]
    # staleness weights as the engine has them: fp32 table entries as floats
    stales = [float(x) for x in jagg.staleness_weight(rs.randint(0, 9, k), "poly")]
    return g, recons, stales


def _bits(t):
    return t.numpy().view(np.int32)


@pytest.mark.parametrize("k", [2, 3, 4, 16])
def test_flush_bitexact_vs_reference(k):
    """flush_mix against the reference's compiled flush (flush_mix_jit),
    buffered_mix against its unjitted buffered_mix with the aggregator's
    mix, and the coefficients: all bit-equal.  Rows are gathered out of
    order from a larger stacked source, as a flush across windows
    gathers them."""
    g, recons, stales = _buffer(k)
    coef, rho_sbar = jagg.buffered_coefs(stales, 0.5)
    tcoef, trho = tagg.buffered_coefs(stales, 0.5)
    assert tcoef.tolist() == coef.tolist() and trho == rho_sbar
    src = {key: np.stack([r[key] for r in recons][::-1] + [g[key]]) for key in g}
    rows = np.arange(k)[::-1].astype(np.int32)
    want = jagg.flush_mix_jit(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, src),
                              jnp.asarray(rows), jnp.asarray(coef), rho_sbar)
    got = tagg.flush_mix(from_jax_params(g), from_jax_params(src), rows, tcoef, trho)
    want_mix = jagg.buffered_mix(jax.tree.map(jnp.asarray, g),
                                 [jax.tree.map(jnp.asarray, r) for r in recons], stales, 0.5,
                                 mix=jagg.async_mix_jit)
    got_mix = tagg.buffered_mix(from_jax_params(g), [from_jax_params(r) for r in recons],
                                stales, 0.5)
    for key in g:
        np.testing.assert_array_equal(_bits(got[key]), np.asarray(want[key]).view(np.int32))
        np.testing.assert_array_equal(_bits(got_mix[key]),
                                      np.asarray(want_mix[key]).view(np.int32))
    # plain torch (a product, then a sum, rounded each) is not the form
    plain = sum(torch.from_numpy(r["w"]) * float(c) for r, c in zip(recons, coef))
    bar = tagg.buffered_mean({"w": torch.from_numpy(np.stack([r["w"] for r in recons]))},
                             coef)["w"]
    assert (plain != bar).float().mean() > 0.1


def test_flush_k1_is_async_mix_bitwise():
    g, recons, stales = _buffer(1)
    got = tagg.buffered_mix(from_jax_params(g), [from_jax_params(recons[0])], stales, 0.5)
    want = tagg.async_mix(from_jax_params(g), from_jax_params(recons[0]), 0.5 * stales[0])
    for key in g:
        assert torch.equal(got[key], want[key])
    ref = jagg.async_mix_jit(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, recons[0]),
                             0.5 * stales[0])
    np.testing.assert_array_equal(_bits(got["w"]), np.asarray(ref["w"]).view(np.int32))


@pytest.mark.parametrize("k", [1, 3])
def test_flush_reconstructions_matches_reference(k):
    """The FedBuff commit over materialised reconstructions against the
    reference's ``_flush_reconstructions``, bit for bit: K = 1 through
    the sequential mix, K = 3 through the aggregator's ``flush_mix``."""
    g, recons, stales = _buffer(k, n=2 ** 12)
    want = jcommon._flush_reconstructions(
        JAggregator(JConfig(num_clients=N)), jax.tree.map(jnp.asarray, g),
        [jax.tree.map(jnp.asarray, r) for r in recons], stales)
    got = tcommon._flush_reconstructions(
        TAggregator(TConfig(num_clients=N)), from_jax_params(g),
        [from_jax_params(r) for r in recons], stales)
    for key in g:
        np.testing.assert_array_equal(_bits(got[key]), np.asarray(want[key]).view(np.int32))


@pytest.mark.parametrize("w", [1, 7])
def test_window_values_on_the_host_match_reference(w):
    """Eq. 1 as the batched engine computes it (the squared norms and
    accuracies read back, the amplifier and product applied on the
    host) against the reference's stacked values over a window of W
    rows and the port's device-side form: bit-equal where the norm's sum
    is exact (entries on a 1/8 grid), at 50 windows of accuracies."""
    rng = np.random.RandomState(w)
    shapes = [(30, 7), (11,), (2, 3, 4)]
    jcfg, tcfg = JConfig(num_clients=w), TConfig(num_clients=w)
    jvals = jcommon._event_helpers(jcfg, lambda p: 0.0, jcommon._value_fn(jcfg))[1]
    tvals = tcommon._event_helpers(tcfg, None, tcommon._value_fn(tcfg))[1]
    for _ in range(50):
        gp, gc = ({f"p{j}": (rng.randint(-8, 9, (w,) + s) / 8).astype(np.float32)
                   for j, s in enumerate(shapes)} for _ in range(2))
        accs = (rng.randint(0, 1001, w) / 1000).astype(np.float32)
        want = np.asarray(jvals(jax.tree.map(jnp.asarray, gp), jax.tree.map(jnp.asarray, gc),
                                jnp.asarray(accs)))
        diff_sq = tcommon._value_fn(tcfg)(from_jax_params(gp), from_jax_params(gc))
        got = tvalue.communication_values_host(diff_sq.numpy(), accs, w)
        dev = tvals(from_jax_params(gp), from_jax_params(gc), torch.from_numpy(accs)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        np.testing.assert_array_equal(got.view(np.int32), dev.view(np.int32))


# ------------------------------------------------------------- whole runs ---

def _ref_perms(mode, m, schedule):
    """The permutations the reference draws, keyed as the port's
    ``perm_fn`` asks for them: (client, step, epoch).  rng = key(seed)
    is split once for init, then once per round (round runtime), event
    (sequential loop) or window (batched engine); a step's key splits
    into one key per row (a full window's split(urng, N)[inv] gives the
    client at arrival position j the j-th key) and each row's key into
    one key per epoch."""
    rng, _ = jax.random.split(jax.random.key(SEED))
    perms = {}
    for step, clients in schedule:
        rng, urng = jax.random.split(rng)
        for c, ck in zip(clients, jax.random.split(urng, len(clients))):
            for e, ek in enumerate(jax.random.split(ck, N_EP + 1)[:N_EP]):
                perms[(int(c), step, e)] = np.asarray(jax.random.permutation(ek, m)).astype(
                    np.int64)
    return perms


def _record(monkeypatch):
    """Wrap both packages' scheduler pops and staleness lookups so a run
    leaves its pop order (windows, or single pops) and the staleness of
    each accepted upload."""
    seen = {"ref": ([], []), "port": ([], [])}
    for side, sched, agg in (("ref", jsched.EventScheduler, JAggregator),
                             ("port", tsched.EventScheduler, TAggregator)):
        pops, stales = seen[side]

        def pop(self, _orig=sched.pop, _pops=pops):
            out = _orig(self)
            _pops.append(([out[0]], [out[1]]))
            return out

        def pop_window(self, k, _orig=sched.pop_window, _pops=pops):
            times, ids = _orig(self, k)
            _pops.append((times.tolist(), ids.tolist()))
            return times, ids

        def stale_weight(self, tau, _orig=agg.stale_weight, _stales=stales):
            _stales.append(int(tau))
            return _orig(self, tau)
        monkeypatch.setattr(sched, "pop", pop)
        monkeypatch.setattr(sched, "pop_window", pop_window)
        monkeypatch.setattr(agg, "stale_weight", stale_weight)
    return seen


def run_pair(data, ref_fns, monkeypatch, mode="event", **cfg):
    """The reference and the port on one configuration; returns (ref
    result, port result, recorded pops/staleness, final parameters of
    each (the last evaluated global model) as flat numpy)."""
    fed, xte, yte = data
    jloss, jeval = ref_fns
    seen = _record(monkeypatch)
    cfg = dict(num_clients=N, rounds=ROUNDS, events_per_eval=N, **cfg)

    def jinit(k):
        p = jcnn.mlp_init(JCFG, k)
        seen["init"] = jax.tree.map(np.asarray, p)
        return p

    def jeval_capture(p):
        seen["ref_final"] = jax.tree.map(np.asarray, p)
        return jeval(p)

    j_run = j_round if mode == "round" else j_event
    ref = j_run(JConfig(local=jclient.LocalSpec(**SPEC), **cfg), init_params_fn=jinit,
                loss_fn=jloss, fed_data=fed, evaluate_fn=jeval_capture, client_eval_fn=jeval)

    m = fed.labels.shape[1]
    if mode == "round":
        schedule = [(t, range(N)) for t in range(1, ROUNDS + 1)]
    else:   # event index (sequential) or first event index (batched) of each pop
        starts = np.cumsum([0] + [len(ids) for _, ids in seen["ref"][0]])
        schedule = [(int(s), ids) for s, (_, ids) in zip(starts, seen["ref"][0])]
    perms = _ref_perms(mode, m, schedule)
    teval = tclient.make_evaluator(tcnn.mlp_forward, TCFG, xte, yte, batch=500)

    def teval_capture(p):
        seen["port_final"] = p
        return teval(p)

    t_run = t_round if mode == "round" else t_event
    res = t_run(TConfig(local=tclient.LocalSpec(**SPEC), **cfg),
                init_params_fn=lambda g: from_jax_params(seen["init"]),
                loss_fn=tclient.make_weighted_classifier_loss(tcnn.mlp_forward, TCFG),
                fed_data=fed, evaluate_fn=teval_capture, client_eval_fn=teval, device="cpu",
                perm_fn=lambda i, step, e, _: torch.from_numpy(perms[(i, step, e)]))
    flat = (np.concatenate([np.ravel(x) for x in jax.tree.leaves(seen["ref_final"])]),
            np.concatenate([x.numpy().ravel() for x in tree_leaves(seen["port_final"])]))
    return ref, res, seen, flat


def assert_engine_parity(ref, res, seen, flat, lossy=False):
    """The engine bars: everything the simulation decides bit for bit,
    parameters within the round-runtime parity test's bounds."""
    assert seen["port"] == seen["ref"]          # windows and times, staleness
    assert dataclasses.asdict(res.comm) == dataclasses.asdict(ref.comm)
    for field in ("client_uplink_bytes", "client_downlink_bytes", "client_failed_rounds",
                  "sim_time", "idle_fraction", "client_idle"):
        assert getattr(res, field) == getattr(ref, field), field
    assert ([(r.round, r.time, r.uploads_so_far, r.boundaries_crossed) for r in res.records]
            == [(r.round, r.time, r.uploads_so_far, r.boundaries_crossed) for r in ref.records])
    diff = np.abs(flat[1] - flat[0])
    accs = np.abs(np.subtract([r.global_acc for r in res.records],
                              [r.global_acc for r in ref.records]))
    assert accs.max() <= 1e-4, accs
    if not lossy:
        assert diff.max() <= 1e-4, diff.max()
    else:
        # a last-bit difference can tip one entry's stochastic rounding
        # across an integer (tests/test_torch_system.py)
        assert (diff > 1e-4).mean() <= 1e-3 and diff.max() <= 1e-3, diff.max()


ENGINE_CASES = [
    # the full-window fast path
    ("afl", "identity", None, 0, 1), ("vafl", "identity", None, 0, 1),
    ("eaflm", "identity", None, 0, 1), ("afl", "topk0.1_int8", None, 0, 1),
    ("vafl", "topk0.1_int8", None, 0, 1), ("eaflm", "topk0.1_int8", None, 0, 1),
    # gathered windows and K = 2 flushes; the folded final flush; reactive
    ("vafl", "identity", None, 2, 2), ("afl", "identity", None, 0, 3),
    ("vafl", "identity", "mobile_fleet", 0, 1),
]


@pytest.mark.parametrize("alg,codec,scenario,max_batch,buffer_size", ENGINE_CASES)
def test_batched_engine_matches_reference(data, ref_fns, monkeypatch, alg, codec, scenario,
                                          max_batch, buffer_size):
    out = run_pair(data, ref_fns, monkeypatch, algorithm=alg, compressor=codec,
                   scenario=scenario, engine="batched", max_batch=max_batch,
                   buffer_size=buffer_size)
    assert len(out[2]["port"][0]) == (ROUNDS if max_batch == 0 else 5)   # windows
    assert_engine_parity(*out, lossy=codec != "identity")


@pytest.mark.parametrize("mode,engine", [("round", "sequential"), ("event", "sequential"),
                                         ("event", "batched")])
def test_fedasync_matches_reference(data, ref_fns, monkeypatch, mode, engine):
    """FedAsync's hinge mix on the three runtimes, with no runtime edit."""
    ref, res, seen, flat = run_pair(data, ref_fns, monkeypatch, mode=mode,
                                    algorithm="fedasync", engine=engine)
    if mode == "round":
        assert dataclasses.asdict(res.comm) == dataclasses.asdict(ref.comm)
        assert [r.selected for r in res.records] == [r.selected for r in ref.records]
        assert np.abs(flat[1] - flat[0]).max() <= 1e-4
    else:
        assert seen["ref"][1] and max(seen["ref"][1]) > 0      # stale uploads were mixed
        assert_engine_parity(ref, res, seen, flat)


@pytest.mark.parametrize("codecs", [{"compressor": "int8"}, {"broadcast_compressor": "int4"}])
def test_dense_codec_runs_match_reference(data, ref_fns, monkeypatch, codecs):
    out = run_pair(data, ref_fns, monkeypatch, algorithm="vafl", engine="batched", **codecs)
    ref, res = out[0], out[1]
    assert 0 < res.comm.uplink_bytes + res.comm.downlink_bytes < (
        (res.comm.model_uploads + res.comm.broadcasts) * res.comm.model_bytes)
    assert_engine_parity(*out, lossy=True)


# ------------------------------------------------ the engine contract ---

def _fed(data, device="cpu", **kw):
    fed, xte, yte = data
    return Federation(model=(tcnn.mlp_forward, tcnn.mlp_init, TCFG), data=fed,
                      test_data=(xte[:300], yte[:300]), local=tclient.LocalSpec(**SPEC),
                      device=device, **kw)


@pytest.mark.parametrize("codec", ["identity", "topk0.1_int8"])
@pytest.mark.parametrize("alg", ["afl", "vafl", "eaflm"])
def test_window1_buffer1_bitmatches_sequential(data, alg, codec):
    """The port's batched engine at max_batch=1, buffer_size=1 IS the
    port's sequential loop: CommStats, records (global_acc included) and
    idle fraction, on torch's own RNG."""
    fed = _fed(data, algorithm=alg, compressor=codec)
    seq = fed.run(rounds=ROUNDS, mode="event")
    bat = fed.run(rounds=ROUNDS, mode="event", engine="batched", max_batch=1, buffer_size=1)
    assert dataclasses.asdict(seq.comm) == dataclasses.asdict(bat.comm)
    assert ([(r.round, r.time, r.global_acc, r.uploads_so_far) for r in seq.records]
            == [(r.round, r.time, r.global_acc, r.uploads_so_far) for r in bat.records])
    assert seq.idle_fraction == bat.idle_fraction
    assert seq.client_uplink_bytes == bat.client_uplink_bytes


def test_batched_options_on_own_rng(data):
    """Every algorithm and codec of the slice runs on the batched engine;
    the eval cache leaves afl untouched (it never reads accuracies) and
    still gates vafl; windows spanning eval boundaries count them."""
    fed = _fed(data)
    for alg in ("afl", "vafl", "eaflm", "fedasync", "fedasync_poly", "fedasync_const"):
        for codec in ("identity", "topk0.1_int8", "int8", "int4"):
            res = fed.run(rounds=2, mode="event", engine="batched", max_batch=2,
                          buffer_size=2, algorithm=alg, compressor=codec)
            assert 0 <= res.records[-1].global_acc <= 1 and res.comm.model_uploads > 0
    afl = fed.run(rounds=2, mode="event", engine="batched", algorithm="afl")
    cached = fed.run(rounds=2, mode="event", engine="batched", algorithm="afl", eval_cache=3)
    assert vars(afl.comm) == vars(cached.comm)
    vafl = fed.run(rounds=4, mode="event", engine="batched", algorithm="vafl", eval_cache=2)
    assert vafl.comm.model_uploads < 4 * N
    wide = fed.run(rounds=2, mode="event", engine="batched", events_per_eval=2)
    assert [r.boundaries_crossed for r in wide.records] == [1, 2]


@pytest.mark.parametrize("field,value", [("shard_clients", True)])
def test_batched_rejects_unported_settings(data, field, value):
    fed = _fed(data)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fed.run(rounds=1, mode="event", engine="batched", **{field: value})


def test_batched_runs_on_cuda_unless_asked(data):
    if torch.cuda.is_available():
        assert _fed(data, device="cuda").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            _fed(data, device="cuda")


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


def _card_and_cpu(codec, **engine):
    """Batched vafl on the card and on the CPU from one initial model and
    one set of permutations: (result, grad_diff_norm launches, encode
    launches, final parameters) per device."""
    xtr, ytr, xte, yte = synthetic_mnist(600, 200, seed=1)
    data = iid_partition(xtr, ytr, 3, samples_per_client=160, seed=1)
    gen = np.random.RandomState(2)
    perms = {(i, ev): torch.from_numpy(gen.permutation(160)) for i in range(3)
             for ev in range(9)}
    cfg = tcnn.MLPConfig(hidden=(64,))
    init = tcnn.mlp_init(cfg, torch.Generator().manual_seed(3))
    out = {}
    for device in ("cuda", "cpu"):
        seen, windows = {}, []
        fed = Federation(model=(tcnn.mlp_forward, lambda c, g: init, cfg), data=data,
                         test_data=(xte, yte), algorithm="vafl", compressor=codec,
                         local=tclient.LocalSpec(32, 1, 1, 0.1), device=device)
        evaluate = fed.evaluate_fn

        def capture(p, evaluate=evaluate, seen=seen):
            seen["params"] = p
            return evaluate(p)
        fed.evaluate_fn = capture

        def perm_fn(i, ev, e, m, windows=windows):
            if not windows or windows[-1] != ev:
                windows.append(ev)
            return perms[(i, ev)]
        g0, t0 = gd_ops.launches, tq_ops.launches
        res = fed.run(rounds=3, mode="event", engine="batched", perm_fn=perm_fn, **engine)
        out[device] = (res, gd_ops.launches - g0, tq_ops.launches - t0, len(windows),
                       torch.cat([x.detach().cpu().ravel() for x in tree_leaves(seen["params"])]))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("engine", [{"max_batch": 0}, {"max_batch": 2, "buffer_size": 2}])
@pytest.mark.parametrize("codec", ["identity", "topk0.1_int8"])
def test_gpu_batched_matches_cpu_path(cuda, codec, engine):
    """The bounds of tests/test_torch_kernels.py::test_gpu_federation_matches_cpu_path;
    on the card grad_diff_norm launches once per window and the encode
    once per accepted upload, on the CPU neither launches."""
    out = _card_and_cpu(codec, **engine)
    (rg, gg, tg, wg, pg), (rc, gc, tc, wc, pc) = out["cuda"], out["cpu"]
    assert wg == wc == (3 if engine["max_batch"] == 0 else 5)
    assert (gg, gc) == (wg, 0) and tc == 0
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
def test_gpu_batched_reproducible_from_a_seed(cuda):
    """The batched engine on the card, twice from one seed in one
    process, on chip_smoke.py's federation (the CNN, 7 clients of 1,000
    samples, topk0.1_int8, gathered windows of 3 and K = 2): the same
    CommStats, ledgers, clock and final parameters, bit for bit."""
    from repro_torch.data.partition import paper_noniid_partition
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
        res = fed.run(rounds=3, mode="event", engine="batched", max_batch=3, buffer_size=2)
        runs.append((vars(res.comm), res.client_uplink_bytes, res.sim_time,
                     [r.uploads_so_far for r in res.records],
                     [x.detach().cpu() for x in tree_leaves(seen["params"])]))
    (c0, u0, s0, r0, p0), (c1, u1, s1, r1, p1) = runs
    assert (c0, u0, s0, r0) == (c1, u1, s1, r1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


@pytest.mark.gpu
def test_gpu_cnn_update_ignores_process_wide_tf32(cuda):
    """The full-width CNN's batched local update (3 clients, 2 SGD steps)
    and evaluator on the card under process-wide TF32 flags
    (``set_float32_matmul_precision("high")``, cuDNN's ``allow_tf32``):
    bit-equal to the same calls under the default flags, and the update
    within the card-vs-CPU bound (atol 1e-4) of the CPU route."""
    from repro_torch.common.pytree import tree_map
    cfg = tcnn.CNNConfig()
    init = tcnn.cnn_init(cfg, torch.Generator().manual_seed(3))
    rs = np.random.RandomState(5)
    x = rs.randn(3, 64, 28, 28).astype(np.float32)
    y = rs.randint(0, 10, (3, 64))
    xte, yte = rs.randn(100, 28, 28).astype(np.float32), rs.randint(0, 10, 100)
    upd = tclient.make_local_update(tclient.make_weighted_classifier_loss(tcnn.cnn_forward, cfg),
                                    tclient.LocalSpec(32, 1, 1, 0.1),
                                    perm_fn=lambda c, s, e, m: torch.arange(m))

    def run(device):
        stacked = tree_map(lambda a: torch.stack([a] * 3).to(device), init)
        data = {"images": torch.from_numpy(x).to(device),
                "labels": torch.from_numpy(y).to(device),
                "mask": torch.ones(3, 64, device=device)}
        evaluate = tclient.make_evaluator(tcnn.cnn_forward, cfg, xte, yte, batch=50,
                                          device=device)
        newp = upd(stacked, data, torch.Generator(device=device).manual_seed(0), 0)[0]
        return ([t.cpu() for t in tree_leaves(newp)],
                float(evaluate(tree_map(lambda a: a[0], newp))))

    plain = run("cuda")
    prev, prev_cudnn = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        tf32 = run("cuda")
    finally:
        torch.set_float32_matmul_precision(prev)
        torch.backends.cudnn.allow_tf32 = prev_cudnn
    cpu = run("cpu")
    assert all(torch.equal(a, b) for a, b in zip(plain[0], tf32[0])) and plain[1] == tf32[1]
    for a, b in zip(plain[0], cpu[0]):
        assert float((a - b).abs().max()) <= 1e-4, float((a - b).abs().max())
