"""repro_torch's run-state checkpoints (``repro_torch.checkpoint``) and
checkpoint-resume in all four runtimes, against repro on the CPU.

* The store: an interrupted write leaves the previous checkpoint
  intact; the run fingerprint equals the reference's field for field
  (apart from the schema), and a checkpoint of another shape raises
  ``CheckpointMismatchError`` naming the field; a bundle the reference
  wrote is refused; bf16 and fp32 leaves come back bit-equal, and host
  copies never alias the live tensors; the npz tree API keys trees as
  the reference does.
* Resume, modelled on tests/test_resilience.py's ``TestCheckpointResume``:
  a run checkpointed every k steps, then resumed from its last
  checkpoint, equals the port's uninterrupted run bit for bit (records
  with their accuracies, ``selected``, CommStats, byte ledgers, clock,
  final parameters).  With the reference's initial parameters and
  permutations injected it also equals the reference's uninterrupted
  run: CommStats, ``selected``, byte ledgers and ``sim_time`` bit for
  bit, parameters within the round runtime's bounds.  Cases: the
  sequential loop (and a resume that extends the budget), the batched
  engine in full windows and with a FedBuff buffer crossing the
  checkpoint under topk0.1_int8 with error feedback (and an extending
  resume, where the writer never popped a next window), the round
  runtime under a reactive scenario, and fedavg's barrier.

The tests marked ``gpu`` resume on the card, and hold a checkpointed
card run against the CPU path; they skip themselves on a host without a
Hopper card and nvcc.
"""
import dataclasses
import os
import pickle

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.checkpoint.store as jck  # noqa: E402
from repro.core import FLRunConfig as JConfig, client as jclient  # noqa: E402
from repro.core import run_event_driven as j_event, run_round_based as j_round  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.data.partition import iid_partition  # noqa: E402
from repro.data.synthetic import synthetic_mnist  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
import repro_torch.checkpoint.store as ck  # noqa: E402
from repro_torch.checkpoint import CheckpointMismatchError  # noqa: E402
from repro_torch.common.pytree import tree_leaves  # noqa: E402
from repro_torch.core import client as tclient  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core.config import FLRunConfig as TConfig  # noqa: E402
from repro_torch.core.federation import Federation  # noqa: E402
from repro_torch.core.runtimes import run_event_driven as t_event  # noqa: E402
from repro_torch.core.runtimes import run_round_based as t_round  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.grad_diff_norm import ops as gd_ops  # noqa: E402
from repro_torch.kernels.topk_quant import ops as tq_ops  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

N, SEED = 4, 0
SPEC = dict(batch_size=32, local_epochs=1, local_rounds=1, lr=0.1)
N_EP = SPEC["local_epochs"] * SPEC["local_rounds"]
JCFG, TCFG = jcnn.MLPConfig(hidden=(32,)), tcnn.MLPConfig(hidden=(32,))


@pytest.fixture(scope="module")
def data():
    xtr, ytr, xte, yte = synthetic_mnist(4000, 1000, seed=0)
    return iid_partition(xtr, ytr, N, samples_per_client=160, seed=0), xte, yte


@pytest.fixture(scope="module")
def ref_fns(data):
    _, xte, yte = data
    return (jclient.make_weighted_classifier_loss(jcnn.mlp_forward, JCFG),
            jclient.make_evaluator(jcnn.mlp_forward, JCFG, xte[:500], yte[:500], batch=500))


# ------------------------------------------------------------- the store ---

def _cfgs(**kw):
    base = dict(algorithm="vafl", num_clients=N, rounds=3, seed=7,
                compressor="topk0.1_int8", events_per_eval=N, engine="batched",
                max_batch=2, buffer_size=2)
    base.update(kw)
    return (JConfig(local=jclient.LocalSpec(**SPEC), **base),
            TConfig(local=tclient.LocalSpec(**SPEC), **base))


@pytest.mark.parametrize("model", ["mlp", "cnn"])
def test_fingerprint_matches_reference(model):
    """The port's fingerprint of the port's copy of the reference's
    initial model equals the reference's, field for field, apart from
    the schema; ``rounds`` stays out of it."""
    if model == "mlp":
        p = jcnn.mlp_init(JCFG, jax.random.key(0))
    else:
        p = jcnn.cnn_init(jcnn.CNNConfig(channels=(4, 8), num_blocks=1), jax.random.key(0))
    jcfg, tcfg = _cfgs()
    want = jck.run_fingerprint(jcfg, "batched", p)
    got = ck.run_fingerprint(tcfg, "batched", from_jax_params(jax.tree.map(np.asarray, p)))
    assert set(got) == set(want)
    for key in want:
        if key != "schema":
            assert got[key] == want[key], key
    assert got["schema"] == ck.RUN_CKPT_SCHEMA != want["schema"]
    assert "rounds" not in got
    assert ck.run_fingerprint(_cfgs(rounds=9)[1], "batched", from_jax_params(
        jax.tree.map(np.asarray, p))) == got


def test_model_spec_names_dtypes_as_numpy():
    tree = {"w": torch.zeros(2, 3), "h": torch.zeros(4, dtype=torch.bfloat16),
            "n": [torch.zeros((), dtype=torch.int64)]}
    assert ck.model_spec(tree) == [("h", (4,), "bfloat16"), ("n/0", (), "int64"),
                                   ("w", (2, 3), "float32")]
    np_tree = {"w": np.zeros((2, 3), np.float32), "n": [np.zeros((), np.int64)]}
    assert ck.model_spec({k: v for k, v in tree.items() if k != "h"}) == jck.model_spec(np_tree)


def test_save_is_atomic(tmp_path, monkeypatch):
    """A write cut off before its rename, or part-way through the pickle,
    leaves the previous checkpoint whole."""
    path = str(tmp_path / "run.ckpt")
    fp = {"schema": ck.RUN_CKPT_SCHEMA, "num_clients": 3}
    ck.save_run_state(path, {"event": 5, "w": np.arange(4)}, fp)

    def dead(*a, **k):
        raise KeyboardInterrupt("killed")
    monkeypatch.setattr(os, "replace", dead)
    with pytest.raises(KeyboardInterrupt):
        ck.save_run_state(path, {"event": 10, "w": np.arange(8)}, fp)
    monkeypatch.undo()
    st = ck.load_run_state(path, fp)
    assert st["event"] == 5 and st["w"].tolist() == [0, 1, 2, 3]

    def torn(obj, f, protocol=None):
        f.write(b"\x80\x05partial")
        raise KeyboardInterrupt("killed mid-write")
    monkeypatch.setattr(pickle, "dump", torn)
    with pytest.raises(KeyboardInterrupt):
        ck.save_run_state(path, {"event": 15}, fp)
    monkeypatch.undo()
    assert ck.load_run_state(path, fp)["event"] == 5
    ck.save_run_state(path, {"event": 20}, fp)
    assert ck.load_run_state(path, fp)["event"] == 20


def test_mismatch_names_every_field(tmp_path):
    path = str(tmp_path / "run.ckpt")
    fp = {"schema": ck.RUN_CKPT_SCHEMA, "num_clients": 3, "seed": 0}
    ck.save_run_state(path, {}, fp)
    with pytest.raises(CheckpointMismatchError) as e:
        ck.load_run_state(path, dict(fp, num_clients=4, seed=1))
    assert "num_clients" in str(e.value) and "seed" in str(e.value)
    assert issubclass(CheckpointMismatchError, ValueError)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int64"])
def test_leaves_round_trip_bit_equal(tmp_path, dtype):
    """Through ``tree_to_host``, a pickle on disk and ``tree_to_device``:
    every bit back, NaN payloads, -0.0, infinities and subnormals
    included (numpy has no bf16: its leaves travel as their uint16
    bits)."""
    dt = getattr(torch, dtype)
    if dt.is_floating_point:      # every bit pattern is a candidate
        ity = {2: np.int16, 4: np.int32}[dt.itemsize]
        bits = np.random.RandomState(0).randint(np.iinfo(ity).min, np.iinfo(ity).max, 4096,
                                                dtype=ity)
        x = torch.cat([torch.from_numpy(bits).view(dt),
                       torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan")],
                                    dtype=dt)])
    else:
        x = torch.arange(-5, 5, dtype=dt) * 2 ** 40
    tree = {"a": [x.reshape(-1, 1)], "b": x[:7]}
    path = str(tmp_path / "t.ckpt")
    ck.save_run_state(path, {"t": ck.tree_to_host(tree)}, {})
    back = ck.tree_to_device(ck.load_run_state(path, {})["t"], "cpu")
    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        width = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        assert torch.equal(a.view(width), b.view(width))
    assert ck.model_spec(back) == ck.model_spec(tree)


def test_host_copies_never_alias(tmp_path):
    """On the CPU ``Tensor.numpy()`` shares memory, and the batched engine
    writes its client stacks in place: a host tree taken before the
    write must keep the old values, and a restored tree must not share
    memory with the loaded bundle."""
    live = {"w": torch.zeros(3, 4)}
    host = ck.tree_to_host(live)
    live["w"].index_copy_(0, torch.tensor([1]), torch.ones(1, 4))
    assert host["w"].sum() == 0
    back = ck.tree_to_device(host, "cpu")
    back["w"].add_(5)
    assert host["w"].sum() == 0


def test_npz_tree_api_keys_as_reference(tmp_path):
    """``save_pytree`` keys leaves as the reference's flattening does, and
    ``load_pytree``/``restore``/``latest_step``/``load_state_dict`` bring
    them back; a scheduler snapshot round-trips through
    ``save_scheduler``/``restore_scheduler`` and pops on as the
    original does."""
    p = jcnn.cnn_init(jcnn.CNNConfig(channels=(4, 8), num_blocks=1), jax.random.key(1))
    tree = from_jax_params(jax.tree.map(np.asarray, p))
    ck.save_pytree(str(tmp_path / "port"), tree, {"step": 1})
    jck.save_pytree(str(tmp_path / "ref"), p)
    port_npz, ref_npz = np.load(tmp_path / "port.npz"), np.load(tmp_path / "ref.npz")
    assert sorted(port_npz.files) == sorted(ref_npz.files)
    for k in ref_npz.files:
        np.testing.assert_array_equal(port_npz[k], ref_npz[k])
    back = ck.load_pytree(str(tmp_path / "ref"), tree)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(tree)))
    ck.save(str(tmp_path / "d"), 3, tree)
    ck.save(str(tmp_path / "d"), 12, tree)
    assert ck.latest_step(str(tmp_path / "d")) == 12
    got, step = ck.restore(str(tmp_path / "d"), tree)
    assert step == 12 and all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                                tree_leaves(tree)))
    assert set(ck.load_state_dict(str(tmp_path / "port"))) == {
        k.split("/")[0] for k in ref_npz.files}
    assert ck.latest_step(str(tmp_path / "absent")) is None

    def sched():
        return tsched.EventScheduler(5, tsched.SpeedModel.paper_testbed(5, 3))
    s = sched()
    for _ in range(7):
        _, c = s.pop()
        s.schedule(c)
    ck.save_scheduler(str(tmp_path / "sched"), s)
    s2 = ck.restore_scheduler(str(tmp_path / "sched"), sched())
    assert [s.pop() for _ in range(4)] == [s2.pop() for _ in range(4)]


@pytest.mark.parametrize("kw", [dict(checkpoint_every=-1, checkpoint_path="x"),
                                dict(checkpoint_every=3), dict(resume=True)])
def test_config_validates_checkpoint_fields(kw):
    """The reference's three checks (``repro.core.config``)."""
    for cfg in (JConfig, TConfig):
        with pytest.raises(ValueError):
            cfg(**kw)


# ---------------------------------------------------------- whole runs ---

def _ref_perms(m, schedule):
    """The reference's permutations keyed as the port's perm_fn asks for
    them, (client, step, epoch), from its steps: (step, clients in draw
    order) per round, event or window (tests/test_torch_batched.py)."""
    rng, _ = jax.random.split(jax.random.key(SEED))
    perms = {}
    for step, clients in schedule:
        rng, urng = jax.random.split(rng)
        for c, ckey in zip(clients, jax.random.split(urng, len(clients))):
            for e, ek in enumerate(jax.random.split(ckey, N_EP + 1)[:N_EP]):
                perms[(int(c), step, e)] = np.asarray(
                    jax.random.permutation(ek, m)).astype(np.int64)
    return perms


def _reference(data, ref_fns, monkeypatch, mode, cfg):
    """The reference's uninterrupted run; returns (result, its initial
    parameters, the permutations it drew, its final parameters)."""
    fed, _, _ = data
    jloss, jeval = ref_fns
    seen, pops = {}, []

    def pop(self, _orig=jsched.EventScheduler.pop):
        out = _orig(self)
        pops.append([out[1]])
        return out

    def pop_window(self, k, _orig=jsched.EventScheduler.pop_window):
        times, ids = _orig(self, k)
        pops.append(ids.tolist())
        return times, ids
    monkeypatch.setattr(jsched.EventScheduler, "pop", pop)
    monkeypatch.setattr(jsched.EventScheduler, "pop_window", pop_window)

    def jinit(k):
        p = jcnn.mlp_init(JCFG, k)
        seen["init"] = jax.tree.map(np.asarray, p)
        return p

    def jeval_capture(p):
        seen["final"] = jax.tree.map(np.asarray, p)
        return jeval(p)

    run = j_round if mode == "round" else j_event
    ref = run(JConfig(local=jclient.LocalSpec(**SPEC), **cfg), init_params_fn=jinit,
              loss_fn=jloss, fed_data=fed, evaluate_fn=jeval_capture, client_eval_fn=jeval)
    monkeypatch.undo()
    m = fed.labels.shape[1]
    if mode == "round" or cfg.get("algorithm") == "fedavg":
        schedule = [(t, range(N)) for t in range(1, cfg["rounds"] + 1)]
    else:
        starts = np.cumsum([0] + [len(ids) for ids in pops])
        schedule = [(int(s), ids) for s, ids in zip(starts, pops)]
    flat = np.concatenate([np.ravel(x) for x in jax.tree.leaves(seen["final"])])
    return ref, seen["init"], _ref_perms(m, schedule), flat


def _port(data, mode, cfg, init, perms, device="cpu"):
    """One port run from the reference's initial model and permutations;
    returns (result, final parameters as one flat CPU tensor)."""
    fed, xte, yte = data
    teval = tclient.make_evaluator(tcnn.mlp_forward, TCFG, xte[:500], yte[:500], batch=500,
                                   device=device)
    seen = {}

    def teval_capture(p):
        seen["final"] = p
        return teval(p)
    run = t_round if mode == "round" else t_event
    res = run(TConfig(local=tclient.LocalSpec(**SPEC), **cfg),
              init_params_fn=lambda g: from_jax_params(init),
              loss_fn=tclient.make_weighted_classifier_loss(tcnn.mlp_forward, TCFG),
              fed_data=fed, evaluate_fn=teval_capture, client_eval_fn=teval, device=device,
              perm_fn=lambda i, step, e, _: torch.from_numpy(perms[(i, step, e)]))
    if "final" not in seen:
        # the resumed part evaluated nothing new: the batched engine
        # reused the last accuracy, so the model is the bundle's
        seen["final"] = ck.tree_to_device(
            ck.load_run_state(cfg["checkpoint_path"], ck.run_fingerprint(
                TConfig(local=tclient.LocalSpec(**SPEC), **cfg), "batched",
                from_jax_params(init)))["global_params"], "cpu")
    return res, torch.cat([x.detach().cpu().ravel() for x in tree_leaves(seen["final"])])


def _everything(res):
    """Every number a run leaves, accuracies included (the bit-equality
    surface of a resume)."""
    return ([(r.round, r.time, r.global_acc, r.uploads_so_far, r.selected, r.values,
              r.client_accs, r.boundaries_crossed) for r in res.records],
            dataclasses.asdict(res.comm), res.sim_time, res.idle_fraction, res.client_idle,
            res.client_uplink_bytes, res.client_downlink_bytes, res.client_failed_rounds)


def assert_matches_reference(ref, res, ref_flat, flat, lossy):
    assert dataclasses.asdict(res.comm) == dataclasses.asdict(ref.comm)
    for field in ("sim_time", "idle_fraction", "client_uplink_bytes", "client_downlink_bytes",
                  "client_failed_rounds"):
        assert getattr(res, field) == getattr(ref, field), field
    assert ([(r.round, r.time, r.uploads_so_far, r.selected) for r in res.records]
            == [(r.round, r.time, r.uploads_so_far, r.selected) for r in ref.records])
    diff = np.abs(flat.numpy() - ref_flat)
    if not lossy:
        assert diff.max() <= 1e-4, diff.max()
    else:
        assert (diff > 1e-4).mean() <= 1e-3 and diff.max() <= 1e-3, diff.max()


RESUME_CASES = {   # name -> (mode, config, checkpoint_every, the writer's rounds)
    "sequential vafl": ("event", dict(algorithm="vafl", rounds=3), 5, 3),
    "sequential afl, extended": ("event", dict(algorithm="afl", rounds=3), 4, 2),
    "batched vafl full windows": ("event", dict(algorithm="vafl", rounds=3,
                                                engine="batched"), 8, 3),
    "batched afl topk EF buffer": ("event", dict(algorithm="afl", rounds=3, engine="batched",
                                                 max_batch=3, buffer_size=2,
                                                 compressor="topk0.1_int8"), 7, 3),
    "batched vafl, extended": ("event", dict(algorithm="vafl", rounds=3, engine="batched",
                                             max_batch=2, buffer_size=3), 4, 2),
    "rounds vafl flaky_edge": ("round", dict(algorithm="vafl", rounds=4,
                                             scenario="flaky_edge", participation=0.75,
                                             compressor="topk0.1_int8"), 3, 4),
    "barrier fedavg": ("event", dict(algorithm="fedavg", rounds=4, participation=0.75,
                                     compressor="topk0.1_int8"), 3, 4),
}


@pytest.mark.parametrize("name", list(RESUME_CASES))
def test_resume_bit_equal(data, ref_fns, monkeypatch, tmp_path, name):
    mode, cfg, every, writer_rounds = RESUME_CASES[name]
    cfg = dict(num_clients=N, seed=SEED, events_per_eval=N, **cfg)
    ref, init, perms, ref_flat = _reference(data, ref_fns, monkeypatch, mode, cfg)
    path = str(tmp_path / "run.ckpt")
    whole, whole_flat = _port(data, mode, cfg, init, perms)
    mid, mid_flat = _port(data, mode, dict(cfg, rounds=writer_rounds, checkpoint_path=path,
                                           checkpoint_every=every), init, perms)
    with open(path, "rb") as f:
        state = pickle.load(f)["state"]
    unit = "round" if "round" in state else "event"
    total = cfg["rounds"] * (1 if unit == "round" else N)
    assert 0 < state[unit] < total        # the resumed part is not empty
    if writer_rounds == cfg["rounds"]:
        # checkpointing never perturbs the run
        assert _everything(mid) == _everything(whole) and torch.equal(mid_flat, whole_flat)
    res, flat = _port(data, mode, dict(cfg, checkpoint_path=path, resume=True), init, perms)
    assert _everything(res) == _everything(whole)
    assert torch.equal(flat, whole_flat)
    assert_matches_reference(ref, res, ref_flat, flat, lossy=cfg.get("compressor") is not None)
    if cfg.get("compressor") and cfg["algorithm"] != "vafl":
        assert state["ef"], "the bundle carries the error-feedback residuals"
    if name.startswith("batched afl"):
        assert state["buffer"], "a FedBuff buffer crosses the checkpoint"
    if name == "batched vafl, extended":
        assert state["nxt"] is None       # the writer's budget ended there


def test_resume_without_file_starts_fresh(data, tmp_path):
    fed, xte, yte = data
    f = Federation(model=(tcnn.mlp_forward, tcnn.mlp_init, TCFG), data=fed,
                   test_data=(xte[:200], yte[:200]), local=tclient.LocalSpec(**SPEC),
                   device="cpu")
    ref = f.run(rounds=1, mode="event", algorithm="afl")
    res = f.run(rounds=1, mode="event", algorithm="afl",
                checkpoint_path=str(tmp_path / "absent.ckpt"), resume=True)
    assert _everything(res) == _everything(ref)


def test_mismatched_run_is_refused(data, tmp_path):
    """A checkpoint of another seed, another client count or another
    model shape raises, naming the field."""
    fed, xte, yte = data
    path = str(tmp_path / "run.ckpt")

    def fed_of(n, hidden):
        cfg = tcnn.MLPConfig(hidden=hidden)
        return Federation(model=(tcnn.mlp_forward, tcnn.mlp_init, cfg),
                          data=iid_partition(*synthetic_mnist(1000, 100, seed=0)[:2], n,
                                             samples_per_client=100, seed=0),
                          test_data=(xte[:100], yte[:100]), local=tclient.LocalSpec(**SPEC),
                          device="cpu")
    fed_of(N, (32,)).run(rounds=1, mode="event", algorithm="afl", checkpoint_path=path,
                         checkpoint_every=2)
    for f, kw, field in ((fed_of(N, (32,)), dict(seed=8), "seed"),
                         (fed_of(N + 1, (32,)), {}, "num_clients"),
                         (fed_of(N, (16,)), {}, "model")):
        with pytest.raises(CheckpointMismatchError, match=field):
            f.run(rounds=1, mode="event", algorithm="afl", checkpoint_path=path,
                  resume=True, **kw)


def test_reference_bundle_is_refused(data, ref_fns, tmp_path):
    """A checkpoint the JAX reference wrote is never resumed: its records
    are the reference's classes, refused before they are imported, and
    a bundle without one fails on its schema."""
    fed, xte, yte = data
    jloss, jeval = ref_fns
    path = str(tmp_path / "ref.ckpt")
    j_event(JConfig(algorithm="afl", num_clients=N, rounds=1, events_per_eval=2,
                    local=jclient.LocalSpec(**SPEC), checkpoint_path=path, checkpoint_every=2),
            init_params_fn=lambda k: jcnn.mlp_init(JCFG, k), loss_fn=jloss, fed_data=fed,
            evaluate_fn=jeval)
    f = Federation(model=(tcnn.mlp_forward, tcnn.mlp_init, TCFG), data=fed,
                   test_data=(xte[:200], yte[:200]), local=tclient.LocalSpec(**SPEC),
                   device="cpu", events_per_eval=2)
    with pytest.raises(CheckpointMismatchError, match="JAX reference"):
        f.run(rounds=1, mode="event", algorithm="afl", checkpoint_path=path, resume=True)
    bare = str(tmp_path / "bare.ckpt")
    jck.save_run_state(bare, {"event": 2, "rng": np.zeros(2, np.uint32)},
                       {"schema": jck.RUN_CKPT_SCHEMA})
    with pytest.raises(CheckpointMismatchError, match="fl-run-ckpt/v1"):
        ck.load_run_state(bare, {})


def test_resumed_obs_counters_continue(data, tmp_path):
    """Obs counters and histograms ride in the bundle: a resumed run's
    final registry equals the uninterrupted run's (apart from the
    checkpoint/resume counters and the resumed trace's own length)."""
    fed, xte, yte = data
    f = Federation(model=(tcnn.mlp_forward, tcnn.mlp_init, TCFG), data=fed,
                   test_data=(xte[:200], yte[:200]), local=tclient.LocalSpec(**SPEC),
                   device="cpu", obs=True)
    path = str(tmp_path / "run.ckpt")
    kw = dict(rounds=3, mode="event", engine="batched", max_batch=3, buffer_size=2,
              compressor="topk0.1_int8")
    whole = f.run(checkpoint_path=path, checkpoint_every=7, **kw)
    res = f.run(checkpoint_path=path, resume=True, **kw)
    skip = {"checkpoints", "resumes", "trace_events"}
    a = {k: v for k, v in whole.metrics["counters"].items() if k not in skip}
    b = {k: v for k, v in res.metrics["counters"].items() if k not in skip}
    assert a == b and a["uploads"] == whole.comm.model_uploads
    assert res.metrics["histograms"] == whole.metrics["histograms"]
    assert whole.metrics["counters"]["checkpoints"] == 1
    assert res.metrics["counters"]["resumes"] == 1


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
@pytest.mark.parametrize("name", list(RESUME_CASES))
def test_gpu_resume_bit_equal(cuda, data, ref_fns, monkeypatch, tmp_path, name):
    """Each runtime's resume on the card: bit-equal to the card's
    uninterrupted run (the run generator's CUDA state, seed and Philox
    offset, rides in the bundle), and the kernels launch over the
    resumed part exactly as often as the uninterrupted run launched
    them from the checkpoint on."""
    mode, cfg, every, writer_rounds = RESUME_CASES[name]
    cfg = dict(num_clients=N, seed=SEED, events_per_eval=N, **cfg)
    _, init, perms, _ = _reference(data, ref_fns, monkeypatch, mode, cfg)
    path = str(tmp_path / "run.ckpt")
    g0, t0 = gd_ops.launches, tq_ops.launches
    whole, whole_flat = _port(data, mode, cfg, init, perms, device="cuda")
    whole_launches = (gd_ops.launches - g0, tq_ops.launches - t0)
    at_save = []
    orig = ck.save_run_state

    def counting(*a, **k):
        at_save.append((gd_ops.launches, tq_ops.launches))
        return orig(*a, **k)
    monkeypatch.setattr(ck, "save_run_state", counting)
    g1, t1 = gd_ops.launches, tq_ops.launches
    _port(data, mode, dict(cfg, rounds=writer_rounds, checkpoint_path=path,
                           checkpoint_every=every), init, perms, device="cuda")
    monkeypatch.undo()
    before = (at_save[-1][0] - g1, at_save[-1][1] - t1)
    g2, t2 = gd_ops.launches, tq_ops.launches
    res, flat = _port(data, mode, dict(cfg, checkpoint_path=path, resume=True), init, perms,
                      device="cuda")
    resumed = (gd_ops.launches - g2, tq_ops.launches - t2)
    assert _everything(res) == _everything(whole)
    assert torch.equal(flat, whole_flat)
    if writer_rounds == cfg["rounds"]:
        assert resumed == (whole_launches[0] - before[0], whole_launches[1] - before[1])
    if cfg["algorithm"] == "vafl" or cfg.get("compressor"):
        assert sum(whole_launches) > 0


@pytest.mark.gpu
def test_gpu_checkpointed_run_matches_cpu_path(cuda, data, ref_fns, monkeypatch, tmp_path):
    """A checkpointed and resumed batched run on the card against the same
    run on the CPU: the same CommStats, ledgers and clock, and close
    final models (the card-vs-CPU bounds of tests/test_torch_batched.py)."""
    mode, cfg, every, _ = RESUME_CASES["batched afl topk EF buffer"]
    cfg = dict(num_clients=N, seed=SEED, events_per_eval=N, **cfg)
    _, init, perms, _ = _reference(data, ref_fns, monkeypatch, mode, cfg)
    out = {}
    for device in ("cuda", "cpu"):
        path = str(tmp_path / f"{device}.ckpt")
        _port(data, mode, dict(cfg, checkpoint_path=path, checkpoint_every=every), init, perms,
              device=device)
        out[device] = _port(data, mode, dict(cfg, checkpoint_path=path, resume=True), init,
                            perms, device=device)
    (rg, pg), (rc, pc) = out["cuda"], out["cpu"]
    assert vars(rg.comm) == vars(rc.comm)
    for field in ("client_uplink_bytes", "client_downlink_bytes", "sim_time", "client_idle"):
        assert getattr(rg, field) == getattr(rc, field), field
    diff = (pg - pc).abs()
    assert float((diff > 1e-4).float().mean()) <= 1e-3 and float(diff.max()) <= 1e-3
