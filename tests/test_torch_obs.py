"""repro_torch's observability (``repro_torch.obs``), against repro on
the CPU; modelled on tests/test_obs.py.

* The trace is the run: on all four runtimes (the round runtime, the
  sequential loop, the batched engine, fedavg's barrier) span and event
  counts reconcile with ``CommStats``, and the metrics registry agrees.
* Obs on is bit-exact: every number a run produces is the same with
  obs on and off.
* The port's trace is the reference's: with the reference's initial
  parameters and permutations injected, its JSONL trace stripped of the
  host timeline (``host``, ``host_dur``) equals the reference's event
  for event, and its counters and histograms equal the reference's
  (gauges too, apart from ``jit_compiles``, which counts what each
  package compiles), in each runtime, under scenarios whose
  availability model fails rounds, and under codecs whose encodes are
  spans.
* The unit layer (registry, tracer, exporters, JSONL, ``resolve_obs``,
  the sampler) behaves as the reference's, ``to_summary`` has the
  reference's keys, ``jit_compiles`` counts the port's kernel builds
  (a rerun builds nothing), and ``torch_profile`` writes a trace.

The tests marked ``gpu`` hold obs on bit-exact on the card and check a
rerun builds nothing there; they skip themselves on a host without a
Hopper card and nvcc.
"""
import dataclasses
import json
import os
import stat

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.obs as jobs  # noqa: E402
from repro.core import FLRunConfig as JConfig, client as jclient  # noqa: E402
from repro.core import run_event_driven as j_event, run_round_based as j_round  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core.metrics import RunResult as JRunResult  # noqa: E402
from repro.data.partition import iid_partition  # noqa: E402
from repro.data.synthetic import synthetic_mnist  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro_torch.core import client as tclient  # noqa: E402
from repro_torch.core.config import FLRunConfig as TConfig  # noqa: E402
from repro_torch.core.federation import Federation  # noqa: E402
from repro_torch.core.metrics import CommStats, RunResult  # noqa: E402
from repro_torch.core.runtimes import run_event_driven as t_event  # noqa: E402
from repro_torch.core.runtimes import run_round_based as t_round  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.obs import compile_tracking  # noqa: E402
from repro_torch.obs.live import MetricsSampler  # noqa: E402
from repro_torch.obs.exporters import (chrome_trace_events, console_summary,  # noqa: E402
                                       write_chrome_trace, write_jsonl)
from repro_torch.obs.metrics import Histogram  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

N, SEED = 4, 0
SPEC = dict(batch_size=32, local_epochs=1, local_rounds=1, lr=0.1)
N_EP = SPEC["local_epochs"] * SPEC["local_rounds"]
JCFG, TCFG = jcnn.MLPConfig(hidden=(32,)), tcnn.MLPConfig(hidden=(32,))

# the four runtimes as (name, algorithm, run overrides)
RUNTIMES = [
    ("rounds", "vafl", dict(mode="round")),
    ("events", "vafl", dict(mode="event")),
    ("batched", "vafl", dict(mode="event", engine="batched", max_batch=3, buffer_size=2)),
    ("sync", "fedavg", dict(mode="event")),
]


@pytest.fixture(scope="module")
def data():
    xtr, ytr, xte, yte = synthetic_mnist(4000, 1000, seed=0)
    return iid_partition(xtr, ytr, N, samples_per_client=160, seed=0), xte, yte


@pytest.fixture(scope="module")
def ref_fns(data):
    _, xte, yte = data
    return (jclient.make_weighted_classifier_loss(jcnn.mlp_forward, JCFG),
            jclient.make_evaluator(jcnn.mlp_forward, JCFG, xte[:500], yte[:500], batch=500))


@pytest.fixture(scope="module")
def fed(data):
    fed_data, xte, yte = data
    return Federation(model=(tcnn.mlp_forward, tcnn.mlp_init, TCFG), data=fed_data,
                      test_data=(xte[:300], yte[:300]), local=tclient.LocalSpec(**SPEC),
                      device="cpu", rounds=3, target_acc=0.99)


def _numeric(res):
    """Everything numeric a run produces (the bit-exactness surface)."""
    return ([(r.round, r.time, r.global_acc, r.uploads_so_far, r.selected, r.values,
              r.client_accs, r.boundaries_crossed) for r in res.records],
            dataclasses.asdict(res.comm), res.sim_time, res.idle_fraction, res.client_idle,
            res.client_uplink_bytes, res.client_downlink_bytes, res.client_failed_rounds)


def _traced(fed, alg, kw, tmp_path, tag, **more):
    path = str(tmp_path / f"{tag}.jsonl")
    kw = dict(kw, **more)
    res = fed.run(algorithm=alg, obs=tobs.ObsConfig(trace_jsonl=path), **kw)
    header, events = tobs.read_jsonl(path)
    return res, header, events


# --------------------------------------------- trace <-> CommStats ---

@pytest.mark.parametrize("name,alg,kw", RUNTIMES, ids=[r[0] for r in RUNTIMES])
def test_trace_counts_match_commstats(fed, tmp_path, name, alg, kw):
    res, header, events = _traced(fed, alg, kw, tmp_path, name)
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append(e)
    uploads = by.get("upload", [])
    assert len(uploads) == res.comm.model_uploads
    assert sum(e["nbytes"] for e in uploads) == res.comm.upload_payload_bytes
    assert sum(e["n"] for e in by.get("report", [])) == res.comm.scalar_reports
    bcasts = by.get("broadcast", [])
    assert sum(e["n"] for e in bcasts) == res.comm.broadcasts
    assert sum(e["nbytes"] for e in bcasts) == res.comm.downlink_bytes
    evals = by.get("eval", [])
    assert len(evals) == len(res.records)
    assert sum(e["boundaries"] for e in evals) == sum(r.boundaries_crossed for r in res.records)
    c = res.metrics["counters"]
    assert c["uploads"] == res.comm.model_uploads
    assert c.get("upload_payload_bytes", 0) == res.comm.upload_payload_bytes
    assert c.get("scalar_reports", 0) == res.comm.scalar_reports
    assert c.get("broadcasts", 0) == res.comm.broadcasts
    assert c["evals"] == len(res.records)
    assert c["trace_events"] == len(events) == header["events"]
    for e in uploads:
        assert e["client"] in range(N) and e["staleness"] >= 0 and e["nbytes"] > 0
        assert e["codec"] == "identity" and "sim" in e and "host" in e
    # the uplink ledger: payloads plus 4-byte scalar reports
    assert res.comm.uplink_bytes == (sum(e["nbytes"] for e in uploads)
                                     + 4 * sum(e["n"] for e in by.get("report", [])))


def test_staleness_windows_and_flushes_traced(fed, tmp_path):
    res, _, events = _traced(fed, "vafl", dict(mode="event", engine="batched", max_batch=3,
                                               buffer_size=3), tmp_path, "stale", rounds=4)
    stale = [e["staleness"] for e in events if e["name"] == "upload"]
    assert stale and max(stale) > 0
    h = res.metrics["histograms"]["staleness"]
    assert h["count"] == len(stale) and h["max"] == max(stale)
    windows = [e for e in events if e["name"] == "window"]
    flushes = [e for e in events if e["name"] == "flush"]
    assert windows and all(e["ph"] == "X" and e["size"] >= 1 for e in windows)
    assert flushes and all(e["k"] >= 1 for e in flushes)
    assert res.metrics["counters"]["windows"] == len(windows)
    assert res.metrics["counters"]["flushes"] == len(flushes)


# -------------------------------------------------- bit-exactness ---

@pytest.mark.parametrize("name,alg,kw", RUNTIMES, ids=[r[0] for r in RUNTIMES])
def test_obs_on_is_bit_exact(fed, name, alg, kw):
    extra = dict(compressor="topk0.1_int8", scenario="flaky_edge")
    off = fed.run(algorithm=alg, **kw, **extra)
    on = fed.run(algorithm=alg, obs=True, **kw, **extra)
    assert _numeric(off) == _numeric(on)
    assert off.metrics is None and off.trace_path is None
    assert set(on.metrics) == {"counters", "gauges", "histograms"}


def test_deterministic_trace(fed, tmp_path):
    kw = dict(mode="event", engine="batched", max_batch=3, buffer_size=2)
    _, _, ev1 = _traced(fed, "vafl", kw, tmp_path, "det1")
    _, _, ev2 = _traced(fed, "vafl", kw, tmp_path, "det2")
    assert _strip_host(ev1) == _strip_host(ev2)


# ----------------------------------------- the reference's trace ---

def _strip_host(events):
    return [{k: v for k, v in e.items() if k not in ("host", "host_dur")} for e in events]


def _ref_perms(m, schedule):
    """(client, step, epoch) -> the reference's permutation
    (tests/test_torch_batched.py)."""
    rng, _ = jax.random.split(jax.random.key(SEED))
    perms = {}
    for step, clients in schedule:
        rng, urng = jax.random.split(rng)
        for c, ckey in zip(clients, jax.random.split(urng, len(clients))):
            for e, ek in enumerate(jax.random.split(ckey, N_EP + 1)[:N_EP]):
                perms[(int(c), step, e)] = np.asarray(
                    jax.random.permutation(ek, m)).astype(np.int64)
    return perms


TRACE_CASES = {   # name -> (mode, config)
    "rounds vafl": ("round", dict(algorithm="vafl")),
    "rounds vafl flaky_edge topk": ("round", dict(algorithm="vafl", scenario="flaky_edge",
                                                  participation=0.75,
                                                  compressor="topk0.1_int8")),
    "events vafl": ("event", dict(algorithm="vafl")),
    "events afl flaky_edge topk": ("event", dict(algorithm="afl", scenario="flaky_edge",
                                                 compressor="topk0.1_int8")),
    "batched vafl": ("event", dict(algorithm="vafl", engine="batched", max_batch=3,
                                   buffer_size=2)),
    "batched afl topk, int8 broadcast": ("event", dict(
        algorithm="afl", engine="batched", max_batch=3, buffer_size=2,
        compressor="topk0.1_int8", broadcast_compressor="int8")),
    "batched vafl full windows mobile_fleet": ("event", dict(
        algorithm="vafl", engine="batched", scenario="mobile_fleet", eval_cache=2)),
    "sync fedavg": ("event", dict(algorithm="fedavg")),
    "sync fedavg flaky_edge topk": ("event", dict(algorithm="fedavg", scenario="flaky_edge",
                                                  compressor="topk0.1_int8")),
}


@pytest.mark.parametrize("name", list(TRACE_CASES))
def test_trace_equals_reference(data, ref_fns, monkeypatch, tmp_path, name):
    mode, cfg = TRACE_CASES[name]
    fed_data, xte, yte = data
    jloss, jeval = ref_fns
    cfg = dict(num_clients=N, rounds=3, seed=SEED, events_per_eval=N, **cfg)
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
    jpath, tpath = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")
    run = j_round if mode == "round" else j_event
    ref = run(JConfig(local=jclient.LocalSpec(**SPEC), obs=jobs.ObsConfig(trace_jsonl=jpath),
                      **cfg),
              init_params_fn=jinit, loss_fn=jloss, fed_data=fed_data, evaluate_fn=jeval)
    monkeypatch.undo()
    if mode == "round" or cfg["algorithm"] == "fedavg":
        schedule = [(t, range(N)) for t in range(1, cfg["rounds"] + 1)]
    else:
        starts = np.cumsum([0] + [len(ids) for ids in pops])
        schedule = [(int(s), ids) for s, ids in zip(starts, pops)]
    perms = _ref_perms(fed_data.labels.shape[1], schedule)
    teval = tclient.make_evaluator(tcnn.mlp_forward, TCFG, xte[:500], yte[:500], batch=500)
    run = t_round if mode == "round" else t_event
    res = run(TConfig(local=tclient.LocalSpec(**SPEC), obs=tobs.ObsConfig(trace_jsonl=tpath),
                      **cfg),
              init_params_fn=lambda g: from_jax_params(seen["init"]),
              loss_fn=tclient.make_weighted_classifier_loss(tcnn.mlp_forward, TCFG),
              fed_data=fed_data, evaluate_fn=teval, device="cpu",
              perm_fn=lambda i, step, e, _: torch.from_numpy(perms[(i, step, e)]))
    jhead, jev = tobs.read_jsonl(jpath)
    thead, tev = tobs.read_jsonl(tpath)
    assert thead == jhead
    assert len(tev) == len(jev)
    for k, (a, b) in enumerate(zip(_strip_host(tev), _strip_host(jev))):
        assert a == b, (k, a, b)
    assert res.metrics["counters"] == ref.metrics["counters"]
    assert res.metrics["histograms"] == ref.metrics["histograms"]
    skip = {"jit_compiles"}
    assert ({k: v for k, v in res.metrics["gauges"].items() if k not in skip}
            == {k: v for k, v in ref.metrics["gauges"].items() if k not in skip})
    names = {e["name"] for e in tev}
    if "flaky_edge" in name:
        assert "failure" in names
    if "topk" in name:
        assert "encode" in names
    if "int8 broadcast" in name:
        assert any(e["name"] == "encode" and e.get("broadcast") for e in tev)


# --------------------------------------------- federation surface ---

def test_obs_reaches_every_runtime_through_the_facade(data, tmp_path):
    """``Federation(obs=...)`` reaches the round runtime as well as the
    event runtimes (the config carries it), and a per-run override
    turns it off."""
    fed_data, xte, yte = data
    path = str(tmp_path / "fed.jsonl")
    f = Federation(model=(tcnn.mlp_forward, tcnn.mlp_init, TCFG), data=fed_data,
                   test_data=(xte[:200], yte[:200]), local=tclient.LocalSpec(**SPEC),
                   device="cpu", obs=tobs.ObsConfig(trace_jsonl=path))
    assert isinstance(f.config.obs, tobs.ObsConfig)
    for mode in ("round", "event"):
        res = f.run(rounds=1, mode=mode)
        assert res.trace_path == path and os.path.exists(path)
        assert "jit_compiles" in res.metrics["gauges"]
    off = f.run(rounds=1, mode="round", obs=None)
    assert off.metrics is None and off.trace_path is None
    assert tobs.read_jsonl(path)[0]["meta"]["num_clients"] == N
    assert TConfig(obs={"max_events": 7}).obs.max_events == 7


def test_to_summary_keys_match_reference(fed):
    res = fed.run(mode="event", algorithm="vafl", obs=True)
    s = res.to_summary()
    want = JRunResult("vafl", [], res.comm, 0.9).to_summary()
    assert set(s) == set(want)
    assert s["staleness_p95"] == jobs.snapshot_percentile(
        res.metrics["histograms"]["staleness"], 95)
    assert RunResult("afl", [], CommStats(), 0.9).to_summary()["staleness_p95"] is None


def test_second_run_compiles_nothing(fed):
    """The zero-rebuild contract: a second identical run in one process
    reads ``jit_compiles == 0`` (nothing is built on the CPU at all)."""
    first = fed.run(mode="event", engine="batched", max_batch=3, algorithm="vafl", obs=True)
    second = fed.run(mode="event", engine="batched", max_batch=3, algorithm="vafl", obs=True)
    assert second.metrics["gauges"]["jit_compiles"] == 0
    assert _numeric(first) == _numeric(second)


def test_kernel_builds_are_counted(tmp_path, monkeypatch):
    """``kernels.build.build`` reports each finished build to
    ``compile_tracking`` (the ``jit_compiles`` gauge): one count a
    kernel built, none for a kernel already built.  Driven here with a
    stand-in compiler that writes its output file."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then "
                    "shift; echo built > \"$1\"; fi; shift; done\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(build, "require_hopper", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    obs = tobs.Observer(tobs.ObsConfig())
    c0, s0 = compile_tracking.compile_count(), compile_tracking.compile_secs()
    build.build(("grad_diff_norm", "topk_quant"))
    assert compile_tracking.compile_count() - c0 == 2
    assert compile_tracking.compile_secs() >= s0
    build.build(("grad_diff_norm",))      # already built: nothing to count
    assert compile_tracking.compile_count() - c0 == 2
    assert obs.finish()["gauges"]["jit_compiles"] == 2
    tobs.install()
    tobs.install()                         # idempotent


def test_torch_profile_writes_a_trace(fed, tmp_path):
    """``ObsConfig(torch_profile=dir)``: the batched engine's hot loop runs
    under ``torch.profiler`` and its Chrome trace lands in ``dir``; the
    numbers do not move."""
    d = str(tmp_path / "prof")
    kw = dict(mode="event", engine="batched", algorithm="afl", rounds=1)
    res = fed.run(obs=tobs.ObsConfig(torch_profile=d), **kw)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(d, files[0])) as f:
        doc = json.load(f)
    assert doc["traceEvents"]
    assert _numeric(res) == _numeric(fed.run(**kw))


def test_sampler_runs_beside_the_hot_loop(fed):
    res = fed.run(mode="event", engine="batched", algorithm="afl", rounds=1,
                  obs=tobs.ObsConfig(sample_interval=0.001, sample_capacity=4))
    assert 2 <= res.metrics["gauges"]["metric_samples"] <= 4


# ------------------------------------------------------ unit layer ---

def test_registry_matches_reference():
    """The same calls on both registries give the same snapshot and the
    same percentiles; a restored registry snapshots as the original."""
    regs = (jobs.MetricsRegistry(), tobs.MetricsRegistry())
    rs = np.random.RandomState(3)
    vals = np.concatenate([rs.exponential(40, 200), [0, 1, 2, 3, 4, 5, 1000, -2]]).tolist()
    for reg in regs:
        reg.counter("c").inc(3)
        reg.gauge("g").set(1.5)
        for v in vals:
            reg.hist("h").observe(v)
    a, b = (r.snapshot() for r in regs)
    assert a == b
    json.dumps(b)
    for q in (0, 5, 50, 95, 99, 100):
        assert (tobs.snapshot_percentile(b["histograms"]["h"], q)
                == jobs.snapshot_percentile(a["histograms"]["h"], q)
                == regs[1].hist("h").percentile(q))
    back = tobs.MetricsRegistry()
    back.restore(b)
    assert back.snapshot() == b
    with pytest.raises(TypeError, match="already exists"):
        regs[1].gauge("c")
    h = Histogram()
    for v in (0, 1, 2, 3, 4, 5, 1000):
        h.observe(v)
    assert h.buckets == {0: 2, 1: 1, 2: 2, 3: 1, 10: 1}


def test_tracer_and_exporters_match_reference(tmp_path):
    """One hook sequence on both observers: the same records (host
    fields aside), the same JSONL (header included) and the same Chrome
    document but for the simulated clock's process name."""
    obss = (jobs.Observer(jobs.ObsConfig(), {"algorithm": "t"}),
            tobs.Observer(tobs.ObsConfig(), {"algorithm": "t"}))
    for obs in obss:
        obs.upload(0, 1.0, nbytes=10, staleness=2)
        with obs.timed("encode", client=1, codec="topk0.1_int8"):
            pass
        obs.window(2, 0.0, 1.0, obs.host_now())
        obs.flush(3, 2.5, folded=True)
        obs.failure(1, 3.0)
        obs.eval_event(4, 3.0, obs.host_now(), boundaries=2, reused=True)
        obs.checkpoint(4, obs.host_now())
        obs.broadcast(None, 3.5, nbytes=64, n=4, codec="int8")
        obs.report(None, 3.5, n=4)
        obs.aggregate(3.5, n=2)
        obs.eval_cache(3, 1)
    ja, ta = obss
    assert _strip_host(ta.tracer.events) == _strip_host(ja.tracer.events)
    assert ta.metrics.snapshot() == ja.metrics.snapshot()

    def chrome(obs, mod):
        doc = mod(obs.tracer, obs.meta)
        for e in doc["traceEvents"]:
            e.pop("ts", None), e.pop("dur", None)
            if e["ph"] == "M" and e["pid"] == 1:
                e["args"]["name"] = "simulated clock"
        return doc
    from repro.obs.exporters import chrome_trace_events as j_chrome
    assert chrome(ta, chrome_trace_events) == chrome(ja, j_chrome)
    write_chrome_trace(ta.tracer, str(tmp_path / "c.json"), ta.meta)
    with open(tmp_path / "c.json") as f:
        doc = json.load(f)
    assert {e["pid"] for e in doc["traceEvents"] if e["ph"] != "M"} == {1, 2}
    path = write_jsonl(ta.tracer, str(tmp_path / "t.jsonl"), {"m": 1})
    header, events = tobs.read_jsonl(path)
    assert header == {"schema": "obs-trace/v1", "meta": {"m": 1}, "events": 10, "dropped": 0}
    assert events == ta.tracer.events
    text = console_summary(ta)
    assert "upload" in text and "window" in text
    t = tobs.Tracer(max_events=2)
    for i in range(5):
        t.emit("e", "i", sim=float(i))
    assert len(t.events) == 2 and t.dropped == 3


def test_resolve_obs_variants():
    assert tobs.resolve_obs(None) is None
    assert tobs.resolve_obs(False) is None
    assert isinstance(tobs.resolve_obs(True), tobs.ObsConfig)
    cfg = tobs.ObsConfig(summary=True)
    assert tobs.resolve_obs(cfg) is cfg
    assert tobs.resolve_obs({"max_events": 7}).max_events == 7
    with pytest.raises(ValueError, match="obs must be"):
        tobs.resolve_obs("yes")
    with pytest.raises(TypeError):
        tobs.resolve_obs({"jax_profile": "x"})     # the port's knob is torch_profile
    assert ({f.name for f in dataclasses.fields(tobs.ObsConfig)} - {"torch_profile"}
            == {f.name for f in dataclasses.fields(jobs.ObsConfig)} - {"jax_profile"})


def test_sampler_series():
    reg = tobs.MetricsRegistry()
    ticks = iter(range(100))
    s = MetricsSampler(reg, interval=1.0, capacity=3, clock=lambda: next(ticks))
    s.sample_once()
    reg.counter("uploads").inc(4)
    s.sample_once()
    assert s.rates() == {"uploads": 4.0} and s.deltas() == {"uploads": 4}
    assert [v for _, v in s.series("uploads")] == [4]
    with pytest.raises(ValueError):
        MetricsSampler(reg, interval=0)


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
@pytest.mark.parametrize("name,alg,kw", RUNTIMES, ids=[r[0] for r in RUNTIMES])
def test_gpu_obs_on_is_bit_exact(cuda, data, name, alg, kw):
    """Obs on the card: every number bit-equal to obs off (the hooks add
    no device work and no wait), and the trace reconciles with
    CommStats; a second identical run builds nothing."""
    fed_data, xte, yte = data
    f = Federation(model=(tcnn.mlp_forward, tcnn.mlp_init, TCFG), data=fed_data,
                   test_data=(xte[:300], yte[:300]), local=tclient.LocalSpec(**SPEC),
                   device="cuda", rounds=3, compressor="topk0.1_int8")
    perms = {(i, s): torch.from_numpy(np.random.RandomState(100 * i + s).permutation(160))
             for i in range(N) for s in range(16)}
    pf = lambda i, s, e, m: perms[(i, s)]  # noqa: E731
    off = f.run(algorithm=alg, perm_fn=pf, **kw)
    on = f.run(algorithm=alg, perm_fn=pf, obs=True, **kw)
    again = f.run(algorithm=alg, perm_fn=pf, obs=True, **kw)
    assert _numeric(off) == _numeric(on) == _numeric(again)
    assert on.metrics["counters"]["uploads"] == on.comm.model_uploads
    assert on.metrics["counters"].get("upload_payload_bytes", 0) == on.comm.upload_payload_bytes
    assert again.metrics["gauges"]["jit_compiles"] == 0
