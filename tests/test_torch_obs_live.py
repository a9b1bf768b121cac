"""repro_torch.obs.live (the live telemetry plane) against repro on the CPU.

* ``render_prometheus``: byte-equal text in both packages for the same
  snapshot, built by the same counter, gauge and histogram operations on
  each package's ``MetricsRegistry`` (the histogram golden, label
  escaping, tenant labels, name sanitising, rate gauges;
  tests/test_obs_live.py:220-283).
* Probes: for the same ``ProbeContext`` each builtin gives the status,
  value and detail the reference's gives, and ``ProbeSet`` the same
  transition alerts, counters and trace events (:285-381).
* ``client_scoreboard`` after the same bridge run (the reference's
  initial parameters and permutations injected) equals the reference's,
  host clock aside.
* The HTTP plane as in the reference: all four endpoints answer mid-run
  and ``/clients`` reconciles with CommStats (:384); routes 404, the
  index and a crit probe's 503 (:436); ``serve_run(live=)`` and its
  sequential-driver guard (:458); two tenants on one plane (:472); the
  chaos fault and retry counters reconcile exactly, and a blackout run
  flips the dead-client probe with its alert in the trace (:533-590).
"""
import json
import threading
import types
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.obs as jobs  # noqa: E402
import repro.obs.live as jlive  # noqa: E402
from repro.core import FLRunConfig as JConfig  # noqa: E402
from repro.core import client as jclient  # noqa: E402
from repro.data.partition import iid_partition  # noqa: E402
from repro.data.synthetic import synthetic_mnist  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.serve import FLServer as JServer  # noqa: E402
from repro.serve import InprocTransport as JInproc  # noqa: E402
from repro.serve.client import ClientCompute as JCompute  # noqa: E402
from repro.serve.client import SequentialDriver as JDriver  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.obs.live as tlive  # noqa: E402
from repro_torch.core import client as tclient  # noqa: E402
from repro_torch.core.config import FLRunConfig as TConfig  # noqa: E402
from repro_torch.core.federation import Federation  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.obs import ObsConfig, Observer, read_jsonl  # noqa: E402
from repro_torch.obs.live import (CRIT, OK, WARN, LiveTarget, ObsHttpServer,  # noqa: E402
                                  ProbeContext, ProbeResult, ProbeSet, available_probes,
                                  get_probe, register_probe, worst)
from repro_torch.resilience import ChaosTransport, FaultSpec, RetryPolicy  # noqa: E402
from repro_torch.serve import (FLServer, InprocTransport, MultiTenantServer,  # noqa: E402
                               SequentialDriver, launch_serving, serve_run)
from repro_torch.serve.client import ClientCompute  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

SEED = 7
SPEC = dict(batch_size=32, local_rounds=1, lr=0.1)


@pytest.fixture(scope="module")
def setup():
    """The reference's tests/test_obs_live.py fixture, for both packages."""
    xtr, ytr, xte, yte = synthetic_mnist(16 * 60 + 200, 200, seed=0)
    jcfg, tcfg = jcnn.MLPConfig(hidden=(16,)), tcnn.MLPConfig(hidden=(16,))
    ref = (jclient.make_weighted_classifier_loss(jcnn.mlp_forward, jcfg),
           jclient.make_evaluator(jcnn.mlp_forward, jcfg, xte, yte, batch=200))
    port = (tclient.make_weighted_classifier_loss(tcnn.mlp_forward, tcfg),
            tclient.make_evaluator(tcnn.mlp_forward, tcfg, xte, yte, batch=200))
    return dict(data=(xtr, ytr), test=(xte, yte), ref=ref, port=port, jcfg=jcfg, tcfg=tcfg)


def _cfg(n_clients, alg="afl", **kw):
    base = dict(algorithm=alg, num_clients=n_clients, rounds=2, local=tclient.LocalSpec(**SPEC),
                target_acc=0.99, events_per_eval=n_clients, seed=SEED,
                obs=ObsConfig(sample_interval=0.02))
    base.update(kw)
    return TConfig(**base)


def _fed(setup, n_clients, samples=60):
    xtr, ytr = setup["data"]
    return iid_partition(xtr, ytr, n_clients, samples_per_client=samples, seed=0)


def _pieces(setup, n_clients, samples=60):
    loss, evaluate = setup["port"]
    return dict(init_params_fn=lambda g: tcnn.mlp_init(setup["tcfg"], g), loss_fn=loss,
                fed_data=_fed(setup, n_clients, samples), evaluate_fn=evaluate, device="cpu")


def _drive(server, workers, tr, *, stall=30.0, absorb=True):
    try:
        server.start()
        for w in workers:
            w.start()
        server.run(stall_timeout=stall)
        for w in workers:
            w.stop()
        for w in workers:
            w.join(timeout=10.0)
        res = server.finalize()
        if absorb:
            server.absorb_client_stats(workers)
    finally:
        tr.close()
    assert not any(w.error for w in workers), [w.error for w in workers]
    return res


def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


# ------------------------------------------------------- prometheus text ---

def _counters_and_gauges(mod):
    reg = mod.MetricsRegistry()
    reg.counter("uploads").inc(8)
    reg.gauge("jit_compiles").set(3)
    reg.gauge("unset")                       # None: skipped
    reg.gauge("ratio").set(0.125)
    return [({}, reg.snapshot())], None


def _histogram_golden(mod):
    reg = mod.MetricsRegistry()
    h = reg.hist("lat")
    for v in (0.5, 1.0, 2.0, 3.0, 7.0):
        h.observe(v)
    return [({}, reg.snapshot())], None


def _tenants_escaped(mod):
    reg_a, reg_b = mod.MetricsRegistry(), mod.MetricsRegistry()
    reg_a.counter("uploads").inc(1)
    reg_b.counter("uploads").inc(2)
    reg_b.hist("staleness").observe(3)
    return [({"tenant": "a"}, reg_a.snapshot()),
            ({"tenant": 'we"ird\\ten\nant'}, reg_b.snapshot())], None


def _sanitised(mod):
    reg = mod.MetricsRegistry()
    reg.counter("weird-name.v2").inc(1)
    reg.hist("commit latency/ms").observe(250.5)
    return [({}, reg.snapshot())], None


def _rates(mod):
    reg = mod.MetricsRegistry()
    reg.counter("uploads").inc(4)
    reg.counter("broadcasts").inc(2)
    return [({}, reg.snapshot())], {0: {"uploads": 2.5, "broadcasts": 1 / 3}}


PROM_CASES = {"counters-gauges": _counters_and_gauges, "histogram": _histogram_golden,
              "tenants-escaped": _tenants_escaped, "sanitised": _sanitised, "rates": _rates}


@pytest.mark.parametrize("case", list(PROM_CASES))
def test_prometheus_text_byte_equal(case):
    t_src, t_rates = PROM_CASES[case](tobs)
    j_src, j_rates = PROM_CASES[case](jobs)
    got = tlive.render_prometheus(t_src, rates=t_rates)
    assert got == jlive.render_prometheus(j_src, rates=j_rates)
    assert got.endswith("\n")
    if case == "histogram":
        lines = got.splitlines()
        for line in ('repro_lat_bucket{le="1"} 2', 'repro_lat_bucket{le="2"} 3',
                     'repro_lat_bucket{le="4"} 4', 'repro_lat_bucket{le="8"} 5',
                     'repro_lat_bucket{le="+Inf"} 5', "repro_lat_count 5",
                     "# TYPE repro_lat_p95 gauge"):
            assert line in lines
        assert "repro_lat_sum 13.5" in got
    if case == "tenants-escaped":
        assert 'repro_uploads_total{tenant="we\\"ird\\\\ten\\nant"} 2' in got
        assert got.count("# TYPE repro_uploads_total counter") == 1
    if case == "rates":
        assert 'repro_counter_rate{metric="uploads"} 2.5' in got


# ------------------------------------------------------------------ probes ---

class TestProbeRegistry:
    def test_builtins_listed_as_the_reference(self):
        assert available_probes()[:5] == jlive.available_probes()[:5] == (
            "staleness-p99", "queue-depth", "commit-latency", "dead-client-fraction",
            "accuracy-stall")
        assert tlive.DEFAULT_PROBES == jlive.DEFAULT_PROBES

    def test_unknown_name_fails_loudly(self):
        with pytest.raises(ValueError, match="staleness-p99"):
            get_probe("no-such-probe")

    def test_register_duplicate_and_overwrite(self):
        from repro_torch.obs.live import probes as reg
        name = "test-probe-dup"
        factory = lambda **kw: lambda ctx: ProbeResult(name, OK)  # noqa: E731
        register_probe(name, factory)
        try:
            with pytest.raises(ValueError, match="already registered"):
                register_probe(name, factory)
            register_probe(name, factory, overwrite=True)
            assert name in available_probes()
            assert get_probe(name) is factory
        finally:
            del reg._REGISTRY[name]

    def test_worst(self):
        assert worst([]) == OK
        assert worst([OK, WARN, OK]) == WARN
        assert worst([WARN, CRIT]) == CRIT


def _snap(mod, hist_name, values):
    reg = mod.MetricsRegistry()
    for v in values:
        reg.hist(hist_name).observe(v)
    return reg.snapshot()


def _rec(a):
    return types.SimpleNamespace(global_acc=a)


# (probe name, factory kwargs, histogram or None, values or server)
PROBE_CASES = [
    ("staleness-p99", {}, None, None),
    ("staleness-p99", dict(warn=8.0, crit=32.0), "staleness", [1] * 50),
    ("staleness-p99", dict(warn=8.0, crit=32.0), "staleness", [16] * 50),
    ("staleness-p99", dict(warn=8.0, crit=32.0), "staleness", [64] * 50),
    ("queue-depth", dict(warn=64.0, crit=256.0), "queue_depth", [300] * 20),
    ("queue-depth", {}, "queue_depth", [1, 2, 90, 3]),
    ("commit-latency", dict(warn_ms=250.0, crit_ms=2000.0), "commit_latency_ms", [500] * 20),
    ("commit-latency", {}, "commit_latency_ms", [3.25, 7.5]),
    ("dead-client-fraction", {}, None, None),
    ("dead-client-fraction", {}, "server", {1, 2, 3}),
    ("dead-client-fraction", {}, "server", {0, 1, 2, 3}),
    ("accuracy-stall", dict(window=3), "records", [0.1, 0.2]),
    ("accuracy-stall", dict(window=3), "records", [0.1, 0.5, 0.5, 0.5, 0.5]),
    ("accuracy-stall", dict(window=3), "records", [0.1, 0.2, 0.3, 0.4, 0.5]),
]


def _probe_ctx(mod, kind, values):
    if kind is None:
        return mod.ProbeContext({})
    if kind == "server":
        srv = types.SimpleNamespace(cfg=types.SimpleNamespace(num_clients=8), _evicted=values)
        return mod.ProbeContext({}, server=srv)
    if kind == "records":
        return mod.ProbeContext({}, server=types.SimpleNamespace(
            records=[_rec(a) for a in values]))
    obs_mod = tobs if mod is tlive else jobs
    return mod.ProbeContext(_snap(obs_mod, kind, values))


@pytest.mark.parametrize("i", range(len(PROBE_CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(PROBE_CASES)])
def test_builtin_probe_equals_the_reference(i):
    name, kw, kind, values = PROBE_CASES[i]
    got = get_probe(name)(**kw)(_probe_ctx(tlive, kind, values))
    want = jlive.get_probe(name)(**kw)(_probe_ctx(jlive, kind, values))
    assert got.to_dict() == want.to_dict()


def test_builtin_probe_statuses_span_the_ladder():
    statuses = {get_probe(n)(**kw)(_probe_ctx(tlive, k, v)).status
                for n, kw, k, v in PROBE_CASES}
    assert statuses == {OK, WARN, CRIT}


def test_probeset_transition_alerts_equal_the_reference():
    """Entering WARN alerts once, a steady status stays silent, and the
    recovery to OK alerts once more: the same verdicts, counters and
    alert events as the reference's."""
    out = []
    for mod, obs_mod in ((tlive, tobs), (jlive, jobs)):
        obs = obs_mod.Observer(obs_mod.ObsConfig())
        statuses = iter([OK, WARN, WARN, CRIT, OK, OK, CRIT])

        def flapper(ctx, _s=statuses, _mod=mod):
            return _mod.ProbeResult("flapper", next(_s), 1.0, "d")
        ps = mod.ProbeSet([flapper], obs=obs)
        verdicts = [ps.verdict(ps.evaluate(mod.ProbeContext({}))) for _ in range(7)]
        counters = obs.metrics.snapshot()["counters"]
        alerts = [{k: v for k, v in e.items() if k != "host"}
                  for e in obs.tracer.events if e["name"] == "alert"]
        out.append((verdicts, counters, alerts))
    assert out[0] == out[1]
    verdicts, counters, alerts = out[0]
    assert verdicts == [OK, WARN, WARN, CRIT, OK, OK, CRIT]
    assert counters["alerts"] == 4 and counters["alerts_crit"] == 2
    assert [e["status"] for e in alerts] == [WARN, CRIT, OK, CRIT]


# --------------------------------------------------------------- scoreboard ---

def _ref_permutations(m, events):
    rng, _ = jax.random.split(jax.random.key(SEED))
    perms = {}
    for ev in range(events):
        rng, urng = jax.random.split(rng)
        ck = jax.random.split(urng, 1)[0]
        ek = jax.random.split(ck, 2)[0]
        perms[ev] = np.asarray(jax.random.permutation(ek, m)).astype(np.int64)
    return perms


def test_scoreboard_after_the_bridge_equals_the_reference(setup):
    """The same bridge run (vafl, topk0.1_int8) in both packages, then
    ``client_scoreboard``: equal but for the host clock's
    ``last_heard_s``."""
    n = 4
    fed = _fed(setup, n, 100)
    base = dict(algorithm="vafl", num_clients=n, rounds=2, target_acc=0.99, events_per_eval=4,
                seed=SEED, compressor="topk0.1_int8")
    jloss, jeval = setup["ref"]
    jcfg = JConfig(local=jclient.LocalSpec(**SPEC), **base)
    jtr = JInproc(n)
    jserver = JServer(jcfg, init_params_fn=lambda k: jcnn.mlp_init(setup["jcfg"], k),
                      evaluate_fn=jeval, transport=jtr, account_bytes=False,
                      resume_fresh_clients=False)
    JDriver(jserver, JCompute.for_run(jcfg, loss_fn=jloss, fed_data=fed,
                                      client_eval_fn=jeval)).run()
    init = jax.tree.map(np.asarray, jcnn.mlp_init(setup["jcfg"], jax.random.split(
        jax.random.key(SEED))[1]))
    perms = _ref_permutations(fed.labels.shape[1], 2 * n)
    loss, evaluate = setup["port"]
    tcfg = TConfig(local=tclient.LocalSpec(**SPEC), **base)
    tr = InprocTransport(n)
    server = FLServer(tcfg, init_params_fn=lambda g: from_jax_params(init), evaluate_fn=evaluate,
                      transport=tr, account_bytes=False, resume_fresh_clients=False,
                      device="cpu")
    SequentialDriver(server, ClientCompute.for_run(
        tcfg, loss_fn=loss, fed_data=fed, client_eval_fn=evaluate, device="cpu",
        perm_fn=lambda i, ev, e, m: torch.from_numpy(perms[ev]))).run()

    def strip(board):
        return dict(board, clients=[{k: v for k, v in row.items() if k != "last_heard_s"}
                                    for row in board["clients"]])
    got, want = strip(server.scoreboard()), strip(jlive.client_scoreboard(jserver))
    assert got == want
    assert got["totals"]["up_bytes"] > 0 and got["processed"] == 2 * n
    tr.close()
    jtr.close()


# ---------------------------------------------------------- the HTTP plane ---

class TestLiveServe:
    def test_http_plane_mid_run_and_exact_reconciliation(self, setup):
        """A 16-client threaded federation answers all four endpoints over
        HTTP while the run is in flight, and the scoreboard's byte totals
        reconcile exactly with the final CommStats."""
        n = 16
        server, workers, tr = launch_serving(_cfg(n), recv_timeout=10.0, **_pieces(setup, n))
        plane = ObsHttpServer([server]).start()
        seen = {}
        stop = threading.Event()

        def scrape():
            while not stop.is_set():
                for path in ("/metrics", "/healthz", "/clients", "/trace"):
                    try:
                        st, body = _get(plane.url + path, timeout=2)
                        if st == 200:
                            seen[path] = body
                    except OSError:
                        pass
                stop.wait(0.01)

        poller = threading.Thread(target=scrape, daemon=True)
        poller.start()
        try:
            res = _drive(server, workers, tr)
        finally:
            stop.set()
            poller.join(timeout=5.0)
        try:
            assert set(seen) == {"/metrics", "/healthz", "/clients", "/trace"}
            assert "repro_uploads_total" in seen["/metrics"]
            health = json.loads(seen["/healthz"])
            assert health["status"] in (OK, WARN, CRIT)
            assert {p["name"] for p in health["probes"]} == set(available_probes()[:5])
            assert len(json.loads(seen["/clients"])["clients"]) == n
            assert json.loads(seen["/trace"])["default"] is not None
            final = server.scoreboard()
            assert final["totals"]["up_bytes"] == res.comm.uplink_bytes
            assert final["totals"]["down_bytes"] == res.comm.downlink_bytes
            assert final["totals"]["accepted_updates"] == res.comm.model_uploads
            assert final["processed"] == n * 2
            st, txt = _get(plane.url + "/metrics")
            assert f"repro_uploads_total {res.comm.model_uploads}" in txt
            st, body = _get(plane.url + "/clients")
            assert json.loads(body)["totals"] == final["totals"]
            assert res.metrics["gauges"]["metric_samples"] >= 2
        finally:
            plane.stop()

    def test_routes_404_index_and_crit_503(self, setup):
        server, workers, tr = launch_serving(_cfg(4), **_pieces(setup, 4))
        always_crit = lambda ctx: ProbeResult("boom", CRIT, 1.0)  # noqa: E731
        plane = ObsHttpServer([server], probes=[always_crit]).start()
        try:
            st, body = _get(plane.url + "/")
            assert st == 200
            assert set(json.loads(body)["endpoints"]) == {"/metrics", "/healthz", "/clients",
                                                          "/trace"}
            with pytest.raises(urllib.error.HTTPError) as e404:
                _get(plane.url + "/nope")
            assert e404.value.code == 404
            with pytest.raises(urllib.error.HTTPError) as e503:
                _get(plane.url + "/healthz")
            assert e503.value.code == 503
            assert json.loads(e503.value.read())["status"] == CRIT
            st, body = _get(plane.url + "/trace?n=5")      # the crit transition's alert
            tail = json.loads(body)["default"]
            assert st == 200 and [(e["name"], e["probe"], e["status"]) for e in tail] == [
                ("alert", "boom", CRIT)]
        finally:
            plane.stop()
            tr.close()

    def test_serve_run_live_flag_and_sequential_guard(self, setup):
        with pytest.raises(ValueError, match="thread driver"):
            serve_run(_cfg(4), driver="sequential", live=True, **_pieces(setup, 4))
        with pytest.raises(ValueError, match="live must be"):
            serve_run(_cfg(4), live="yes", **_pieces(setup, 4))
        res = serve_run(_cfg(4), live=True, recv_timeout=10.0, **_pieces(setup, 4))
        assert res.metrics["counters"]["uploads"] == res.comm.model_uploads
        assert res.metrics["gauges"]["metric_samples"] >= 2

    def test_federation_serve_live(self, setup):
        """``Federation.serve(live=...)``: the plane is up while the run is
        and stopped after it."""
        loss, evaluate = setup["port"]
        p = _pieces(setup, 4)
        fed = Federation(data=p["fed_data"], algorithm="afl", init_params_fn=p["init_params_fn"],
                         loss_fn=loss, evaluate_fn=evaluate, local=tclient.LocalSpec(**SPEC),
                         seed=SEED, obs=ObsConfig(sample_interval=0.02), device="cpu")
        res = fed.serve(rounds=2, live={"host": "127.0.0.1", "port": 0}, stall_timeout=30.0,
                        recv_timeout=10.0)
        assert res.comm.broadcasts == 8
        assert res.metrics["counters"]["uploads"] == res.comm.model_uploads


class TestMultiTenantLive:
    def test_two_tenants_isolated_metrics_one_plane(self, setup):
        sa, wa, ta = launch_serving(_cfg(4), name="tenant-a", recv_timeout=10.0,
                                    **_pieces(setup, 4))
        sb, wb, tb = launch_serving(_cfg(4, alg="vafl"), name="tenant-b", recv_timeout=10.0,
                                    **_pieces(setup, 4))
        mt = MultiTenantServer([sa, sb], live=True)
        scraped = []
        stop = threading.Event()
        try:
            mt.start()
            assert mt.live is not None and sa.live is mt.live is sb.live
            url = mt.live.url

            def scrape():
                while not stop.is_set():
                    try:
                        st, txt = _get(url + "/metrics", timeout=2)
                        scraped.append(txt)
                    except OSError:
                        pass
                    stop.wait(0.01)

            poller = threading.Thread(target=scrape, daemon=True)
            poller.start()
            for w in wa + wb:
                w.start()
            res_a, res_b = mt.run(stall_timeout=30.0)
            stop.set()
            poller.join(timeout=5.0)
            for w in wa + wb:
                w.stop()
            for w in wa + wb:
                w.join(timeout=10.0)
            sa.absorb_client_stats(wa)
            sb.absorb_client_stats(wb)
        finally:
            stop.set()
            ta.close()
            tb.close()
        assert mt.live is None
        assert scraped, "the plane never answered mid-run"
        assert 'tenant="tenant-a"' in scraped[-1]
        assert 'tenant="tenant-b"' in scraped[-1]
        for res in (res_a, res_b):
            c = res.metrics["counters"]
            assert c["uploads"] == res.comm.model_uploads
            assert c["upload_payload_bytes"] == res.comm.upload_payload_bytes
        assert sa.obs.metrics is not sb.obs.metrics
        assert res_a.comm.upload_payload_bytes != res_b.comm.upload_payload_bytes


class TestChaosTelemetry:
    def test_fault_and_retry_counters_reconcile_exactly(self, setup):
        """chaos_faults_<kind> == ChaosTransport.stats[kind] for every
        injected fate, and client_retries == the fleet's retry sum; a
        second absorb does not double-count."""
        chaos = ChaosTransport(4, faults=FaultSpec(drop=0.15, duplicate=0.1, reorder=0.1,
                                                   seed=11))
        retry = RetryPolicy(max_attempts=8, attempt_timeout_s=0.5, base_s=0.02,
                            max_backoff_s=0.25, seed=11)
        server, workers, tr = launch_serving(
            _cfg(4, rounds=3), transport=chaos, retry=retry, recv_timeout=10.0,
            exchange_timeout=10.0, **_pieces(setup, 4))
        res = _drive(server, workers, tr)
        c = res.metrics["counters"]
        injected = {k: v for k, v in chaos.stats.items() if k not in ("sent", "delivered") and v}
        assert injected, "fault schedule never fired"
        for kind, n in injected.items():
            assert c.get(f"chaos_faults_{kind}", 0) == n, kind
        assert c.get("chaos_faults", 0) == sum(injected.values())
        assert c.get("client_retries", 0) == sum(w.stats["retries"] for w in workers)
        server.absorb_client_stats(workers)
        c2 = server._finalized.metrics["counters"]
        assert c2.get("client_retries", 0) == c.get("client_retries", 0)
        assert c2.get("chaos_faults", 0) == c.get("chaos_faults", 0)

    def test_chaos_flips_probe_and_alert_lands_in_trace(self, setup, tmp_path):
        """A blackout-heavy chaos run evicts clients; the dead-client probe
        flips to WARN or CRIT, and the transition alert is a structured
        event in the exported trace."""
        out = tmp_path / "trace.jsonl"
        chaos = ChaosTransport(4, faults=FaultSpec(blackout=0.5, blackout_s=1.0, seed=3))
        retry = RetryPolicy(max_attempts=8, attempt_timeout_s=0.3, base_s=0.02,
                            max_backoff_s=0.2, seed=3)
        cfg = _cfg(4, rounds=3, obs=ObsConfig(trace_jsonl=str(out), sample_interval=0.02))
        server, workers, tr = launch_serving(
            cfg, transport=chaos, retry=retry, recv_timeout=5.0, exchange_timeout=5.0,
            liveness_timeout=0.2, **_pieces(setup, 4))
        target = LiveTarget(server, probes=[
            get_probe("dead-client-fraction")(warn=0.01, crit=0.9)])
        worst_seen = [OK]
        stop = threading.Event()

        def watch():
            while not stop.is_set():
                h = target.health()
                worst_seen[0] = worst([worst_seen[0], h["status"]])
                stop.wait(0.01)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        try:
            server.start()
            for w in workers:
                w.start()
            server.run(stall_timeout=20.0)
            for w in workers:
                w.stop()
            for w in workers:
                w.join(timeout=10.0)
        finally:
            stop.set()
            watcher.join(timeout=5.0)
        final = target.health()
        server.finalize()
        tr.close()
        assert server.evictions > 0, "blackout never tripped liveness"
        assert worst([worst_seen[0], final["status"]]) in (WARN, CRIT)
        _header, events = read_jsonl(str(out))
        alerts = [e for e in events if e["name"] == "alert"]
        assert alerts, "no alert event in the exported trace"
        assert alerts[0]["probe"] == "dead-client-fraction"
        assert alerts[0]["status"] in (WARN, CRIT)
        assert server._finalized.metrics["counters"]["alerts"] == len(alerts)


def test_observer_alert_counts_with_a_bare_observer():
    obs = Observer(ObsConfig())
    ps = ProbeSet([lambda ctx: ProbeResult("p", WARN, 2.0, "x")], obs=obs)
    ps.evaluate(ProbeContext({}))
    ps.evaluate(ProbeContext({}))
    assert obs.metrics.snapshot()["counters"]["alerts"] == 1
