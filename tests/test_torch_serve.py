"""repro_torch.serve (the federation as a live service, in process) and
repro_torch.resilience's retry policy, against repro on the CPU.

* The determinism bridge: ``serve_run(driver="sequential")`` with the
  reference's initial parameters and permutations injected equals the
  reference's own bridge (afl, vafl, eaflm, fedasync under identity;
  vafl under topk0.1_int8 and under int8 up and down): pop order,
  staleness, CommStats, byte ledgers, records and ``sim_time`` bit for
  bit, parameters within the event runtime's parity bounds
  (tests/test_torch_events.py: the local SGD itself is not bit-equal
  between XLA and torch).  On torch's own generator the bridge equals
  the port's ``run(mode="event")`` bit for bit, parameters included.
* Ports of the reference's tests/test_serve.py (transport registry,
  FIFO, backpressure, drain, dedup, the server lifecycle without process
  workers, the thread-worker runs without socket and live) and of
  tests/test_resilience.py (the retry policy, ``_exchange``, eviction
  and readmission, a wedged exchange, the bridge's checkpoint resume and
  its refusals).  Every serve run bounds itself (``stall_timeout``,
  ``recv_timeout``, ``join(timeout=...)``).

The tests marked ``gpu`` run the bridge and the thread workers on the
card; they skip themselves on a host without a Hopper card and nvcc.
"""
import dataclasses
import threading
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.algorithms.base import Aggregator as JAggregator  # noqa: E402
from repro.core import FLRunConfig as JConfig  # noqa: E402
from repro.core import client as jclient  # noqa: E402
from repro.core.scheduler import EventScheduler as JScheduler  # noqa: E402
from repro.data.partition import iid_partition  # noqa: E402
from repro.data.synthetic import synthetic_mnist  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.resilience import FaultPlan as JFaultPlan, FaultSpec as JFaultSpec  # noqa: E402
from repro.resilience import RetryPolicy as JRetryPolicy  # noqa: E402
from repro.serve import serve_run as j_serve  # noqa: E402
from repro_torch.algorithms.base import Aggregator as TAggregator  # noqa: E402
from repro_torch.common.pytree import tree_leaves, tree_map  # noqa: E402
from repro_torch.compress import get_codec  # noqa: E402
from repro_torch.core import client as tclient  # noqa: E402
from repro_torch.core.config import FLRunConfig as TConfig  # noqa: E402
from repro_torch.core.federation import Federation  # noqa: E402
from repro_torch.core.runtimes import run_event_driven as t_event  # noqa: E402
from repro_torch.core.scheduler import EventScheduler as TScheduler  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.grad_diff_norm import ops as gd_ops  # noqa: E402
from repro_torch.kernels.topk_quant import ops as tq_ops  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.obs import ObsConfig  # noqa: E402
from repro_torch.resilience import FaultPlan, FaultSpec, RetryPolicy  # noqa: E402
from repro_torch.serve import (FLServer, InprocTransport, MultiTenantServer,  # noqa: E402
                               ProcessClientWorker, SequentialDriver, available_transports,
                               get_transport, launch_serving, register_transport, serve_run)
from repro_torch.serve import messages as wire  # noqa: E402
from repro_torch.serve.client import ClientCompute, _exchange, worker_seed  # noqa: E402
from repro_torch.serve.messages import (BroadcastMsg, UploadMsg, WireError,  # noqa: E402
                                        msg_from_wire, msg_to_wire)
from repro_torch.weights import from_jax_params  # noqa: E402

N, SEED = 4, 7
SPEC = dict(batch_size=32, local_rounds=1, lr=0.1)
BOUNDS = dict(stall_timeout=5.0, recv_timeout=5.0)   # every thread run bounds its waits


@pytest.fixture(scope="module")
def setup():
    """The reference's tests/test_serve.py fixture, for both packages."""
    xtr, ytr, xte, yte = synthetic_mnist(4 * 100 + 200, 200, seed=0)
    fed = iid_partition(xtr, ytr, N, samples_per_client=100, seed=0)
    jcfg, tcfg = jcnn.MLPConfig(hidden=(16,)), tcnn.MLPConfig(hidden=(16,))
    ref = (jclient.make_weighted_classifier_loss(jcnn.mlp_forward, jcfg),
           jclient.make_evaluator(jcnn.mlp_forward, jcfg, xte, yte, batch=200))
    port = (tclient.make_weighted_classifier_loss(tcnn.mlp_forward, tcfg),
            tclient.make_evaluator(tcnn.mlp_forward, tcfg, xte, yte, batch=200))
    init = jax.tree.map(np.asarray, jcnn.mlp_init(jcfg, jax.random.split(
        jax.random.key(SEED))[1]))
    return dict(fed=fed, ref=ref, port=port, tcfg=tcfg, init=init, test=(xte, yte))


def _cfg(alg="afl", **kw):
    base = dict(algorithm=alg, num_clients=N, rounds=2, local=tclient.LocalSpec(**SPEC),
                target_acc=0.99, events_per_eval=4, seed=SEED)
    base.update(kw)
    return TConfig(**base)


def _callables(setup, init=None):
    """The port's callables on the CPU, from the reference's initial
    parameters (or from the generator when ``init`` is False)."""
    loss, evaluate = setup["port"]
    tcfg = setup["tcfg"]
    init_fn = ((lambda g: tcnn.mlp_init(tcfg, g)) if init is False
               else (lambda g: from_jax_params(setup["init"])))
    return dict(init_params_fn=init_fn, loss_fn=loss, fed_data=setup["fed"],
                evaluate_fn=evaluate, device="cpu")


def _upload(client, seq, tree, sim_time=1.0):
    return UploadMsg(kind=wire.UPDATE, client=client, seq=seq, version=0, sim_time=sim_time,
                     payload=tree)


def _server(setup, alg="afl", **kw):
    cb = _callables(setup)
    tr = InprocTransport(N)
    server = FLServer(_cfg(alg), init_params_fn=cb["init_params_fn"],
                      evaluate_fn=cb["evaluate_fn"], transport=tr, device="cpu", **kw)
    return server, tr


# ------------------------------------------------- the bridge vs repro ---

def ref_permutations(m, events):
    """The reference bridge's draws: key(seed) split once for the initial
    model, then per event split -> one client key -> per-epoch split."""
    rng, _ = jax.random.split(jax.random.key(SEED))
    perms = {}
    for ev in range(events):
        rng, urng = jax.random.split(rng)
        ck = jax.random.split(urng, 1)[0]
        ek = jax.random.split(ck, 2)[0]
        perms[ev] = np.asarray(jax.random.permutation(ek, m)).astype(np.int64)
    return perms


def _record_pops_and_staleness(monkeypatch):
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


BRIDGE_CASES = [("afl", {}), ("vafl", {}), ("eaflm", {}), ("fedasync", {}),
                ("vafl", dict(compressor="topk0.1_int8")),
                ("vafl", dict(compressor="int8", broadcast_compressor="int8"))]


def _ledgers(res):
    return (dataclasses.asdict(res.comm), res.sim_time, res.idle_fraction, res.client_idle,
            res.client_uplink_bytes, res.client_downlink_bytes, res.client_failed_rounds,
            [(r.round, r.time, r.uploads_so_far) for r in res.records])


@pytest.mark.parametrize("alg,kw", BRIDGE_CASES,
                         ids=[a + ("-" + "-".join(k.values()) if k else "") for a, k in BRIDGE_CASES])
def test_sequential_serve_matches_reference(setup, monkeypatch, alg, kw):
    seen = _record_pops_and_staleness(monkeypatch)
    jloss, jeval = setup["ref"]
    loss, evaluate = setup["port"]

    def jeval_capture(p):
        seen["ref_final"] = jax.tree.map(np.asarray, p)
        return jeval(p)

    def teval_capture(p):
        seen["port_final"] = p
        return evaluate(p)
    base = dict(algorithm=alg, num_clients=N, rounds=2, target_acc=0.99, events_per_eval=4,
                seed=SEED, **kw)
    ref = j_serve(JConfig(local=jclient.LocalSpec(**SPEC), **base), driver="sequential",
                  init_params_fn=lambda k: jcnn.mlp_init(jcnn.MLPConfig(hidden=(16,)), k),
                  loss_fn=jloss, fed_data=setup["fed"], evaluate_fn=jeval_capture,
                  client_eval_fn=jeval)
    perms = ref_permutations(setup["fed"].labels.shape[1], 2 * N)
    res = serve_run(TConfig(local=tclient.LocalSpec(**SPEC), **base), driver="sequential",
                    init_params_fn=lambda g: from_jax_params(setup["init"]), loss_fn=loss,
                    fed_data=setup["fed"], evaluate_fn=teval_capture, client_eval_fn=evaluate,
                    device="cpu", perm_fn=lambda i, ev, e, m: torch.from_numpy(perms[ev]))
    assert seen["port"] == seen["ref"]          # pop order and times, staleness
    assert len(seen["port"][0]) == 2 * N
    assert _ledgers(res) == _ledgers(ref)
    diff = np.concatenate([np.abs(b.numpy() - a).ravel() for a, b in zip(
        jax.tree.leaves(seen["ref_final"]), tree_leaves(seen["port_final"]))])
    if kw.get("compressor") in (None, "identity"):
        assert diff.max() <= 1e-4, diff.max()
    else:
        # a last-bit difference can tip one entry's stochastic rounding
        # across an integer step (tests/test_torch_events.py)
        assert (diff > 1e-4).mean() <= 1e-3 and diff.max() <= 1e-3, diff.max()


def _everything(res, params):
    return ([(r.round, r.time, r.global_acc, r.uploads_so_far) for r in res.records],
            dataclasses.asdict(res.comm), res.sim_time, res.idle_fraction,
            res.client_uplink_bytes, res.client_downlink_bytes,
            [x.numpy().tobytes() for x in tree_leaves(params)])


@pytest.mark.parametrize("alg,kw", BRIDGE_CASES + [("vafl", dict(scenario="mobile_fleet"))],
                         ids=[a + ("-" + "-".join(k.values()) if k else "")
                              for a, k in BRIDGE_CASES + [("vafl", {"s": "mobile_fleet"})]])
def test_bridge_equals_event_run_on_torch_rng(setup, alg, kw):
    """On torch's own generator (the initial model drawn from it, then
    every event's permutations), serve(driver="sequential") equals
    run(mode="event") bit for bit, parameters included."""
    xte, yte = setup["test"]
    fed = Federation(model=(tcnn.mlp_forward, tcnn.mlp_init, setup["tcfg"]),
                     data=setup["fed"], test_data=(xte, yte), algorithm=alg,
                     local=tclient.LocalSpec(**SPEC), seed=SEED, events_per_eval=4,
                     device="cpu", **kw)
    seen = {}
    evaluate = fed.evaluate_fn

    def capture(p):
        seen["params"] = p
        return evaluate(p)
    fed.evaluate_fn = capture
    a = _everything(fed.run(rounds=2, mode="event"), seen["params"])
    b = _everything(fed.serve(rounds=2, driver="sequential"), seen["params"])
    assert a == b


def test_sync_barrier_algorithms_rejected(setup):
    with pytest.raises(ValueError, match="sync barrier"):
        serve_run(_cfg("fedavg"), driver="sequential", **_callables(setup))


# ------------------------------------------------------------- registry ---

class TestTransportRegistry:
    def test_builtins_first_in_stable_order(self):
        assert available_transports()[:1] == ("inproc",)

    def test_unknown_name_fails_loudly(self):
        with pytest.raises(ValueError, match="inproc"):
            get_transport("carrier-pigeon")

    @pytest.mark.parametrize("name", ["socket", "chaos"])
    def test_unported_builtins_name_the_roadmap(self, name):
        with pytest.raises(ValueError, match="item 9b"):
            get_transport(name)

    def test_register_resolve_duplicate_overwrite(self):
        from repro_torch.serve import transport as reg

        def factory(num_clients, capacity=0):
            return InprocTransport(num_clients, capacity)

        register_transport("x-test", factory)
        try:
            assert get_transport("x-test") is factory
            assert "x-test" in available_transports()
            with pytest.raises(ValueError, match="already registered"):
                register_transport("x-test", factory)
            register_transport("x-test", factory, overwrite=True)
        finally:
            del reg._REGISTRY["x-test"]

    def test_serve_accepts_transport_instance(self, setup):
        tr = InprocTransport(N)
        res = serve_run(_cfg("afl", rounds=1), transport=tr, driver="sequential",
                        **_callables(setup))
        assert res.comm.model_uploads == N
        tr.close()

    def test_unknown_driver_fails_loudly(self, setup):
        with pytest.raises(ValueError, match="sequential"):
            serve_run(_cfg(), driver="carrier-pigeon", **_callables(setup))

    def test_unported_pieces_name_the_roadmap(self, setup):
        server, tr = _server(setup)
        with pytest.raises(NotImplementedError, match="item 9b"):
            ProcessClientWorker(("127.0.0.1", 0), 0)
        with pytest.raises(NotImplementedError, match="item 9b"):
            serve_run(_cfg(), live=True, **_callables(setup))
        with pytest.raises(NotImplementedError, match="item 9b"):
            MultiTenantServer([server], live=True)
        with pytest.raises(NotImplementedError, match="item 9b"):
            server.scoreboard()
        tr.close()

    def test_serve_runs_on_cuda_unless_asked(self, setup):
        """The default device is the card; without one serve raises."""
        if torch.cuda.is_available():
            pytest.skip("a card is visible")
        cb = dict(_callables(setup), device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            serve_run(_cfg(), driver="sequential", **cb)
        loss, _ = setup["port"]
        with pytest.raises(RuntimeError, match="CUDA"):
            ClientCompute.for_run(_cfg(), loss_fn=loss, fed_data=setup["fed"])
        with pytest.raises(RuntimeError, match="CUDA"):
            ClientCompute(loss_fn=loss, local=_cfg().local, data={}, num_clients=N)


# --------------------------------------------------- transport semantics ---

class TestTransportSemantics:
    def test_concurrent_producers_fifo_no_drops(self):
        n, per = 4, 30
        tr = InprocTransport(n)
        chans = [tr.client_channel(i) for i in range(n)]

        def produce(i):
            for s in range(per):
                assert chans[i].send(_upload(i, s, {"x": s}), timeout=1.0)

        threads = [threading.Thread(target=produce, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        seen = {i: [] for i in range(n)}
        got = 0
        deadline = time.monotonic() + 10
        while got < n * per and time.monotonic() < deadline:
            for msg in tr.drain_uploads(16, timeout=0.5):
                seen[msg.client].append(msg.seq)
                got += 1
        for t in threads:
            t.join(timeout=10)
        assert got == n * per
        for i in range(n):
            assert seen[i] == list(range(per)), f"client {i} lost order"

    def test_backpressure_bounds_queue_depth(self):
        tr = InprocTransport(1, capacity=3)
        ch = tr.client_channel(0)
        for s in range(3):
            assert ch.send(_upload(0, s, None), timeout=0.2)
        t0 = time.monotonic()
        assert ch.send(_upload(0, 3, None), timeout=0.1) is False
        assert time.monotonic() - t0 >= 0.1     # blocked, then refused
        assert tr.queue_depth() == 3
        assert tr.recv_upload(timeout=0.1).seq == 0
        assert ch.send(_upload(0, 3, None), timeout=0.2)

    def test_drain_waits_only_for_first_and_caps_window(self):
        tr = InprocTransport(1)
        ch = tr.client_channel(0)
        for s in range(10):
            ch.send(_upload(0, s, None))
        win = tr.drain_uploads(4, timeout=0.5)
        assert [m.seq for m in win] == [0, 1, 2, 3]
        assert tr.queue_depth() == 6
        tr.close()
        t0 = time.monotonic()
        assert InprocTransport(1).drain_uploads(4, timeout=0.15) == []
        assert time.monotonic() - t0 >= 0.15

    def test_server_dedups_replayed_seq(self, setup):
        server, tr = _server(setup)
        tree = server.global_params
        ch = tr.client_channel(0)
        ch.send(_upload(0, 5, tree))
        server.step(timeout=0.2)
        assert server.processed == 1
        first = ch.recv(timeout=1.0)
        assert first.kind == wire.DOWNLOAD and first.ack_seq == 5
        ch.send(_upload(0, 5, tree))   # replayed seq
        server.step(timeout=0.2)
        assert server.processed == 1          # NOT re-processed
        assert server.duplicates == 1
        replay = ch.recv(timeout=1.0)          # cached reply re-sent
        assert replay.kind == wire.DOWNLOAD and replay.ack_seq == 5
        tr.close()

    def test_wire_round_trip_preserves_bits(self):
        """A frame carries trees and payload planes as host numpy and puts
        them back on the asked device, bits unchanged (bf16 included)."""
        tree = {"w": torch.linspace(-1, 1, 7), "b": torch.randn(3).to(torch.bfloat16)}
        msg = msg_to_wire(BroadcastMsg(kind=wire.DOWNLOAD, version=9, tree=tree, ack_seq=2))
        assert msg[:4] == wire.MAGIC
        back = msg_from_wire(msg[8:], device="cpu")
        assert back.version == 9 and back.ack_seq == 2
        for k in tree:
            assert back.tree[k].dtype == tree[k].dtype and torch.equal(back.tree[k], tree[k])
        codec = get_codec("topk0.1_int8")
        payload = codec.encode({"w": torch.randn(100)}, seed=3)
        up = msg_from_wire(msg_to_wire(UploadMsg(kind=wire.UPDATE, client=1, seq=4, version=0,
                                                 payload=payload, enc_seed=3))[8:])
        for plane in ("idx", "val"):
            np.testing.assert_array_equal(up.payload.planes[plane], payload.planes[plane])
        assert torch.equal(codec.decode(up.payload)["w"], codec.decode(payload)["w"])

    def test_wire_errors(self):
        import pickle
        with pytest.raises(ValueError, match="schema mismatch"):
            msg_from_wire(pickle.dumps(("serve-wire/v0", None)))
        with pytest.raises(WireError, match="undecodable"):
            msg_from_wire(b"\x00garbage")


# ----------------------------------------------------- server lifecycle ---

class TestServerLifecycle:
    def test_graceful_drain_commits_partial_buffer(self, setup):
        """finalize() never loses an accepted update: three buffered
        reconstructions under K=4 commit as one partial flush."""
        cb = _callables(setup)
        cfg = _cfg("afl", num_clients=3, rounds=1, buffer_size=4, events_per_eval=3)
        tr = InprocTransport(3)
        server = FLServer(cfg, init_params_fn=cb["init_params_fn"],
                          evaluate_fn=cb["evaluate_fn"], transport=tr, device="cpu")
        server.start()
        init = server.global_params
        for i in range(3):
            shifted = tree_map(lambda x, _i=i: x + 0.01 * (_i + 1), init)
            tr.client_channel(i).send(_upload(i, 0, shifted))
        deadline = time.monotonic() + 20
        while server.processed < 3 and time.monotonic() < deadline:
            server.step(timeout=0.5)
        assert server.processed == 3
        assert len(server._buffer) == 3 and server.server_version == 0
        res = server.finalize()
        assert server.server_version == 1 and not server._buffer
        moved = max(float((a - b).abs().max()) for a, b in zip(
            tree_leaves(server.global_params), tree_leaves(init)))
        assert moved > 0
        assert res.comm.model_uploads == 3
        tr.close()

    def test_wedged_two_phase_exchange_discarded_via_failure_hook(self, setup):
        cb = _callables(setup)
        tr = InprocTransport(N)
        server = FLServer(_cfg("vafl", obs=ObsConfig()), init_params_fn=cb["init_params_fn"],
                          evaluate_fn=cb["evaluate_fn"], transport=tr, device="cpu")
        server.start()
        tr.client_channel(0).send(UploadMsg(kind=wire.REPORT, client=0, seq=0, version=0,
                                            sim_time=1.0, value=1e9))
        server.step(timeout=0.5)
        assert 0 in server._pending          # accepted, payload never lands
        res = server.finalize(drain_timeout=0.1)
        assert not server._pending
        assert res.metrics["counters"].get("failures", 0) == 1
        tr.close()

    def test_stalled_fleet_trips_timeout_not_wedge(self, setup):
        server, tr = _server(setup)
        server.start()
        t0 = time.monotonic()
        res = server.run(stall_timeout=0.3)       # nobody ever uploads
        assert time.monotonic() - t0 < 5.0
        assert res.comm.model_uploads == 0
        tr.close()

    def test_sequential_driver_demands_shared_ledger(self, setup):
        server, tr = _server(setup)
        with pytest.raises(ValueError, match="account_bytes"):
            SequentialDriver(server, compute=None)
        tr.close()

    def test_server_holds_trees_on_its_device(self, setup):
        """The initial model comes from the server's own generator on its
        device: the port's init of a seeded run, reproducibly."""
        tcfg = setup["tcfg"]
        cb = _callables(setup, init=False)
        tr = InprocTransport(N)
        server = FLServer(_cfg("afl"), init_params_fn=cb["init_params_fn"],
                          evaluate_fn=cb["evaluate_fn"], transport=tr, device="cpu")
        want = tcnn.mlp_init(tcfg, torch.Generator().manual_seed(SEED))
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(server.global_params),
                                                     tree_leaves(want)))
        assert server.gen.device.type == "cpu"
        tr.close()


# ------------------------------------------------------ live federations ---

def _reconciled(res):
    c = res.metrics["counters"]
    return (c.get("uploads", 0) == res.comm.model_uploads
            and c.get("scalar_reports", 0) == res.comm.scalar_reports
            and c.get("broadcasts", 0) == res.comm.broadcasts
            and c.get("upload_payload_bytes", 0) == res.comm.upload_payload_bytes)


class TestLiveServe:
    def test_live_vafl_compressed_reconciles(self, setup):
        """Concurrent thread workers, vafl + topk0.1_int8, two-phase
        protocol over inproc: the run completes and the obs counters
        reconcile with CommStats; the encode runs once per accepted
        upload (its wrapper's plain route here)."""
        loss, evaluate = setup["port"]
        federation = Federation(
            data=setup["fed"], algorithm="vafl", compressor="topk0.1_int8", obs=ObsConfig(),
            init_params_fn=lambda g: tcnn.mlp_init(setup["tcfg"], g), loss_fn=loss,
            evaluate_fn=evaluate, local=tclient.LocalSpec(**SPEC), seed=SEED, device="cpu")
        res = federation.serve(rounds=2, **BOUNDS)
        assert res.comm.broadcasts == 2 * N     # every event completed
        assert res.comm.scalar_reports == 2 * N
        assert 0 < res.comm.model_uploads <= 2 * N
        assert res.comm.upload_payload_bytes > 0
        assert res.records and np.isfinite(res.records[-1].global_acc)
        assert _reconciled(res)
        assert res.metrics["counters"].get("failures", 0) == 0
        assert res.metrics["histograms"]["queue_depth"]["count"] > 0
        assert sum(res.client_uplink_bytes) == res.comm.uplink_bytes
        assert sum(res.client_downlink_bytes) == res.comm.downlink_bytes

    def test_live_capacity_bounds_observed_depth(self, setup):
        cfg = _cfg("afl", rounds=2, obs=ObsConfig())
        res = serve_run(cfg, capacity=2, **BOUNDS, **_callables(setup))
        assert res.comm.broadcasts == 2 * N
        qd = res.metrics["histograms"]["queue_depth"]
        assert qd["max"] <= 2 + N
        assert _reconciled(res)

    def test_scenario_paced_workers(self, setup):
        """``pace=True``: workers draw service times from the run's
        scenario fleet, so upload sim_times are simulated seconds."""
        cfg = _cfg("afl", rounds=1, scenario="paper_testbed")
        res = serve_run(cfg, pace=True, **BOUNDS, **_callables(setup))
        assert res.comm.broadcasts == N
        assert res.records[-1].time > 0

    def test_multi_tenant_two_federations_one_device(self, setup):
        cb = {k: v for k, v in _callables(setup).items()}
        sa, wa, ta = launch_serving(_cfg("afl", rounds=2), recv_timeout=5.0, **cb)
        sb, wb, tb = launch_serving(_cfg("vafl", rounds=2, compressor="topk0.1_int8"),
                                    recv_timeout=5.0, **cb)
        mt = MultiTenantServer([sa, sb])
        mt.start()
        for w in wa + wb:
            w.start()
        try:
            res_a, res_b = mt.run(stall_timeout=5)
        finally:
            for w in wa + wb:
                w.stop()
            for w in wa + wb:
                w.join(timeout=5)
            ta.close()
            tb.close()
        assert not any(w.is_alive() or w.error for w in wa + wb)
        assert res_a.comm.broadcasts == 2 * N
        assert res_b.comm.broadcasts == 2 * N
        assert res_a.comm.model_uploads == 2 * N      # afl always ships
        assert res_b.comm.scalar_reports == 2 * N     # vafl reports first
        assert res_b.comm.upload_payload_bytes < res_a.comm.model_bytes * 8

    def test_thread_workers_draw_their_own_streams(self, setup):
        """Each worker's generator is seeded from (seed, client) by the
        counter-based mixing: distinct per client, fixed per seed."""
        seeds = [worker_seed(SEED, i) for i in range(N)]
        assert len(set(seeds)) == N and seeds == [worker_seed(SEED, i) for i in range(N)]
        assert all(0 <= s < 2 ** 63 for s in seeds)


# ----------------------------------------------------------- resilience ---

class TestRetryPolicy:
    def test_validation(self):
        with pytest.raises(ValueError, match="max_attempts"):
            RetryPolicy(max_attempts=0)
        with pytest.raises(ValueError, match="jitter"):
            RetryPolicy(jitter=1.5)

    def test_backoff_bounds_and_cap(self):
        rp = RetryPolicy(base_s=0.1, factor=2.0, max_backoff_s=0.3, jitter=0.5, seed=11)
        for attempt, nominal in ((1, 0.1), (2, 0.2), (3, 0.3), (6, 0.3)):
            b = rp.backoff(attempt, client=2, nonce=7)
            assert nominal * 0.5 <= b <= nominal * 1.5

    def test_backoff_deterministic_per_frame(self):
        rp = RetryPolicy(seed=4)
        assert rp.backoff(2, 1, 9) == rp.backoff(2, 1, 9)
        assert rp.backoff(2, 1, 9) != rp.backoff(2, 1, 10)

    def test_zero_jitter_is_exact(self):
        rp = RetryPolicy(base_s=0.05, factor=2.0, max_backoff_s=1.0, jitter=0.0)
        assert rp.backoff(3, 0, 0) == pytest.approx(0.2)

    def test_backoff_and_fates_equal_the_reference(self):
        """The copies draw the reference's counter streams bit for bit."""
        rp, jrp = RetryPolicy(seed=5), JRetryPolicy(seed=5)
        assert [rp.backoff(a, c, s) for a in (1, 2, 3) for c in range(3) for s in range(5)] == \
            [jrp.backoff(a, c, s) for a in (1, 2, 3) for c in range(3) for s in range(5)]
        kw = dict(drop=0.1, corrupt=0.05, duplicate=0.1, reorder=0.1, bcast_drop=0.2, seed=3)
        plan, jplan = FaultPlan(FaultSpec(**kw), 3), JFaultPlan(JFaultSpec(**kw), 3)
        for _ in range(100):
            for c in range(3):
                assert plan.fate(c) == jplan.fate(c)
                assert plan.bcast_fate(c) == jplan.bcast_fate(c)


class _ScriptedChannel:
    """A channel that answers sends from a script: replies[i] answers the
    i-th send (None = the reply was lost)."""

    def __init__(self, replies):
        self._replies = list(replies)
        self._inbox = []
        self.sends = 0

    def send(self, msg, timeout=None):
        if self._replies:
            reply = self._replies.pop(0)
            if reply is not None:
                self._inbox.append(reply)
        self.sends += 1
        return True

    def recv(self, timeout=None):
        if self._inbox:
            return self._inbox.pop(0)
        time.sleep(min(timeout or 0.01, 0.01))
        return None


_FAST = RetryPolicy(max_attempts=4, attempt_timeout_s=0.15, base_s=0.005, max_backoff_s=0.02,
                    seed=0)


def _msg(seq):
    return UploadMsg(kind=wire.REPORT, client=0, seq=seq, version=0)


class TestExchangeRetry:
    def test_lost_reply_recovered_by_retry(self):
        ch = _ScriptedChannel([None, BroadcastMsg(kind=wire.DOWNLOAD, version=1, ack_seq=3)])
        stats = {}
        reply = _exchange(ch, _msg(3), recv_timeout=5.0, retry=_FAST, stats=stats)
        assert reply is not None and reply.ack_seq == 3
        assert ch.sends == 2 and stats["retries"] == 1

    def test_stale_reply_discarded_on_ack_seq(self):
        stale = BroadcastMsg(kind=wire.DOWNLOAD, version=1, ack_seq=4)
        good = BroadcastMsg(kind=wire.DOWNLOAD, version=1, ack_seq=5)
        ch = _ScriptedChannel([None])
        ch._inbox = [stale, good]
        reply = _exchange(ch, _msg(5), recv_timeout=5.0, retry=_FAST)
        assert reply is good

    def test_exhaustion_returns_none(self):
        ch = _ScriptedChannel([])
        stats = {}
        t0 = time.monotonic()
        reply = _exchange(ch, _msg(0), recv_timeout=5.0, retry=_FAST, stats=stats)
        assert reply is None
        assert ch.sends == _FAST.max_attempts
        assert stats["retries"] == _FAST.max_attempts - 1
        assert time.monotonic() - t0 < 3.0

    def test_no_retry_without_policy(self):
        ch = _ScriptedChannel([])
        assert _exchange(ch, _msg(0), recv_timeout=0.1) is None
        assert ch.sends == 1


class TestLiveness:
    def test_silent_client_evicted_then_readmitted(self, setup):
        server, tr = _server(setup, liveness_timeout=0.05)
        server._last_heard[:] = time.monotonic() - 1.0
        server._police()
        assert server.evictions == N
        assert server._evicted == set(range(N))
        tr.client_channel(0).send(_upload(0, 0, server.global_params))
        server.step(timeout=0.2)
        assert 0 not in server._evicted
        assert server.readmissions == 1 and server.processed == 1
        tr.close()

    def test_restarted_client_rebased_fresh(self, setup):
        server, tr = _server(setup)
        ch = tr.client_channel(0)
        ch.send(_upload(0, 0, server.global_params))
        ch.send(_upload(0, 1, server.global_params))
        server.step(timeout=0.2)
        assert server.processed == 2 and server._last_seq[0] == 1
        server._evict(0, reason="test")
        ch.send(_upload(0, 0, server.global_params))   # a fresh process
        server.step(timeout=0.2)
        assert server.restarts == 1 and server.duplicates == 0
        assert server.processed == 3 and server._last_seq[0] == 0
        kinds = []
        while True:
            msg = ch.recv(timeout=0.1)
            if msg is None:
                break
            kinds.append(msg.kind)
        assert wire.INIT in kinds        # re-bootstrap broadcast
        tr.close()

    def test_wedged_exchange_expires_on_deadline(self, setup):
        server, tr = _server(setup, alg="vafl", exchange_timeout=0.05)
        tr.client_channel(0).send(UploadMsg(kind=wire.REPORT, client=0, seq=0, version=0,
                                            sim_time=1.0, value=1e9))
        server.step(timeout=0.2)
        assert 0 in server._pending      # accepted, payload never lands
        time.sleep(0.1)
        server._police()
        assert server.exchange_expired == 1
        assert not server._pending
        tr.close()


class TestCheckpointResume:
    def _records(self, res):
        return [(r.round, r.time, r.global_acc, r.uploads_so_far) for r in res.records]

    def test_serve_bridge_bit_equal(self, setup, tmp_path):
        """The server checkpoints mid-run, the bridge driver rebuilds every
        client's exact state from the bundle (and the run generator's
        state) and continues bit-identically."""
        cb = _callables(setup, init=False)
        path = str(tmp_path / "sv.ckpt")
        ref = serve_run(_cfg("afl", rounds=2), driver="sequential", **cb)
        serve_run(_cfg("afl", rounds=2, checkpoint_path=path, checkpoint_every=3),
                  driver="sequential", **cb)
        res = serve_run(_cfg("afl", rounds=2, checkpoint_path=path, resume=True),
                        driver="sequential", **cb)
        assert self._records(res) == self._records(ref)
        assert dataclasses.asdict(res.comm) == dataclasses.asdict(ref.comm)
        assert res.sim_time == ref.sim_time

    def test_serve_bridge_codec_without_ef_bit_equal(self, setup, tmp_path):
        cb = _callables(setup, init=False)
        path = str(tmp_path / "svc.ckpt")
        kw = dict(compressor="topk0.5_int8", error_feedback=False)
        ref = serve_run(_cfg("afl", rounds=2, **kw), driver="sequential", **cb)
        serve_run(_cfg("afl", rounds=2, checkpoint_path=path, checkpoint_every=3, **kw),
                  driver="sequential", **cb)
        res = serve_run(_cfg("afl", rounds=2, checkpoint_path=path, resume=True, **kw),
                        driver="sequential", **cb)
        assert self._records(res) == self._records(ref)
        assert dataclasses.asdict(res.comm) == dataclasses.asdict(ref.comm)

    def test_bridge_refuses_client_side_state(self, setup, tmp_path):
        cb = _callables(setup)
        path = str(tmp_path / "vf.ckpt")
        serve_run(_cfg("vafl", rounds=2, checkpoint_path=path, checkpoint_every=3),
                  driver="sequential", **cb)
        with pytest.raises(ValueError, match="needs_values"):
            serve_run(_cfg("vafl", rounds=2, checkpoint_path=path, resume=True),
                      driver="sequential", **cb)
        path2 = str(tmp_path / "ef.ckpt")
        kw = dict(compressor="topk0.5_int8", error_feedback=True)
        serve_run(_cfg("afl", rounds=2, checkpoint_path=path2, checkpoint_every=3, **kw),
                  driver="sequential", **cb)
        with pytest.raises(ValueError, match="error_feedback"):
            serve_run(_cfg("afl", rounds=2, checkpoint_path=path2, resume=True, **kw),
                      driver="sequential", **cb)


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


def _card_federation(setup, **kw):
    xte, yte = setup["test"]
    return Federation(model=(tcnn.mlp_forward, tcnn.mlp_init, setup["tcfg"]), data=setup["fed"],
                      test_data=(xte, yte), local=tclient.LocalSpec(**SPEC), seed=SEED,
                      events_per_eval=4, device="cuda", **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("alg", ["vafl", "afl"])
def test_gpu_bridge_equals_event_run(cuda, setup, alg):
    """On the card the bridge equals run(mode="event") bit for bit and
    launches both kernels as often (vafl: one grad_diff_norm a report;
    the encode once an accepted upload)."""
    fed = _card_federation(setup, algorithm=alg, compressor="topk0.1_int8")
    seen = {}
    evaluate = fed.evaluate_fn

    def capture(p):
        seen["params"] = p
        return evaluate(p)
    fed.evaluate_fn = capture
    out = []
    for call in (lambda: fed.run(rounds=2, mode="event"),
                 lambda: fed.serve(rounds=2, driver="sequential")):
        g0, t0 = gd_ops.launches, tq_ops.launches
        res = call()
        out.append((_everything(res, tree_map(lambda x: x.cpu(), seen["params"])),
                    gd_ops.launches - g0, tq_ops.launches - t0, res.comm.model_uploads))
    assert out[0] == out[1]
    assert out[0][2] == out[0][3] > 0
    assert out[0][1] == (2 * N if alg == "vafl" else 0)


@pytest.mark.gpu
def test_gpu_thread_workers_reconcile(cuda, setup):
    """Thread workers on the card under vafl + topk0.1_int8: the run ends,
    the byte ledgers reconcile with CommStats, one encode an accepted
    upload and one grad_diff_norm a report."""
    fed = _card_federation(setup, algorithm="vafl", compressor="topk0.1_int8")
    g0, t0 = gd_ops.launches, tq_ops.launches
    res = fed.serve(rounds=3, **BOUNDS)
    assert res.comm.broadcasts == res.comm.scalar_reports == 3 * N
    assert sum(res.client_uplink_bytes) == res.comm.uplink_bytes
    assert tq_ops.launches - t0 == res.comm.model_uploads
    assert gd_ops.launches - g0 == 3 * N
