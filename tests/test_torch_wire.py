"""repro_torch's wire and its faults against repro on the CPU: frames,
the socket transport, process client workers, the chaos transport.

* Frames: a hello frame is byte-equal in both packages; ``read_frame``
  raises the same errors (bad magic, an oversized length, EOF inside a
  frame, an undecodable body) and returns None on a clean EOF
  (tests/test_resilience.py's ``TestWireFrames``).
* The socket transport: fp32 and bf16 trees and a ``topk0.1_int8``
  payload keep their bits across it; a reader fed garbage marks its
  client dead as ``"wire-error"`` and a fresh hello re-admits it.
* The bridge over ``socket`` equals the reference's bridge over
  ``socket`` (pop order, staleness, ledgers; parameters within the event
  runtime's parity bounds) and the port's own bridge over ``inproc`` bit
  for bit.
* Chaos: for one ``FaultSpec`` and the same scripted sends the port's
  and the reference's ``ChaosTransport`` (over ``inproc``, hold times 0,
  no blackout or reset, so no host clock decides) reach the same
  ``stats`` and deliver the same per-client ``(client, seq)`` sequences;
  under seeded drop, duplicate, reorder and blackout with retrying
  thread workers every client commits the fault-free run's multiset,
  over ``inproc`` and over ``socket`` (tests/test_resilience.py:444).
* Process workers (``spawn``, the MLP, ``device="cpu"``): a SIGKILLed
  worker does not wedge the server (tests/test_serve.py:298); four
  workers commit every upload and the byte ledgers reconcile; a
  two-phase policy that reads Eq. 1 values ends the child, as in the
  reference.

Every run bounds its waits.  The tests marked ``gpu`` run process
workers, the socket bridge and the chaos soak on the card; they skip
themselves without a Hopper card and nvcc.
"""
import dataclasses
import socket
import struct
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
from repro.resilience import ChaosTransport as JChaos  # noqa: E402
from repro.resilience import FaultSpec as JFaultSpec  # noqa: E402
from repro.serve import messages as jwire  # noqa: E402
from repro.serve import serve_run as j_serve  # noqa: E402
from repro_torch.algorithms.base import Aggregator as TAggregator  # noqa: E402
from repro_torch.common.pytree import tree_leaves  # noqa: E402
from repro_torch.compress import get_codec  # noqa: E402
from repro_torch.core import client as tclient  # noqa: E402
from repro_torch.core.config import FLRunConfig as TConfig  # noqa: E402
from repro_torch.core.federation import Federation  # noqa: E402
from repro_torch.core.scheduler import EventScheduler as TScheduler  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.grad_diff_norm import ops as gd_ops  # noqa: E402
from repro_torch.kernels.topk_quant import ops as tq_ops  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.resilience import ChaosTransport, FaultSpec, RetryPolicy  # noqa: E402
from repro_torch.serve import (FLServer, ProcessClientWorker, get_transport,  # noqa: E402
                               launch_serving, serve_run)
from repro_torch.serve import messages as wire  # noqa: E402
from repro_torch.serve.messages import (MAGIC, MAX_FRAME_BYTES, BroadcastMsg,  # noqa: E402
                                        UploadMsg, WireError, msg_from_wire, msg_to_wire,
                                        read_frame)
from repro_torch.serve.socket_transport import SocketTransport  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

N, SEED = 4, 7
SPEC = dict(batch_size=32, local_rounds=1, lr=0.1)
BOUNDS = dict(stall_timeout=30.0, recv_timeout=10.0)   # every thread run bounds its waits
CHAOS = dict(drop=0.15, duplicate=0.1, reorder=0.1, blackout=0.03, blackout_s=0.3, seed=11)
RETRY = dict(max_attempts=8, attempt_timeout_s=0.5, base_s=0.02, max_backoff_s=0.25, seed=11)


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


def _callables(setup):
    loss, evaluate = setup["port"]
    tcfg = setup["tcfg"]
    return dict(init_params_fn=lambda g: tcnn.mlp_init(tcfg, g), loss_fn=loss,
                fed_data=setup["fed"], evaluate_fn=evaluate, device="cpu")


def _upload(client, seq, tree, sim_time=1.0):
    return UploadMsg(kind=wire.UPDATE, client=client, seq=seq, version=0, sim_time=sim_time,
                     payload=tree)


# --------------------------------------------------------------- frames ---

def test_hello_frame_byte_equal_to_the_reference():
    assert msg_to_wire(("hello", 3)) == jwire.msg_to_wire(("hello", 3))
    assert MAGIC == jwire.MAGIC and MAX_FRAME_BYTES == jwire.MAX_FRAME_BYTES


def _feed(case):
    """A socket pair whose reading end holds ``case``'s bytes."""
    a, b = socket.socketpair()
    if case == "bad-magic":
        a.sendall(b"XXXX" + struct.pack("!I", 4) + b"body")
    elif case == "oversized":
        a.sendall(MAGIC + struct.pack("!I", MAX_FRAME_BYTES + 1))
    elif case == "eof-mid-frame":
        a.sendall(MAGIC + struct.pack("!I", 100) + b"short")
        a.close()
    elif case == "clean-eof":
        a.close()
    return a, b


def _outcome(read, case):
    a, b = _feed(case)
    try:
        return ("value", read(b))
    except Exception as e:   # noqa: BLE001: the outcome is compared
        return (type(e).__name__, str(e))
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("case", ["bad-magic", "oversized", "eof-mid-frame", "clean-eof"])
def test_read_frame_outcomes_equal_the_reference(case):
    got, want = _outcome(read_frame, case), _outcome(jwire.read_frame, case)
    assert got == want
    kind = {"bad-magic": "WireError", "oversized": "WireError",
            "eof-mid-frame": "ConnectionError", "clean-eof": "value"}[case]
    assert got[0] == kind
    if case == "clean-eof":
        assert got[1] is None
    a, b = _feed(case)
    try:
        if kind == "WireError":
            with pytest.raises(WireError):
                read_frame(b)
        elif kind == "ConnectionError":
            with pytest.raises(ConnectionError, match="mid-frame"):
                read_frame(b)
    finally:
        a.close()
        b.close()


def test_undecodable_body_and_send_side_guard(monkeypatch):
    with pytest.raises(WireError, match="undecodable"):
        msg_from_wire(b"\x00garbage that is not a pickle")
    with pytest.raises(jwire.WireError, match="undecodable"):
        jwire.msg_from_wire(b"\x00garbage that is not a pickle")
    monkeypatch.setattr(wire, "MAX_FRAME_BYTES", 64)
    with pytest.raises(WireError, match="exceeds"):
        msg_to_wire(_upload(0, 0, {"w": torch.zeros(1024)}))


# ------------------------------------------------------ socket transport ---

class TestSocketTransport:
    def test_registry_resolves_both(self):
        assert get_transport("socket") is SocketTransport
        assert get_transport("chaos") is ChaosTransport

    def test_needs_a_card_unless_asked(self, setup):
        if torch.cuda.is_available():
            pytest.skip("a card is visible")
        with pytest.raises(RuntimeError, match="CUDA"):
            SocketTransport(1)
        with pytest.raises(RuntimeError, match="CUDA"):
            ChaosTransport(1, inner="socket")
        with pytest.raises(RuntimeError, match="CUDA"):
            ProcessClientWorker(("127.0.0.1", 1), 0, forward_fn=tcnn.mlp_forward,
                                model_cfg=setup["tcfg"], local=_cfg().local,
                                fed_data=setup["fed"])

    def test_round_trip_preserves_bits(self):
        """Uploads in and a broadcast back over localhost TCP: fp32 and
        bf16 leaves, and a topk0.1_int8 payload's int8 values and int32
        indices, bit for bit; FIFO by TCP byte order."""
        gen = torch.Generator().manual_seed(0)
        tree = {"w": torch.randn(7, generator=gen),
                "b": torch.randn(3, generator=gen).to(torch.bfloat16)}
        codec = get_codec("topk0.1_int8")
        payload = codec.encode({"w": torch.randn(1000, generator=gen)}, seed=3)
        tr = SocketTransport(1, device="cpu")
        ch = tr.client_channel(0)
        try:
            ch.send(UploadMsg(kind=wire.REPORT, client=0, seq=0, version=0, value=3.5))
            ch.send(_upload(0, 1, tree))
            ch.send(UploadMsg(kind=wire.UPDATE, client=0, seq=2, version=0, payload=payload,
                              codec=codec.name, enc_seed=3))
            first, second, third = (tr.recv_upload(timeout=5.0) for _ in range(3))
            assert (first.kind, first.seq, first.value) == (wire.REPORT, 0, 3.5)
            assert second.seq == 1 and second.recv_host > 0
            for k in tree:
                assert second.payload[k].dtype == tree[k].dtype
                assert torch.equal(second.payload[k], tree[k])
            for plane in ("idx", "val"):
                got, want = third.payload.planes[plane], payload.planes[plane]
                assert got.dtype == want.dtype and np.array_equal(got, want)
            assert payload.planes["val"].dtype == np.int8
            assert payload.planes["idx"].dtype == np.int32
            assert torch.equal(codec.decode(third.payload)["w"], codec.decode(payload)["w"])
            tr.send_broadcast(0, BroadcastMsg(kind=wire.DOWNLOAD, version=9, tree=tree,
                                              ack_seq=1))
            reply = ch.recv(timeout=5.0)
            assert reply.kind == wire.DOWNLOAD and reply.version == 9 and reply.ack_seq == 1
            for k in tree:
                assert reply.tree[k].dtype == tree[k].dtype
                assert torch.equal(reply.tree[k], tree[k])
        finally:
            ch.close()
            tr.close()

    def test_broadcast_before_connect_waits_for_the_hello(self):
        tr = SocketTransport(2, device="cpu")
        try:
            tr.send_broadcast(1, BroadcastMsg(kind=wire.INIT, version=0))
            tr.send_broadcast(1, BroadcastMsg(kind=wire.FINAL, version=4))
            ch = tr.client_channel(1)
            got = [ch.recv(timeout=5.0).kind, ch.recv(timeout=5.0).kind]
            assert got == [wire.INIT, wire.FINAL]
            ch.close()
        finally:
            tr.close()

    def test_reader_survives_garbage_as_dead_client(self, setup):
        """A corrupt frame marks the client dead with reason "wire-error";
        the server evicts it and counts the wire error, and a fresh hello
        re-admits it (tests/test_resilience.py:384)."""
        cb = _callables(setup)
        tr = SocketTransport(1, device="cpu")
        server = FLServer(_cfg("afl", num_clients=1, events_per_eval=1),
                          init_params_fn=cb["init_params_fn"], evaluate_fn=cb["evaluate_fn"],
                          transport=tr, device="cpu")
        host, port = tr.address
        raw = socket.create_connection((host, port))
        raw.sendall(msg_to_wire(("hello", 0)))
        raw.sendall(b"\xde\xad\xbe\xef garbage, not a frame")
        deadline = time.monotonic() + 5
        while not tr.dead_clients() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert tr.dead_clients() == {0}
        assert tr.dead_reasons()[0] == "wire-error"
        server._police()
        assert 0 in server._evicted and server.wire_errors >= 1
        assert server.dead_reason[0] == "wire-error"
        raw.close()
        fresh = socket.create_connection((host, port))
        fresh.sendall(msg_to_wire(("hello", 0)))
        deadline = time.monotonic() + 5
        readmitted = False
        while time.monotonic() < deadline:
            server._police()
            if 0 not in server._evicted:
                readmitted = True
                break
            time.sleep(0.01)
        assert readmitted and server.readmissions == 1
        fresh.close()
        tr.close()

    def test_thread_workers_over_socket(self, setup):
        """Thread workers over real TCP connections (tests/test_serve.py's
        ``test_live_socket_transport``), vafl + topk0.1_int8: every event
        completes and the ledgers reconcile with CommStats."""
        res = serve_run(_cfg("vafl", compressor="topk0.1_int8"), transport="socket", **BOUNDS,
                        **_callables(setup))
        assert res.comm.broadcasts == res.comm.scalar_reports == 2 * N
        assert 0 < res.comm.model_uploads <= 2 * N
        assert sum(res.client_uplink_bytes) == res.comm.uplink_bytes
        assert sum(res.client_downlink_bytes) == res.comm.downlink_bytes


# --------------------------------------------------- the bridge over TCP ---

def ref_permutations(m, events):
    """The reference bridge's draws (tests/test_torch_serve.py)."""
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


def _ledgers(res):
    return (dataclasses.asdict(res.comm), res.sim_time, res.idle_fraction, res.client_idle,
            res.client_uplink_bytes, res.client_downlink_bytes, res.client_failed_rounds,
            [(r.round, r.time, r.uploads_so_far) for r in res.records])


@pytest.mark.parametrize("alg", ["afl", "vafl"])
def test_socket_bridge_matches_reference_and_inproc(setup, monkeypatch, alg):
    """``serve(driver="sequential", transport="socket")`` under
    topk0.1_int8 against the reference's bridge over ``socket`` (the
    reference's initial parameters and permutations injected), and bit
    for bit against the port's own bridge over ``inproc``."""
    seen = _record_pops_and_staleness(monkeypatch)
    jloss, jeval = setup["ref"]
    loss, evaluate = setup["port"]
    finals = {}

    def jeval_capture(p):
        finals["ref"] = jax.tree.map(np.asarray, p)
        return jeval(p)

    def capture(key):
        def teval(p):
            finals[key] = p
            return evaluate(p)
        return teval
    base = dict(algorithm=alg, num_clients=N, rounds=2, target_acc=0.99, events_per_eval=4,
                seed=SEED, compressor="topk0.1_int8")
    ref = j_serve(JConfig(local=jclient.LocalSpec(**SPEC), **base), driver="sequential",
                  transport="socket",
                  init_params_fn=lambda k: jcnn.mlp_init(jcnn.MLPConfig(hidden=(16,)), k),
                  loss_fn=jloss, fed_data=setup["fed"], evaluate_fn=jeval_capture,
                  client_eval_fn=jeval)
    perms = ref_permutations(setup["fed"].labels.shape[1], 2 * N)
    out = {}
    for tr in ("socket", "inproc"):
        out[tr] = serve_run(
            TConfig(local=tclient.LocalSpec(**SPEC), **base), driver="sequential",
            transport=tr, init_params_fn=lambda g: from_jax_params(setup["init"]), loss_fn=loss,
            fed_data=setup["fed"], evaluate_fn=capture(tr), client_eval_fn=evaluate,
            device="cpu", perm_fn=lambda i, ev, e, m: torch.from_numpy(perms[ev]))
    pops, stales = seen["port"]
    assert len(pops) == 2 * 2 * N
    assert (pops[:2 * N], stales[:len(stales) // 2]) == seen["ref"]
    assert _ledgers(out["socket"]) == _ledgers(ref) == _ledgers(out["inproc"])
    assert [r.global_acc for r in out["socket"].records] == \
        [r.global_acc for r in out["inproc"].records]
    sock, inproc = tree_leaves(finals["socket"]), tree_leaves(finals["inproc"])
    assert all(torch.equal(a, b) for a, b in zip(sock, inproc))
    diff = np.concatenate([np.abs(b.numpy() - a).ravel() for a, b in zip(
        jax.tree.leaves(finals["ref"]), sock)])
    # a last-bit difference can tip one entry's stochastic rounding across
    # an integer step (tests/test_torch_events.py)
    assert (diff > 1e-4).mean() <= 1e-3 and diff.max() <= 1e-3, diff.max()


# ----------------------------------------------------------------- chaos ---

def _script(transport_cls, spec_cls, upload_cls, bcast_cls, frames=240):
    """Scripted sends from one thread through a ChaosTransport over inproc
    with a drain after each: its stats and the per-client (client, seq)
    sequences it delivered, uplink and downlink."""
    spec = spec_cls(drop=0.1, corrupt=0.05, duplicate=0.1, reorder=0.1, delay=0.05,
                    reorder_s=0.0, delay_s=0.0, bcast_drop=0.2, seed=5)
    t = transport_cls(N, faults=spec)
    chans = [t.client_channel(i) for i in range(N)]
    up = {i: [] for i in range(N)}
    down = {i: [] for i in range(N)}
    seqs = [0] * N
    for i in np.random.RandomState(0).randint(0, N, frames):
        i = int(i)
        chans[i].send(upload_cls(kind="update", client=i, seq=seqs[i], version=0))
        seqs[i] += 1
        while True:
            m = t.recv_upload(timeout=0)
            if m is None:
                break
            up[m.client].append((m.client, m.seq))
            t.send_broadcast(m.client, bcast_cls(kind="download", ack_seq=m.seq))
        for j in range(N):
            while True:
                b = chans[j].recv(timeout=0)
                if b is None:
                    break
                down[j].append((j, b.ack_seq))
    stats = dict(t.stats)
    faults = t.poll_fault_stats()
    wire_errors = t.poll_wire_errors()
    t.close()
    return stats, up, down, faults, wire_errors


def test_chaos_fates_equal_the_reference():
    got = _script(ChaosTransport, FaultSpec, UploadMsg, BroadcastMsg)
    want = _script(JChaos, JFaultSpec, jwire.UploadMsg, jwire.BroadcastMsg)
    assert got == want
    stats = got[0]
    for kind in ("drop", "corrupt", "duplicate", "reorder", "delay", "bcast_drop"):
        assert stats[kind] > 0, kind     # every scripted fate fired
    assert got[4] == stats["corrupt"]


def test_chaos_surfaces_blackout_and_corrupt_to_the_server(setup):
    """A blackout reads as a dead client (reason "blackout") and the
    server evicts it; corrupt frames reach its wire-error counter through
    ``poll_wire_errors`` (tests/test_resilience.py:314-337)."""
    cb = _callables(setup)
    chaos = ChaosTransport(N, faults=FaultSpec(seed=1))
    chaos._dark_until[2] = time.monotonic() + 5.0
    chaos._wire_errors = 3
    server = FLServer(_cfg("afl"), init_params_fn=cb["init_params_fn"],
                      evaluate_fn=cb["evaluate_fn"], transport=chaos, device="cpu")
    assert chaos.dead_reasons() == {2: "blackout"}
    server._police()
    assert 2 in server._evicted and server.evictions == 1
    assert server.dead_reason[2] == "blackout"
    assert server.wire_errors == 3 and chaos.poll_wire_errors() == 0
    chaos.close()


def _lap(setup, transport, *, retry=None, **kw):
    server, workers, tr = launch_serving(_cfg("afl", rounds=3), transport=transport,
                                         recv_timeout=10.0, retry=retry, **kw,
                                         **_callables(setup))
    try:
        server.start()
        for w in workers:
            w.start()
        server.run(stall_timeout=30.0)
        for w in workers:
            w.stop()
        for w in workers:
            w.join(timeout=10.0)
    finally:
        tr.close()
    assert not any(w.error for w in workers), [w.error for w in workers]
    return server, workers


@pytest.mark.parametrize("inner", ["inproc", "socket"])
def test_chaos_commits_fault_free_multiset(setup, inner):
    """Under seeded drop + duplicate + reorder + blackout with retrying
    clients every client commits exactly as many updates as the
    fault-free run, and the schedule fired (tests/test_resilience.py:444),
    over ``inproc`` and over ``socket``."""
    s0, _ = _lap(setup, inner)
    base = [int(x) for x in s0.accepted_by_client]
    assert s0.processed == 3 * N and base == [3] * N
    chaos = ChaosTransport(N, inner=inner, faults=FaultSpec(**CHAOS), device="cpu")
    s1, workers = _lap(setup, chaos, retry=RetryPolicy(**RETRY), exchange_timeout=10.0,
                       liveness_timeout=30.0)
    assert [int(x) for x in s1.accepted_by_client] == base
    assert s1.processed == s0.processed
    injected = sum(chaos.stats[k] for k in ("drop", "duplicate", "reorder", "blackout"))
    assert injected > 0, "fault schedule never fired"
    if chaos.stats["drop"] or chaos.stats["blackout"]:
        assert sum(w.stats["retries"] for w in workers) > 0


# ------------------------------------------------------- process workers ---

def _process_server(setup, cfg):
    cb = _callables(setup)
    tr = SocketTransport(cfg.num_clients, device="cpu")
    server = FLServer(cfg, init_params_fn=cb["init_params_fn"], evaluate_fn=cb["evaluate_fn"],
                      transport=tr, device="cpu")
    return server, tr


def _worker(setup, tr, i, cfg, **kw):
    return ProcessClientWorker(tr.address, i, forward_fn=tcnn.mlp_forward,
                               model_cfg=setup["tcfg"], local=cfg.local,
                               fed_data=setup["fed"], device="cpu", **kw)


def test_killed_process_worker_does_not_wedge_server(setup, monkeypatch):
    """A client OS process SIGKILLed mid-run: the server keeps draining
    what arrived, trips the stall timeout and finalizes; it never blocks
    on the dead client (tests/test_serve.py:298)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = _cfg("afl", rounds=10_000, events_per_eval=100_000)
    server, tr = _process_server(setup, cfg)
    worker = _worker(setup, tr, 0, cfg)
    try:
        server.start()
        worker.start()
        deadline = time.monotonic() + 120
        while server.processed < 1 and time.monotonic() < deadline:
            server.step(timeout=0.1)
        assert server.processed >= 1, "worker never delivered an upload"
        worker.kill()
        t0 = time.monotonic()
        res = server.run(stall_timeout=1.5)
        assert time.monotonic() - t0 < 30
        worker.join(timeout=10)
        assert worker.exitcode is not None      # actually dead
        assert 1 <= server.processed < server.total_events
        assert res.comm.model_uploads == server.processed
    finally:
        worker.kill()
        tr.close()


def test_process_workers_commit_and_reconcile(setup, monkeypatch):
    """Four spawned workers on the CPU over TCP: every event completes,
    each client commits its rounds, and the byte ledgers reconcile with
    CommStats."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = _cfg("afl", compressor="topk0.1_int8")
    server, tr = _process_server(setup, cfg)
    workers = [_worker(setup, tr, i, cfg) for i in range(N)]
    try:
        server.start()
        for w in workers:
            w.start()
        res = server.run(stall_timeout=60.0)
        for w in workers:
            w.join(timeout=30)
    finally:
        for w in workers:
            w.kill()
        tr.close()
    assert [w.exitcode for w in workers] == [0] * N
    assert res.comm.broadcasts == res.comm.model_uploads == 2 * N
    assert [int(x) for x in server.accepted_by_client] == [2] * N
    assert sum(res.client_uplink_bytes) == res.comm.uplink_bytes
    assert sum(res.client_downlink_bytes) == res.comm.downlink_bytes
    assert res.comm.upload_payload_bytes < res.comm.model_bytes * 2 * N


def test_process_worker_refuses_value_policies_in_the_child(setup, monkeypatch):
    """vafl reads Eq. 1 values, which need the server's eval set: the
    child raises (``ClientCompute.helpers``) and exits non-zero before its
    first report, as the reference's child does; the server stalls out
    cleanly with nothing processed."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = _cfg("vafl")
    server, tr = _process_server(setup, cfg)
    worker = _worker(setup, tr, 0, cfg)
    try:
        server.start()
        worker.start()
        worker.join(timeout=120)
        res = server.run(stall_timeout=0.5)
    finally:
        worker.kill()
        tr.close()
    assert worker.exitcode == 1
    assert server.processed == 0 and res.comm.scalar_reports == 0


# -------------------------------------------------------------- the card ---

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
                      events_per_eval=4, device="cuda", compressor="topk0.1_int8", **kw)


@pytest.mark.gpu
def test_gpu_process_workers_run_on_the_card(cuda, setup):
    """Process workers computing on the card: each child's encode
    launches there (its count comes back on a queue), the children's
    counts sum to the server's accepted uploads, and the ledgers
    reconcile."""
    import multiprocessing
    import chip_smoke
    build.build(("grad_diff_norm", "topk_quant"))     # built before any child starts
    cfg = _cfg("afl", compressor="topk0.1_int8")
    xte, yte = setup["test"]
    evaluate = tclient.make_evaluator(tcnn.mlp_forward, setup["tcfg"], xte, yte, batch=200,
                                      device="cuda")
    tr = SocketTransport(N, device="cuda")
    server = FLServer(cfg, init_params_fn=_callables(setup)["init_params_fn"],
                      evaluate_fn=evaluate, transport=tr, device="cuda")
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    host, port = tr.address
    procs = [ctx.Process(target=chip_smoke.counting_client, args=(
        q, str(chip_smoke.ROOT), host, port, i, tcnn.mlp_forward, setup["tcfg"], cfg.local,
        *(np.asarray(getattr(setup["fed"], k)[i:i + 1]) for k in ("images", "labels", "mask")),
        None, None, "cuda", 120.0)) for i in range(N)]
    try:
        server.start()
        for p in procs:
            p.start()
        res = server.run(stall_timeout=120.0)
        counts = [q.get(timeout=120) for _ in procs]
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            p.kill()
        tr.close()
    assert [p.exitcode for p in procs] == [0] * N
    assert all(c["device"] == "cuda" and c["topk_quant"] > 0 and c["jax_free"] for c in counts)
    assert sum(c["topk_quant"] for c in counts) == res.comm.model_uploads == 2 * N
    assert sum(res.client_uplink_bytes) == res.comm.uplink_bytes


@pytest.mark.gpu
@pytest.mark.parametrize("alg", ["vafl", "afl"])
def test_gpu_socket_bridge_equals_event_run(cuda, setup, alg):
    """On the card the bridge over TCP equals run(mode="event") bit for
    bit, with the same launches of both kernels."""
    fed = _card_federation(setup, algorithm=alg)
    seen = {}
    evaluate = fed.evaluate_fn

    def capture(p):
        seen["params"] = p
        return evaluate(p)
    fed.evaluate_fn = capture
    out = []
    for call in (lambda: fed.run(rounds=2, mode="event"),
                 lambda: fed.serve(rounds=2, driver="sequential", transport="socket")):
        g0, t0 = gd_ops.launches, tq_ops.launches
        res = call()
        out.append((_ledgers(res), [r.global_acc for r in res.records],
                    [x.cpu().numpy().tobytes() for x in tree_leaves(seen["params"])],
                    gd_ops.launches - g0, tq_ops.launches - t0))
    assert out[0] == out[1]
    assert out[0][4] > 0 and out[0][3] == (2 * N if alg == "vafl" else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("inner", ["inproc", "socket"])
def test_gpu_chaos_commits_fault_free_multiset(cuda, setup, inner):
    fed = _card_federation(setup, algorithm="afl")
    base = fed.serve(rounds=3, **BOUNDS)
    chaos = ChaosTransport(N, inner=inner, faults=FaultSpec(**CHAOS), device="cuda")
    t0 = tq_ops.launches
    res = fed.serve(rounds=3, transport=chaos, retry=RetryPolicy(**RETRY),
                    exchange_timeout=10.0, liveness_timeout=30.0, **BOUNDS)
    assert res.comm.broadcasts == base.comm.broadcasts == 3 * N
    assert res.comm.model_uploads == base.comm.model_uploads == 3 * N
    assert tq_ops.launches - t0 >= res.comm.model_uploads
    assert sum(chaos.stats[k] for k in ("drop", "duplicate", "reorder", "blackout")) > 0
