"""Client workers: the other end of a serve transport.  Port of
``repro.serve.client``.

Two drivers share one compute bundle (:class:`ClientCompute`, the same
local update and Eq. 1 helpers the closed-loop runtimes use):

* :class:`ThreadClientWorker`: a free-running thread per client: local
  round -> (report ->) upload -> download, repeatedly, optionally paced
  by a ``repro_torch.sim`` speed model (:class:`ScenarioPacer`).
  Concurrency is real: arrival order at the server is whatever the
  threads produce.  Each worker draws its permutations from a
  ``torch.Generator`` of its own on the device, seeded from ``(seed,
  client)`` by the counter-based mixing of ``repro_torch.sim.base``
  (the reference folds the client into its key), so a thread run is
  held to statistical and accounting bars, not to bits.

* :class:`SequentialDriver`: the determinism bridge.  One thread owns
  every client AND pumps the server between sends, drawing from the
  server's run generator in ``run_event_driven``'s order (the initial
  model, then each event's permutations) with its encode seeds and
  scheduler arithmetic: a ``buffer_size=1`` serve run through this
  driver is bit-identical to ``run(mode="event")``, on either device.

The reference's third driver, ``ProcessClientWorker`` (an OS process
over the socket transport), is ROADMAP.md queue 1 item 9b.

Wire discipline shared by the drivers: ``seq`` increments on every
message a client sends (the server dedups on it), and ``version``
echoes the last download.
"""
from __future__ import annotations

import threading
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from repro_torch.common.pytree import stacked_index, tree_broadcast, tree_map
from repro_torch.compress import ErrorFeedback, compress_update, get_codec
from repro_torch.core import value as value_lib
from repro_torch.core.config import resolve_device
from repro_torch.core.client import make_local_update
from repro_torch.core.runtimes.common import (_UPLOAD, _enc_seed, _event_helpers, _tree_delta,
                                              _value_fn)
from repro_torch.serve import messages as wire
from repro_torch.serve.messages import UploadMsg
from repro_torch.sim.base import _hash

# the counter stream a thread worker's generator seed is drawn from (the
# sim streams are 1-6, repro_torch.sim.base)
STREAM_WORKER = 7


def worker_seed(seed: int, client: int) -> int:
    """A thread worker's generator seed: the run seed and the client id
    mixed by splitmix64 (distinct clients, independent streams)."""
    return _hash(seed, STREAM_WORKER, client, 0) >> 1


class ClientCompute:
    """The per-client math, shared across workers in one process: the
    local update over size-1 stacks plus the lazily-built scalar helpers
    (Eq. 1 values through ``value_backend``, the grad_diff_norm kernel on
    ``cuda``; gradient norms).  It runs on ``cuda`` unless ``device="cpu"``
    is passed, and raises without a card."""

    def __init__(self, *, loss_fn, local, data, num_clients, client_eval_fn=None,
                 sq_diff=None, device="cuda", perm_fn=None):
        self.device = resolve_device(device)
        self.local_update = make_local_update(loss_fn, local, perm_fn=perm_fn)
        self.data = {"images": torch.as_tensor(np.asarray(data["images"]), device=self.device),
                     "labels": torch.as_tensor(np.asarray(data["labels"]),
                                               device=self.device).long(),
                     "mask": torch.as_tensor(np.asarray(data["mask"]), device=self.device)}
        self._num_clients = num_clients
        self._client_eval_fn = client_eval_fn
        self._sq_diff = sq_diff
        self._helpers = None

    @classmethod
    def for_run(cls, run_cfg, *, loss_fn, fed_data, client_eval_fn=None, device="cuda",
                perm_fn=None):
        return cls(loss_fn=loss_fn, local=run_cfg.local,
                   data={"images": fed_data.images, "labels": fed_data.labels,
                         "mask": fed_data.mask},
                   num_clients=run_cfg.num_clients, client_eval_fn=client_eval_fn,
                   sq_diff=_value_fn(run_cfg), device=device, perm_fn=perm_fn)

    def helpers(self):
        if self._helpers is None:
            if self._client_eval_fn is None:
                raise ValueError(
                    "this worker's policy reads Eq. 1 values, which need a client eval fn: "
                    "pass client_eval_fn/evaluate_fn to ClientCompute")
            self._helpers = _event_helpers(SimpleNamespace(num_clients=self._num_clients),
                                           self._client_eval_fn, self._sq_diff)
        return self._helpers

    def local_round(self, params, i, gen, step):
        """One client's local round as a size-1 stacked call, drawing from
        ``gen`` with ``step`` passed on to ``perm_fn``; returns (stacked
        new params, stacked effective gradient)."""
        one = tree_broadcast(params, 1)
        d_i = {k: v[i:i + 1] for k, v in self.data.items()}
        newp_s, eff_s, _ = self.local_update(one, d_i, gen, step, clients=[i])
        return newp_s, eff_s

    def value(self, newp_s, eff_s, prev_grad) -> float:
        """Eq. 1 V for this round, the closed loop's arithmetic including
        the zeros prev-grad on a client's first round."""
        batch_eval, values_fn, _ = self.helpers()
        accs = batch_eval(newp_s)
        pg = (prev_grad if prev_grad is not None
              else tree_map(torch.zeros_like, stacked_index(eff_s, 0)))
        return float(values_fn(tree_broadcast(pg, 1), eff_s, accs)[0])

    def norm(self, eff_s) -> float:
        return float(value_lib.stacked_sq_norms(eff_s)[0])


class ScenarioPacer:
    """Paces free-running workers from a ``repro_torch.sim`` speed model:
    each round draws the client's simulated service time, advances that
    client's sim clock (the ``sim_time`` it stamps on uploads) and, when
    ``time_scale > 0``, sleeps ``time_scale`` host seconds per simulated
    second (capped), so traffic follows the scenario's shape without
    replaying it in real time."""

    def __init__(self, speed, time_scale: float = 0.0, max_sleep: float = 0.25):
        self.speed = speed
        self.time_scale = time_scale
        self.max_sleep = max_sleep
        self._t = {}
        self._lock = threading.Lock()   # workers share the speed model's counters

    def advance(self, client: int) -> float:
        with self._lock:
            t0 = self._t.get(client, 0.0)
            service = float(self.speed.sample(client, t0))
            self._t[client] = t0 + service
        if self.time_scale > 0:
            time.sleep(min(service * self.time_scale, self.max_sleep))
        return t0 + service


# ------------------------------------------------------- worker loop ---

def _recv_ctrl(channel, timeout: float, stop=None, skip_init: bool = False):
    """Wait for the server's next broadcast, polling so a stop flag can
    break the wait; None on deadline.  ``skip_init`` drops stray mid-run
    INIT frames (a server that re-admitted this client as fresh)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if stop is not None and stop.is_set():
            return None
        msg = channel.recv(timeout=0.05)
        if msg is not None:
            if skip_init and msg.kind == wire.INIT:
                continue
            return msg
    return None


def _exchange(channel, msg, *, recv_timeout: float, stop=None, retry=None, stats=None):
    """One stop-and-wait exchange: send ``msg``, wait for its reply.

    Without a :class:`~repro_torch.resilience.RetryPolicy` this is one
    send and one wait.  With one, the SAME frame (same ``seq``) is re-sent
    with exponential backoff and seeded jitter whenever an attempt's
    reply wait times out; the server dedups by ``(client, seq)`` and
    replays its cached reply.  Replies are matched on ``ack_seq``: a
    stale reply to a previous exchange is discarded.  Returns the reply,
    or None on exhaustion."""
    attempts = 1 if retry is None else retry.max_attempts
    wait = recv_timeout if retry is None else retry.attempt_timeout_s
    for attempt in range(1, attempts + 1):
        if stop is not None and stop.is_set():
            return None
        if attempt > 1:
            if stats is not None:
                stats["retries"] = stats.get("retries", 0) + 1
            time.sleep(retry.backoff(attempt - 1, msg.client, msg.seq))
        if not channel.send(msg, timeout=recv_timeout):
            continue                   # backpressure deadline: retry
        deadline = time.monotonic() + wait
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            reply = _recv_ctrl(channel, left, stop, skip_init=True)
            if reply is None:
                break
            if (reply.kind in (wire.DECISION, wire.DOWNLOAD)
                    and reply.ack_seq >= 0 and reply.ack_seq != msg.seq):
                continue               # stale reply: keep waiting
            return reply
    return None


def _client_loop(compute: ClientCompute, channel, client: int, *, pacer=None,
                 rounds: Optional[int] = None, recv_timeout: float = 30.0, stop=None,
                 retry=None, stats=None) -> int:
    """The free-running client body of a thread worker; returns the
    number of completed rounds.  ``retry`` (a
    ``repro_torch.resilience.RetryPolicy``) makes every exchange survive
    lost frames and lost replies; ``stats`` (a dict) accumulates the
    retry count."""
    init = _recv_ctrl(channel, recv_timeout, stop)
    if init is None or init.kind != wire.INIT:
        return 0
    meta = init.meta
    params = init.tree
    seed_cfg = SimpleNamespace(seed=meta["seed"])
    codec = get_codec(meta["compressor"])
    ef = ErrorFeedback(enabled=meta["error_feedback"])
    # a generator of this worker's own: independent streams, no
    # cross-thread coordination (the sequential driver shares the run's)
    gen = torch.Generator(device=compute.device).manual_seed(worker_seed(meta["seed"], client))
    prev_grad = None
    version = int(init.version)   # 0 on a fresh run; the restored version after a resume
    seq = 0
    t0 = time.monotonic()
    total = rounds if rounds is not None else int(meta["rounds"])
    r = 0
    while r < total and not (stop is not None and stop.is_set()):
        sim_t = pacer.advance(client) if pacer is not None else time.monotonic() - t0
        newp_s, eff_s = compute.local_round(params, client, gen, r)
        value = norm = None
        if meta["needs_values"]:
            value = compute.value(newp_s, eff_s, prev_grad)
        if meta["needs_norms"]:
            norm = compute.norm(eff_s)
        reply = None
        if meta["two_phase"]:
            reply = _exchange(channel, UploadMsg(
                kind=wire.REPORT, client=client, seq=seq, version=version, sim_time=sim_t,
                value=value, norm=norm), recv_timeout=recv_timeout, stop=stop, retry=retry,
                stats=stats)
            seq += 1
            if reply is None or reply.kind == wire.FINAL:
                break
        if reply is None or reply.kind == wire.DECISION:
            newp = stacked_index(newp_s, 0)
            if codec.is_identity:
                payload, enc_seed = newp, 0
            else:
                # free workers seed the encoder from their OWN round
                # counter (the closed loop's global event counter does
                # not exist under concurrency); deterministic per client
                enc_seed = _enc_seed(seed_cfg, r, client, _UPLOAD)
                payload, _ = compress_update(codec, ef, client, _tree_delta(newp, params),
                                             seed=enc_seed)
            reply = _exchange(channel, UploadMsg(
                kind=wire.UPDATE, client=client, seq=seq, version=version, sim_time=sim_t,
                codec=codec.name, payload=payload, enc_seed=enc_seed),
                recv_timeout=recv_timeout, stop=stop, retry=retry, stats=stats)
            seq += 1
        if reply is None or reply.kind == wire.FINAL:
            break
        if reply.kind != wire.DOWNLOAD:
            raise RuntimeError(f"protocol violation: expected download, got {reply.kind!r}")
        params = reply.tree
        version = reply.version
        prev_grad = stacked_index(eff_s, 0)
        r += 1
    channel.close()
    return r


class ThreadClientWorker(threading.Thread):
    """One client as a daemon thread over any transport's channel.  An
    exception in the client body is kept on ``error`` (the server then
    trips its stall timeout) rather than lost."""

    def __init__(self, compute: ClientCompute, channel, client: int, *, pacer=None,
                 rounds: Optional[int] = None, recv_timeout: float = 30.0, retry=None):
        super().__init__(daemon=True, name=f"serve-client-{client}")
        self.client = client
        self.completed = 0
        self.error = None
        self.stats = {"retries": 0}
        self._kw = dict(pacer=pacer, rounds=rounds, recv_timeout=recv_timeout, retry=retry,
                        stats=self.stats)
        self._compute, self._channel = compute, channel
        # NOT "_stop": threading.Thread owns that name
        self._stop_evt = threading.Event()

    def stop(self) -> None:
        self._stop_evt.set()

    def run(self) -> None:
        try:
            self.completed = _client_loop(self._compute, self._channel, self.client,
                                          stop=self._stop_evt, **self._kw)
        except Exception as e:    # noqa: BLE001: serve_run raises it after the join
            self.error = e


# ------------------------------------------------- sequential driver ---

class SequentialDriver:
    """The determinism bridge: one thread plays every client in the
    scheduler's completion order and pumps ``server.step()`` between
    sends, so a ``buffer_size=1`` serve run is bit-identical to
    ``run_event_driven`` (the same generator drawn in the same order, the
    same encode seeds, the same scheduler arithmetic).

    The driver owns the :class:`EventScheduler` (build the server with
    ``account_bytes=False``) and bills each event's actual wire bytes
    into it where the closed loop does."""

    def __init__(self, server, compute: ClientCompute):
        if server._account_bytes:
            raise ValueError(
                "SequentialDriver bills the scheduler itself: build the FLServer with "
                "account_bytes=False and a shared sched")
        self.server = server
        self.compute = compute

    def _pump_recv(self, channel):
        """Alternate server.step() with channel polls until the reply
        lands (single-threaded: the reply is deterministic and queued)."""
        for _ in range(1000):
            msg = channel.recv(timeout=0)
            if msg is not None:
                return msg
            self.server.step(timeout=0)
        raise RuntimeError("serve exchange wedged: no reply after the server drained its "
                           "queue (transport bug?)")

    def run(self):
        server, compute = self.server, self.compute
        cfg = server.cfg
        N = cfg.num_clients
        channels = [server.transport.client_channel(i) for i in range(N)]
        start_ev = server.processed
        if start_ev:
            # a resumed server (restore_checkpoint(fresh_clients=False)):
            # every client's state comes from the server's checkpointed
            # view (params from the per-client decode base, versions and
            # seq watermarks) instead of the init broadcast, and the run
            # generator was restored with it
            if server.policy.needs_values:
                raise ValueError(
                    "bit-equal bridge resume needs a policy without needs_values: per-client "
                    "prev-grad state lives client-side and is not in the server checkpoint")
            codec = get_codec(cfg.compressor)
            if not codec.is_identity and cfg.error_feedback:
                raise ValueError(
                    "bit-equal bridge resume with a codec needs error_feedback=False: EF "
                    "residuals live client-side and are not in the server checkpoint")
            meta = {"needs_values": server.policy.needs_values,
                    "needs_norms": server.policy.needs_norms,
                    "two_phase": server.two_phase, "compressor": cfg.compressor,
                    "error_feedback": cfg.error_feedback}
            params = [server.client_base[i] for i in range(N)]
            versions = [int(v) for v in server.model_version]
            seqs = [int(s) + 1 for s in server._last_seq]
        else:
            server.start()
            inits = [self._pump_recv(ch) for ch in channels]
            meta = inits[0].meta
            params = [init.tree for init in inits]
            codec = get_codec(meta["compressor"])
            versions = [0] * N
            seqs = [0] * N
        ef = ErrorFeedback(enabled=meta["error_feedback"])
        prev_grads = [None] * N
        sched = server.sched
        gen = server.gen        # drawn for the initial model already
        # the driver owns checkpoint cadence: the server's own save fires
        # inside _finish_event, BEFORE this loop bills the event's bytes
        # into the scheduler; every save waits for sched.schedule() below
        ckpt_every, server._ckpt_every = server._ckpt_every, 0
        for ev in range(start_ev, server.total_events):
            t_now, i = sched.pop()
            u0, d0 = server.comm.uplink_bytes, server.comm.downlink_bytes
            newp_s, eff_s = compute.local_round(params[i], i, gen, ev)
            value = norm = None
            if meta["needs_values"]:
                value = compute.value(newp_s, eff_s, prev_grads[i])
            if meta["needs_norms"]:
                norm = compute.norm(eff_s)
            ch = channels[i]
            reply = None
            if meta["two_phase"]:
                ch.send(UploadMsg(kind=wire.REPORT, client=i, seq=seqs[i], version=versions[i],
                                  sim_time=t_now, value=value, norm=norm))
                seqs[i] += 1
                reply = self._pump_recv(ch)
            if reply is None or reply.kind == wire.DECISION:
                newp = stacked_index(newp_s, 0)
                if codec.is_identity:
                    payload, enc_seed = newp, 0
                else:
                    # the GLOBAL event counter seeds the encoder: the
                    # bit-exactness hinge against the closed loop
                    enc_seed = _enc_seed(cfg, ev, i, _UPLOAD)
                    payload, _ = compress_update(codec, ef, i, _tree_delta(newp, params[i]),
                                                 seed=enc_seed)
                ch.send(UploadMsg(kind=wire.UPDATE, client=i, seq=seqs[i], version=versions[i],
                                  sim_time=t_now, codec=codec.name, payload=payload,
                                  enc_seed=enc_seed))
                seqs[i] += 1
                reply = self._pump_recv(ch)
            if reply.kind != wire.DOWNLOAD:
                raise RuntimeError(f"protocol violation: expected download, got "
                                   f"{reply.kind!r}")
            params[i] = reply.tree
            versions[i] = reply.version
            prev_grads[i] = stacked_index(eff_s, 0)
            # the round's actual wire bytes reschedule the client: the
            # closed loop's call (byte-aware network models included)
            sched.schedule(i, upload_bytes=server.comm.uplink_bytes - u0,
                           download_bytes=server.comm.downlink_bytes - d0)
            if ckpt_every and server.processed % ckpt_every == 0:
                server.save_checkpoint()
        return server.finalize()


class ProcessClientWorker:
    """One client as an OS process over the socket transport: not ported
    yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("process client workers and the socket transport are not "
                                  "ported to repro_torch yet (ROADMAP.md, queue 1 item 9b)")
