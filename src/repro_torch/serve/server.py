"""``FLServer``: the federation as a live service.  Port of
``repro.serve.server``.

The closed-loop runtimes pull completions from a simulated scheduler;
the server's hot loop instead drains a transport's upload queue into
windows and feeds each message through the SAME protocol objects
(``UploadPolicy`` / ``Aggregator``), codec plumbing and accounting the
runtimes use:

* scalar **reports** run the policy's ship/skip decision with exact
  fleet-wide state server-side (two-phase exchange: decision frames go
  back unbilled, like the closed loop's in-process decision);
* accepted **updates** decode against the model the client actually
  downloaded (per-client base cache), enter a FedBuff-style buffer of
  ``buffer_size`` reconstructions and commit through the shared
  ``_flush_reconstructions``; ``buffer_size=1`` is the sequential
  per-arrival mix bit for bit;
* every event closes with a **download** carrying the latest global
  model; per-client version tracking feeds the staleness weights s(tau).

The server's trees live on the federation's device (``device=``, a CUDA
device unless the caller asks for the CPU).  Its initial model comes
from ``torch.Generator(device).manual_seed(seed)``, the first draws of
the generator the sequential bridge driver goes on drawing from, as
``run_event_driven`` does.

``EventScheduler`` is reused for bookkeeping only (per-client byte
ledgers and, under the single-threaded bridge driver, the exact
simulated clock); nothing here waits on simulated time.  Every transport
receive carries a timeout; a stalled fleet trips ``stall_timeout`` and
the drain path commits whatever is buffered instead of wedging.

Resilience: uploads are deduplicated by ``(client, seq)``: a replayed
seq re-sends the cached reply instead of reprocessing, so at-least-once
clients compose into exactly-once processing; accepted two-phase
reports carry a per-exchange deadline (``exchange_timeout``); clients
silent past ``liveness_timeout`` (or reported dead by the transport)
are evicted, and re-admitted on their next message, with a fresh decode
base when they restarted (seq back at 0) or reconnected.
``checkpoint_path``/``checkpoint_every`` on the config write one atomic
full-run checkpoint (``repro_torch.checkpoint``), and ``resume=True``
continues from it.
"""
from __future__ import annotations

import os
import time
from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch

import repro_torch.checkpoint.store as ck
from repro_torch.algorithms.base import UploadPolicy
from repro_torch.common.pytree import tree_bytes, tree_map
from repro_torch.core.config import resolve_device
from repro_torch.core.metrics import CommStats, RoundRecord, RunResult
from repro_torch.core.runtimes.common import (_BROADCAST, _attach_sim_result,
                                              _compressed_broadcast, _enc_seed, _finish_obs,
                                              _flush_reconstructions, _make_codecs,
                                              _obs_for_run, _scenario_models,
                                              _tree_apply_delta, _tree_delta)
from repro_torch.core.scheduler import EventScheduler, SpeedModel
from repro_torch.obs.console import progress
from repro_torch.serve import messages as wire
from repro_torch.serve.messages import BroadcastMsg, UploadMsg
from repro_torch.serve.transport import Transport

# hot-loop poll granularity: long enough to sleep the loop when the
# fleet is quiet, short enough that stop() and stall checks respond
_POLL = 0.05

_COUNTERS = ("duplicates", "evictions", "readmissions", "exchange_expired", "wire_errors",
             "restarts")


class FLServer:
    """One federation behind a transport.  Lifecycle:

        server = FLServer(cfg, init_params_fn=..., evaluate_fn=...,
                          transport=transport, device="cuda")
        server.start()                      # init broadcasts
        result = server.run()               # hot loop until total_events
        # or: server.step(timeout) from an external loop (multi-tenant),
        #     then server.finalize()
    """

    def __init__(self, run_cfg, *, init_params_fn, evaluate_fn, transport: Transport,
                 total_events: Optional[int] = None, sched: Optional[EventScheduler] = None,
                 speed: Optional[SpeedModel] = None, account_bytes: bool = True,
                 verbose: bool = False, exchange_timeout: Optional[float] = None,
                 liveness_timeout: Optional[float] = None, resume_fresh_clients: bool = True,
                 name: str = "default", device="cuda"):
        alg, policy, aggregator = run_cfg.make_algorithm()
        if alg.event_mode != "async":
            raise ValueError(
                f"algorithm {run_cfg.algorithm!r} runs a sync barrier "
                "(event_mode='sync-barrier'); the live serve loop has no "
                "barrier; use an async algorithm (afl/vafl/eaflm/fedasync)")
        self.device = resolve_device(device)
        self.cfg = run_cfg
        # the tenant label of this federation (multi-tenant serving)
        self.name = name
        self.policy, self.aggregator = policy, aggregator
        N = run_cfg.num_clients
        policy.begin_run(N)
        aggregator.begin_run(N)
        # the run generator: the initial model is its first draws, as in
        # run_event_driven; the sequential bridge driver draws each
        # event's permutations from it afterwards
        self.gen = torch.Generator(device=self.device).manual_seed(run_cfg.seed)
        self.global_params = tree_map(lambda x: x.to(self.device), init_params_fn(self.gen))
        self.evaluate_fn = evaluate_fn
        self.comm = CommStats(model_bytes=tree_bytes(self.global_params))
        self.codec, self.bcodec, _ef = _make_codecs(run_cfg)   # EF is client-side
        self.obs = _obs_for_run(run_cfg)
        self.transport = transport
        self.verbose = verbose

        # scheduler: bookkeeping ledgers (and, when an external driver
        # owns it, the exact simulated clock the result reports), built
        # as the closed loop builds it, scenario models included
        if sched is None:
            compute, net, avail = _scenario_models(run_cfg, N)
            speed = speed or compute or SpeedModel.paper_testbed(N, run_cfg.seed)
            sched = EventScheduler(N, speed, network=net, availability=avail, obs=self.obs)
        self.sched = sched
        self._account_bytes = account_bytes

        # the two-phase exchange exists iff the policy can decline: it
        # reports scalars or overrides the default always-ship decide()
        self.two_phase = bool(policy.reports or type(policy).decide is not UploadPolicy.decide)

        self.model_version = np.zeros(N, int)
        self.server_version = 0
        self.prev_global = self.global_params
        self.prev_prev_global = self.global_params
        # the model each client last downloaded: the codec delta's decode
        # base (lossy under a broadcast codec, what the client trains from)
        self.client_base = [self.global_params] * N
        self._buffer: list = []          # reconstruction trees
        self._buf_stale: list = []       # their staleness weights s(tau)
        self._buf_recv: list = []        # their transport arrival stamps
        self.K = max(1, run_cfg.buffer_size)
        self.window = run_cfg.max_batch if run_cfg.max_batch > 0 else N
        self.records: list = []
        self.processed = 0               # completed events (downloads sent)
        self.total_events = run_cfg.rounds * N if total_events is None else total_events
        # client -> (sim_time, carried report bytes, host deadline) of an
        # accepted report whose update has not landed
        self._pending: dict = {}
        self._last_seq = np.full(N, -1, np.int64)   # dedup watermark
        self._stopping = False
        self._finalized = None

        # resilience state: reply cache for dedup replay, liveness
        # bookkeeping, and the counters a chaos run reconciles
        self.exchange_timeout = exchange_timeout
        self.liveness_timeout = liveness_timeout
        self._last_reply: dict = {}       # client -> last reply sent
        self._evicted: set = set()
        self.dead_reason: dict = {}       # client -> why it was evicted
        self._last_heard = np.full(N, time.monotonic())
        self.accepted_by_client = np.zeros(N, np.int64)  # committed updates
        self.duplicates = 0
        self.evictions = 0
        self.readmissions = 0
        self.exchange_expired = 0
        self.wire_errors = 0
        self.restarts = 0

        # full-run checkpointing: one atomic file; resume restores it when
        # present.  resume_fresh_clients=True (a live fleet restart)
        # rebases every client on the restored global; the bridge driver
        # passes False and rebuilds its clients from the checkpoint.
        self._ckpt_path = run_cfg.checkpoint_path
        self._ckpt_every = run_cfg.checkpoint_every
        if run_cfg.resume and self._ckpt_path and os.path.exists(self._ckpt_path):
            self.restore_checkpoint(self._ckpt_path, fresh_clients=resume_fresh_clients)

    # ----------------------------------------------------------- lifecycle ---

    def _init_meta(self) -> dict:
        return {"schema": wire.WIRE_SCHEMA,
                "needs_values": self.policy.needs_values,
                "needs_norms": self.policy.needs_norms,
                "two_phase": self.two_phase,
                "compressor": self.cfg.compressor,
                "error_feedback": self.cfg.error_feedback,
                "seed": self.cfg.seed,
                "rounds": self.cfg.rounds}

    def start(self) -> None:
        """Send every client its init broadcast: the initial model plus
        the run flags it needs.  Bootstrap traffic, not billed.  After a
        resume this broadcasts the RESTORED global."""
        meta = self._init_meta()
        for i in range(self.cfg.num_clients):
            self.transport.send_broadcast(i, BroadcastMsg(
                kind=wire.INIT, version=self.server_version, tree=self.global_params,
                meta=meta))

    def stop(self) -> None:
        """Ask the hot loop to drain and return after the current window."""
        self._stopping = True

    def run(self, stall_timeout: float = 60.0) -> RunResult:
        """The hot loop: drain upload windows until ``total_events``
        events completed, ``stop()`` was called, or no message arrived
        for ``stall_timeout`` seconds (a dead fleet: drain and return
        rather than wedge)."""
        if self.obs is not None:       # opt-in live metric sampler
            self.obs.sampler_start()
        last_msg = time.monotonic()
        while self.processed < self.total_events and not self._stopping:
            if self.step(timeout=_POLL):
                last_msg = time.monotonic()
            elif time.monotonic() - last_msg > stall_timeout:
                break
        return self.finalize()

    def step(self, timeout: float = 0.0) -> int:
        """Drain and process ONE window (up to ``max_batch`` messages
        already queued, waiting at most ``timeout`` for the first).
        Returns the number of messages processed: 0 when the queue was
        quiet, so external loops (multi-tenant) can round-robin."""
        self._police()
        window = self.transport.drain_uploads(self.window, timeout=timeout)
        if not window:
            return 0
        if self.obs is not None:
            self.obs.queue_depth(self.transport.queue_depth() + len(window))
            h0 = self.obs.host_now()
        for msg in window:
            self._handle(msg)
        if self.obs is not None:
            self.obs.window(len(window), window[0].sim_time, window[-1].sim_time, h0)
        return len(window)

    # --------------------------------------------------------- liveness ---

    def _police(self, now: Optional[float] = None) -> None:
        """Per-step housekeeping: expire wedged two-phase exchanges,
        consume the transport's dead/reconnect surfaces, and evict
        clients silent past the liveness deadline.  Every path is
        idempotent."""
        now = time.monotonic() if now is None else now
        if self.exchange_timeout is not None and self._pending:
            for i in [i for i, (_, _, dl) in self._pending.items()
                      if dl is not None and now >= dl]:
                t, _, _ = self._pending.pop(i)
                self.exchange_expired += 1
                if self.obs is not None:
                    self.obs.failure(i, t, kind="exchange-timeout")
        tr = self.transport
        if hasattr(tr, "poll_fault_stats") and self.obs is not None:
            for kind, n in tr.poll_fault_stats().items():
                self.obs.fault(kind, n)
        if hasattr(tr, "poll_wire_errors"):
            n = tr.poll_wire_errors()
            if n:
                self.wire_errors += n
                if self.obs is not None:
                    self.obs.wire_error(n)
        if hasattr(tr, "dead_clients"):
            reasons = tr.dead_reasons() if hasattr(tr, "dead_reasons") else {}
            for i in tr.dead_clients():
                if i not in self._evicted:
                    reason = reasons.get(i, "transport-dead")
                    if reason == "wire-error":
                        self.wire_errors += 1
                        if self.obs is not None:
                            self.obs.wire_error()
                    self._evict(i, reason=reason)
        if hasattr(tr, "poll_reconnects"):
            for i in tr.poll_reconnects():
                self._readmit(i, fresh=True)
        if self.liveness_timeout is not None:
            for i in np.nonzero(now - self._last_heard > self.liveness_timeout)[0]:
                i = int(i)
                if i not in self._evicted:
                    self._evict(i, reason="liveness")

    def _evict(self, i: int, *, reason: str) -> None:
        """Mark a client dead: discard its wedged exchange (the failure
        path) and stop expecting traffic until it re-admits."""
        self._evicted.add(i)
        self.dead_reason[i] = reason
        self.evictions += 1
        pend = self._pending.pop(i, None)
        if self.obs is not None:
            self.obs.evict(i, self.sched.now, reason=reason)
            if pend is not None:
                self.obs.failure(i, pend[0], kind="evicted")

    def _readmit(self, i: int, *, fresh: bool) -> None:
        """Welcome an evicted client back.  ``fresh`` (a restarted or
        reconnected client) rebases it on the current global model: fresh
        decode base, current version, seq watermark reset, reply cache
        dropped, and a new init broadcast."""
        self._evicted.discard(i)
        self.dead_reason.pop(i, None)
        self.readmissions += 1
        self._last_heard[i] = time.monotonic()
        if fresh:
            self.client_base[i] = self.global_params
            self.model_version[i] = self.server_version
            self._last_seq[i] = -1
            self._last_reply.pop(i, None)
            self._pending.pop(i, None)
            self.transport.send_broadcast(i, BroadcastMsg(
                kind=wire.INIT, version=self.server_version, tree=self.global_params,
                meta=self._init_meta()))
        if self.obs is not None:
            self.obs.readmit(i, self.sched.now, fresh=fresh)

    # ------------------------------------------------------ event handling ---

    def _handle(self, msg: UploadMsg) -> None:
        i = int(msg.client)
        self._last_heard[i] = time.monotonic()
        if msg.seq <= self._last_seq[i]:
            if i in self._evicted and msg.seq == 0:
                # a restarted client (seq reset) rather than a duplicate:
                # rebase it and process the message
                self.restarts += 1
                self._readmit(i, fresh=True)
            else:
                # a retry or a duplicate: count it and replay the cached
                # reply, so a client whose reply was lost makes progress
                self.duplicates += 1
                if i in self._evicted:
                    self._readmit(i, fresh=False)
                if self.obs is not None:
                    self.obs.duplicate(i, msg.sim_time)
                last = self._last_reply.get(i)
                if last is not None:
                    self.transport.send_broadcast(i, last)
                return
        elif i in self._evicted:
            self._readmit(i, fresh=False)
        self._last_seq[i] = msg.seq
        if msg.kind == wire.REPORT:
            self._handle_report(i, msg)
        elif msg.kind == wire.UPDATE:
            self._handle_update(i, msg)
        else:
            raise ValueError(f"unknown upload kind {msg.kind!r}")

    def _handle_report(self, i: int, msg: UploadMsg) -> None:
        """Phase 1 of a two-phase event: the scalar report and the
        server-side ship/skip decision (exact policy state: VAFL's gate
        reads the whole fleet's reported values)."""
        t = msg.sim_time
        u0 = self.comm.uplink_bytes
        thr = self.policy.window_threshold(self._server_delta)
        if self.policy.reports:
            self.comm.record_report(1)
            if self.obs is not None:
                self.obs.report(i, t)
        upload = self.policy.decide(i, msg.value, msg.norm, thr)
        if upload:
            # decision frames are unbilled control-plane traffic; the
            # payload arrives as this client's next message.  The
            # report's bytes carry over so the whole exchange lands in one
            # ledger entry, and the exchange gets its own host deadline
            deadline = (None if self.exchange_timeout is None
                        else time.monotonic() + self.exchange_timeout)
            self._pending[i] = (t, self.comm.uplink_bytes - u0, deadline)
            reply = BroadcastMsg(kind=wire.DECISION, upload=True, version=self.server_version,
                                 ack_seq=msg.seq)
            self._last_reply[i] = reply
            self.transport.send_broadcast(i, reply)
        else:
            self._finish_event(i, t, self.comm.uplink_bytes - u0, ack_seq=msg.seq)

    def _handle_update(self, i: int, msg: UploadMsg) -> None:
        """An accepted upload's payload: decode, buffer, commit every K."""
        t = msg.sim_time
        pend = self._pending.pop(i, None)
        carry = pend[1] if pend is not None else 0   # the report's bytes
        u0 = self.comm.uplink_bytes
        p0 = self.comm.upload_payload_bytes
        if self.codec.is_identity:
            recon = msg.payload            # the full parameter tree
            self.comm.record_upload(1)
        else:
            with (self.obs.timed("decode", client=i, codec=self.codec.name)
                  if self.obs is not None else nullcontext()):
                decoded = self.codec.decode(msg.payload)
            recon = _tree_apply_delta(self.client_base[i], decoded)
            self.comm.record_upload(1, nbytes=msg.payload.nbytes)
        staleness = self.server_version - self.model_version[i]
        if self.obs is not None:
            self.obs.upload(i, t, staleness=int(staleness),
                            nbytes=self.comm.upload_payload_bytes - p0, codec=self.codec.name)
        self._buffer.append(recon)
        self._buf_stale.append(self.aggregator.stale_weight(int(staleness)))
        self._buf_recv.append(msg.recv_host)
        self.accepted_by_client[i] += 1
        if len(self._buffer) >= self.K:
            self._flush(t)
        self._finish_event(i, t, carry + self.comm.uplink_bytes - u0, ack_seq=msg.seq)

    def _flush(self, sim_time: float) -> None:
        """Commit the buffer: one staleness-weighted FedBuff mix through
        the shared runtime math, then advance the server version."""
        if self.obs is not None:
            self.obs.flush(len(self._buffer), sim_time)
        self.prev_prev_global = self.prev_global
        self.prev_global = self.global_params
        self.global_params = _flush_reconstructions(self.aggregator, self.global_params,
                                                    self._buffer, self._buf_stale)
        self.server_version += 1
        if self.obs is not None:
            now = time.monotonic()
            for stamp in self._buf_recv:
                if stamp:
                    self.obs.commit_latency(now - stamp)
        self._buffer.clear()
        self._buf_stale.clear()
        self._buf_recv.clear()

    def _finish_event(self, i: int, t: float, up_bytes: int, ack_seq: int = -1) -> None:
        """Every event's tail: the download broadcast, version tracking,
        byte ledgers, and the eval-boundary record.  ``ack_seq`` echoes
        the upload seq this download answers."""
        d0 = self.comm.downlink_bytes
        if self.bcodec is None:
            sent = self.global_params
            self.comm.record_broadcast(1)
        else:
            sent = _compressed_broadcast(
                self.bcodec, self.comm, self.global_params, 1,
                _enc_seed(self.cfg, self.processed, i, _BROADCAST), obs=self.obs)
        if self.obs is not None:
            self.obs.broadcast(i, t, nbytes=self.comm.downlink_bytes - d0,
                               codec=None if self.bcodec is None else self.bcodec.name)
        self.client_base[i] = sent
        self.model_version[i] = self.server_version
        reply = BroadcastMsg(kind=wire.DOWNLOAD, version=self.server_version, tree=sent,
                             ack_seq=ack_seq)
        self._last_reply[i] = reply
        self.transport.send_broadcast(i, reply)
        if self._account_bytes:
            self.sched.account_bytes(i, up_bytes, self.comm.downlink_bytes - d0)
        self.processed += 1
        if self.processed % self.cfg.events_per_eval == 0:
            h0 = self.obs.host_now() if self.obs is not None else 0.0
            acc = float(self.evaluate_fn(self.global_params))
            if self.obs is not None:
                self.obs.eval_event(self.processed, t, h0)
            self.records.append(RoundRecord(round=self.processed, time=t, global_acc=acc,
                                            uploads_so_far=self.comm.model_uploads))
            if self.verbose:
                progress(f"[{self.cfg.algorithm}/serve] ev {self.processed:4d} t={t:8.1f} "
                         f"acc={acc:.4f} uploads={self.comm.model_uploads}")
        # checkpoint AFTER the eval-boundary record, so a bundle holds it
        if self._ckpt_every and self.processed % self._ckpt_every == 0:
            self.save_checkpoint()

    def _server_delta(self):
        return _tree_delta(self.prev_global, self.prev_prev_global)

    # ------------------------------------------------------ live plane ---

    def scoreboard(self) -> dict:
        """The per-client health scoreboard of the live telemetry plane
        (``/clients``), which is not ported yet."""
        raise NotImplementedError("the live telemetry plane (client_scoreboard, /clients) is "
                                  "not ported to repro_torch yet (ROADMAP.md, queue 1 item 9b)")

    def absorb_client_stats(self, workers) -> None:
        """Fold the fleet's client-side stats (retry counts) into the obs
        metrics after the workers joined.  Idempotent (the counter is SET
        to the fleet total), and it refreshes an already-sealed result's
        snapshot, because client threads stop only after ``finalize()``
        returned."""
        if self.obs is None:
            return
        total = sum(getattr(w, "stats", {}).get("retries", 0) for w in workers)
        self.obs.metrics.counter("client_retries").value = int(total)
        tr = self.transport
        if hasattr(tr, "poll_fault_stats"):
            for kind, n in tr.poll_fault_stats().items():
                self.obs.fault(kind, n)
        if self._finalized is not None and self._finalized.metrics is not None:
            self._finalized.metrics = self.obs.metrics.snapshot()

    # ---------------------------------------------------- checkpointing ---

    def save_checkpoint(self, path: Optional[str] = None) -> str:
        """Write one atomic full-run checkpoint: everything the serve loop
        needs to continue (model lineage, per-client bases and versions,
        dedup watermarks, the FedBuff buffer, CommStats, records, policy
        state, the scheduler snapshot, the run generator, resilience
        counters and obs metrics)."""
        path = path or self._ckpt_path
        if not path:
            raise ValueError("no checkpoint_path configured")
        h0 = self.obs.host_now() if self.obs is not None else 0.0
        state = {
            "processed": self.processed,
            "server_version": self.server_version,
            "model_version": self.model_version.copy(),
            "last_seq": self._last_seq.copy(),
            "rng": ck.generator_state(self.gen),
            "global_params": ck.tree_to_host(self.global_params),
            "prev_global": ck.tree_to_host(self.prev_global),
            "prev_prev_global": ck.tree_to_host(self.prev_prev_global),
            "client_base": [ck.tree_to_host(t) for t in self.client_base],
            "buffer": [ck.tree_to_host(t) for t in self._buffer],
            "buf_stale": list(self._buf_stale),
            "comm": dict(self.comm.__dict__),
            "records": list(self.records),
            "policy": self.policy.state(),
            "sched": self.sched.snapshot(),
            "accepted_by_client": self.accepted_by_client.copy(),
            "counters": {k: getattr(self, k) for k in _COUNTERS},
            "obs": self.obs.metrics.snapshot() if self.obs is not None else None,
        }
        ck.save_run_state(path, state, ck.run_fingerprint(self.cfg, "serve",
                                                          self.global_params))
        if self.obs is not None:
            self.obs.checkpoint(self.processed, h0)
        return path

    def restore_checkpoint(self, path: Optional[str] = None, *,
                           fresh_clients: bool = True) -> None:
        """Restore a ``save_checkpoint`` bundle (fingerprint-validated: a
        mismatched config or model shape raises
        ``CheckpointMismatchError``).  ``fresh_clients=True`` is the live
        fleet restart: every client is rebased on the restored global and
        ``start()`` re-bootstraps them.  ``False`` keeps the exact
        per-client state for a driver that rebuilds its clients from the
        checkpoint (the bit-equal resume)."""
        path = path or self._ckpt_path
        st = ck.load_run_state(path, ck.run_fingerprint(self.cfg, "serve", self.global_params))
        h0 = self.obs.host_now() if self.obs is not None else 0.0
        dev = self.device
        self.processed = int(st["processed"])
        self.server_version = int(st["server_version"])
        self.model_version = np.asarray(st["model_version"], int).copy()
        self._last_seq = np.asarray(st["last_seq"], np.int64).copy()
        ck.set_generator_state(self.gen, st["rng"])
        self.global_params = ck.tree_to_device(st["global_params"], dev)
        self.prev_global = ck.tree_to_device(st["prev_global"], dev)
        self.prev_prev_global = ck.tree_to_device(st["prev_prev_global"], dev)
        self.client_base = [ck.tree_to_device(t, dev) for t in st["client_base"]]
        self._buffer = [ck.tree_to_device(t, dev) for t in st["buffer"]]
        self._buf_stale = list(st["buf_stale"])
        self._buf_recv = [0.0] * len(self._buffer)
        self.comm.__dict__.update(st["comm"])
        self.records = list(st["records"])
        if st["policy"] is not None:
            self.policy.set_state(st["policy"])
        self.sched.restore(st["sched"])
        self.accepted_by_client = np.asarray(st["accepted_by_client"], np.int64).copy()
        for k, v in st["counters"].items():
            setattr(self, k, int(v))
        if self.obs is not None and st["obs"] is not None:
            self.obs.metrics.restore(st["obs"])
        N = self.cfg.num_clients
        if fresh_clients:
            self.client_base = [self.global_params] * N
            self.model_version = np.full(N, self.server_version, int)
            self._last_seq = np.full(N, -1, np.int64)
            self._last_reply = {}
            self._pending = {}
        self._evicted = set()
        self.dead_reason = {}
        self._last_heard = np.full(N, time.monotonic())
        if self.obs is not None:
            self.obs.checkpoint(self.processed, h0, restored=True)

    # ------------------------------------------------------------ shutdown ---

    def finalize(self, drain_timeout: float = 1.0) -> RunResult:
        """Graceful drain and shutdown: process everything still queued,
        commit any partial buffer (no accepted update is lost), discard
        wedged two-phase exchanges through the failure hook, send final
        broadcasts, seal obs, build the ``RunResult``.  Idempotent."""
        if self._finalized is not None:
            return self._finalized
        if self.obs is not None:
            self.obs.sampler_stop()
        deadline = time.monotonic() + drain_timeout
        while self.processed < self.total_events:
            n = self.step(timeout=0.01)
            if n == 0 and time.monotonic() > deadline:
                break
        for i, (t, _carry, _deadline) in sorted(self._pending.items()):
            # a client accepted for upload never delivered its payload
            if self.obs is not None:
                self.obs.failure(i, t)
        self._pending.clear()
        if self._buffer:
            self._flush(float(self.sched.now))
        for i in range(self.cfg.num_clients):
            self.transport.send_broadcast(i, BroadcastMsg(kind=wire.FINAL,
                                                          version=self.server_version))
        tr = self.transport    # last fault-stat drain before obs seals
        if hasattr(tr, "poll_fault_stats") and self.obs is not None:
            for kind, n in tr.poll_fault_stats().items():
                self.obs.fault(kind, n)
        res = RunResult(self.cfg.algorithm, self.records, self.comm,
                        self.cfg.target_acc).finalize_target()
        res = _finish_obs(_attach_sim_result(res, self.sched), self.obs)
        self._finalized = res
        return res
