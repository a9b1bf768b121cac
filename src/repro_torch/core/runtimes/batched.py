"""Batched async execution engine (``FLRunConfig.engine="batched"``).
Port of ``repro.core.runtimes.batched`` without its client-sharding
branch (``FLRunConfig`` rejects ``shard_clients``).

Per-client state lives in device-resident stacked trees (leading axis =
client) instead of Python lists; each scheduler window of up to
``max_batch`` completions runs as ONE batched local update over the
gathered sub-stack (``core.client``: one SGD step of W clients launches
the kernels of one step), and accepted uploads flow through a
FedBuff-style buffer flushed as a staleness-weighted mean every
``buffer_size`` arrivals.

Two performance layers on top of that execution model:

* **Full-window fast path.**  At ``max_batch=0`` (the throughput
  default) a window is a *permutation* of all N clients, so the engine
  skips the stack copies: the update runs over the stacked state in
  CLIENT order with each client's draws taken at its arrival position
  (``make_local_update_keyed``, row for row the gathered path),
  prev_grads becomes the update's eff output by reference, and the
  download write-back is a pure gather of version trees (no scatter).

* **One-window-deep pipeline.**  Host work that cannot affect gating
  (rescheduling the window's clients, popping the NEXT window,
  gathering its data) happens between dispatching a window's device
  work and reading its gating inputs, which come back in one
  non-blocking copy into pinned memory, started at once.  Nothing in
  between waits for the card (Eq. 1's amplifier is applied on the host
  after the read; row indices go up through pinned memory; only
  ``eval_cache`` reads a window's fresh accuracies at once), so the
  host does that work while the card runs the window.  Eval
  records hold device scalars until the end of the run, the download
  write-back and prev-grad scatter land in one commit (in place), and a
  flush triggered by the window's final event is folded into it.

The algorithm is the ``UploadPolicy`` / ``Aggregator`` protocol: the
policy's declared stacked inputs (Eq. 1 values, one grad_diff_norm
launch over the window's W rows; gradient norms) are computed once per
window, and its scalar ``decide`` is applied per event in arrival
order; the server-delta threshold is evaluated once per window (at the
mix point).  Codec payloads and error feedback stay per client (one
topk_int8 encode per accepted upload).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

import repro_torch.checkpoint.store as ck
from repro_torch.algorithms.base import Aggregator
from repro_torch.common.pytree import (stacked_index, tree_bytes, tree_gather, tree_map,
                                       tree_scatter_, tree_stack)
from repro_torch.core.aggregation import buffered_coefs, buffered_mix
from repro_torch.core.client import make_local_update_keyed
from repro_torch.core.metrics import CommStats, RoundRecord, RunResult
from repro_torch.core.runtimes.common import (_BROADCAST, _UPLOAD, _attach_sim_result,
                                              _compressed_broadcast, _compressed_upload,
                                              _enc_seed, _event_helpers, _finish_obs,
                                              _make_codecs, _obs_for_run, _tree_delta,
                                              _value_fn, commit_full, commit_full_flush,
                                              commit_win, commit_win_flush)
from repro_torch.core.scheduler import EventScheduler
from repro_torch.core.value import communication_values_host
from repro_torch.obs.console import progress


class _HostCopy:
    """A device tensor on its way to the host: one non-blocking copy into
    pinned memory, started at construction; ``numpy()`` waits for that
    copy alone.  CPU tensors pass through."""

    def __init__(self, x: torch.Tensor):
        x = x.detach()
        self.done = None
        if x.is_cuda:
            self.host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self.host.copy_(x, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record()
        else:
            self.host = x

    def numpy(self) -> np.ndarray:
        if self.done is not None:
            self.done.synchronize()
        return self.host.numpy()

    def __float__(self):
        return float(self.numpy())


def _device_rows(idx: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Row indices on ``dev`` without waiting for the card: a copy from
    pageable host memory waits for the stream to drain, a copy from
    pinned memory is only queued.  On the CPU the array itself."""
    rows = torch.from_numpy(np.asarray(idx, np.int64))
    return rows.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else rows


class _AccCache:
    """Per-client Eq. 1 accuracy cache (``FLRunConfig.eval_cache``): each
    client's accuracy term is refreshed at most once every ``every`` of
    its own events and the cached scalar reused in between.  Fresh rows
    are gathered and evaluated in one call (the reference pads them to a
    power of two to bound its compiled variants; eager torch needs no
    padding and the padded rows were never read)."""

    def __init__(self, num_clients: int, every: int, batch_eval, obs=None):
        self.every = every
        self.batch_eval = batch_eval
        self.obs = obs
        self.acc = np.zeros(num_clients, np.float32)
        # "never evaluated" sorts as infinitely stale
        self.age = np.full(num_clients, np.iinfo(np.int32).max, np.int64)

    def window_accs(self, newp, clients: np.ndarray) -> np.ndarray:
        """fp32 accuracies for the window's clients, indexed by ``newp``
        rows (``clients[r]`` = client id of row r), on the host."""
        need = np.flatnonzero(self.age[clients] >= self.every)
        if self.obs is not None:
            self.obs.eval_cache(hits=len(clients) - len(need), misses=len(need))
        if len(need):
            fresh = self.batch_eval(tree_gather(newp, need)).detach().cpu().numpy()
            self.acc[clients[need]] = fresh.astype(np.float32)
            self.age[clients[need]] = 0
        self.age[clients] += 1
        return self.acc[clients]


def _run_event_batched(run_cfg, policy, aggregator, global_params, gen, local_update,
                       loss_fn, perm_fn, data, evaluate_fn, client_eval_fn, speed,
                       net=None, avail=None, verbose=False) -> RunResult:
    """The batched engine, from ``run_event_driven``'s set-up: the initial
    model, the run's generator, the gathered-window local update (with
    ``loss_fn`` and ``perm_fn`` for its full-window form; a window passes
    its first event index as the step) and the data on the device."""
    N = run_cfg.num_clients
    dev = next(iter(data.values())).device
    comm = CommStats(model_bytes=tree_bytes(global_params))
    codec, bcodec, ef = _make_codecs(run_cfg)
    keyed_update = make_local_update_keyed(loss_fn, run_cfg.local, perm_fn=perm_fn)

    # device-resident stacked per-client state: no Python lists of full
    # trees, everything gathers/scatters on a leading axis
    client_params = tree_map(
        lambda x: x.unsqueeze(0).repeat((N,) + (1,) * x.dim()), global_params)
    prev_grads = tree_map(
        lambda x: torch.zeros((N,) + tuple(x.shape), dtype=torch.float32,
                              device=dev), global_params)
    model_version = np.zeros(N, int)  # version each client last downloaded
    server_version = 0
    prev_global = global_params
    prev_prev_global = global_params

    obs = _obs_for_run(run_cfg)
    sq_diff = _value_fn(run_cfg)
    batch_eval, _, norms_fn = _event_helpers(run_cfg, client_eval_fn, sq_diff)
    acc_cache = (_AccCache(N, run_cfg.eval_cache, batch_eval, obs=obs)
                 if policy.needs_values and run_cfg.eval_cache > 0 else None)
    # a window's final flush folds into the commit only when the default
    # flush math applies (a plugin aggregator's override must stay in
    # charge of its own mixing)
    foldable_flush = type(aggregator).flush_mix is Aggregator.flush_mix

    W = run_cfg.max_batch if run_cfg.max_batch > 0 else N
    W = max(1, min(W, N))
    K = max(1, run_cfg.buffer_size)
    total_events = run_cfg.rounds * N
    sched = EventScheduler(N, speed, network=net, availability=avail, obs=obs)
    # a reactive scenario consumes per-event payload bytes (or
    # availability draws) at reschedule time, so the pipeline's
    # reschedule+pop-ahead must wait for the window's upload decisions
    reactive = sched.reactive
    records: list = []
    # the FedBuff buffer: (stacked_tree, row) references: rows of the
    # window's output for identity uploads (client ids on the fast path,
    # window positions otherwise), size-1 stacks for codec
    # reconstructions; gathered/stacked only at flush time
    buffer: list = []
    buf_stale: list = []              # their staleness weights s(tau)

    def flush(sim=None):
        nonlocal global_params, prev_global, prev_prev_global, server_version
        if obs is not None:
            obs.flush(len(buffer), sim)
        prev_prev_global = prev_global
        prev_global = global_params
        if len(buffer) == 1:          # bit-exact sequential mix (K=1 path)
            ref, row = buffer[0]
            global_params = buffered_mix(global_params, [stacked_index(ref, row)], buf_stale,
                                         aggregator.mix_rate, mix=aggregator.mix)
        else:
            groups: list = []         # consecutive same-source rows
            for ref, row in buffer:
                if groups and groups[-1][0] is ref:
                    groups[-1][1].append(row)
                else:
                    groups.append((ref, [row]))
            if len(groups) == 1:      # common case: one source
                src, rows = groups[0]
            else:                     # buffer spans windows/codec payloads
                src = tree_map(lambda *xs: torch.cat(xs, 0),
                               *[tree_gather(ref, rows) for ref, rows in groups])
                rows = range(len(buffer))
            coef, rho_sbar = buffered_coefs(buf_stale, aggregator.mix_rate)
            global_params = aggregator.flush_mix(global_params, src, np.asarray(rows),
                                                 coef, rho_sbar)
        server_version += 1
        buffer.clear()
        buf_stale.clear()

    last_eval = (None, None)           # (server_version, deferred acc)
    ev = 0
    pre_d = None                       # next window's pre-gathered data
    nxt = None

    # full-run checkpoint-resume (docs/RESILIENCE.md).  The pipeline is
    # one window deep, so a checkpoint taken at the end of a loop body
    # bundles the already-popped NEXT window with the scheduler snapshot
    # (its data gather, already dispatched, is not stored: a resumed run
    # gathers its first window itself); buffered updates are
    # materialised as host trees (their stacked-window sources don't
    # outlive the iteration) and restored as size-1 stacks, exactly how
    # codec reconstructions enter the buffer, so the flush math is
    # unchanged.  Deferred eval scalars resolve into COPIES for the
    # bundle (each waits for its own pending copy), while the live
    # records stay deferred: a checkpoint may wait for the card, a
    # window without one never does.
    ckpt_path, ckpt_every = run_cfg.checkpoint_path, run_cfg.checkpoint_every
    fingerprint = (ck.run_fingerprint(run_cfg, "batched", global_params)
                   if ckpt_path else None)

    def _save_ckpt():
        h0 = obs.host_now() if obs is not None else 0.0
        state = {
            "event": ev,
            "rng": ck.generator_state(gen),
            "global_params": ck.tree_to_host(global_params),
            "prev_global": ck.tree_to_host(prev_global),
            "prev_prev_global": ck.tree_to_host(prev_prev_global),
            "client_params": ck.tree_to_host(client_params),
            "prev_grads": ck.tree_to_host(prev_grads),
            "model_version": model_version.copy(),
            "server_version": server_version,
            "comm": dict(comm.__dict__),
            "records": [dataclasses.replace(r, global_acc=float(r.global_acc))
                        for r in records],
            "last_eval": (None if last_eval[0] is None
                          else (int(last_eval[0]), float(last_eval[1]))),
            "buffer": [ck.tree_to_host(stacked_index(ref, row)) for ref, row in buffer],
            "buf_stale": list(buf_stale),
            "policy": policy.state(),
            "ef": {c: ck.tree_to_host(t) for c, t in ef.residuals.items()},
            "acc_cache": (None if acc_cache is None else
                          {"acc": acc_cache.acc.copy(), "age": acc_cache.age.copy()}),
            "nxt": (None if nxt is None else
                    (np.asarray(nxt[0], np.float64), np.asarray(nxt[1], np.int64))),
            "sched": sched.snapshot(),
            "obs_metrics": obs.metrics.snapshot() if obs is not None else None,
        }
        ck.save_run_state(ckpt_path, state, fingerprint)
        if obs is not None:
            obs.checkpoint(ev, h0)

    if run_cfg.resume and ckpt_path and os.path.exists(ckpt_path):
        st = ck.load_run_state(ckpt_path, fingerprint)
        ev = int(st["event"])
        ck.set_generator_state(gen, st["rng"])
        global_params = ck.tree_to_device(st["global_params"], dev)
        prev_global = ck.tree_to_device(st["prev_global"], dev)
        prev_prev_global = ck.tree_to_device(st["prev_prev_global"], dev)
        client_params = ck.tree_to_device(st["client_params"], dev)
        prev_grads = ck.tree_to_device(st["prev_grads"], dev)
        model_version = np.asarray(st["model_version"], int).copy()
        server_version = int(st["server_version"])
        comm.__dict__.update(st["comm"])
        records = list(st["records"])
        if st["last_eval"] is not None:
            last_eval = (int(st["last_eval"][0]), st["last_eval"][1])
        buffer[:] = [(tree_map(lambda x: x.unsqueeze(0), ck.tree_to_device(t, dev)), 0)
                     for t in st["buffer"]]
        buf_stale[:] = list(st["buf_stale"])
        if st["policy"] is not None:
            policy.set_state(st["policy"])
        ef.residuals = {int(c): ck.tree_to_device(t, dev) for c, t in st["ef"].items()}
        if acc_cache is not None and st["acc_cache"] is not None:
            acc_cache.acc = np.asarray(st["acc_cache"]["acc"], np.float32).copy()
            acc_cache.age = np.asarray(st["acc_cache"]["age"], np.int64).copy()
        sched.restore(st["sched"])
        if st["nxt"] is not None:
            times = np.asarray(st["nxt"][0], np.float64)
            idx_np = np.asarray(st["nxt"][1], np.int64)
        elif ev < total_events:
            # the writer's event budget ended at this checkpoint, so it
            # never popped a next window; a resume that EXTENDS the run
            # (rounds is outside the fingerprint) pops it now: the
            # restored scheduler is exactly the state the longer run
            # popped from mid-body
            times, idx_np = sched.pop_window(min(W, total_events - ev))
        else:
            times, idx_np = np.empty(0), np.empty(0, int)
        if obs is not None:
            if st.get("obs_metrics"):
                obs.metrics.restore(st["obs_metrics"])
            obs.checkpoint(ev, obs.host_now(), restored=True)
    else:
        times, idx_np = (sched.pop_window(min(W, total_events))
                         if total_events else (np.empty(0), np.empty(0, int)))
    if obs is not None:                # opt-in device profiler (hot loop)
        obs.profile_start()
        obs.sampler_start()            # opt-in live metric sampler
    while len(idx_np):
        t_now = float(times[-1])
        w = len(idx_np)
        full = w == N                  # a full window = client permutation
        h0 = obs.host_now() if obs is not None else 0.0
        idx_dev = None if full else _device_rows(idx_np, dev)

        # ---- dispatch the window's device work ------------------------
        if full:
            # run in client order with draws at arrival positions: row for
            # row the gathered path, without its stack copies.
            # row(client i) == i.
            inv = np.empty(N, np.int64)
            inv[idx_np] = np.arange(N)
            sub_base = client_params
            newp, eff, _ = keyed_update(client_params, data, gen, ev, idx_np)
            row_of = idx_np            # event j -> row in newp/eff
        else:
            sub_base = tree_gather(client_params, idx_dev)
            d_w = pre_d if pre_d is not None else tree_gather(data, idx_dev)
            newp, eff, _ = local_update(sub_base, d_w, gen, ev, clients=idx_np)
            row_of = np.arange(w)
        pre_d = None
        if obs is not None:
            # host_dur here is DISPATCH time (the card runs on after it);
            # the window span measures dispatch through commit
            obs.local_update(float(times[0]), t_now, h0, clients=w)

        # the policy's declared stacked inputs: ONE call per window each,
        # all read back by one device->host copy started at once.  Eq. 1
        # reads its norms and the accuracies; its fp32 amplifier and
        # product are applied on the host after the read (the device's
        # bits), so no step before the read waits for the card
        reads, host_accs = [], None
        if policy.needs_values:
            pg_w = prev_grads if full else tree_gather(prev_grads, idx_dev)
            reads.append(sq_diff(pg_w, eff))
            if acc_cache is not None:
                # rows of newp map to clients: identity on the fast path
                # (client order), the window's arrival ids otherwise
                host_accs = acc_cache.window_accs(newp, np.arange(N) if full else idx_np)
            else:
                reads.append(batch_eval(newp))
        if policy.needs_norms:
            reads.append(norms_fn(eff))
        inputs = _HostCopy(torch.stack([r.float() for r in reads])) if reads else None

        # ---- the one-window-deep pipeline ----------------------------
        # everything gating CANNOT change happens before we read the
        # gating inputs: restart each client from its own completion time
        # (window execution must not barrier the simulated clock), pop
        # the NEXT window, and gather its data.  A reactive scenario
        # defers all of this to after the decision loop: the network
        # model needs each event's actual payload bytes.
        nxt = None
        if not reactive:
            for j in range(w):
                sched.schedule(int(idx_np[j]), start=float(times[j]))
            remaining = total_events - ev - w
            nxt = sched.pop_window(min(W, remaining)) if remaining else None
            if nxt is not None and len(nxt[1]) < N:
                pre_d = tree_gather(data, _device_rows(nxt[1], dev))

        V_w = norms_w = None
        if inputs is not None:
            got = inputs.numpy()
            order = row_of if full else slice(None)
            if policy.needs_values:
                accs = host_accs if host_accs is not None else got[1]
                V_w = communication_values_host(got[0], accs, N).astype(np.float64)[order]
            if policy.needs_norms:
                norms_w = got[-1].astype(np.float64)[order]
        # the policy's server-side threshold (EAFLM Eq. 3) is evaluated
        # once per WINDOW, from the deltas as of window start: an
        # intentional engine approximation (mid-window flushes advance the
        # server deltas without re-thresholding).  The sequential engine
        # recomputes per event; max_batch=1/buffer_size=1 is the
        # bit-exact configuration.
        thr = policy.window_threshold(lambda: _tree_delta(prev_global, prev_prev_global))

        dl_rel = np.empty(w, np.int64)      # per-event index into ver_trees
        ver_trees: list = []                # distinct globals downloaded
        ver_pos: dict = {}                  # server_version -> position
        enc_downloads: list = []            # per-client lossy downlink trees
        pending = None                      # final flush folded into commit
        ev_up = np.zeros(w, np.int64)       # per-event on-the-wire bytes
        ev_down = np.zeros(w, np.int64)
        for j in range(w):
            i = int(idx_np[j])
            r = int(row_of[j])
            t_j = float(times[j])
            u0, d0 = comm.uplink_bytes, comm.downlink_bytes
            if policy.reports:
                comm.record_report(1)
                if obs is not None:
                    obs.report(i, t_j)
            upload = policy.decide(i, None if V_w is None else float(V_w[j]),
                                   None if norms_w is None else float(norms_w[j]), thr)

            if upload:
                p0 = comm.upload_payload_bytes
                if codec.is_identity:
                    buffer.append((newp, r))
                    comm.record_upload(1)
                else:
                    recon = _compressed_upload(codec, ef, comm, stacked_index(sub_base, r),
                                               stacked_index(newp, r), i,
                                               _enc_seed(run_cfg, ev + j, i, _UPLOAD), obs=obs)
                    buffer.append((tree_map(lambda x: x.unsqueeze(0), recon), 0))
                staleness = server_version - model_version[i]
                buf_stale.append(aggregator.stale_weight(staleness))
                if obs is not None:
                    obs.upload(i, t_j, staleness=int(staleness),
                               nbytes=comm.upload_payload_bytes - p0, codec=codec.name)
                if len(buffer) >= K:
                    if (j == w - 1 and len(buffer) > 1 and foldable_flush
                            and bcodec is None and all(ref is newp for ref, _ in buffer)):
                        # window's final flush: fold into the commit
                        # (only this event can download the new version)
                        rows = np.asarray([rr for _, rr in buffer])
                        coef, rho_sbar = buffered_coefs(buf_stale, aggregator.mix_rate)
                        pending = (rows, coef, rho_sbar)
                        if obs is not None:
                            obs.flush(len(buffer), t_j, folded=True)
                        server_version += 1
                        buffer.clear()
                        buf_stale.clear()
                    else:
                        flush(t_j)

            if bcodec is None:
                comm.record_broadcast(1)
                if pending is not None and server_version not in ver_pos:
                    dl_rel[j] = -1      # the in-commit flushed global
                else:
                    if server_version not in ver_pos:
                        ver_pos[server_version] = len(ver_trees)
                        ver_trees.append(global_params)
                    dl_rel[j] = ver_pos[server_version]
            else:
                enc_downloads.append(_compressed_broadcast(
                    bcodec, comm, global_params, 1, _enc_seed(run_cfg, ev + j, i, _BROADCAST),
                    obs=obs))
            model_version[i] = server_version
            ev_up[j] = comm.uplink_bytes - u0
            ev_down[j] = comm.downlink_bytes - d0
            if obs is not None:
                obs.broadcast(i, t_j, nbytes=int(ev_down[j]),
                              codec=None if bcodec is None else bcodec.name)

        if reactive:
            # byte-aware reschedule: each client restarts from its own
            # completion time plus the link delay its actual payload cost
            for j in range(w):
                sched.schedule(int(idx_np[j]), start=float(times[j]),
                               upload_bytes=int(ev_up[j]), download_bytes=int(ev_down[j]))
            remaining = total_events - ev - w
            nxt = sched.pop_window(min(W, remaining)) if remaining else None
            if nxt is not None and len(nxt[1]) < N:
                pre_d = tree_gather(data, _device_rows(nxt[1], dev))
        else:
            # already rescheduled (pipeline); ledger the bytes only
            for j in range(w):
                sched.account_bytes(int(idx_np[j]), int(ev_up[j]), int(ev_down[j]))

        if any(ref is newp for ref, _ in buffer):
            # detach leftover buffer entries from the window output before
            # it goes out of scope: a partially-full buffer would otherwise
            # pin one full (w, ...) stack per window until the flush
            rows = np.asarray([r for ref, r in buffer if ref is newp])
            sub = tree_gather(newp, rows)
            fresh = iter(range(len(rows)))
            buffer[:] = [(sub, next(fresh)) if ref is newp else (ref, r) for ref, r in buffer]
        sub_base = None    # release the window's download-base reference

        # ---- commit: flush remainder + download write-back + prev-grad
        # scatter, one call ---------------------------------------------
        if pending is not None:
            prev_prev_global = prev_global
            prev_global = global_params
        if bcodec is None:
            # fast path: re-index the per-event versions by CLIENT (row i
            # of the new stack belongs to client i, whose event was j =
            # inv[i]); sub-full windows keep arrival order
            rel_np = dl_rel[inv] if full else dl_rel
            rel = torch.as_tensor(np.where(rel_np < 0, len(ver_trees), rel_np), device=dev)
            if full:
                if pending is not None:
                    global_params, client_params, prev_grads = commit_full_flush(
                        global_params, ver_trees, rel, eff, newp, *pending)
                else:
                    client_params, prev_grads = commit_full(ver_trees, rel, eff)
            else:
                if pending is not None:
                    global_params, client_params, prev_grads = commit_win_flush(
                        global_params, client_params, prev_grads, idx_dev, ver_trees, rel,
                        eff, newp, *pending)
                else:
                    client_params, prev_grads = commit_win(client_params, prev_grads,
                                                           idx_dev, ver_trees, rel, eff)
        else:
            assert pending is None     # bcodec downloads are never folded
            if full:
                # client order: client i received enc_downloads[inv[i]]
                client_params = tree_stack(enc_downloads[int(v)] for v in inv)
                prev_grads = eff
            else:
                tree_scatter_(client_params, idx_dev, tree_stack(enc_downloads))
                tree_scatter_(prev_grads, idx_dev, eff)

        if obs is not None:
            # one span per window: sim bounds = first/last completion,
            # host duration = dispatch through commit (this point)
            obs.window(w, float(times[0]), t_now, h0)
        prev_ev, ev = ev, ev + w
        epe = run_cfg.events_per_eval
        crossed = ev // epe - prev_ev // epe
        if crossed:
            # eval records hold device scalars until the end of the run so
            # evaluation overlaps the next window's compute; a record whose
            # global model is bit-identical to the previous one (no flush
            # since) reuses its scalar outright
            h0e = obs.host_now() if obs is not None else 0.0
            reused = last_eval[0] == server_version
            if reused:
                acc = last_eval[1]     # bit-identical model: reuse (exact)
            else:
                acc = _HostCopy(evaluate_fn(global_params))
                last_eval = (server_version, acc)
            if obs is not None:
                # the acc scalar stays deferred: the hook never reads it
                obs.eval_event(ev, t_now, h0e, boundaries=crossed, reused=reused)
            records.append(RoundRecord(round=ev, time=t_now, global_acc=acc,
                                       uploads_so_far=comm.model_uploads,
                                       boundaries_crossed=crossed))
            if verbose:
                progress(f"[{run_cfg.algorithm}/batched] ev {ev:5d} t={t_now:8.1f} "
                         f"acc={float(acc):.4f} uploads={comm.model_uploads}")
        if ckpt_every and ev // ckpt_every > prev_ev // ckpt_every:
            _save_ckpt()

        if nxt is None:
            break
        times, idx_np = nxt

    if obs is not None:
        obs.profile_stop()
        obs.sampler_stop()
    if buffer:  # partial buffer at run end: flush so no update is lost
        flush(float(sched.now))

    for r in records:                  # resolve the deferred eval scalars
        r.global_acc = float(r.global_acc)
    res = RunResult(run_cfg.algorithm, records, comm, run_cfg.target_acc).finalize_target()
    return _finish_obs(_attach_sim_result(res, sched), obs)
