"""Event-driven runtime: wall-clock asynchronous simulation on the
deterministic event scheduler.  Port of ``repro.core.runtimes.events``.
``run_event_driven`` is the entry point; it dispatches on
the algorithm's ``event_mode``: sync-barrier baselines like FedAvg run
the round-barrier runtime (``repro_torch.core.runtimes.sync``); every
other algorithm runs ``run_cfg.engine``: the sequential loop here, or
the batched engine (``repro_torch.core.runtimes.batched``).

The sequential loop processes one client completion at a time: the
``UploadPolicy`` makes the scalar ship/skip decision from whatever
inputs it declared (Eq. 1 value, gradient norm, server-delta threshold),
and each accepted upload enters the global model through the
``Aggregator``'s staleness-weighted async mix.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

import repro_torch.checkpoint.store as ck
from repro_torch.common.pytree import stacked_index, tree_broadcast, tree_bytes, tree_map
from repro_torch.core.client import make_local_update
from repro_torch.core.config import resolve_device
from repro_torch.core.metrics import CommStats, RoundRecord, RunResult
from repro_torch.core.runtimes.common import (_BROADCAST, _UPLOAD, _attach_sim_result,
                                              _compressed_broadcast, _compressed_upload,
                                              _enc_seed, _event_helpers, _finish_obs,
                                              _make_codecs, _obs_for_run, _scenario_models,
                                              _tree_delta, _value_fn)
from repro_torch.core.scheduler import EventScheduler, SpeedModel
from repro_torch.obs.console import progress


def run_event_driven(run_cfg, *, init_params_fn, loss_fn, fed_data, evaluate_fn,
                     client_eval_fn=None, speed: Optional[SpeedModel] = None,
                     device="cuda", perm_fn=None, verbose: bool = False) -> RunResult:
    """Wall-clock async runtime.  run_cfg.rounds counts *per-client* rounds
    (total events = rounds * N for comparability with round mode).  The
    arguments are ``run_round_based``'s, plus ``speed``, the compute
    model (default: the scenario's fleet, else the paper's testbed); the
    local update passes the event index (the batched engine: the
    window's first event index) to ``perm_fn`` as its step."""
    dev = resolve_device(device)
    alg, policy, aggregator = run_cfg.make_algorithm()
    N = run_cfg.num_clients
    policy.begin_run(N)
    aggregator.begin_run(N)
    client_eval_fn = client_eval_fn or evaluate_fn
    # scenario models (repro_torch.sim): the compute fleet becomes the
    # speed model (an explicitly passed ``speed`` still wins), the network
    # and availability models ride into the scheduler.  The default
    # scenario builds (None, None, None), the pre-scenario arithmetic.
    compute, net, avail = _scenario_models(run_cfg, N)
    speed = speed or compute or SpeedModel.paper_testbed(N, run_cfg.seed)
    gen = torch.Generator(device=dev).manual_seed(run_cfg.seed)
    global_params = tree_map(lambda x: x.to(dev), init_params_fn(gen))
    local_update = make_local_update(loss_fn, run_cfg.local, perm_fn=perm_fn)
    data = {"images": torch.as_tensor(np.asarray(fed_data.images), device=dev),
            "labels": torch.as_tensor(np.asarray(fed_data.labels), device=dev).long(),
            "mask": torch.as_tensor(np.asarray(fed_data.mask), device=dev)}
    if alg.event_mode == "sync-barrier":
        # round-barrier baselines are their own runtime
        from repro_torch.core.runtimes.sync import _run_sync_barrier
        return _run_sync_barrier(run_cfg, policy, aggregator, global_params, gen,
                                 local_update, data, fed_data.counts, evaluate_fn,
                                 client_eval_fn, speed, net, avail, verbose)
    if run_cfg.engine == "batched":
        from repro_torch.core.runtimes.batched import _run_event_batched
        return _run_event_batched(run_cfg, policy, aggregator, global_params, gen,
                                  local_update, loss_fn, perm_fn, data, evaluate_fn,
                                  client_eval_fn, speed, net, avail, verbose)
    comm = CommStats(model_bytes=tree_bytes(global_params))
    codec, bcodec, ef = _make_codecs(run_cfg)

    # per-client state
    client_params = [global_params] * N
    prev_grads = [None] * N
    model_version = np.zeros(N, int)  # version each client last downloaded
    server_version = 0
    prev_global = global_params
    prev_prev_global = global_params

    records: list = []
    total_events = run_cfg.rounds * N
    obs = _obs_for_run(run_cfg)
    sched = EventScheduler(N, speed, network=net, availability=avail, obs=obs)
    batch_eval, values_fn, norms_fn = _event_helpers(run_cfg, client_eval_fn,
                                                     _value_fn(run_cfg))

    # full-run checkpoint-resume (docs/RESILIENCE.md): one atomic file
    # holding everything the loop body touches, written every
    # checkpoint_every events at the end of the body (nothing draws from
    # the generator between the save and the next event); resume=True
    # restores it when present and the run continues bit-identically
    # from the saved event.
    ckpt_path, ckpt_every = run_cfg.checkpoint_path, run_cfg.checkpoint_every
    fingerprint = (ck.run_fingerprint(run_cfg, "events", global_params)
                   if ckpt_path else None)

    def _save_ckpt(next_ev):
        h0 = obs.host_now() if obs is not None else 0.0
        state = {
            "event": next_ev,
            "rng": ck.generator_state(gen),
            "global_params": ck.tree_to_host(global_params),
            "prev_global": ck.tree_to_host(prev_global),
            "prev_prev_global": ck.tree_to_host(prev_prev_global),
            "client_params": [ck.tree_to_host(t) for t in client_params],
            "prev_grads": [ck.tree_to_host(t) for t in prev_grads],
            "model_version": model_version.copy(),
            "server_version": server_version,
            "comm": dict(comm.__dict__),
            "records": list(records),
            "policy": policy.state(),
            "ef": {c: ck.tree_to_host(t) for c, t in ef.residuals.items()},
            "sched": sched.snapshot(),
            "obs_metrics": obs.metrics.snapshot() if obs is not None else None,
        }
        ck.save_run_state(ckpt_path, state, fingerprint)
        if obs is not None:
            obs.checkpoint(next_ev, h0)

    start_ev = 0
    if run_cfg.resume and ckpt_path and os.path.exists(ckpt_path):
        st = ck.load_run_state(ckpt_path, fingerprint)
        start_ev = int(st["event"])
        ck.set_generator_state(gen, st["rng"])
        global_params = ck.tree_to_device(st["global_params"], dev)
        prev_global = ck.tree_to_device(st["prev_global"], dev)
        prev_prev_global = ck.tree_to_device(st["prev_prev_global"], dev)
        client_params = [ck.tree_to_device(t, dev) for t in st["client_params"]]
        prev_grads = [ck.tree_to_device(t, dev) for t in st["prev_grads"]]
        model_version = np.asarray(st["model_version"], int).copy()
        server_version = int(st["server_version"])
        comm.__dict__.update(st["comm"])
        records = list(st["records"])
        if st["policy"] is not None:
            policy.set_state(st["policy"])
        ef.residuals = {int(c): ck.tree_to_device(t, dev) for c, t in st["ef"].items()}
        sched.restore(st["sched"])
        if obs is not None:
            if st.get("obs_metrics"):
                obs.metrics.restore(st["obs_metrics"])
            obs.checkpoint(start_ev, obs.host_now(), restored=True)

    for ev in range(start_ev, total_events):
        t_now, i = sched.pop()
        u0, d0 = comm.uplink_bytes, comm.downlink_bytes
        one = tree_broadcast(client_params[i], 1)
        d_i = {k: v[i:i + 1] for k, v in data.items()}
        h0 = obs.host_now() if obs is not None else 0.0
        newp_s, eff_s, _ = local_update(one, d_i, gen, ev, clients=[i])
        newp, eff_grad = stacked_index(newp_s, 0), stacked_index(eff_s, 0)
        if obs is not None:
            # sim span: the client's whole local round ended at t_now
            obs.local_update(t_now, t_now, h0, client=i)

        # the policy's declared inputs, computed as size-1 stacked calls
        value = norm = None
        if policy.needs_values:
            accs = batch_eval(newp_s)
            pg = prev_grads[i] if prev_grads[i] is not None else tree_map(
                torch.zeros_like, eff_grad)
            value = float(values_fn(tree_broadcast(pg, 1), eff_s, accs)[0])
        if policy.needs_norms:
            norm = float(norms_fn(eff_s)[0])
        thr = policy.window_threshold(lambda: _tree_delta(prev_global, prev_prev_global))
        if policy.reports:
            comm.record_report(1)
            if obs is not None:
                obs.report(i, t_now)
        upload = policy.decide(i, value, norm, thr)

        if upload:
            p0 = comm.upload_payload_bytes
            if codec.is_identity:
                recon = newp
                comm.record_upload(1)
            else:
                # ship codec(delta vs the model this client downloaded);
                # the server mixes the reconstruction it actually received
                recon = _compressed_upload(codec, ef, comm, client_params[i], newp, i,
                                           _enc_seed(run_cfg, ev, i, _UPLOAD), obs=obs)
            staleness = server_version - model_version[i]
            if obs is not None:
                obs.upload(i, t_now, staleness=int(staleness),
                           nbytes=comm.upload_payload_bytes - p0, codec=codec.name)
            s = aggregator.stale_weight(staleness)
            prev_prev_global = prev_global
            prev_global = global_params
            global_params = aggregator.mix(global_params, recon, aggregator.mix_rate * s)
            server_version += 1

        # client downloads the latest global model and goes again
        if bcodec is None:
            client_params[i] = global_params
            comm.record_broadcast(1)
        else:
            client_params[i] = _compressed_broadcast(bcodec, comm, global_params, 1,
                                                     _enc_seed(run_cfg, ev, i, _BROADCAST),
                                                     obs=obs)
        if obs is not None:
            obs.broadcast(i, t_now, nbytes=comm.downlink_bytes - d0,
                          codec=None if bcodec is None else bcodec.name)
        model_version[i] = server_version
        prev_grads[i] = eff_grad
        # the round's actual on-the-wire bytes (report + payload up, the
        # received broadcast down) feed the scenario's network model: an
        # active one turns them into link delay before the next round
        sched.schedule(i, upload_bytes=comm.uplink_bytes - u0,
                       download_bytes=comm.downlink_bytes - d0)

        if (ev + 1) % run_cfg.events_per_eval == 0:
            h0 = obs.host_now() if obs is not None else 0.0
            acc = float(evaluate_fn(global_params))
            if obs is not None:
                obs.eval_event(ev + 1, t_now, h0)
            records.append(RoundRecord(round=ev + 1, time=t_now, global_acc=acc,
                                       uploads_so_far=comm.model_uploads))
            if verbose:
                progress(f"[{run_cfg.algorithm}/event] ev {ev + 1:4d} t={t_now:8.1f} "
                         f"acc={acc:.4f} uploads={comm.model_uploads}")
        if ckpt_every and (ev + 1) % ckpt_every == 0:
            _save_ckpt(ev + 1)

    res = RunResult(run_cfg.algorithm, records, comm, run_cfg.target_acc).finalize_target()
    return _finish_obs(_attach_sim_result(res, sched), obs)
