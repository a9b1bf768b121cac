"""Synchronous round-barrier runtime: the idle-time baseline (FedAvg).
Port of ``repro.core.runtimes.sync``.

Algorithms registered with ``event_mode="sync-barrier"`` land here from
``run_event_driven``: each round the sampled participant set S trains,
the barrier waits for the slowest *participant*, the ``UploadPolicy``
masks who ships a model (FedAvg's always-upload policy masks exactly S,
but a gated sync algorithm works too: the policy's lazy round inputs
cost nothing unless declared), and the ``Aggregator`` folds the
uploaded set into the global model (weighted FedAvg).  Honors the same
codec config as the async runtime (uploads ship codec(delta vs the
broadcast base) with error feedback) and the same ``participation``
fraction as the round-based runtime.
"""
from __future__ import annotations

import os

import numpy as np
import torch

import repro_torch.checkpoint.store as ck
from repro_torch.algorithms.base import RoundContext
from repro_torch.common.pytree import tree_broadcast, tree_bytes, tree_map
from repro_torch.core.metrics import CommStats, RoundRecord, RunResult
from repro_torch.core.runtimes.common import (_active, _finish_obs, _make_codecs,
                                              _obs_for_run, _participation_mask,
                                              _round_broadcast, _round_helpers,
                                              _round_uploads, _tree_delta)
from repro_torch.obs.console import progress


def _run_sync_barrier(run_cfg, policy, aggregator, global_params, gen, local_update, data,
                      counts, evaluate_fn, client_eval_fn, speed, net=None, avail=None,
                      verbose=False) -> RunResult:
    """The barrier loop, from ``run_event_driven``'s set-up: the initial
    model, the run's generator, its local update (the round is the step
    it passes to ``perm_fn``) and the data on the device."""
    N = run_cfg.num_clients
    dev = next(iter(data.values())).device
    comm = CommStats(model_bytes=tree_bytes(global_params))
    codec, bcodec, ef = _make_codecs(run_cfg)
    obs = _obs_for_run(run_cfg)
    client_base = global_params
    counts = torch.as_tensor(np.asarray(counts), dtype=torch.float32, device=dev)

    # lazy round inputs for gated sync policies, never computed for
    # always-upload baselines like fedavg
    batch_eval, values_fn, grad_norms_fn = _round_helpers(run_cfg, client_eval_fn)
    prev_grads = None   # (N, ...) grad stack retained only under needs_values
    prev_global = global_params
    prev_prev_global = global_params

    records = []
    now = 0.0
    busy = np.zeros(N)
    up_bytes = np.zeros(N, np.int64)      # per-client on-the-wire ledger
    down_bytes = np.zeros(N, np.int64)
    failed = np.zeros(N, np.int64)
    net = net if _active(net) else None
    avail = avail if _active(avail) else None
    part_rng = np.random.RandomState(run_cfg.seed + 101)

    # full-run checkpoint-resume (docs/RESILIENCE.md), round-grained like
    # the round-based runtime — same bundle shape, plus the speed model's
    # state (the barrier samples it every round).
    ckpt_path, ckpt_every = run_cfg.checkpoint_path, run_cfg.checkpoint_every
    fingerprint = (ck.run_fingerprint(run_cfg, "sync", global_params)
                   if ckpt_path else None)
    _models = (("speed", speed), ("network", net), ("availability", avail))

    def _save_ckpt(t_done):
        h0 = obs.host_now() if obs is not None else 0.0
        state = {
            "round": t_done,
            "rng": ck.generator_state(gen),
            "global_params": ck.tree_to_host(global_params),
            "prev_global": ck.tree_to_host(prev_global),
            "prev_prev_global": ck.tree_to_host(prev_prev_global),
            "client_base": ck.tree_to_host(client_base),
            "prev_grads": ck.tree_to_host(prev_grads),
            "comm": dict(comm.__dict__),
            "records": list(records),
            "policy": policy.state(),
            "ef": {c: ck.tree_to_host(x) for c, x in ef.residuals.items()},
            "part_rng": part_rng.get_state(),
            "models": {name: m.state() for name, m in _models
                       if m is not None and hasattr(m, "state")},
            "clock": (now, busy.copy(), up_bytes.copy(), down_bytes.copy(), failed.copy()),
            "obs_metrics": obs.metrics.snapshot() if obs is not None else None,
        }
        ck.save_run_state(ckpt_path, state, fingerprint)
        if obs is not None:
            obs.checkpoint(t_done, h0)

    start_t = 0
    if run_cfg.resume and ckpt_path and os.path.exists(ckpt_path):
        st = ck.load_run_state(ckpt_path, fingerprint)
        start_t = int(st["round"])
        ck.set_generator_state(gen, st["rng"])
        global_params = ck.tree_to_device(st["global_params"], dev)
        prev_global = ck.tree_to_device(st["prev_global"], dev)
        prev_prev_global = ck.tree_to_device(st["prev_prev_global"], dev)
        client_base = ck.tree_to_device(st["client_base"], dev)
        prev_grads = ck.tree_to_device(st["prev_grads"], dev)
        comm.__dict__.update(st["comm"])
        records = list(st["records"])
        if st["policy"] is not None:
            policy.set_state(st["policy"])
        ef.residuals = {int(c): ck.tree_to_device(x, dev) for c, x in st["ef"].items()}
        part_rng.set_state(st["part_rng"])
        for name, m in _models:
            if name in st["models"] and m is not None:
                m.set_state(st["models"][name])
        now, busy, up_bytes, down_bytes, failed = st["clock"]
        busy, up_bytes, down_bytes, failed = (
            busy.copy(), up_bytes.copy(), down_bytes.copy(), failed.copy())
        if obs is not None:
            if st.get("obs_metrics"):
                obs.metrics.restore(st["obs_metrics"])
            obs.checkpoint(start_t, obs.host_now(), restored=True)

    for t in range(start_t + 1, run_cfg.rounds + 1):
        # the round's participating set S (same sampling as round-based)
        part = _participation_mask(part_rng, run_cfg.participation, N)
        stacked = tree_broadcast(client_base, N)
        h0 = obs.host_now() if obs is not None else 0.0
        stacked, eff_grads, _ = local_update(stacked, data, gen, t)
        if obs is not None:
            obs.local_update(now, now, h0, clients=N)
        round_times = np.array([speed.sample(c, now) for c in range(N)])
        busy[part] += round_times[part]   # non-participants idle all round
        u0, d0 = up_bytes.copy(), down_bytes.copy()
        ctx = RoundContext(
            part=part, comm=comm,
            values_fn=lambda: values_fn(
                prev_grads if prev_grads is not None else tree_map(torch.zeros_like, eff_grads),
                eff_grads, batch_eval(stacked)),
            norms_fn=lambda: grad_norms_fn(eff_grads),
            server_delta_fn=lambda: _tree_delta(prev_global, prev_prev_global))
        r0 = comm.scalar_reports
        mask, _ = policy.round_mask(ctx)
        if obs is not None and comm.scalar_reports > r0:
            obs.report(None, now, n=comm.scalar_reports - r0)
        if not mask.any():  # guard (a policy may suppress all participants)
            norms_np = ctx.norms().detach().cpu().double().numpy()
            norms_np[~part] = -np.inf
            mask = norms_np == norms_np.max()
        if avail is not None:
            # mid-round failure: the participant burned the round's
            # compute but its update never reaches the server
            for c in np.flatnonzero(part):
                if avail.round_fails(int(c)):
                    failed[c] += 1
                    mask = mask & (np.arange(N) != c)
                    if obs is not None:
                        obs.failure(int(c), now)
        stacked = _round_uploads(run_cfg, codec, ef, comm, client_base, stacked, mask, t,
                                 up_acc=up_bytes, obs=obs, sim=now)
        prev_prev_global = prev_global
        prev_global = global_params
        global_params = aggregator.round_aggregate(
            global_params, stacked, torch.as_tensor(mask, device=dev), counts)
        if obs is not None:
            obs.aggregate(now, n=int(mask.sum()))
        client_base = _round_broadcast(run_cfg, bcodec, comm, global_params, N, t,
                                       down_acc=down_bytes, obs=obs, sim=now)
        # barrier: slowest *participant*, including its own transfer time
        # under a byte-aware network model
        delay = np.zeros(N)
        if net is not None:
            delay = np.array([net.delay(c, int(up_bytes[c] - u0[c]),
                                        int(down_bytes[c] - d0[c]), now)
                              for c in range(N)])
        now += float((round_times + delay)[part].max())
        if policy.needs_values:   # fedavg never reads it: don't retain
            prev_grads = eff_grads
        if t % run_cfg.eval_every == 0:
            h0 = obs.host_now() if obs is not None else 0.0
            acc = float(evaluate_fn(global_params))
            if obs is not None:
                obs.eval_event(t, now, h0)
            records.append(RoundRecord(round=t, time=now, global_acc=acc,
                                       uploads_so_far=comm.model_uploads))
            if verbose:
                progress(f"[{run_cfg.algorithm}] round {t:3d} t={now:8.1f} acc={acc:.4f}")
        if ckpt_every and t % ckpt_every == 0:
            _save_ckpt(t)
    res = RunResult(run_cfg.algorithm, records, comm, run_cfg.target_acc).finalize_target()
    idle = np.clip(1.0 - busy / max(now, 1e-9), 0.0, 1.0)
    res.idle_fraction = float(1.0 - (busy / max(now, 1e-9)).mean())
    res.sim_time = float(now)
    res.client_idle = [float(x) for x in idle]
    res.client_uplink_bytes = [int(x) for x in up_bytes]
    res.client_downlink_bytes = [int(x) for x in down_bytes]
    res.client_failed_rounds = [int(x) for x in failed]
    return _finish_obs(res, obs)
