"""Round-based runtime: the paper's Algorithm 1.  Port of
``repro.core.runtimes.rounds``.

Every round all clients train locally; the algorithm's ``UploadPolicy``
masks who ships a model (VAFL's Eq. 2 mean threshold over the Eq. 1
values, EAFLM's Eq. 3 suppression, always-yes for AFL/FedAvg); the
``Aggregator`` folds the selected set into the global model.  This mode
produces the paper's Table III numbers (communication times, CCR).
"""
from __future__ import annotations

import os

import numpy as np
import torch

import repro_torch.checkpoint.store as ck
from repro_torch.algorithms.base import RoundContext
from repro_torch.common.pytree import tree_broadcast, tree_bytes, tree_map
from repro_torch.core.client import make_local_update
from repro_torch.core.config import resolve_device
from repro_torch.core.metrics import CommStats, RoundRecord, RunResult
from repro_torch.core.runtimes.common import (_active, _finish_obs, _make_codecs,
                                              _obs_for_run, _participation_mask,
                                              _round_broadcast, _round_helpers,
                                              _round_uploads, _scenario_models, _tree_delta)
from repro_torch.obs.console import progress


def run_round_based(run_cfg, *, init_params_fn, loss_fn, fed_data, evaluate_fn,
                    client_eval_fn=None, device="cuda", perm_fn=None,
                    verbose: bool = False) -> RunResult:
    """Algorithm 1.  init_params_fn(generator) -> params;
    loss_fn(params, batch) -> (loss, aux); fed_data: FederatedData
    (numpy); evaluate_fn(params) -> global test Acc; client_eval_fn(params)
    -> Acc (defaults to evaluate_fn).  ``device`` is where the run lives
    (a CUDA device unless the caller asks for the CPU); ``perm_fn`` is
    the local update's permutation hook (``core.client``)."""
    dev = resolve_device(device)
    _, policy, aggregator = run_cfg.make_algorithm()
    N = run_cfg.num_clients
    policy.begin_run(N)
    aggregator.begin_run(N)
    client_eval_fn = client_eval_fn or evaluate_fn
    gen = torch.Generator(device=dev).manual_seed(run_cfg.seed)
    global_params = tree_map(lambda x: x.to(dev), init_params_fn(gen))
    stacked = tree_broadcast(global_params, N)
    prev_grads = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=dev),
                          stacked)
    prev_global = global_params  # for EAFLM server-delta threshold
    prev_prev_global = global_params

    local_update = make_local_update(loss_fn, run_cfg.local, perm_fn=perm_fn)
    counts = torch.as_tensor(np.asarray(fed_data.counts), dtype=torch.float32, device=dev)
    data = {"images": torch.as_tensor(np.asarray(fed_data.images), device=dev),
            "labels": torch.as_tensor(np.asarray(fed_data.labels), device=dev).long(),
            "mask": torch.as_tensor(np.asarray(fed_data.mask), device=dev)}

    comm = CommStats(model_bytes=tree_bytes(global_params))
    codec, bcodec, ef = _make_codecs(run_cfg)
    obs = _obs_for_run(run_cfg)
    client_base = global_params   # what clients actually received last
    records = []
    batch_eval, values_fn, grad_norms_fn = _round_helpers(run_cfg, client_eval_fn)
    part_rng = np.random.RandomState(run_cfg.seed + 101)

    # scenario (repro_torch.sim): the round-based runtime has no clock by
    # default (record time = the round index) — under an active
    # scenario= it simulates one like the sync barrier: every round
    # costs the slowest participant's service + byte-aware link delay,
    # and availability failures discard uploads mid-round
    compute, net, avail = _scenario_models(run_cfg, N)
    net = net if _active(net) else None
    avail = avail if _active(avail) else None
    now = 0.0
    busy = np.zeros(N)
    up_bytes = np.zeros(N, np.int64)
    down_bytes = np.zeros(N, np.int64)
    failed = np.zeros(N, np.int64)

    # full-run checkpoint-resume (docs/RESILIENCE.md): here the unit is
    # a ROUND — one atomic file every checkpoint_every rounds, bundling
    # the model lineage, per-client grads/EF, the run's generator, the
    # participation RNG, the scenario model states and the clock.
    ckpt_path, ckpt_every = run_cfg.checkpoint_path, run_cfg.checkpoint_every
    fingerprint = (ck.run_fingerprint(run_cfg, "rounds", global_params)
                   if ckpt_path else None)
    _models = (("compute", compute), ("network", net), ("availability", avail))

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
        stacked = tree_broadcast(client_base, N)
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
        # without a scenario the round-based runtime has no clock: its
        # simulated timeline is the round index (matching record.time)
        sim = now if compute is not None else float(t)
        h0 = obs.host_now() if obs is not None else 0.0
        stacked, eff_grads, _ = local_update(stacked, data, gen, t)
        if obs is not None:
            obs.local_update(sim, sim, h0, clients=N)
        # per-client eval: needed by Eq. 1 values and/or the round record
        client_accs = (batch_eval(stacked)
                       if policy.needs_values or run_cfg.record_client_accs else None)

        part = _participation_mask(part_rng, run_cfg.participation, N)
        ctx = RoundContext(
            part=part, comm=comm,
            values_fn=lambda: values_fn(
                prev_grads, eff_grads,
                client_accs if client_accs is not None else batch_eval(stacked)),
            norms_fn=lambda: grad_norms_fn(eff_grads),
            server_delta_fn=lambda: _tree_delta(prev_global, prev_prev_global))
        r0 = comm.scalar_reports
        mask, vals_list = policy.round_mask(ctx)
        if obs is not None and comm.scalar_reports > r0:
            # policies report in bulk (ctx.comm.record_report(|S|)) with
            # no per-client split: one trace event carries the count
            obs.report(None, sim, n=comm.scalar_reports - r0)
        if not mask.any():  # guard (a policy may suppress all participants)
            norms_np = ctx.norms().detach().cpu().double().numpy()
            norms_np[~part] = -np.inf
            mask = norms_np == norms_np.max()
        service = (np.array([compute.sample(c, now) for c in range(N)])
                   if compute is not None else None)
        if avail is not None:
            for c in np.flatnonzero(part):
                if avail.round_fails(int(c)):
                    failed[c] += 1
                    mask = mask & (np.arange(N) != c)
                    if obs is not None:
                        obs.failure(int(c), sim)
        u0, d0 = up_bytes.copy(), down_bytes.copy()
        stacked = _round_uploads(run_cfg, codec, ef, comm, client_base, stacked, mask, t,
                                 up_acc=up_bytes, obs=obs, sim=sim)

        prev_prev_global = prev_global
        prev_global = global_params
        global_params = aggregator.round_aggregate(
            global_params, stacked, torch.as_tensor(mask, device=dev), counts)
        if obs is not None:
            obs.aggregate(sim, n=int(mask.sum()))
        # broadcast the new global model to every client
        client_base = _round_broadcast(run_cfg, bcodec, comm, global_params, N, t,
                                       down_acc=down_bytes, obs=obs, sim=sim)
        if service is not None:
            delay = np.zeros(N)
            if net is not None:
                delay = np.array([net.delay(c, int(up_bytes[c] - u0[c]),
                                            int(down_bytes[c] - d0[c]), now)
                                  for c in range(N)])
            busy[part] += service[part]
            now += float((service + delay)[part].max())
        stacked = tree_broadcast(client_base, N)
        prev_grads = eff_grads

        if t % run_cfg.eval_every == 0:
            h0 = obs.host_now() if obs is not None else 0.0
            acc = float(evaluate_fn(global_params))
            if obs is not None:
                obs.eval_event(t, now if compute is not None else float(t), h0)
            records.append(RoundRecord(
                round=t, time=now if compute is not None else float(t), global_acc=acc,
                uploads_so_far=comm.model_uploads,
                selected=[int(i) for i in np.where(mask)[0]],
                values=vals_list,
                client_accs=None if not run_cfg.record_client_accs else
                [float(a) for a in client_accs.cpu().numpy()]))
            if verbose:
                progress(f"[{run_cfg.algorithm}] round {t:3d} acc={acc:.4f} "
                         f"uploads={comm.model_uploads} selected={int(mask.sum())}/{N}")
        if ckpt_every and t % ckpt_every == 0:
            _save_ckpt(t)

    res = RunResult(run_cfg.algorithm, records, comm, run_cfg.target_acc).finalize_target()
    res.client_uplink_bytes = [int(x) for x in up_bytes]
    res.client_downlink_bytes = [int(x) for x in down_bytes]
    res.client_failed_rounds = [int(x) for x in failed]
    if compute is not None:   # a simulated clock exists only under scenario=
        idle = np.clip(1.0 - busy / max(now, 1e-9), 0.0, 1.0)
        res.sim_time = float(now)
        res.idle_fraction = float(idle.mean())
        res.client_idle = [float(x) for x in idle]
    return _finish_obs(res, obs)
