"""Synchronous round-barrier runtime: the idle-time baseline (FedAvg).
Port of ``repro.core.runtimes.sync`` without its checkpoint and obs
branches.

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

import numpy as np
import torch

from repro_torch.algorithms.base import RoundContext
from repro_torch.common.pytree import tree_broadcast, tree_bytes, tree_map
from repro_torch.core.metrics import CommStats, RoundRecord, RunResult
from repro_torch.core.runtimes.common import (_active, _make_codecs, _participation_mask,
                                              _round_broadcast, _round_helpers,
                                              _round_uploads, _tree_delta)


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

    for t in range(1, run_cfg.rounds + 1):
        # the round's participating set S (same sampling as round-based)
        part = _participation_mask(part_rng, run_cfg.participation, N)
        stacked = tree_broadcast(client_base, N)
        stacked, eff_grads, _ = local_update(stacked, data, gen, t)
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
        mask, _ = policy.round_mask(ctx)
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
        stacked = _round_uploads(run_cfg, codec, ef, comm, client_base, stacked, mask, t,
                                 up_acc=up_bytes)
        prev_prev_global = prev_global
        prev_global = global_params
        global_params = aggregator.round_aggregate(
            global_params, stacked, torch.as_tensor(mask, device=dev), counts)
        client_base = _round_broadcast(run_cfg, bcodec, comm, global_params, N, t,
                                       down_acc=down_bytes)
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
            acc = float(evaluate_fn(global_params))
            records.append(RoundRecord(round=t, time=now, global_acc=acc,
                                       uploads_so_far=comm.model_uploads))
            if verbose:
                print(f"[{run_cfg.algorithm}] round {t:3d} t={now:8.1f} acc={acc:.4f}",
                      flush=True)
    res = RunResult(run_cfg.algorithm, records, comm, run_cfg.target_acc).finalize_target()
    idle = np.clip(1.0 - busy / max(now, 1e-9), 0.0, 1.0)
    res.idle_fraction = float(1.0 - (busy / max(now, 1e-9)).mean())
    res.sim_time = float(now)
    res.client_idle = [float(x) for x in idle]
    res.client_uplink_bytes = [int(x) for x in up_bytes]
    res.client_downlink_bytes = [int(x) for x in down_bytes]
    res.client_failed_rounds = [int(x) for x in failed]
    return res
