"""Round-based runtime: the paper's Algorithm 1.  Port of
``repro.core.runtimes.rounds`` without its scenario, observability and
checkpoint branches (``FLRunConfig`` rejects those settings).

Every round all clients train locally; the algorithm's ``UploadPolicy``
masks who ships a model (VAFL's Eq. 2 mean threshold over the Eq. 1
values, EAFLM's Eq. 3 suppression, always-yes for AFL/FedAvg); the
``Aggregator`` folds the selected set into the global model.  This mode
produces the paper's Table III numbers (communication times, CCR).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.algorithms.base import RoundContext
from repro_torch.common.pytree import tree_broadcast, tree_bytes, tree_map
from repro_torch.core.client import make_local_update
from repro_torch.core.config import resolve_device
from repro_torch.core.metrics import CommStats, RoundRecord, RunResult
from repro_torch.core.runtimes.common import (_make_codecs, _participation_mask,
                                              _round_broadcast, _round_helpers,
                                              _round_uploads, _tree_delta)


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
    client_base = global_params   # what clients actually received last
    records = []
    batch_eval, values_fn, grad_norms_fn = _round_helpers(run_cfg, client_eval_fn)
    part_rng = np.random.RandomState(run_cfg.seed + 101)
    up_bytes = np.zeros(N, np.int64)
    down_bytes = np.zeros(N, np.int64)

    for t in range(1, run_cfg.rounds + 1):
        stacked, eff_grads, _ = local_update(stacked, data, gen, t)
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
        mask, vals_list = policy.round_mask(ctx)
        if not mask.any():  # guard (a policy may suppress all participants)
            norms_np = ctx.norms().detach().cpu().double().numpy()
            norms_np[~part] = -np.inf
            mask = norms_np == norms_np.max()
        stacked = _round_uploads(run_cfg, codec, ef, comm, client_base, stacked, mask, t,
                                 up_acc=up_bytes)

        prev_prev_global = prev_global
        prev_global = global_params
        global_params = aggregator.round_aggregate(
            global_params, stacked, torch.as_tensor(mask, device=dev), counts)
        # broadcast the new global model to every client
        client_base = _round_broadcast(run_cfg, bcodec, comm, global_params, N, t,
                                       down_acc=down_bytes)
        stacked = tree_broadcast(client_base, N)
        prev_grads = eff_grads

        if t % run_cfg.eval_every == 0:
            acc = float(evaluate_fn(global_params))
            records.append(RoundRecord(
                round=t, time=float(t), global_acc=acc,
                uploads_so_far=comm.model_uploads,
                selected=[int(i) for i in np.where(mask)[0]],
                values=vals_list,
                client_accs=None if not run_cfg.record_client_accs else
                [float(a) for a in client_accs.cpu().numpy()]))
            if verbose:
                print(f"[{run_cfg.algorithm}] round {t:3d} acc={acc:.4f} "
                      f"uploads={comm.model_uploads} selected={int(mask.sum())}/{N}",
                      flush=True)

    res = RunResult(run_cfg.algorithm, records, comm, run_cfg.target_acc).finalize_target()
    res.client_uplink_bytes = [int(x) for x in up_bytes]
    res.client_downlink_bytes = [int(x) for x in down_bytes]
    res.client_failed_rounds = [0] * N
    return res
