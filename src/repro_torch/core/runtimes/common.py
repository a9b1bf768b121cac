"""Plumbing shared by the runtimes (rounds / events / sync / batched):
codec wiring with per-client error feedback, deterministic per-transfer
encode seeds, participation sampling, the scenario models, the stacked
per-client inputs and the batched engine's helper set (the counterpart
of the reference's ``_engine_jits``, as plain functions on tensors).
Port of ``repro.core.runtimes.common`` without client sharding.

Nothing in here knows which algorithm is running; runtimes consume the
``UploadPolicy`` / ``Aggregator`` protocol for every algorithm-dependent
decision.
"""
from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from repro_torch.common.pytree import (stacked_index, tree_gather, tree_leaves, tree_map,
                                       tree_scatter, tree_scatter_, tree_stack)
from repro_torch.compress import ErrorFeedback, compress_update, get_codec
from repro_torch.core import value as value_lib
from repro_torch.kernels.grad_diff_norm.ops import tree_grad_diff_sq_norm


def _value_fn(cfg):
    """The stacked ||g_prev - g_cur||^2 backend: the grad_diff_norm
    kernel's wrapper unless the config overrides it."""
    return cfg.value_backend if cfg.value_backend is not None else tree_grad_diff_sq_norm


# ------------------------------------------------- compression plumbing ---

def _make_codecs(run_cfg):
    codec = get_codec(run_cfg.compressor)
    bcodec = None
    if run_cfg.broadcast_compressor not in (None, "", "identity", "none"):
        bcodec = get_codec(run_cfg.broadcast_compressor)
    return codec, bcodec, ErrorFeedback(enabled=run_cfg.error_feedback)


_UPLOAD, _BROADCAST = 1, 2


# ------------------------------------------------- obs plumbing ---

def _obs_for_run(run_cfg):
    """The run's ``repro_torch.obs`` Observer, or None when observability
    is off (``obs=None``, the default): every hook site in the runtimes
    is behind an ``if obs is not None``, so the disabled path costs one
    branch, nothing else."""
    ocfg = getattr(run_cfg, "obs", None)
    if ocfg is None:
        return None
    from repro_torch.obs import Observer
    return Observer(ocfg, meta={
        "algorithm": run_cfg.algorithm, "engine": run_cfg.engine,
        "num_clients": run_cfg.num_clients, "seed": run_cfg.seed,
        "compressor": run_cfg.compressor,
        "broadcast_compressor": run_cfg.broadcast_compressor})


def _finish_obs(res, obs):
    """Seal the observer onto the result (exports + metrics snapshot)."""
    if obs is not None:
        obs.finish(res)
    return res


# ------------------------------------------------- scenario plumbing ---

def _scenario_models(run_cfg, num_clients):
    """Build the run's ``repro_torch.sim`` scenario models: ``(compute,
    network, availability)``, or ``(None, None, None)`` for the default
    scenario (``scenario=None`` or an all-defaults config), the
    bit-exact legacy path."""
    if run_cfg.scenario is None or run_cfg.scenario.is_default():
        return None, None, None
    return run_cfg.scenario.build(num_clients, run_cfg.seed)


def _active(model):
    """A scenario model that is present and not a declared no-op
    (ideal network / always-on availability carry ``active = False``)."""
    return model is not None and getattr(model, "active", True)


def _participation_mask(part_rng, participation: float, n: int) -> np.ndarray:
    """The round's participating set S."""
    if participation < 1.0:
        k = max(1, int(round(participation * n)))
        part = np.zeros(n, bool)
        part[part_rng.choice(n, size=k, replace=False)] = True
        return part
    return np.ones(n, bool)


def _enc_seed(run_cfg, step: int, i: int, kind: int) -> int:
    """Deterministic per-transfer seed: payloads are reproducible from the
    run seed alone, and distinct transfers never share a seed
    (multiplicative mixing over (seed, kind, step, client))."""
    h = (run_cfg.seed ^ (kind * 0x9E3779B9)) & 0xFFFFFFFF
    h = (h * 1_000_003 + step) & 0xFFFFFFFF
    h = (h * 1_000_003 + i) & 0xFFFFFFFF
    return h


def _tree_delta(a, b):
    return tree_map(lambda x, y: x.float() - y.float(), a, b)


def _tree_apply_delta(base, delta):
    return tree_map(lambda b, d: (b.float() + d.float()).to(b.dtype), base, delta)


def _compressed_upload(codec, ef, comm, base, client_tree, i, seed, obs=None):
    """One client's compressed upload: encode codec(delta vs ``base``, the
    model the client downloaded) with error feedback, account the wire
    bytes, and return the reconstruction the server receives.  Under obs
    the encode+decode is a host-timed "encode" span tagged with the
    codec."""
    delta = _tree_delta(client_tree, base)
    with (obs.timed("encode", client=i, codec=codec.name)
          if obs is not None else nullcontext()):
        payload, decoded = compress_update(codec, ef, i, delta, seed=seed)
    comm.record_upload(1, nbytes=payload.nbytes)
    return _tree_apply_delta(base, decoded)


def _compressed_broadcast(bcodec, comm, params, n, seed, obs=None):
    """Encode one model broadcast to ``n`` clients; returns the lossy
    model they receive (no EF on the downlink)."""
    with (obs.timed("encode", codec=bcodec.name, broadcast=True)
          if obs is not None else nullcontext()):
        bp = bcodec.encode(params, seed=seed)
        out = bcodec.decode(bp)
    comm.record_broadcast(n, nbytes=n * bp.nbytes)
    return out


def _round_uploads(run_cfg, codec, ef, comm, base, stacked, mask, t, up_acc=None,
                   obs=None, sim=None):
    """One round's upload leg: account the selected set's uploads; with a
    codec, each selected client ships codec(delta vs ``base``) with error
    feedback and the reconstructions are scattered back into the stack
    (the server aggregates what it received).  ``up_acc`` (optional (N,)
    int array) receives each client's on-the-wire upload bytes.  Under
    obs each selected client's upload becomes a trace event (staleness 0:
    synchronous rounds aggregate fresh models)."""
    sel = [int(i) for i in np.flatnonzero(mask)]
    if codec.is_identity:
        comm.record_upload(len(sel))
        if up_acc is not None:
            up_acc[sel] += comm.model_bytes
        if obs is not None:
            for i in sel:
                obs.upload(i, sim, nbytes=comm.model_bytes, codec=codec.name)
        return stacked
    recon = []
    for i in sel:
        b0 = comm.uplink_bytes
        recon.append(_compressed_upload(codec, ef, comm, base, stacked_index(stacked, i), i,
                                        _enc_seed(run_cfg, t, i, _UPLOAD), obs=obs))
        if up_acc is not None:
            up_acc[i] += comm.uplink_bytes - b0
        if obs is not None:
            obs.upload(i, sim, nbytes=comm.uplink_bytes - b0, codec=codec.name)
    if sel:   # one scatter per leaf, not one stack copy per client
        stacked = tree_scatter(stacked, sel, tree_stack(recon))
    return stacked


def _round_broadcast(run_cfg, bcodec, comm, global_params, n, t, down_acc=None, obs=None,
                     sim=None):
    """One round's broadcast leg: returns the model the clients receive
    (lossy under a downlink codec).  ``down_acc`` (optional (n,) int
    array) receives each client's downlink bytes.  Under obs the whole
    round's broadcast is ONE trace event with n receivers and the TOTAL
    wire bytes."""
    if bcodec is None:
        comm.record_broadcast(n)
        if down_acc is not None:
            down_acc += comm.model_bytes
        if obs is not None:
            obs.broadcast(None, sim, nbytes=n * comm.model_bytes, n=n)
        return global_params
    d0 = comm.downlink_bytes
    out = _compressed_broadcast(bcodec, comm, global_params, n,
                                _enc_seed(run_cfg, t, 0, _BROADCAST), obs=obs)
    if down_acc is not None:
        down_acc += (comm.downlink_bytes - d0) // n
    if obs is not None:
        obs.broadcast(None, sim, nbytes=comm.downlink_bytes - d0, n=n, codec=bcodec.name)
    return out


def _flush_reconstructions(aggregator, global_params, recons, stales):
    """Mix a buffer of reconstruction trees into the global model: the
    FedBuff-K commit for any engine holding materialised
    reconstructions (in the reference, the serve loop's; its port is
    ROADMAP queue 1 item 9).  A singleton buffer is the sequential per-arrival
    mix bit for bit (``buffered_mix`` K=1 path); larger buffers take the
    aggregator's ``flush_mix`` so a plugin aggregator stays in charge of
    its own mixing."""
    from repro_torch.core.aggregation import buffered_coefs, buffered_mix
    if len(recons) == 1:
        return buffered_mix(global_params, recons, stales, aggregator.mix_rate,
                            mix=aggregator.mix)
    src = tree_stack(list(recons))
    coef, rho_sbar = buffered_coefs(stales, aggregator.mix_rate)
    return aggregator.flush_mix(global_params, src, np.arange(len(recons)), coef, rho_sbar)


def _attach_sim_result(res, sched):
    """Copy the scheduler's per-client simulation ledger onto a
    ``RunResult`` (event runtime)."""
    idle = sched.idle_fraction()
    res.sim_time = float(sched.now)
    res.idle_fraction = float(idle.mean())
    res.client_idle = [float(x) for x in idle]
    res.client_uplink_bytes = [int(x) for x in sched.client_up_bytes]
    res.client_downlink_bytes = [int(x) for x in sched.client_down_bytes]
    res.client_failed_rounds = [int(x) for x in sched.client_failed_rounds]
    return res


def _round_helpers(run_cfg, client_eval_fn):
    """The stacked round inputs of the round and barrier runtimes: the
    event helpers over N-row stacks, with the config's value backend."""
    return _event_helpers(run_cfg, client_eval_fn, _value_fn(run_cfg))


def _event_helpers(run_cfg, client_eval_fn, sq_diff):
    """Stacked per-client inputs over a stack of W rows (the sequential
    loop passes size-1 stacks, the batched engine a window's W rows, the
    round runtimes all N): per-client eval, Eq. 1 values with ``sq_diff``
    (one call for all W rows: the grad_diff_norm kernel's wrapper unless
    the config overrides it) and squared gradient norms.  Each is
    computed only when the policy (or the round record) reads it."""
    N = run_cfg.num_clients

    def batch_eval(stacked):
        rows = tree_leaves(stacked)[0].shape[0]
        return torch.stack([torch.as_tensor(client_eval_fn(stacked_index(stacked, i)))
                            for i in range(rows)])

    def values_fn(gp, gc, accs):
        return value_lib.communication_values_stacked(gp, gc, accs, N, sq_diff_fn=sq_diff)

    return batch_eval, values_fn, value_lib.stacked_sq_norms


# ------------------------------------------- batched-engine helper set ---
# The reference compiles these as one donated jit each; here they are
# plain functions whose writes into the (N, ...) stacked client state go
# in place (``index_copy_``), so a window never copies the full stacks.
# Its gather and stack are ``tree_gather`` and ``tree_stack``, and its
# folded flush is ``aggregation.flush_mix``.  ``versions`` is the list of
# distinct global models the window's clients downloaded, and ``rel`` (a
# LongTensor) picks one per row; under a folded flush the new global is
# appended to it, for the clients that downloaded after the flush.

def _downloads(versions, rel):
    """(W, ...) stacked downloads: row j is ``versions[rel[j]]``."""
    return tree_gather(tree_stack(versions), rel)


def commit_win(cp, pg, idx, versions, rel, eff):
    """Sub-full-window commit: the window's downloads and effective
    gradients written into rows ``idx`` of the client stacks, in place."""
    tree_scatter_(cp, idx, _downloads(versions, rel))
    tree_scatter_(pg, idx, eff)
    return cp, pg


def commit_win_flush(gp, cp, pg, idx, versions, rel, eff, src, rows, coef, rho_sbar):
    """``commit_win`` with the window's final buffer flush folded in: the
    new global is produced and handed to the clients that downloaded it
    (``rel == len(versions)``)."""
    from repro_torch.core.aggregation import flush_mix
    gnew = flush_mix(gp, src, rows, coef, rho_sbar)
    cp, pg = commit_win(cp, pg, idx, versions + [gnew], rel, eff)
    return gnew, cp, pg


def commit_full(versions, rel, eff):
    """Full-window commit (w == N): every client downloaded, so the new
    client stack is a per-client gather of download versions and
    prev_grads IS the window's eff stack (client order)."""
    return _downloads(versions, rel), eff


def commit_full_flush(gp, versions, rel, eff, src, rows, coef, rho_sbar):
    """``commit_full`` with the window's final buffer flush folded in."""
    from repro_torch.core.aggregation import flush_mix
    gnew = flush_mix(gp, src, rows, coef, rho_sbar)
    cp, pg = commit_full(versions + [gnew], rel, eff)
    return gnew, cp, pg
