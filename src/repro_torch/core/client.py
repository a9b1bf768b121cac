"""Client-side local training.  Port of ``repro.core.client``.

Client state is a stacked tree (leading axis = client), and a call
trains all of its W rows as one batched computation, as the
reference's vmapped update does: ``torch.func.vmap`` of the per-client
loss gives the W losses, and autograd differentiates their sum, in
which row i's parameters reach only loss i, so each row gets its own
client's gradient.  One SGD step of W clients launches the kernels of
one step (on the card the CNN's convolutions are batched GEMMs,
``models/cnn.py``).  Per-client sample masks handle quantity skew.

The "effective gradient" of a local round is (theta_start - theta_end)/lr,
the quantity whose round-over-round difference feeds Eq. 1.

Randomness comes from the run's ``torch.Generator``: one permutation of
the client's M (padded) samples per local epoch, drawn row by row in
the call's draw order before the step loop, so a client's draws do not
depend on how many clients share its call.  ``perm_fn(client, step,
epoch, M) -> LongTensor`` replaces those draws, so tests can hand both
packages the same permutations.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.common import fp32
from repro_torch.common.pytree import tree_flatten, tree_sq_diff_norm, tree_unflatten


@dataclass(frozen=True)
class LocalSpec:
    batch_size: int = 32
    local_epochs: int = 1       # E in the paper
    local_rounds: int = 5       # r in the paper (gradient rounds per report)
    lr: float = 0.1             # eta
    # FedProx: proximal term mu/2 * ||theta - theta_global||^2 added to
    # every local step.  0 = plain FedAvg local SGD.
    prox_mu: float = 0.0
    # DP-style upload sanitisation: clip the local update to L2 norm
    # dp_clip and add N(0, (dp_clip*dp_noise)^2).
    dp_clip: float = 0.0        # 0 = off
    dp_noise: float = 0.0       # noise multiplier sigma


def make_local_update(loss_fn: Callable, spec: LocalSpec,
                      perm_fn: Optional[Callable] = None):
    """loss_fn(params, batch) -> (loss, aux); batch has 'images',
    'labels', 'weights'.  Returns

    update(stacked_params, data, generator, step, clients) -> (new_params, eff_grad, mean_loss)

    over stacked clients, with data {"images": (W,M,...), "labels": (W,M),
    "mask": (W,M)} on the parameters' device, ``step`` the call's index
    (the round in the round runtime, the event in the sequential loop,
    the window's first event in the batched engine) and ``clients`` the
    client id of each row (default 0..W-1), both passed on to
    ``perm_fn``.  Rows draw their randomness in row order."""
    run = _build_local_update(loss_fn, spec, perm_fn)

    def update(stacked_params, data, generator, step: int = 0, clients=None):
        n = data["labels"].shape[0]
        clients = list(range(n)) if clients is None else [int(c) for c in clients]
        return run(stacked_params, data, generator, step, clients, list(range(n)))

    return update


def make_local_update_keyed(loss_fn: Callable, spec: LocalSpec,
                            perm_fn: Optional[Callable] = None):
    """The batched engine's full-window form of ``make_local_update``:

    update_keyed(stacked_params, data, generator, step, order) -> (new_params, eff_grad, mean_loss)

    over all N clients in CLIENT order (row c is client c), where
    ``order`` is the window's arrival order of client ids: client
    ``order[j]`` draws its randomness at position j, as it would in the
    gathered form, so the two forms agree row for row.  Shares the
    per-window body with ``make_local_update``."""
    run = _build_local_update(loss_fn, spec, perm_fn)

    def update_keyed(stacked_params, data, generator, step: int, order):
        order = [int(c) for c in order]
        return run(stacked_params, data, generator, step, order, order)

    return update_keyed


def _build_local_update(loss_fn: Callable, spec: LocalSpec, perm_fn: Optional[Callable]):
    B, lr = spec.batch_size, spec.lr
    n_ep = spec.local_epochs * spec.local_rounds

    def weighted(treedef, leaves, x, y, w, anchor):
        p = tree_unflatten(treedef, leaves)
        loss, _ = loss_fn(p, {"images": x, "labels": y, "weights": w})
        if spec.prox_mu:
            loss = loss + 0.5 * spec.prox_mu * tree_sq_diff_norm(
                p, tree_unflatten(treedef, anchor))
        return loss

    def draws(gen, step, clients, M, shapes, device):
        """Each client's epoch permutations, and under DP its noise, in
        draw order: ``clients[j]`` is the j-th client to draw."""
        perms, noise = [], []
        for c in clients:
            perms.append(torch.stack([
                (perm_fn(c, step, e, M) if perm_fn is not None else
                 torch.randperm(M, generator=gen, device=gen.device)).to(device)
                for e in range(n_ep)]))
            if spec.dp_clip:
                noise.append([torch.randn(s, generator=gen, device=gen.device).to(device)
                              for s in shapes])
        return perms, noise

    def run(stacked_params, data, gen, step, clients, rows):
        """Train row ``rows[j]`` with the j-th client's draws."""
        images, labels, mask = data["images"], data["labels"], data["mask"]
        W, M = labels.shape
        # small / non-IID shards: clamp the effective batch to the shard size
        b = min(B, M)
        nb = max(M // b, 1)
        leaves, treedef = tree_flatten(stacked_params)
        p0 = [x.detach() for x in leaves]   # the downloaded models (FedProx / DP base)
        perms_j, noise_j = draws(gen, step, clients, M, [x.shape[1:] for x in p0],
                                 images.device)
        if rows == list(range(W)):
            perms = torch.stack(perms_j)
        else:   # arrival-order draws into client-order rows
            perms = torch.empty((W, n_ep, M), dtype=torch.long, device=images.device)
            perms[torch.as_tensor(rows, device=images.device)] = torch.stack(perms_j)
        losses_fn = torch.func.vmap(partial(weighted, treedef))
        ar = torch.arange(W, device=images.device)[:, None]
        cur = p0
        ep_means = []
        # forward and backward in IEEE fp32 whatever the process-wide
        # TF32 flags say (the CNN's GEMM route scopes its forward too)
        with fp32.ieee():
            for e in range(n_ep):
                pe = perms[:, e, :nb * b]
                xb = images[ar, pe].reshape((W, nb, b) + tuple(images.shape[2:]))
                yb = labels[ar, pe].reshape(W, nb, b)
                wb = mask[ar, pe].reshape(W, nb, b)
                losses = []
                for s in range(nb):
                    req = [x.detach().requires_grad_(True) for x in cur]
                    loss = losses_fn(req, xb[:, s], yb[:, s], wb[:, s], p0)
                    # row i's parameters reach only loss i: the gradient of the
                    # sum is each client's own gradient, exactly
                    grads = torch.autograd.grad(loss.sum(), req)
                    with torch.no_grad():
                        cur = [(x.float() - lr * g.float()).to(x.dtype) for x, g in zip(req, grads)]
                    losses.append(loss.detach())
                ep_means.append(torch.mean(torch.stack(losses), 0))
        if spec.dp_clip:
            # clip each row's round delta and add Gaussian noise (DP-FedAvg client op)
            delta = [a.float() - c.float() for a, c in zip(cur, p0)]
            sq = torch.zeros(W, dtype=torch.float32, device=images.device)
            for d in delta:
                sq = sq + torch.sum(torch.square(d).reshape(W, -1), 1)
            scale = torch.clamp_max(spec.dp_clip / torch.clamp_min(torch.sqrt(sq), 1e-9), 1.0)
            sigma = spec.dp_clip * spec.dp_noise
            noise = [torch.empty_like(d) for d in delta]
            for j, r in enumerate(rows):
                for k in range(len(delta)):
                    noise[k][r] = noise_j[j][k]
            cur = [(c.float() + (d * scale.reshape((W,) + (1,) * (d.dim() - 1))
                                 + sigma * z)).to(c.dtype) for c, d, z in zip(p0, delta, noise)]
        newp = tree_unflatten(treedef, cur)
        eff_grad = tree_unflatten(treedef, [(a.float() - c.float()) / lr
                                            for a, c in zip(p0, cur)])
        return newp, eff_grad, torch.mean(torch.stack(ep_means), 0)

    return run


def make_weighted_classifier_loss(forward_fn, cfg):
    """Wraps a classifier forward into a sample-weighted loss (mask-aware)."""
    def loss_fn(params, batch):
        logits = forward_fn(cfg, params, batch["images"])
        labels = batch["labels"].long()
        w = batch.get("weights")
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
        if w is not None:
            loss = torch.sum(nll * w) / torch.clamp_min(torch.sum(w), 1.0)
        else:
            loss = torch.mean(nll)
        return loss, {}
    return loss_fn


def make_evaluator(forward_fn, cfg, test_images, test_labels, batch: int = 1000,
                   subsample: int = 0, subsample_seed: int = 0, device="cpu"):
    """Returns an accuracy evaluator params -> fp32 0-dim tensor.

    The test set is padded up to a whole number of batches and the
    padding masked out, so a set smaller than ``batch`` works and the
    tail counts: accuracy divides by the true sample count.
    ``subsample > 0`` scores a fixed subset of that many samples, drawn
    once from ``subsample_seed`` with numpy exactly as the reference
    draws it."""
    test_images = np.asarray(test_images)
    test_labels = np.asarray(test_labels)
    if 0 < subsample < len(test_labels):
        pick = np.sort(np.random.RandomState(subsample_seed).choice(
            len(test_labels), size=subsample, replace=False))
        test_images, test_labels = test_images[pick], test_labels[pick]
    n = len(test_labels)
    b = min(batch, n)
    nb = -(-n // b)                     # ceil division: tail batch included
    xi = torch.zeros((nb * b,) + test_images.shape[1:], dtype=torch.float32, device=device)
    xi[:n] = torch.from_numpy(np.ascontiguousarray(test_images, np.float32)).to(device)
    yi = torch.full((nb * b,), -1, dtype=torch.int64, device=device)
    yi[:n] = torch.from_numpy(test_labels.astype(np.int64)).to(device)
    wi = (torch.arange(nb * b, device=device) < n).float()
    # the reference's jitted ``tot / n`` is tot * fl32(1/n) (XLA rewrites a
    # division by a constant), and Eq. 1 raises to this accuracy
    inv_n = float(np.float32(1.0) / np.float32(n))

    @torch.no_grad()
    @fp32.ieee()
    def evaluate(params):
        tot = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(nb):
            logits = forward_fn(cfg, params, xi[i * b:(i + 1) * b])
            hits = (torch.argmax(logits, -1) == yi[i * b:(i + 1) * b]).float()
            tot = tot + torch.sum(hits * wi[i * b:(i + 1) * b])
        return tot * inv_n

    return evaluate
