"""Client-side local training.  Port of ``repro.core.client``.

Client state is a stacked tree (leading axis = client), as in the
reference; the update walks the clients in a Python loop where the
reference vmaps them.  Per-client sample masks handle quantity skew.

The "effective gradient" of a local round is (theta_start - theta_end)/lr,
the quantity whose round-over-round difference feeds Eq. 1.

Randomness comes from the run's ``torch.Generator``: one permutation of
the client's M (padded) samples per local epoch.  ``perm_fn(client,
step, epoch, M) -> LongTensor`` replaces those draws, so tests can hand
both packages the same permutations.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.common.pytree import (stacked_index, tree_flatten, tree_map,
                                       tree_sq_diff_norm, tree_sq_norm,
                                       tree_stack, tree_unflatten)


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

    over stacked clients, with data {"images": (N,M,...), "labels": (N,M),
    "mask": (N,M)} on the parameters' device, ``step`` the call's index
    (the round in the round runtime, the event in the event runtime) and
    ``clients`` the client id of each row (default 0..N-1), both passed
    on to ``perm_fn``."""
    B, lr = spec.batch_size, spec.lr
    n_ep = spec.local_epochs * spec.local_rounds

    def one_client(i, params, images, labels, mask, gen, step):
        M = images.shape[0]
        # small / non-IID shards: clamp the effective batch to the shard size
        b = min(B, M)
        nb = max(M // b, 1)
        p0 = params   # the downloaded global model (FedProx anchor / DP base)
        leaves, treedef = tree_flatten(params)
        leaves = [x.detach() for x in leaves]
        ep_means = []
        for e in range(n_ep):
            perm = (perm_fn(i, step, e, M) if perm_fn is not None else
                    torch.randperm(M, generator=gen, device=gen.device))
            perm = perm.to(images.device)[:nb * b]
            xb = images[perm].reshape(nb, b, *images.shape[1:])
            yb = labels[perm].reshape(nb, b)
            wb = mask[perm].reshape(nb, b)
            losses = []
            for s in range(nb):
                req = [x.requires_grad_(True) for x in leaves]
                p = tree_unflatten(treedef, req)
                loss, _ = loss_fn(p, {"images": xb[s], "labels": yb[s], "weights": wb[s]})
                if spec.prox_mu:
                    loss = loss + 0.5 * spec.prox_mu * tree_sq_diff_norm(p, p0)
                grads = torch.autograd.grad(loss, req)
                with torch.no_grad():
                    leaves = [(x.float() - lr * g.float()).to(x.dtype)
                              for x, g in zip(req, grads)]
                losses.append(loss.detach())
            ep_means.append(torch.mean(torch.stack(losses)))
        newp = tree_unflatten(treedef, leaves)
        if spec.dp_clip:
            # clip the round delta and add Gaussian noise (DP-FedAvg client op)
            delta = tree_map(lambda a, c: a.float() - c.float(), newp, p0)
            nrm = torch.sqrt(tree_sq_norm(delta))
            scale = torch.clamp_max(spec.dp_clip / torch.clamp_min(nrm, 1e-9), 1.0)
            sigma = spec.dp_clip * spec.dp_noise
            delta = tree_map(lambda d: d * scale + sigma * torch.randn(
                d.shape, generator=gen, device=gen.device).to(d.device), delta)
            newp = tree_map(lambda c, d: (c.float() + d).to(c.dtype), p0, delta)
        eff_grad = tree_map(lambda a, c: (a.float() - c.float()) / lr, params, newp)
        return newp, eff_grad, torch.mean(torch.stack(ep_means))

    def update(stacked_params, data, generator, step: int = 0, clients=None):
        n = data["labels"].shape[0]
        clients = range(n) if clients is None else clients
        outs = [one_client(c, stacked_index(stacked_params, i), data["images"][i],
                           data["labels"][i], data["mask"][i], generator, step)
                for i, c in enumerate(clients)]
        return (tree_stack([o[0] for o in outs]), tree_stack([o[1] for o in outs]),
                torch.stack([o[2] for o in outs]))

    return update


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
    def evaluate(params):
        tot = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(nb):
            logits = forward_fn(cfg, params, xi[i * b:(i + 1) * b])
            hits = (torch.argmax(logits, -1) == yi[i * b:(i + 1) * b]).float()
            tot = tot + torch.sum(hits * wi[i * b:(i + 1) * b])
        return tot * inv_n

    return evaluate
