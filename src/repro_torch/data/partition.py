"""Federated dataset partitioning: IID and non-IID splits.

Reproduces the paper's §IV-C data construction (Fig. 3):
  * IID — the training set split equally; every client holds all 10 labels.
  * Non-IID (paper style) — label- and quantity-skew: some clients hold
    all labels with many samples, others only a few labels with few
    samples.
  * Dirichlet(alpha) — the standard benchmark skew, as a generalisation.

Partitions are materialised as fixed-size padded buffers (per-client
sample mask) so client local training vmaps across clients.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FederatedData:
    images: np.ndarray       # (N_clients, max_samples, ...)
    labels: np.ndarray       # (N_clients, max_samples)
    mask: np.ndarray         # (N_clients, max_samples) 1 = real sample
    counts: np.ndarray       # (N_clients,)


def _pack(per_client_idx, x, y) -> FederatedData:
    n = len(per_client_idx)
    counts = np.array([len(ix) for ix in per_client_idx], np.int32)
    mx = int(counts.max())
    imgs = np.zeros((n, mx) + x.shape[1:], x.dtype)
    labs = np.zeros((n, mx), np.int32)
    mask = np.zeros((n, mx), np.float32)
    for i, ix in enumerate(per_client_idx):
        imgs[i, :len(ix)] = x[ix]
        labs[i, :len(ix)] = y[ix]
        mask[i, :len(ix)] = 1.0
    return FederatedData(imgs, labs, mask, counts)


def iid_partition(x, y, num_clients: int, samples_per_client: int = None,
                  seed: int = 0) -> FederatedData:
    """Paper IID: equal split, each client sees all labels."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(x))
    spc = samples_per_client or len(x) // num_clients
    idx = [order[i * spc:(i + 1) * spc] for i in range(num_clients)]
    return _pack(idx, x, y)


def paper_noniid_partition(x, y, num_clients: int, samples_per_client: int = None,
                           seed: int = 0) -> FederatedData:
    """Paper non-IID (Fig. 3): half the clients hold all labels with full
    quota; the rest hold a random 2-4 label subset with 30-70% quota."""
    rng = np.random.RandomState(seed)
    spc = samples_per_client or len(x) // num_clients
    by_label = {c: list(rng.permutation(np.where(y == c)[0])) for c in range(10)}
    ptr = {c: 0 for c in range(10)}

    def take(c, k):
        got = by_label[c][ptr[c]:ptr[c] + k]
        ptr[c] += len(got)
        return got

    idx = []
    for i in range(num_clients):
        rich = i < (num_clients + 1) // 2
        if rich:
            labels = list(range(10))
            quota = spc
        else:
            labels = list(rng.choice(10, size=rng.randint(2, 5), replace=False))
            quota = int(spc * rng.uniform(0.3, 0.7))
        per = quota // len(labels)
        mine = []
        for c in labels:
            mine += take(c, per)
        idx.append(np.array(mine, np.int64))
    return _pack(idx, x, y)


def dirichlet_partition(x, y, num_clients: int, alpha: float = 0.5,
                        seed: int = 0) -> FederatedData:
    rng = np.random.RandomState(seed)
    idx = [[] for _ in range(num_clients)]
    for c in np.unique(y):
        ix = rng.permutation(np.where(y == c)[0])
        p = rng.dirichlet([alpha] * num_clients)
        splits = (np.cumsum(p) * len(ix)).astype(int)[:-1]
        for i, part in enumerate(np.split(ix, splits)):
            idx[i] += part.tolist()
    return _pack([np.array(ix, np.int64) for ix in idx], x, y)
