"""Functional optimizers on parameter trees of tensors.  Port of
``repro.optim.optimizers``.

Each optimizer is a factory returning ``(init_fn, update_fn)``:
    state = init_fn(params)
    updates, state = update_fn(grads, state, params, step)
    params = apply_updates(params, updates)
Learning rates may be floats or schedule callables ``step -> lr``
(``repro_torch.optim.schedules``).  ``step`` is a Python int (or a 0-dim
integer tensor).  Every update is elementwise fp32 in the reference's
order of operations, with its scalars (the learning rate, the bias
corrections) as fp32 values on the parameters' device; Adam's ``b ** t``
is the C library's ``powf``, the function the reference's CPU compile
calls, and its square root is correctly rounded on the CPU as well
(``common/fp32.py``).  Nothing is updated in place: each call
returns new trees.
"""
from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

from repro_torch.common import fp32
from repro_torch.common.pytree import global_norm, tree_leaves, tree_map

Schedule = Union[float, Callable]


def _scalar(x, device) -> torch.Tensor:
    """An fp32 value as a 0-dim tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.float32(x), device=device)


def _device(tree):
    return tree_leaves(tree)[0].device


def _lr_at(lr: Schedule, step):
    return lr(step) if callable(lr) else np.float32(lr)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to global norm at most ``max_norm``, the norm before)."""
    g = global_norm(grads)
    scale = torch.clamp_max(_scalar(max_norm, g.device) / torch.clamp_min(g, 1e-9), 1.0)
    return tree_map(lambda x: x * scale, grads), g


def sgd(lr: Schedule, momentum: float = 0.0, nesterov: bool = False):
    def init(params):
        if momentum == 0.0:
            return {}
        return {"mu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    def update(grads, state, params, step):
        dev = _device(grads)
        lr_t = _scalar(_lr_at(lr, int(step)), dev)
        if momentum == 0.0:
            return tree_map(lambda g: -lr_t * g.float(), grads), state
        mom = _scalar(momentum, dev)
        mu = tree_map(lambda m, g: mom * m + g.float(), state["mu"], grads)
        if nesterov:
            upd = tree_map(lambda m, g: -(lr_t * (mom * m + g.float())), mu, grads)
        else:
            upd = tree_map(lambda m: -lr_t * m, mu)
        return upd, {"mu": mu}

    return init, update


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    return adamw(lr, b1=b1, b2=b2, eps=eps, weight_decay=0.0)


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0):
    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params, step):
        dev = _device(grads)
        step = int(step)
        lr_np = np.float32(_lr_at(lr, step))
        t = np.float32(step) + np.float32(1.0)
        s = lambda x: _scalar(x, dev)
        c1, c2 = s(np.float32(1) - fp32.powf(b1, t)), s(np.float32(1) - fp32.powf(b2, t))
        b1_, b2_, nb1, nb2 = s(b1), s(b2), s(1 - b1), s(1 - b2)
        lr_t, neg_lr, eps_ = s(lr_np), s(-lr_np), s(eps)
        m = tree_map(lambda m_, g: b1_ * m_ + nb1 * g.float(), state["m"], grads)
        v = tree_map(lambda v_, g: b2_ * v_ + nb2 * torch.square(g.float()), state["v"], grads)
        upd = tree_map(lambda m_, v_: neg_lr * (m_ / c1) / (fp32.sqrt(v_ / c2) + eps_), m, v)
        if weight_decay:
            lr_wd = s(lr_np * np.float32(weight_decay))
            upd = tree_map(lambda u, p: u - lr_wd * p.float(), upd, params)
        return upd, {"m": m, "v": v}

    return init, update
