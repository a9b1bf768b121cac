"""Carry parameter trees, and optimiser states, between the JAX
reference and this port.

Both packages keep one tree layout (dict keys, list order, HWIO
convolution weights), so the bridge is a plain per-leaf copy; an
optimiser state is a dict of such trees (``{"m", "v"}`` for Adam and
AdamW, ``{"mu"}`` or ``{}`` for SGD), carried the same way.  The
reference side is numpy: pass ``jax.tree.map(np.asarray, params)`` in,
and hand ``to_numpy_params``'s result to ``jax.numpy.asarray`` back.
Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.pytree import tree_map


def from_jax_params(tree, device="cpu"):
    """Tree of numpy arrays (the reference's parameters, or an optimiser
    state of ``repro.optim``) -> tree of tensors."""
    return tree_map(lambda x: torch.from_numpy(np.array(x, copy=True)).to(device), tree)


def to_numpy_params(tree):
    """Tree of tensors -> tree of numpy arrays in the reference's layout."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)

