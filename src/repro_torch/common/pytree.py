"""Parameter-tree utilities: the port of ``repro.common.pytree``.

A tree is nested dicts (keys visited in sorted order), lists and tuples
(visited in order) with tensors at the leaves; ``None`` and empty
containers are subtrees without leaves.  That is ``jax.tree.flatten``'s
order, and it matters beyond tidiness: the top-k codec hashes the flat
index of every parameter (``kernels/topk_quant``), so any other leaf
order would change its payloads.
"""
from __future__ import annotations

import torch

_LEAF = "*"


def tree_flatten(tree):
    """Leaves in ``jax.tree.flatten`` order, plus the structure that
    ``tree_unflatten`` rebuilds the tree from."""
    leaves = []
    return leaves, _walk(tree, leaves)


def _walk(t, leaves):
    # a module-level function, not a closure that names itself: such a
    # closure is a reference cycle holding ``leaves``, so every flattened
    # tree stayed alive until the cyclic collector ran (a full-width
    # model's parameters among them)
    if t is None:
        return None
    if isinstance(t, dict):
        return (dict, tuple((k, _walk(t[k], leaves)) for k in sorted(t)))
    if isinstance(t, (list, tuple)):
        return (type(t), tuple(_walk(x, leaves) for x in t))
    leaves.append(t)
    return _LEAF


def tree_unflatten(treedef, leaves):
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def _build(d, it):
    if d is None:
        return None
    if d == _LEAF:
        return next(it)
    kind, items = d
    if kind is dict:
        return {k: _build(v, it) for k, v in items}
    return kind(_build(v, it) for v in items)


def tree_leaves(tree):
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over corresponding leaves of same-structure trees."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def _fp32_sum(terms, device):
    """((0 + t0) + t1) + ..., the order of ``jax.tree.reduce(add, ...)``."""
    total = torch.zeros((), dtype=torch.float32, device=device)
    for t in terms:
        total = total + t
    return total


def _device(tree):
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else None


def tree_sq_norm(a):
    """Squared L2 norm of all leaves (fp32 accumulation)."""
    return _fp32_sum((torch.sum(torch.square(x.float())) for x in tree_leaves(a)),
                     _device(a))


def global_norm(a):
    """L2 norm of all leaves: the square root of ``tree_sq_norm``'s fp32 sum."""
    return torch.sqrt(tree_sq_norm(a))


def tree_sq_diff_norm(a, b):
    """||a - b||^2, one leaf at a time (fp32 accumulation)."""
    return _fp32_sum((torch.sum(torch.square(x.float() - y.float()))
                      for x, y in zip(tree_leaves(a), tree_leaves(b))), _device(a))


def count_params(tree) -> int:
    return int(sum(x.numel() for x in tree_leaves(tree)))


def tree_bytes(tree) -> int:
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(tree)))


def stacked_index(stacked, i):
    """Row ``i`` of a stacked tree (leading axis = client)."""
    return tree_map(lambda x: x[i], stacked)


def tree_stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_broadcast(tree, n: int):
    """``n`` copies of a tree as a stacked tree (views, no copy)."""
    return tree_map(lambda x: x.unsqueeze(0).expand((n,) + tuple(x.shape)), tree)


def _rows(idx, device):
    return torch.as_tensor(idx, dtype=torch.long, device=device)


def tree_gather(stacked, idx):
    """Rows ``idx`` of a stacked tree, as a (W, ...) stacked tree.
    ``idx`` is a sequence of ints or an integer tensor."""
    return tree_map(lambda x: x[_rows(idx, x.device)], stacked)


def tree_scatter_(stacked, idx, rows):
    """Write the (W, ...) stacked ``rows`` into rows ``idx`` of
    ``stacked`` in place (``index_copy_``, one call per leaf); returns
    ``stacked``."""
    for s, u in zip(tree_leaves(stacked), tree_leaves(rows)):
        s.index_copy_(0, _rows(idx, s.device), u.to(s.dtype))
    return stacked


def tree_scatter(stacked, idx, rows):
    """Write the (W, ...) stacked ``rows`` into rows ``idx`` of
    ``stacked``, out of place.  ``idx`` is a sequence of ints or an
    integer tensor."""
    def put(s, u):
        s = s.clone()
        s[_rows(idx, s.device)] = u.to(s.dtype)
        return s
    return tree_map(put, stacked, rows)
