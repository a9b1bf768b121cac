"""Checkpointing: npz-based tree save/restore with step metadata, plus
full-run state checkpoints.  Port of ``repro.checkpoint.store``.

Trees are flattened to path-keyed arrays ("groups/0/attn/wq" style, the
reference's keys) so checkpoints are stable across library versions and
partially loadable.

Run-state checkpoints (``save_run_state`` / ``load_run_state``,
docs/RESILIENCE.md) are different: ONE atomic file bundling everything
a runtime needs to continue bit-identically: model, per-client state,
policy/aggregator buffers, CommStats, obs counters, the run's
``torch.Generator`` state and the scheduler snapshot.  The bundle
pickles (state entries include None, ragged per-client lists and nested
dicts) with every tensor leaf as numpy on the host (``tree_to_host``);
a config fingerprint is stored alongside and validated on load, so a
checkpoint from a different run shape fails loudly
(:class:`CheckpointMismatchError`) instead of resuming garbage.  Writes
go to a temp file in the same directory, are fsynced, then
``os.replace``d: a crash mid-write never corrupts the previous
checkpoint.

The port's bundles carry their own schema (``RUN_CKPT_SCHEMA``): their
generator state is a ``torch.Generator``'s, where the reference's is a
``jax.random`` key, so neither package resumes the other's checkpoint.
Loading refuses any pickled class of the JAX reference before it is
imported.
"""
from __future__ import annotations

import functools
import json
import os
import pickle
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.common.pytree import tree_flatten, tree_map, tree_unflatten

RUN_CKPT_SCHEMA = "fl-run-ckpt-torch/v1"


class CheckpointMismatchError(ValueError):
    """The checkpoint on disk was written by a different run shape
    (schema, config or model spec) — resuming it would be garbage."""


# ------------------------------------------------------- host leaves ---

class HostLeaf:
    """A host copy of a tensor whose dtype numpy has no name for
    (bfloat16, the float8 types): its raw bits as an unsigned integer
    array of the same width, and the torch dtype's name."""

    def __init__(self, bits: np.ndarray, dtype: str):
        self.bits = bits
        self.dtype = dtype


_INT_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@functools.lru_cache(maxsize=None)
def _numpy_has(dtype: torch.dtype) -> bool:
    try:
        torch.empty((), dtype=dtype).numpy()
    except TypeError:
        return False
    return True


def _dtype_name(dtype) -> str:
    """numpy's name for a dtype ("float32", "bfloat16"), the reference's
    spelling, for torch and numpy dtypes alike."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


def _to_host(x):
    """One leaf as a host array that shares no memory with ``x``: on the
    CPU ``Tensor.numpy()`` aliases the tensor, and the runtimes write
    their client stacks in place."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if not _numpy_has(x.dtype):      # keep the bits, unsigned
            bits = x.to("cpu", copy=True).contiguous().view(_INT_OF_WIDTH[x.element_size()])
            return HostLeaf(bits.numpy().view(f"u{x.element_size()}"), _dtype_name(x.dtype))
        return x.to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


def _to_device(x, device):
    if isinstance(x, HostLeaf):
        bits = np.array(x.bits, copy=True).view(f"i{x.bits.itemsize}")
        return torch.from_numpy(bits).view(getattr(torch, x.dtype)).to(device)
    return torch.from_numpy(np.array(x, copy=True)).to(device)


# ---------------------------------------------------------- npz trees ---

def _flatten_with_path(tree):
    """(path key, leaf) pairs in leaf order; a path is the dict keys and
    sequence indices from the root, joined by "/"."""
    out = []

    def walk(t, path):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (str(k),))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (str(i),))
        else:
            out.append(("/".join(path), t))

    walk(tree, ())
    return out


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _to_host(leaf) for key, leaf in _flatten_with_path(tree)}


def save_pytree(path: str, tree, metadata: Optional[Dict[str, Any]] = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: v.bits if isinstance(v, HostLeaf) else v for k, v in _flatten(tree).items()}
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)
    if metadata is not None:
        with open(re.sub(r"\.npz$", "", path) + ".meta.json", "w") as f:
            json.dump(metadata, f, indent=1, default=str)


def load_pytree(path: str, like):
    """Restore into the structure of ``like`` (shapes, dtypes and devices
    of its tensor leaves preserved)."""
    if not path.endswith(".npz"):
        path += ".npz"
    data = np.load(path)
    leaves, treedef = tree_flatten(like)
    out = []
    for (key, _), leaf in zip(_flatten_with_path(like), leaves):
        arr = data[key]
        assert arr.shape == tuple(leaf.shape), (key, arr.shape, leaf.shape)
        if isinstance(leaf, torch.Tensor):
            if _numpy_has(leaf.dtype):
                t = torch.from_numpy(np.array(arr, copy=True)).to(leaf.dtype)
            else:                               # the saved bits
                t = _to_device(HostLeaf(arr, _dtype_name(leaf.dtype)), "cpu")
            out.append(t.to(leaf.device))
        else:
            out.append(arr.astype(leaf.dtype) if hasattr(leaf, "dtype") else arr)
    return tree_unflatten(treedef, out)


def load_state_dict(path: str) -> Dict[str, Any]:
    """Load an npz checkpoint back into the nested dict it was flattened
    from (keys split on "/"), for states with no ``like`` template, e.g.
    a scheduler snapshot whose heap length may differ from a freshly
    built scheduler's."""
    if not path.endswith(".npz"):
        path += ".npz"
    data = np.load(path)
    out: Dict[str, Any] = {}
    for key in data.files:
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]
    return out


def save_scheduler(path: str, sched, metadata: Optional[Dict[str, Any]] = None):
    """Persist an ``EventScheduler.snapshot()`` (heap, clocks, per-client
    accounting, model RNG counters)."""
    save_pytree(path, sched.snapshot(), metadata)


def restore_scheduler(path: str, sched):
    """Restore a saved scheduler snapshot into ``sched`` (built with the
    same num_clients and scenario models) and return it."""
    return sched.restore(load_state_dict(path))


def save(ckpt_dir: str, step: int, tree, metadata=None):
    md = {"step": step}
    md.update(metadata or {})
    save_pytree(os.path.join(ckpt_dir, f"step_{step:08d}"), tree, md)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)\.npz", f))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, like, step: Optional[int] = None):
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    return load_pytree(os.path.join(ckpt_dir, f"step_{step:08d}"), like), step


# ------------------------------------------------ run-state checkpoints ---

def tree_to_host(tree):
    """Tensor leaves to host copies (numpy, or ``HostLeaf`` bits for a
    dtype numpy lacks): picklable, version-stable, and never aliasing
    the live tensors.  None passes through."""
    if tree is None:
        return None
    return tree_map(_to_host, tree)


def tree_to_device(tree, device):
    """A ``tree_to_host`` tree back onto ``device`` as fresh tensors,
    bit-equal to the saved ones.  None passes through."""
    if tree is None:
        return None
    return tree_map(lambda x: _to_device(x, device), tree)


def generator_state(gen: torch.Generator) -> np.ndarray:
    """The run generator's state as uint8 numpy (on ``cuda`` its seed
    and Philox offset)."""
    return gen.get_state().numpy().copy()


def set_generator_state(gen: torch.Generator, state) -> None:
    gen.set_state(torch.from_numpy(np.asarray(state, np.uint8).copy()))


def model_spec(params) -> list:
    """The model's shape signature: (path, shape, dtype) per leaf, with
    the reference's keys and numpy's dtype names; part of the run
    fingerprint so a checkpoint can't restore into a differently-shaped
    model."""
    return [(key, tuple(leaf.shape), _dtype_name(leaf.dtype))
            for key, leaf in sorted(_flatten_with_path(params), key=lambda kv: kv[0])]


def run_fingerprint(run_cfg, runtime: str, params) -> dict:
    """Everything that must match between the writing and the resuming
    run for bit-equal continuation.  ``rounds`` is deliberately ABSENT —
    extending a run past its original budget is a supported resume."""
    return {
        "schema": RUN_CKPT_SCHEMA,
        "runtime": runtime,
        "algorithm": run_cfg.algorithm,
        "num_clients": run_cfg.num_clients,
        "seed": run_cfg.seed,
        "compressor": run_cfg.compressor,
        "broadcast_compressor": run_cfg.broadcast_compressor,
        "error_feedback": run_cfg.error_feedback,
        "participation": run_cfg.participation,
        "mix_rate": run_cfg.mix_rate,
        "staleness_kind": run_cfg.staleness_kind,
        "events_per_eval": run_cfg.events_per_eval,
        "buffer_size": run_cfg.buffer_size,
        "max_batch": run_cfg.max_batch,
        "eval_cache": run_cfg.eval_cache,
        "eval_subsample": run_cfg.eval_subsample,
        "local": (run_cfg.local.batch_size, run_cfg.local.local_rounds,
                  run_cfg.local.lr),
        "model": model_spec(params),
    }


def save_run_state(path: str, state: dict, fingerprint: dict) -> str:
    """Atomically persist one run-state bundle: pickle to a temp file in
    the target's directory, fsync, then ``os.replace`` — a kill at any
    byte leaves either the old checkpoint or the new one, never a torn
    file.  Returns the path written."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    bundle = {"schema": RUN_CKPT_SCHEMA, "fingerprint": fingerprint,
              "state": state}
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(bundle, f, protocol=pickle.HIGHEST_PROTOCOL)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


class _Unpickler(pickle.Unpickler):
    """Refuses the JAX reference's classes (its bundles hold its
    ``RoundRecord``s) before their modules are imported: on a host
    without JAX the import itself would fail."""

    def __init__(self, f, path):
        super().__init__(f)
        self.path = path

    def find_class(self, module, name):
        if module.split(".")[0] in ("repro", "jax", "jaxlib"):
            raise CheckpointMismatchError(
                f"{self.path} is not a {RUN_CKPT_SCHEMA} checkpoint (it pickles "
                f"{module}.{name}, a class of the JAX reference)")
        return super().find_class(module, name)


def load_run_state(path: str, fingerprint: dict) -> dict:
    """Load a run-state bundle, validating schema and fingerprint.  A
    mismatch raises :class:`CheckpointMismatchError` naming every
    differing field — a checkpoint from a different config/model shape
    fails loudly instead of resuming garbage."""
    with open(path, "rb") as f:
        bundle = _Unpickler(f, path).load()
    if not isinstance(bundle, dict) or bundle.get("schema") != RUN_CKPT_SCHEMA:
        raise CheckpointMismatchError(
            f"{path} is not a {RUN_CKPT_SCHEMA} checkpoint "
            f"(schema={bundle.get('schema') if isinstance(bundle, dict) else None!r})")
    saved = bundle["fingerprint"]
    diffs = []
    for key in sorted(set(saved) | set(fingerprint)):
        a, b = saved.get(key), fingerprint.get(key)
        if a != b:
            diffs.append(f"  {key}: checkpoint={a!r} vs run={b!r}")
    if diffs:
        raise CheckpointMismatchError(
            f"checkpoint {path} was written by a different run — "
            "refusing to resume:\n" + "\n".join(diffs))
    return bundle["state"]
