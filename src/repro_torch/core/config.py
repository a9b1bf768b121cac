"""FL run configuration.  Port of ``repro.core.config``: the same field
names, defaults and validation.

A field whose subsystem this port does not have yet raises
``NotImplementedError`` when set, rather than being ignored: client
sharding (ROADMAP.md, queue 1 item 10).

* ``engine`` selects the event runtime's engine: "sequential" (one
  client per event) or "batched" (windows of ``max_batch`` clients as
  one batched update, a FedBuff buffer of ``buffer_size`` uploads,
  ``eval_cache``).
* ``scenario`` resolves through ``repro_torch.sim``.
* ``checkpoint_path`` names ONE run-state file
  (``repro_torch.checkpoint``) written atomically every
  ``checkpoint_every`` events (sequential loop, batched engine) or
  rounds (round runtime, barrier); ``resume=True`` continues from it,
  bit for bit, when it exists.
* ``obs`` (None, True, a ``repro_torch.obs.ObsConfig`` or a dict of its
  fields) turns on tracing, metrics and exporters without changing a
  number.
* ``value_backend`` here is a *stacked* function, ``(stacked_a,
  stacked_b) -> (W,)``; None selects the grad_diff_norm kernel's
  wrapper.

The device is not a field: the entry points take ``device=`` (default
``"cuda"``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.algorithms.registry import get_algorithm
from repro_torch.core.client import LocalSpec

ENGINES = ("sequential", "batched")

# field -> (value meaning "off", ROADMAP.md queue 1 item that ports it);
# any other value is a subsystem not ported yet
_NOT_PORTED = {"shard_clients": (False, 10)}


@dataclass
class FLRunConfig:
    algorithm: str = "vafl"
    num_clients: int = 7
    rounds: int = 200                  # R (server rounds / event budget)
    local: LocalSpec = field(default_factory=LocalSpec)
    target_acc: float = 0.94
    eval_every: int = 1
    seed: int = 0
    # EAFLM constants (paper: xi_d = 1/D, D = 1, alpha = 0.98); beta has
    # m folded in (m = 1), calibrated in the reference.
    eaflm_alpha: float = 0.98
    eaflm_beta: float = 1e-2
    # update compression: codec spec for accepted uploads and an optional
    # codec for the model broadcast (no error feedback there)
    compressor: str = "identity"
    broadcast_compressor: Optional[str] = None
    error_feedback: bool = True        # SGD-EF residuals on the upload path
    # partial participation: fraction of clients in the round's set S
    participation: float = 1.0
    # log per-client test accuracy in every RoundRecord (one eval of
    # every client per round, even for algorithms that never read it)
    record_client_accs: bool = True
    # event-driven runtime
    mix_rate: float = 0.5              # rho
    staleness_kind: str = "poly"       # 'poly' | 'const' | 'hinge'
    events_per_eval: int = 7
    value_backend: Optional[Callable] = None  # stacked ||dg||^2 per client
    engine: str = "sequential"
    max_batch: int = 0
    buffer_size: int = 1
    shard_clients: bool = False
    eval_subsample: int = 0
    eval_cache: int = 0
    scenario: Optional[object] = None
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0
    resume: bool = False
    obs: Optional[object] = None

    def __post_init__(self):
        get_algorithm(self.algorithm)  # raises ValueError listing names
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine: {self.engine!r}; known engines: "
                             f"{', '.join(ENGINES)}")
        for name, (off, item) in _NOT_PORTED.items():
            if getattr(self, name) != off:
                raise NotImplementedError(
                    f"FLRunConfig.{name}={getattr(self, name)!r} is not ported to "
                    f"repro_torch yet (ROADMAP.md, queue 1 item {item})")
        if self.scenario is not None:
            # lazy import: repro_torch.sim is only pulled in when a
            # scenario is configured
            from repro_torch.sim import resolve_scenario
            self.scenario = resolve_scenario(self.scenario)
        if self.obs is not None:
            # lazy import, mirroring scenario=
            from repro_torch.obs import resolve_obs
            self.obs = resolve_obs(self.obs)
        if self.eval_subsample < 0 or self.eval_cache < 0:
            raise ValueError("eval_subsample and eval_cache must be >= 0 "
                             f"(got {self.eval_subsample}, {self.eval_cache})")
        if self.checkpoint_every < 0:
            raise ValueError(f"checkpoint_every must be >= 0 (got {self.checkpoint_every})")
        if self.checkpoint_every > 0 and not self.checkpoint_path:
            raise ValueError("checkpoint_every > 0 needs a checkpoint_path")
        if self.resume and not self.checkpoint_path:
            raise ValueError("resume=True needs a checkpoint_path")

    def make_algorithm(self):
        """``(Algorithm spec, UploadPolicy, Aggregator)`` for one run."""
        alg = get_algorithm(self.algorithm)
        return alg, alg.make_policy(self), alg.make_aggregator(self)


def resolve_device(device) -> torch.device:
    """The run's device.  ``"cuda"`` (the entry points' default) needs a
    visible card; there is no silent fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is visible; repro_torch runs on "
            "the GPU by default; pass device='cpu' to run its plain PyTorch path")
    return dev
