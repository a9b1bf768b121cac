"""Parameter factory: builds parameter trees from an explicit
``torch.Generator``.  Port of ``repro.models.factory`` with all six of
its initializers; its abstract (sharding-spec) mode waits (ROADMAP.md
§1 item 11).

The draws come from torch's generator, so a tree made here from a seed
differs from the reference's tree for the same seed; tests that compare
the two packages carry the reference's parameters across with
``repro_torch.weights.from_jax_params``.
"""
from __future__ import annotations

from typing import Optional

import torch


class ParamFactory:
    """Deterministic parameter creator on the generator's device."""

    def __init__(self, generator: torch.Generator, dtype=torch.float32):
        self.generator = generator
        self.dtype = dtype

    def _normal(self, shape):
        return torch.randn(shape, generator=self.generator,
                           device=self.generator.device, dtype=torch.float32)

    def param(self, shape, axes, init: str = "fan_in", scale: Optional[float] = None,
              dtype=None):
        """``axes`` names one logical axis per dimension, as in the
        reference; it is checked and otherwise unused here."""
        shape = tuple(int(s) for s in shape)
        if len(tuple(axes)) != len(shape):
            raise ValueError(f"axes {axes} vs shape {shape}")
        dtype = dtype or self.dtype
        dev = self.generator.device
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=dev)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=dev)
        if init == "normal":
            std = scale if scale is not None else 0.02
            return (self._normal(shape) * std).to(dtype)
        if init == "fan_in":
            fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
            std = (scale if scale is not None else 1.0) / (fan_in ** 0.5)
            return (self._normal(shape) * std).to(dtype)
        if init == "uniform":
            lim = scale if scale is not None else 1.0 / (shape[0] ** 0.5)
            u = torch.rand(shape, generator=self.generator, device=dev, dtype=torch.float32)
            return ((2.0 * u - 1.0) * lim).to(dtype)
        if init == "constant":
            return torch.full(shape, scale, dtype=dtype, device=dev)
        raise ValueError(f"unknown init {init}")
