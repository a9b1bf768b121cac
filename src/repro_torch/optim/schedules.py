"""Learning-rate schedules, including WSD (warmup-stable-decay) from
MiniCPM [arXiv:2404.06395], the minicpm_2b training recipe.  Port of
``repro.optim.schedules``.

A schedule maps a step (a Python int) to the fp32 learning rate, a numpy
float32 computed on the host in the reference's order of fp32
operations; WSD's ``floor_ratio ** in_decay`` is the C library's
``powf``, which the reference's CPU compile calls (``common/fp32.py``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.common import fp32

f32 = np.float32


def constant(lr: float):
    return lambda step: f32(lr)


def cosine(peak: float, warmup: int, total: int, floor: float = 0.0):
    def sched(step):
        s = f32(step)
        warm = f32(peak) * s / f32(max(warmup, 1))
        prog = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)), f32(0), f32(1))
        cos = f32(floor) + f32(0.5 * (peak - floor)) * (f32(1) + np.cos(f32(np.pi) * prog))
        return f32(warm if s < warmup else cos)
    return sched


def wsd(peak: float, warmup: int, stable: int, decay: int, floor_ratio: float = 0.1):
    """Warmup-Stable-Decay: linear warmup -> flat peak -> exponential-ish
    decay to floor_ratio*peak over `decay` steps (MiniCPM's schedule)."""
    floor = peak * floor_ratio

    def sched(step):
        s = f32(step)
        warm = f32(peak) * s / f32(max(warmup, 1))
        in_decay = np.clip((s - f32(warmup) - f32(stable)) / f32(max(decay, 1)), f32(0), f32(1))
        dec = f32(peak) * fp32.powf(floor_ratio, in_decay)[()]
        out = warm if s < warmup else (f32(peak) if s < warmup + stable else dec)
        return f32(max(out, f32(floor) if s >= warmup + stable + decay else f32(0)))
    return sched
