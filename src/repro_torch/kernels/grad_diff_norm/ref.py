"""Plain PyTorch version of the grad_diff_norm kernel: the path taken on
CPU tensors, and what ``chip_smoke.py`` holds the kernel against on the
card."""
from __future__ import annotations

import torch


def grad_diff_sq_norm_2d(a, b):
    """(W, P) pair -> (W,) fp32 row sums of (a - b)^2."""
    d = a.float() - b.float()
    return torch.sum(d * d, dim=1)
