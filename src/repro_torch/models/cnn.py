"""Small residual CNN / MLP image classifiers, the paper's client models.
Port of ``repro.models.cnn``.

Parameters keep the reference's tree and layouts: convolution weights
are HWIO and images NHWC at the public functions, so a reference tree
carries over by plain copy (``repro_torch.weights``).  Inside the
forward the activations run in NCHW for ``F.conv2d``.

On CUDA the convolutions run in full fp32, as the reference's do:
cuDNN's default for fp32 is TF32 (a 10-bit mantissa), which moved a
small federation's final weights by up to 2.4e-3 on an H100.  The
setting is scoped to the port's own convolutions, forward and backward
(``_FP32Conv2d``), so a caller's process-wide cuDNN flags are left as
they are.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.factory import ParamFactory


@dataclass(frozen=True)
class CNNConfig:
    name: str = "vafl_cnn"
    image_size: int = 28
    channels: Tuple[int, ...] = (16, 32)
    num_blocks: int = 2
    num_classes: int = 10
    param_dtype: str = "float32"
    arch_type: str = "cnn"
    source: str = "VAFL paper Fig.2 (ResNet on MNIST, reproduced at matching scale)"


@dataclass(frozen=True)
class MLPConfig:
    name: str = "vafl_mlp"
    image_size: int = 28
    hidden: Tuple[int, ...] = (128, 64)
    num_classes: int = 10
    param_dtype: str = "float32"
    arch_type: str = "mlp"
    source: str = "fast-test stand-in for the paper's client model"


def _dtype(name: str):
    return getattr(torch, name)


# ------------------------------------------------------------------ CNN ---

def _conv_init(fac, cin, cout, k=3):
    return {"w": fac.param((k, k, cin, cout), (None, None, None, None), init="normal",
                           scale=(2.0 / (k * k * cin)) ** 0.5),
            "b": fac.param((cout,), (None,), init="zeros")}


def _same_pad(size: int, k: int, stride: int):
    """XLA's "SAME" padding of one spatial dim: (before, after).  Odd
    totals put the extra row after, so a 3x3 stride-2 conv on 28x28 pads
    (0, 1), which torch's symmetric ``padding=`` cannot express."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


@contextmanager
def _cudnn_fp32():
    """cuDNN in full fp32 and deterministic for the block's duration: no
    TF32, no benchmarked or nondeterministic algorithms (with them, two
    card runs of Algorithm 1 from one seed ended at different weights
    and upload bytes).  Its ``enabled`` flag is kept, and the process-wide
    flags are restored on exit."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=True,
                     allow_tf32=False):
        yield


class _FP32Conv2d(torch.autograd.Function):
    """``F.conv2d(x, w, b, stride=stride)`` whose forward and backward both
    run inside ``_cudnn_fp32``: autograd runs the backward after the
    forward's scope has closed, so a context around the forward alone
    would leave the gradients in TF32.  The backward's ``torch.nn.grad``
    calls take the forward's own keyword arguments."""

    @staticmethod
    def forward(ctx, x, w, b, stride):
        ctx.save_for_backward(x, w)
        ctx.conv = {"stride": stride}
        with _cudnn_fp32():
            return F.conv2d(x, w, b, **ctx.conv)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        with _cudnn_fp32():
            gx = torch.nn.grad.conv2d_input(x.shape, w, gy, **ctx.conv) if need_x else None
            gw = torch.nn.grad.conv2d_weight(x, w.shape, gy, **ctx.conv) if need_w else None
        return gx, gw, gy.sum((0, 2, 3)) if need_b else None, None


def _conv(p, x, stride=1):
    """x NCHW, p["w"] HWIO -> NCHW."""
    k = p["w"].shape[0]
    ph = _same_pad(x.shape[2], k, stride)
    pw = _same_pad(x.shape[3], k, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    w = p["w"].permute(3, 2, 0, 1)
    if x.is_cuda:
        return _FP32Conv2d.apply(x, w, p["b"], stride)
    return F.conv2d(x, w, p["b"], stride=stride)


def cnn_init(cfg: CNNConfig, generator: torch.Generator):
    fac = ParamFactory(generator, dtype=_dtype(cfg.param_dtype))
    c0 = cfg.channels[0]
    params = {"stem": _conv_init(fac, 1, c0), "blocks": [], "proj": []}
    cin = c0
    for ci in cfg.channels:
        for _ in range(cfg.num_blocks):
            params["blocks"].append({
                "c1": _conv_init(fac, cin, ci), "c2": _conv_init(fac, ci, ci),
                "proj": _conv_init(fac, cin, ci, k=1) if cin != ci else None,
            })
            cin = ci
    params["head"] = {"w": fac.param((cin, cfg.num_classes), (None, None)),
                      "b": fac.param((cfg.num_classes,), (None,), init="zeros")}
    return params


def cnn_forward(cfg: CNNConfig, params, images):
    """images (B, H, W) or (B, H, W, 1) NHWC -> logits (B, classes)."""
    x = images if images.dim() == 4 else images[..., None]
    # a real NCHW copy: the permuted view of a one-channel NHWC batch has
    # channels-last strides, which then run through every conv (and on
    # the CPU, torch 2.13's conv backward crashed on them with 3 threads)
    x = x.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)
    x = F.relu(_conv(params["stem"], x))
    for bp in params["blocks"]:
        stride = 2 if bp["proj"] is not None else 1  # downsample on stage change
        h = F.relu(_conv(bp["c1"], x, stride))
        h = _conv(bp["c2"], h)
        sc = x if bp["proj"] is None else _conv(bp["proj"], x, stride)
        x = F.relu(h + sc)
    x = torch.mean(x, dim=(2, 3))
    return x @ params["head"]["w"] + params["head"]["b"]


# ------------------------------------------------------------------ MLP ---

def mlp_init(cfg: MLPConfig, generator: torch.Generator):
    fac = ParamFactory(generator, dtype=_dtype(cfg.param_dtype))
    dims = (cfg.image_size * cfg.image_size,) + tuple(cfg.hidden) + (cfg.num_classes,)
    return {"layers": [{"w": fac.param((a, b), (None, None)),
                        "b": fac.param((b,), (None,), init="zeros")}
                       for a, b in zip(dims[:-1], dims[1:])]}


def mlp_forward(cfg: MLPConfig, params, images):
    x = images.reshape(images.shape[0], -1)
    for i, lp in enumerate(params["layers"]):
        x = x @ lp["w"] + lp["b"]
        if i < len(params["layers"]) - 1:
            x = F.relu(x)
    return x


# ---------------------------------------------------------- shared loss ---

def classifier_loss(forward_fn, cfg, params, batch):
    """batch {"images": (B,H,W), "labels": (B,)} -> (loss, metrics)."""
    logits = forward_fn(cfg, params, batch["images"])
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return torch.mean(nll), {"acc": acc}
