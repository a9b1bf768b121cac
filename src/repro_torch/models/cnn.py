"""Small residual CNN / MLP image classifiers, the paper's client models.
Port of ``repro.models.cnn``.

Parameters keep the reference's tree and layouts: convolution weights
are HWIO and images NHWC at the public functions, so a reference tree
carries over by plain copy (``repro_torch.weights``).

Activations run NCHW.  On CPU tensors a convolution is ``F.conv2d``.
On CUDA tensors it is an im2col GEMM (``_conv_gemm``).  The batched
local update runs a window of W clients through ``torch.func.vmap``,
which makes each convolution a grouped one, and on an H100 cuDNN's
deterministic algorithms ran a grouped convolution one group at a time:
a window of 7 clients launched 27,254 CUDA kernels, against 8,636 in
the GEMM form (``chip_smoke.py``); its nondeterministic algorithms had
made two runs from one seed differ.  In the GEMM form the clients'
weights are a batch dimension of one batched matmul, and the windows
are gathered by a depthwise convolution with one-hot filters, which
vmap runs as one ungrouped call for all W clients; nothing forward or
backward sums with atomics, so card runs reproduce bit for bit.  The
gather and the GEMM run inside ``common.fp32.ieee()``: IEEE fp32, no
TF32, deterministic cuDNN should it ever take the gather, whatever the
process-wide flags say; the local update (``core.client``) runs its
backward in the same scope.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.common import fp32
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


@functools.lru_cache(maxsize=None)
def _window_filters(cin: int, k: int, device) -> torch.Tensor:
    """(cin * k * k, 1, k, k) one-hot filters: depthwise, output channel
    c * k * k + i * k + j of input channel c copies window offset (i, j)."""
    return torch.eye(k * k, device=device).reshape(k * k, 1, k, k).repeat(cin, 1, 1, 1)


def _conv_gemm(p, x, stride=1):
    """x NCHW, p["w"] HWIO -> NCHW as im2col and a batched GEMM: the card's
    convolution (module docstring).  After the "SAME" padding, the
    one-hot depthwise convolution lays each output position's window out
    as (cin, kh, kw) channels, exactly (one product by 1 a value), the
    weight reshaped to (cout, cin * kh * kw) multiplies them, and the bias
    is added after, as the reference adds it.  The weight is expanded
    over the images, so its gradient is one GEMM an image and a sum, not
    one GEMM with a reduction as long as the batch.  Both run in IEEE
    fp32 (``fp32.ieee()``), so the gather stays exact."""
    k, _, cin, cout = p["w"].shape
    ph = _same_pad(x.shape[2], k, stride)
    pw = _same_pad(x.shape[3], k, stride)
    if ph[0] != ph[1] or pw[0] != pw[1]:
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        ph = pw = (0, 0)
    with fp32.ieee():
        cols = F.conv2d(x, _window_filters(cin, k, x.device), stride=stride,
                        padding=(ph[0], pw[0]), groups=cin)
        n, _, ho, wo = cols.shape
        wm = p["w"].permute(3, 2, 0, 1).reshape(cout, cin * k * k).expand(n, cout, cin * k * k)
        out = torch.bmm(wm, cols.reshape(n, cin * k * k, ho * wo)) + p["b"][:, None]
    return out.reshape(n, cout, ho, wo)


def _gemm_route(x) -> bool:
    """Whether a convolution takes the card's GEMM route: on CUDA tensors
    (the tests also take it on the CPU, to hold it against ``F.conv2d``
    and the reference)."""
    return x.is_cuda


def _conv(p, x, stride=1):
    """x NCHW, p["w"] HWIO -> NCHW: ``F.conv2d`` after the "SAME" pad, or
    on the card ``_conv_gemm``."""
    if _gemm_route(x):
        return _conv_gemm(p, x, stride)
    k = p["w"].shape[0]
    ph = _same_pad(x.shape[2], k, stride)
    pw = _same_pad(x.shape[3], k, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], stride=stride)


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
