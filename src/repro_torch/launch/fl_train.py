"""Cross-silo VAFL training entry point: the paper's technique across silos.
Port of ``repro.launch.fl_train``.

Each pod is a federated silo; per step each silo computes its own
gradient, its Eq. 1 communication value, and the algorithm's gate (Eq. 2
for vafl) decides which silos contribute to the aggregation
(``make_fl_train_step``).

    PYTHONPATH=src python -m repro_torch.launch.fl_train --arch minicpm_2b \\
        --smoke --steps 10 --pods 2 --batch-per-pod 4 --seq 128 [--device cpu]

The device defaults to ``cuda`` and raises without a card.  All pods run
on the one device, one after another; the reference's ``--devices`` only
set XLA's count of placeholder host devices for its pod mesh and has no
counterpart here.  The same gate as a collective across processes is
``repro_torch.distributed.gated``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.algorithms.registry import available_algorithms
from repro_torch.common.pytree import tree_map
from repro_torch.data.synthetic import token_stream
from repro_torch.launch.steps import make_fl_train_step
from repro_torch.models import decoder
from repro_torch.models.registry import get_config, get_smoke_config


def run(arch: str, *, smoke: bool, steps: int, pods: int, batch_per_pod: int, seq: int,
        lr: float, algorithm: str = "vafl", device="cuda", cfg=None, verbose: bool = True):
    """Run ``steps`` cross-silo steps; returns each step's info (loss,
    V, mask, grad_norm) as host values.  ``cfg`` overrides the
    registry's config (``chip_smoke.py`` cuts the depth)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fl_train(device='cuda') needs a CUDA card; pass device='cpu' "
                           "to train on the host")
    cfg = cfg or (get_smoke_config(arch) if smoke else get_config(arch))
    step_fn, opt_init = make_fl_train_step(cfg, n_pods=pods, lr=lr, algorithm=algorithm)
    params = decoder.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    opt_state = opt_init(params)
    prev_grads = tree_map(lambda x: torch.zeros((pods,) + tuple(x.shape), dtype=torch.float32,
                                                device=device), params)
    B, S = batch_per_pod, seq
    # per-silo data: different seeds => non-IID silo streams
    silo = [token_stream(steps * B, S, cfg.vocab_size, seed=100 + p) for p in range(pods)]
    infos = []
    for s in range(steps):
        batch = {key: torch.from_numpy(np.stack([silo[p][j][s * B:(s + 1) * B]
                                                 for p in range(pods)])).long().to(device)
                 for j, key in enumerate(("tokens", "labels"))}
        params, opt_state, prev_grads, info = step_fn(params, opt_state, prev_grads, batch, s)
        info = {k: v.detach().cpu().numpy() for k, v in info.items()}
        infos.append(info)
        if verbose:
            print(f"step {s:3d} loss={float(info['loss']):.4f} "
                  f"V={np.array2string(info['V'], precision=2)} "
                  f"silos_synced={int(info['mask'].sum())}/{pods}")
    return infos


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--batch-per-pod", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    # any registered algorithm is launchable: the step consumes its
    # stacked gate (UploadPolicy.gate_stacked), not name branches
    ap.add_argument("--algorithm", default="vafl", choices=available_algorithms())
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args()
    run(a.arch, smoke=a.smoke, steps=a.steps, pods=a.pods, batch_per_pod=a.batch_per_pod,
        seq=a.seq, lr=a.lr, algorithm=a.algorithm, device=a.device)
    print("done — uploads gated by Eq.2 on every step; "
          "comm saved = (1 - synced/pods) of cross-silo aggregation rounds")


if __name__ == "__main__":
    main()
