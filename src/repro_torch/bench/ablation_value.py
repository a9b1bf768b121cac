"""Beyond-paper ablation: which ingredients of Eq. 1 matter?  Port of
the reference's ``benchmarks/ablation_value.py``, plus ``--device``.

The paper's conclusion asks for "other reference factors" in the value
computation.  This ablates the three ingredients of
V = ||g^{k-1} - g^k||^2 * (1 + N/1e3)^Acc:

  full        the paper's Eq. 1
  no_acc      drop the accuracy amplification (V = grad-diff norm)
  no_diff     replace the *difference* with the plain gradient norm
              (||g^k||^2 * amp): is the obsolescence check needed, or
              is EAFLM-style magnitude enough?
  random      V ~ U(0,1): selection with the same mean-threshold budget
              but no signal (control)
  strong_acc  Eq. 1 with a strong amplifier base (1000^Acc)

CSV: experiment,variant,comm_times,best_acc,ccr_vs_afl.

    python -m repro_torch.bench.ablation_value [--device cuda|cpu] [--exp d] [--rounds 20] [--corrupt 0]

The port's ``value_backend`` is stacked, ``(W, ...) -> (W,)``, so each
variant is a stacked function.
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch.bench.fl_common import EXPERIMENTS, BenchScale, build_problem
from repro_torch.common.pytree import tree_leaves
from repro_torch.core import Federation
from repro_torch.core.client import LocalSpec, make_evaluator, make_weighted_classifier_loss
from repro_torch.core.config import resolve_device
from repro_torch.core.metrics import ccr
from repro_torch.core.value import stacked_sq_norms
from repro_torch.kernels.grad_diff_norm.ops import tree_grad_diff_sq_norm


def variant_backend(kind: str, seed: int = 0):
    """A stacked ``value_backend`` implementing the variant: (W, ...)
    trees in, (W,) fp32 out.  (The Acc/N amplification happens
    downstream; variants that drop it do so through the client eval.)
    ``random`` draws from a ``torch.Generator`` of its own, seeded with
    ``seed`` on the device of the first call's trees."""
    if kind in ("full", "no_acc"):
        return tree_grad_diff_sq_norm
    if kind == "no_diff":
        return lambda gp, gc: stacked_sq_norms(gc)
    if kind == "random":
        state = {}

        def rand(gp, gc):
            leaf = tree_leaves(gc)[0]
            if "gen" not in state:
                state["gen"] = torch.Generator(device=leaf.device).manual_seed(seed)
            return torch.rand((leaf.shape[0],), generator=state["gen"], dtype=torch.float32,
                              device=leaf.device)
        return rand
    raise ValueError(kind)


def run(exp: str = "d", scale: BenchScale = None, model: str = "mlp",
        corrupt_clients: int = 0, seed: int = 0, device="cuda"):
    """corrupt_clients > 0 randomises the labels of that many clients:
    the regime where selecting by quality should matter (the paper's
    'honest clients' caveat, made measurable)."""
    scale = scale or BenchScale(samples_per_client=800, rounds=20, test_samples=800,
                                target_acc=0.94)
    device = resolve_device(device)
    n, iid = EXPERIMENTS[exp]
    fed, triple, test = build_problem(model, scale, n, iid)
    if corrupt_clients:
        import numpy as np
        rng = np.random.RandomState(seed)
        labels = fed.labels.copy()
        for c in range(n - corrupt_clients, n):
            m = fed.mask[c] > 0
            labels[c, m] = rng.randint(0, 10, size=int(m.sum()))
        fed.labels[:] = labels
    local = LocalSpec(batch_size=32, local_epochs=1, local_rounds=scale.local_rounds, lr=0.1)
    # one loss and one evaluator shared by every variant's Federation
    fwd, init, mcfg = triple
    loss_fn = make_weighted_classifier_loss(fwd, mcfg)
    evaluate = make_evaluator(fwd, mcfg, *test, batch=min(500, scale.test_samples),
                              device=device)
    base = dict(data=fed, init_params_fn=lambda g: init(mcfg, g), loss_fn=loss_fn,
                evaluate_fn=evaluate, local=local, rounds=scale.rounds,
                target_acc=scale.target_acc, device=device)

    # AFL baseline for CCR
    afl = Federation(algorithm="afl", **base).run()
    c0 = afl.uploads_to_target or afl.comm.model_uploads

    print("experiment,variant,comm_times,best_acc,ccr_vs_afl")
    print(f"{exp},afl,{c0},{afl.best_acc:.4f},0.0")
    rows = []
    zero = torch.zeros((), dtype=torch.float32, device=device)
    for variant in ("full", "no_acc", "no_diff", "random", "strong_acc"):
        backend = variant_backend("full" if variant == "strong_acc" else variant, seed)
        if variant == "strong_acc":
            # Eq. 1's (1 + N/1e3)^Acc is ~1 for small N, so low-Acc (e.g.
            # corrupted) clients are not damped.  Emulate a strong base
            # (1000^Acc) by scaling the reported Acc so that
            # value_base(N)^(acc*s) == 1000^acc.
            s = math.log(1000.0) / math.log(1.0 + n / 1e3)
            client_eval = lambda p: evaluate(p) * s  # noqa: E731
        elif variant == "no_acc":
            # neutralise the amplification by reporting Acc = 0:
            # (1 + N/1e3)^0 == 1
            client_eval = lambda p: zero  # noqa: E731
        else:
            client_eval = None
        res = Federation(algorithm="vafl", value_backend=backend, client_eval_fn=client_eval,
                         **base).run()
        c1 = res.uploads_to_target or res.comm.model_uploads
        print(f"{exp},{variant},{c1},{res.best_acc:.4f},{ccr(c0, c1):.4f}")
        rows.append((variant, c1, res.best_acc))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--exp", default="d")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--corrupt", type=int, default=0)
    a = ap.parse_args()
    run(a.exp, BenchScale(samples_per_client=800, rounds=a.rounds, test_samples=800,
                          target_acc=0.94),
        corrupt_clients=a.corrupt, device=a.device)


if __name__ == "__main__":
    main()
