"""Paper Fig. 5/6: per-client Acc during VAFL, and VAFL's global Acc
across the four experiments.  Port of the reference's
``benchmarks/fig5_clients.py``, plus ``--device``.  CSV:
experiment,round,client,acc, with the global rows at client = -1.

    python -m repro_torch.bench.fig5_clients [--device cuda|cpu] [--rounds 30] [--exp abcd]
"""
from __future__ import annotations

import argparse

from repro_torch.bench.fl_common import EXPERIMENTS, BenchScale, run_experiment


def run(model="mlp", scale=None, experiments=None, device="cuda"):
    scale = scale or BenchScale()
    print("experiment,round,client,acc")
    out = {}
    for exp in (experiments or EXPERIMENTS):
        res = run_experiment(exp, "vafl", model=model, scale=scale, device=device)
        out[exp] = res
        for rec in res.records:
            if rec.client_accs:
                for ci, acc in enumerate(rec.client_accs):
                    print(f"{exp},{rec.round},{ci},{acc:.4f}")
            print(f"{exp},{rec.round},-1,{rec.global_acc:.4f}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--model", default="mlp")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--exp", default=None)
    a = ap.parse_args()
    run(model=a.model, scale=BenchScale(rounds=a.rounds),
        experiments=list(a.exp) if a.exp else None, device=a.device)


if __name__ == "__main__":
    main()
