"""Paper Fig. 4: global-model Acc over rounds for AFL / EAFLM / VAFL in
each experiment.  Port of the reference's
``benchmarks/fig4_convergence.py``; the one addition is ``--device``
(the card unless the caller asks for the CPU).  Prints CSV rows
experiment,algorithm,round,acc and optionally writes a matplotlib
figure.

    python -m repro_torch.bench.fig4_convergence [--device cuda|cpu] [--rounds 30] [--exp abcd] [--png out.png]
"""
from __future__ import annotations

import argparse

from repro_torch.bench.fl_common import ALGS, EXPERIMENTS, BenchScale, run_experiment


def run(model="mlp", scale=None, experiments=None, png=None, device="cuda"):
    scale = scale or BenchScale()
    curves = {}
    print("experiment,algorithm,round,acc")
    for exp in (experiments or EXPERIMENTS):
        for alg in ALGS:
            res = run_experiment(exp, alg, model=model, scale=scale, device=device)
            curves[(exp, alg)] = [(r.round, r.global_acc) for r in res.records]
            for rnd, acc in curves[(exp, alg)]:
                print(f"{exp},{alg},{rnd},{acc:.4f}")
    if png:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        exps = sorted({e for e, _ in curves})
        fig, axes = plt.subplots(1, len(exps), figsize=(4 * len(exps), 3.2), squeeze=False)
        for i, exp in enumerate(exps):
            ax = axes[0][i]
            for alg in ALGS:
                xs, ys = zip(*curves[(exp, alg)])
                ax.plot(xs, ys, label=alg.upper())
            ax.set_title(f"experiment {exp}")
            ax.set_xlabel("round")
            ax.set_ylabel("Acc")
            ax.legend()
        fig.tight_layout()
        fig.savefig(png, dpi=120)
        print(f"# wrote {png}")
    return curves


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--model", default="mlp")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--exp", default=None)
    ap.add_argument("--png", default=None)
    a = ap.parse_args()
    run(model=a.model, scale=BenchScale(rounds=a.rounds),
        experiments=list(a.exp) if a.exp else None, png=a.png, device=a.device)


if __name__ == "__main__":
    main()
