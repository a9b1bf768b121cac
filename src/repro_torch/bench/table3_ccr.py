"""Paper Table III: communication times + CCR for AFL / EAFLM / VAFL in
experiments a-d.  Port of the reference's ``benchmarks/table3_ccr.py``.
Prints CSV: experiment,algorithm,communication_times,reached_target,
best_acc,ccr,paper_comm,paper_ccr.

    python -m repro_torch.bench.table3_ccr [--device cuda|cpu] [--model mlp|cnn] [--exp abcd]

The federation runs on the card unless ``--device cpu`` is given;
without a card the default raises.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.bench.fl_common import (ALGS, EXPERIMENTS, BenchScale, run_experiment,
                                         table3_row)

PAPER_TABLE3 = {  # (comm times, CCR) from the paper, for the report
    ("a", "afl"): (39, 0.0), ("a", "eaflm"): (25, 0.3590), ("a", "vafl"): (28, 0.2821),
    ("b", "afl"): (84, 0.0), ("b", "eaflm"): (45, 0.4643), ("b", "vafl"): (43, 0.4881),
    ("c", "afl"): (45, 0.0), ("c", "eaflm"): (19, 0.5778), ("c", "vafl"): (22, 0.5111),
    ("d", "afl"): (77, 0.0), ("d", "eaflm"): (35, 0.5455), ("d", "vafl"): (27, 0.6494),
}


def run(model="mlp", scale=None, experiments=None, out_json=None, device="cuda",
        verbose=False):
    scale = scale or BenchScale()
    rows = []
    for exp in (experiments or EXPERIMENTS):
        results = {alg: run_experiment(exp, alg, model=model, scale=scale, device=device,
                                       verbose=verbose) for alg in ALGS}
        rows += table3_row(exp, results)
    print("experiment,algorithm,communication_times,reached_target,best_acc,ccr,"
          "paper_comm,paper_ccr")
    for r in rows:
        pc, pr = PAPER_TABLE3[(r["experiment"], r["algorithm"])]
        print(f"{r['experiment']},{r['algorithm']},{r['communication_times']},"
              f"{r['reached_target']},{r['best_acc']},{r['ccr']},{pc},{pr}")
    if out_json:
        with open(out_json, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--model", default="mlp", choices=("mlp", "cnn"))
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--samples", type=int, default=1000)
    ap.add_argument("--target", type=float, default=0.94)
    ap.add_argument("--exp", default=None, help="subset, e.g. 'ab'")
    ap.add_argument("--out-json", default=None)
    ap.add_argument("-v", "--verbose", action="store_true")
    a = ap.parse_args()
    run(model=a.model,
        scale=BenchScale(samples_per_client=a.samples, rounds=a.rounds, target_acc=a.target),
        experiments=list(a.exp) if a.exp else None, out_json=a.out_json, device=a.device,
        verbose=a.verbose)


if __name__ == "__main__":
    main()
