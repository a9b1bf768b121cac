"""Shared harness for the paper's four experiments (a-d).  Port of the
reference's ``benchmarks/fl_common.py``; the one addition is
``device``, where the federation runs (the card unless the caller asks
for the CPU).

Paper setup (§IV/§V): MNIST, small ResNet, 3 or 7 clients, IID / non-IID,
r=5, E=1, B=32, eta=0.1, R=200 rounds, target Acc 94%.

Scaled as the reference scales it (BenchScale defaults below):
synthetic-MNIST stands in for MNIST (no network access); the default
client model is the small MLP with the CNN available via --model cnn;
rounds and per-client sample counts are scaled down (the paper's
*comparisons*, comm counts to target Acc and CCR between
AFL/EAFLM/VAFL, are preserved, absolute round counts are not).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.client import LocalSpec
from repro_torch.core.federation import Federation
from repro_torch.core.metrics import ccr
from repro_torch.data.partition import iid_partition, paper_noniid_partition
from repro_torch.data.synthetic import synthetic_mnist
from repro_torch.models.cnn import (CNNConfig, MLPConfig, cnn_forward, cnn_init,
                                    mlp_forward, mlp_init)

EXPERIMENTS = {
    # paper §V-B: (num_clients, iid)
    "a": (3, True),
    "b": (7, True),     # paper says "7 clients with data" (IID implied)
    "c": (3, False),
    "d": (7, False),
}

ALGS = ("afl", "eaflm", "vafl")


@dataclass
class BenchScale:
    samples_per_client: int = 1000
    rounds: int = 30
    test_samples: int = 1000
    target_acc: float = 0.94
    local_rounds: int = 1      # r (paper: 5), scaled as the reference scales it
    seed: int = 0


def build_problem(model: str = "mlp", scale: BenchScale = None,
                  num_clients: int = 3, iid: bool = True):
    """Synthetic-MNIST federation for one paper experiment: returns
    ``(fed_data, (forward_fn, init_fn, model_cfg), (xte, yte))``; the
    model triple and test split plug straight into ``Federation``."""
    scale = scale or BenchScale()
    n_train = max(num_clients * scale.samples_per_client, 2000)
    xtr, ytr, xte, yte = synthetic_mnist(n_train, scale.test_samples, seed=scale.seed)
    part = iid_partition if iid else paper_noniid_partition
    fed = part(xtr, ytr, num_clients, samples_per_client=scale.samples_per_client,
               seed=scale.seed)
    if model == "cnn":
        triple = (cnn_forward, cnn_init, CNNConfig())
    else:
        triple = (mlp_forward, mlp_init, MLPConfig(hidden=(128, 64)))
    return fed, triple, (xte, yte)


def build_federation(exp: str, alg: str, *, model: str = "mlp", scale: BenchScale = None,
                     device="cuda", **config) -> Federation:
    """One paper experiment (a-d) as a configured ``Federation``."""
    scale = scale or BenchScale()
    n, iid = EXPERIMENTS[exp]
    fed, triple, test = build_problem(model, scale, n, iid)
    return Federation(
        model=triple, data=fed, test_data=test, algorithm=alg,
        local=LocalSpec(batch_size=32, local_epochs=1, local_rounds=scale.local_rounds,
                        lr=0.1),
        rounds=scale.rounds, target_acc=scale.target_acc, seed=scale.seed,
        eval_batch=min(500, scale.test_samples), device=device, **config)


def run_experiment(exp: str, alg: str, *, model: str = "mlp", scale: BenchScale = None,
                   mode: str = "round", compressor: str = "identity",
                   broadcast_compressor: str = None, device="cuda", verbose: bool = False):
    return build_federation(
        exp, alg, model=model, scale=scale, device=device, compressor=compressor,
        broadcast_compressor=broadcast_compressor).run(mode=mode, verbose=verbose)


def table3_row(exp: str, results: dict) -> list:
    """results: {alg: RunResult} -> rows (exp, alg, comm_times, ccr).
    Per-run numbers come from ``RunResult.to_summary()``; the cross-run
    CCR (Eq. 4 against the AFL baseline) is the one field no single run
    can know about itself."""
    base = results["afl"].to_summary()
    c0 = base["uploads_to_target"] or base["uploads"]
    rows = []
    for alg in ALGS:
        s = results[alg].to_summary()
        c1 = s["uploads_to_target"] or s["uploads"]
        rows.append({
            "experiment": exp, "algorithm": s["algorithm"],
            "communication_times": c1,
            "reached_target": s["uploads_to_target"] is not None,
            "best_acc": s["best_acc"],
            "ccr": round(ccr(c0, c1), 4) if alg != "afl" else 0.0,
        })
    return rows
