"""Beyond-paper example: VAFL federating *language models*.  Port of the
reference's ``examples/fl_llm_finetune.py``, plus ``--device`` (the card
unless the caller asks for the CPU).

The FL runtime is model-agnostic (clients are opaque parameter trees):
here each client locally fine-tunes a small transformer LM on its own
token stream (disjoint shards of one Markov corpus), and the server
gates uploads with Eq. 1/2 exactly as for the MNIST CNN.  The local
update runs the LM loss under ``torch.func.vmap`` over the clients, so
on the card the attention kernels' forward and backward run once a step
for all clients (the Function's vmap rule folds the clients into the
batch).

    PYTHONPATH=src python -m repro_torch.examples.fl_llm_finetune [--rounds 6] \\
        [--arch minicpm_2b] [--clients 3] [--device cuda|cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import Federation
from repro_torch.core.client import LocalSpec
from repro_torch.core.metrics import ccr
from repro_torch.data.partition import FederatedData
from repro_torch.data.synthetic import token_stream
from repro_torch.models import decoder
from repro_torch.models.registry import get_smoke_config

LOCAL = LocalSpec(batch_size=8, local_epochs=1, local_rounds=2, lr=0.5)
TARGET_ACC = 0.15


def make_lm_loss(cfg):
    def loss_fn(params, batch):
        toks = batch["images"].long()                 # (B, S) tokens
        w = batch.get("weights")
        logits, _ = decoder.forward(cfg, params, toks[:, :-1], remat=False)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, toks[:, 1:, None])[..., 0]
        nll = torch.mean(nll, dim=-1)                 # per sequence
        if w is not None:
            loss = torch.sum(nll * w) / torch.clamp_min(torch.sum(w), 1.0)
        else:
            loss = torch.mean(nll)
        return loss, {}
    return loss_fn


def make_lm_evaluator(cfg, test_tokens, device="cuda"):
    xt = torch.from_numpy(np.asarray(test_tokens)).long().to(device)

    @torch.no_grad()
    def evaluate(params):
        logits, _ = decoder.forward(cfg, params, xt[:, :-1], remat=False)
        pred = torch.argmax(logits, dim=-1)
        return torch.mean((pred == xt[:, 1:]).float())
    return evaluate


def build_federation(cfg, n_clients, seqs_per_client=48, seq_len=48):
    streams = []
    for c in range(n_clients):
        # one shared corpus structure, disjoint per-silo shards
        toks, _ = token_stream(seqs_per_client, seq_len, cfg.vocab_size,
                               seed=1000 + 17 * c, structure_seed=7)
        streams.append(toks)
    images = np.stack(streams).astype(np.int32)      # (N, M, S)
    N, M, _ = images.shape
    return FederatedData(images=images,
                         labels=np.zeros((N, M), np.int32),
                         mask=np.ones((N, M), np.float32),
                         counts=np.full(N, M, np.int32))


def make_federation(cfg, fed, algorithm, device="cuda", init_params_fn=None,
                    test_tokens=None):
    """The example's federation for one algorithm in explicit-fns mode:
    the decoder's LM loss and a next-token-accuracy evaluator."""
    if test_tokens is None:
        test_tokens, _ = token_stream(32, 48, cfg.vocab_size, seed=7, structure_seed=7)
    return Federation(
        data=fed, algorithm=algorithm,
        init_params_fn=init_params_fn or (lambda g: decoder.init_params(cfg, g)),
        loss_fn=make_lm_loss(cfg), evaluate_fn=make_lm_evaluator(cfg, test_tokens, device),
        local=LOCAL, target_acc=TARGET_ACC, device=device)


def run(arch="minicpm_2b", clients=3, rounds=6, device="cuda", verbose=True):
    """afl then vafl; returns {algorithm: RunResult}."""
    # narrow vocab so the Markov table is learnable within the demo budget
    cfg = get_smoke_config(arch).replace(vocab_size=128)
    fed = build_federation(cfg, clients)
    results = {}
    for alg in ("afl", "vafl"):
        if verbose:
            print(f"\n=== {alg.upper()} (federated LM fine-tune, {clients} silos) ===")
        results[alg] = make_federation(cfg, fed, alg, device).run(rounds=rounds,
                                                                  verbose=verbose)
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm_2b")
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    results = run(args.arch, args.clients, args.rounds, args.device)
    afl, vafl = results["afl"], results["vafl"]
    print(f"\nAFL : uploads={afl.comm.model_uploads} "
          f"next-token acc={afl.best_acc:.3f}")
    print(f"VAFL: uploads={vafl.comm.model_uploads} "
          f"next-token acc={vafl.best_acc:.3f} "
          f"CCR={ccr(afl.comm.model_uploads, vafl.comm.model_uploads):.2%}")


if __name__ == "__main__":
    main()
