"""End-to-end driver (paper experiment d, scaled): 7 heterogeneous
clients, non-IID data, CNN or MLP client model, federated rounds
comparing any set of registered algorithms: the Table III pipeline on
one machine, on the ``Federation`` facade.  Port of the reference's
``examples/fl_mnist_vafl.py``, plus ``--device`` (the card unless the
caller asks for the CPU).

    PYTHONPATH=src python -m repro_torch.examples.fl_mnist_vafl [--rounds 200] \\
        [--model cnn|mlp] [--mode round|event] [--algs afl,eaflm,vafl] \\
        [--compress topk0.1_int8] [--broadcast-compress int8] \\
        [--engine batched --buffer 16] [--device cuda|cpu]

--algs takes any registered algorithm names (repro_torch.algorithms;
e.g. add fedasync to compare its staleness-weighted mixing in event
mode).  --engine batched (event mode) runs the windowed batched async
engine; --buffer K enables FedBuff-style buffered mixing.  --compress
ships codec payloads instead of full fp32 models on accepted uploads;
the summary then shows byte-CCR next to the paper's count-CCR.
"""
import argparse

from repro_torch.algorithms import available_algorithms
from repro_torch.core import Federation
from repro_torch.core.client import LocalSpec
from repro_torch.core.metrics import ccr
from repro_torch.data.partition import paper_noniid_partition
from repro_torch.data.synthetic import synthetic_mnist


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--clients", type=int, default=7)
    ap.add_argument("--samples", type=int, default=1000)
    ap.add_argument("--model", default="mlp", choices=("mlp", "cnn"))
    ap.add_argument("--mode", default="round", choices=("round", "event"))
    ap.add_argument("--target", type=float, default=0.94)
    ap.add_argument("--algs", default="afl,eaflm,vafl",
                    help="comma list of registered algorithms "
                         f"({', '.join(available_algorithms())})")
    ap.add_argument("--compress", default="identity",
                    help="upload codec spec (identity|int8|int4|topk0.1|topk0.1_int8|...)")
    ap.add_argument("--broadcast-compress", default=None, help="optional downlink codec spec")
    ap.add_argument("--engine", default="sequential", choices=("sequential", "batched"),
                    help="event-mode execution engine; batched scales to 1000+ clients")
    ap.add_argument("--max-batch", type=int, default=0,
                    help="batched engine window bound (0 = num clients)")
    ap.add_argument("--buffer", type=int, default=1, help="batched engine FedBuff buffer size K")
    args = ap.parse_args()
    if args.engine == "batched" and args.mode != "event":
        ap.error("--engine batched requires --mode event")
    if (args.buffer != 1 or args.max_batch) and args.engine != "batched":
        ap.error("--buffer/--max-batch require --engine batched")

    xtr, ytr, xte, yte = synthetic_mnist(args.clients * args.samples + 2000, 2000, seed=0)
    fed_data = paper_noniid_partition(xtr, ytr, args.clients, samples_per_client=args.samples,
                                      seed=0)

    # ONE federation, algorithm swapped per run: the model, loss and
    # evaluator are built once
    algs = args.algs.split(",")
    fed = Federation(model=args.model, data=fed_data, test_data=(xte, yte), algorithm=algs[0],
                     compressor=args.compress, broadcast_compressor=args.broadcast_compress,
                     local=LocalSpec(batch_size=32, local_epochs=1, local_rounds=1, lr=0.1),
                     target_acc=args.target, eval_every=1, engine=args.engine,
                     max_batch=args.max_batch, buffer_size=args.buffer, device=args.device)
    results = {}
    for alg in algs:
        print(f"\n=== {alg.upper()} ===")
        results[alg] = fed.run(rounds=args.rounds, mode=args.mode, algorithm=alg, verbose=True)

    print("\n=== summary (experiment d, scaled) ===")
    base = results.get("afl") or next(iter(results.values()))
    c0 = base.uploads_to_target or base.comm.model_uploads
    print(f"{'alg':8s} {'best_acc':>9s} {'comm_times':>11s} {'CCR':>7s} "
          f"{'byte_CCR':>9s} {'uplink_KB':>10s} {'hit target':>11s}")
    for alg, res in results.items():
        c1 = res.uploads_to_target or res.comm.model_uploads
        print(f"{alg:8s} {res.best_acc:9.4f} {c1:11d} "
              f"{ccr(c0, c1):7.2%} {res.byte_ccr:9.2%} "
              f"{res.comm.upload_payload_bytes / 1024:10.1f} "
              f"{str(res.uploads_to_target is not None):>11s}")


if __name__ == "__main__":
    main()
