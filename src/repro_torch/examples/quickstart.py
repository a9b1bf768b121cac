"""Quickstart: the VAFL public API in about 20 lines.  Port of the
reference's ``examples/quickstart.py``; ``--device`` (the card unless
the caller asks for the CPU), ``--rounds`` and ``--samples`` (per
client) are its knobs.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cuda|cpu]

Builds a 3-client federation on synthetic MNIST, runs 8 wall-clock
rounds of VAFL on the paper's simulated testbed (``repro_torch.sim``
scenario: laptop and Pi devices on a home LAN, byte-aware link delays),
and prints the communication ledger (the scalar V reports that replace
most full-model uploads) and the simulated time to accuracy.  Swap
``algorithm=`` for any registered name ("afl", "eaflm", "fedavg",
"fedasync", ...) and ``scenario=`` for any zoo name ("mobile_fleet",
"flaky_edge", "datacenter", ...): the runtimes are algorithm- and
scenario-agnostic.
"""
import argparse

from repro_torch.core import Federation
from repro_torch.core.client import LocalSpec
from repro_torch.core.metrics import ccr
from repro_torch.data.partition import iid_partition
from repro_torch.data.synthetic import synthetic_mnist


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--samples", type=int, default=1000, help="samples per client")
    args = ap.parse_args()
    R = args.rounds

    # 1. data: synthetic MNIST, split IID across 3 clients
    xtr, ytr, xte, yte = synthetic_mnist(3 * args.samples, 1000, seed=0)
    fed_data = iid_partition(xtr, ytr, num_clients=3, samples_per_client=args.samples)

    # 2. the federation: model + algorithm + codecs + scenario in one object
    fed = Federation(model="mlp", data=fed_data, test_data=(xte, yte),
                     algorithm="vafl", scenario="paper_testbed",
                     local=LocalSpec(batch_size=32, local_epochs=1, local_rounds=1, lr=0.1),
                     target_acc=0.85, device=args.device)

    # 3. VAFL: every completion the client reports the scalar V_i (Eq. 1);
    #    only above-mean clients upload their model (Eq. 2)
    res = fed.run(rounds=R, mode="event", verbose=True)

    print(f"\nbest Acc          : {res.best_acc:.4f}")
    print(f"model uploads     : {res.comm.model_uploads} (plain AFL would use {R * 3})")
    print(f"scalar V reports  : {res.comm.scalar_reports} "
          f"({res.comm.scalar_reports * 4} bytes total)")
    print(f"CCR vs AFL        : {ccr(R * 3, res.comm.model_uploads):.2%}")
    print(f"sim wall-clock    : {res.sim_time:.1f} s (mean idle {res.idle_fraction:.1%})")
    print(f"bytes on the wire : {res.comm.uplink_bytes / 1e6:.2f} MB up / "
          f"{res.comm.downlink_bytes / 1e6:.2f} MB down")
    tta = ("not reached" if res.time_to_target is None
           else f"{res.time_to_target:.1f} s simulated")
    print(f"time to {fed.config.target_acc:.0%} Acc   : {tta}")


if __name__ == "__main__":
    main()
