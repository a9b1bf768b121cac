#!/usr/bin/env python3
"""Time Algorithm 1 on one CUDA card, another version of repro_torch
against this checkout's, in turns: the two calls it makes into its
kernels (``TopKQuantCodec.encode``, ``tree_grad_diff_sq_norm``) on
chip_smoke.py's inputs, with the CUDA kernels one call runs
(``torch.profiler``), and seconds per round of chip_smoke.py's main
path (3 rounds of vafl, then of afl).  In the first PROFILED_PAIRS
pairs one vafl round is profiled for the device time of its kernels.

    mkdir -p build/parent && git archive <commit> src | tar -x -C build/parent
    python3 algo1_ab.py build/parent/src

runs PAIRS pairs of processes, one on each version, in turns (old, new,
new, old, ...), and prints one JSON object a reading.  It needs one card
and imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
PAIRS = 10
PROFILED_PAIRS = 2
ROUNDS = 3


def child(label: str, pair: int) -> None:
    """One version's readings, from the package on PYTHONPATH."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("algo1_ab: no CUDA device")
    import repro_torch
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.compress.composed import TopKQuantCodec
    from repro_torch.kernels.grad_diff_norm import ops as gd

    def say(**row):
        print(json.dumps(dict(label=label, pair=pair, package=repro_torch.__file__, **row)),
              flush=True)

    def timed(case, n, fn):
        """CUDA-event mean of back-to-back calls, and what one call ran."""
        iters = (20, 3) if n > cs.RESIDENT_LIMIT else (200, 20)
        ms, act = cs.cuda_ms(fn, *iters), cs.device_activity(fn)
        say(case=case, elements=n, ms=ms, cuda_kernels=len(act["kernels"]),
            kernel_us=sum(us for _, us in act["kernels"]),
            copy_us=sum(us for _, us in act["copies"]))

    gen = torch.Generator(device="cuda").manual_seed(11)
    codec = TopKQuantCodec(0.1)
    for layout, what in cs.ENC_CASES:
        tree = cs._encode_tree(layout, what, gen)
        timed(f"encode {layout} {what}", sum(x.numel() for x in tree_leaves(tree)),
              lambda: codec.encode(tree, seed=3))
    for layout, w in cs.GRAD_TREES:
        a32, b32 = cs._stacked_pair(layout, w, gen)
        n = sum(x.numel() for x in a32.values())
        for dtype in (torch.float32, torch.bfloat16):
            a = {k: x.to(dtype) for k, x in a32.items()}
            b = {k: x.to(dtype) for k, x in b32.items()}
            timed(f"tree_grad_diff_sq_norm {layout} W={w} {str(dtype)[6:]}", n,
                  lambda: gd.tree_grad_diff_sq_norm(a, b))

    fed = cs.algo1_federation()
    fed.run(rounds=1)      # warm-up: kernel libraries loaded
    for alg in ("vafl", "afl"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fed.run(rounds=ROUNDS, algorithm=alg)
        torch.cuda.synchronize()
        say(case=f"{alg} seconds per round", rounds=ROUNDS,
            s_per_round=(time.perf_counter() - t0) / ROUNDS,
            uploads=res.comm.model_uploads, upload_bytes=res.comm.upload_payload_bytes)
    if pair < PROFILED_PAIRS:
        act = cs.device_activity(lambda: fed.run(rounds=1, algorithm="vafl"))
        per_name = {}
        for kname, us in act["kernels"]:
            per_name[kname] = per_name.get(kname, 0.0) + us
        say(case="one vafl round, CUDA kernels (torch.profiler)",
            kernels=len(act["kernels"]), kernel_us=sum(per_name.values()),
            copies=len(act["copies"]), copy_us=sum(us for _, us in act["copies"]),
            top=sorted(per_name.items(), key=lambda kv: -kv[1])[:8])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", help="the src/ directory of the version to time against this one")
    ap.add_argument("--child", nargs=2, metavar=("LABEL", "PAIR"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child[0], int(args.child[1]))
        return
    for pair in range(PAIRS):
        for label in (("old", "new") if pair % 2 == 0 else ("new", "old")):
            src = Path(args.parent).resolve() if label == "old" else ROOT / "src"
            subprocess.run([sys.executable, str(Path(__file__).resolve()), args.parent,
                            "--child", label, str(pair)],
                           env=dict(os.environ, PYTHONPATH=str(src)), check=True,
                           stdin=subprocess.DEVNULL, timeout=900)


if __name__ == "__main__":
    main()
