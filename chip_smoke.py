#!/usr/bin/env python3
"""Smoke test of repro_torch on one NVIDIA H100: build the CUDA kernels,
hold each against its plain PyTorch version on the card, time them, and
drive the port's main path, Algorithm 1 through the public entry point:

    Federation(model="cnn", algorithm="vafl", compressor="topk0.1_int8",
               device="cuda").run(rounds=3, mode="round")

then afl on the same federation.  Run it from the root of a checkout:

    python3 chip_smoke.py

It exits non-zero, and prints no result, when a phase fails, when no
CUDA device is visible, or when it is not inside a checkout.  The last
line of its output is one JSON object naming the device; the line
before it is the card's name and power limit (``nvidia-smi``), and the
line before that the per-kernel JSON (launches, max error, times,
bound).  It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
GD_SHAPES = [(7, 42698), (1, 2 ** 24 + 123)]   # main path: 7 clients x CNN params
TQ_SIZES = [42698, 2 ** 24 + 123]
TQ_OPS_PER_ELEM = 24             # 10 hash + 14 float/convert/select ops (csrc/topk_quant.cu)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of one call over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, nops: float) -> tuple:
    """The least time for the work: the larger of its bytes over the HBM rate
    and its operations over the fp32 rate, and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from repro_torch.kernels import build
    t0 = time.time()
    logs = build.build()
    say(f"[build] {len(logs)} kernels built for sm_90a in {time.time() - t0:.1f} s "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                say(f"[build] {name}: {line.strip()}")


def phase_grad_diff_norm(rows: dict):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.grad_diff_norm import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    for w, p in GD_SHAPES:
        a32 = torch.randn(w, p, generator=gen, device="cuda")
        b32 = torch.randn(w, p, generator=gen, device="cuda")
        for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-3)):
            a, b = a32.to(dtype), b32.to(dtype)
            got, again = ops.grad_diff_sq_norm_2d(a, b), ops.grad_diff_sq_norm_2d(a, b)
            want = ref.grad_diff_sq_norm_2d(a, b)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = float(((got - want).abs() / want.abs()).max())
            if not torch.allclose(got, want, rtol=rtol, atol=0):
                fail(f"grad_diff_norm {w}x{p} {dtype}: rel err {rel:.3g} > rtol {rtol}")
            if not torch.equal(got, again):
                fail(f"grad_diff_norm {w}x{p} {dtype}: two runs differ")
            say(f"[check] grad_diff_norm ({w}, {p}) {str(dtype)[6:]}: max abs err {err:.6g}, "
                f"max rel err {rel:.3g} (rtol {rtol}), reruns bit-identical")
            if dtype != torch.float32:
                continue
            nbytes, nops = 2 * w * p * 4 + w * 4, 3 * w * p
            bms, bby = bound_ms(nbytes, nops)
            lib = (cuda_ms(lambda: F.mse_loss(a[0], b[0], reduction="sum")) if w == 1 else None)
            rows[(w, p)] = {
                "name": "grad_diff_norm", "route": "cuda",
                "source": "src/repro_torch/csrc/grad_diff_norm.cu",
                "replaces": "src/repro/kernels/grad_diff_norm/kernel.py:39",
                "shape": [w, p], "dtype": "float32", "max_abs_err": err, "max_rel_err": rel,
                "ms": cuda_ms(lambda: ops.grad_diff_sq_norm_2d(a, b)),
                "plain_ms": cuda_ms(lambda: ref.grad_diff_sq_norm_2d(a, b)),
                "bound_ms": bms, "bound_by": bby, "library_ms": lib,
                "library_call": "F.mse_loss(a, b, reduction='sum')" if w == 1 else None}


def phase_topk_quant(rows: dict):
    import torch
    from repro_torch.compress.composed import TopKQuantCodec
    from repro_torch.kernels.topk_quant import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(1)
    for n in TQ_SIZES:
        x = torch.randn(n, generator=gen, device="cuda")
        k = max(1, int(round(0.1 * n)))
        thr, scale = ops.topk_threshold_scale(x, k)
        q, m = ops.topk_quant(x, thr, scale, 0x9E3779B9)
        rq, rm = ref.topk_quant(x, thr, scale, 0x9E3779B9)
        torch.cuda.synchronize()
        if not (torch.equal(q, rq) and torch.equal(m, rm)):
            fail(f"topk_quant n={n}: q/mask differ from the plain version "
                 f"({int((q != rq).sum())} q, {int((m != rm).sum())} mask entries)")
        pk = TopKQuantCodec(0.1).encode({"x": x}, seed=12345)
        pr = TopKQuantCodec(0.1, use_kernel=False).encode({"x": x}, seed=12345)
        for plane in ("idx", "val"):
            if not (pk.planes[plane].dtype == pr.planes[plane].dtype
                    and (pk.planes[plane] == pr.planes[plane]).all()):
                fail(f"topk_int8 codec n={n}: {plane} plane differs from the plain version")
        if pk.nbytes != pr.nbytes or pk.meta["scale"] != pr.meta["scale"]:
            fail(f"topk_int8 codec n={n}: nbytes/scale differ from the plain version")
        err = float((q.int() - rq.int()).abs().max())
        say(f"[check] topk_quant n={n}: q, mask bit-exact; codec idx/val planes, scale and "
            f"nbytes ({pk.nbytes}, {len(pk.planes['idx'])} kept) bit-exact")
        bms, bby = bound_ms(6 * n + 8, TQ_OPS_PER_ELEM * n)
        rows[n] = {
            "name": "topk_quant", "route": "cuda",
            "source": "src/repro_torch/csrc/topk_quant.cu",
            "replaces": "src/repro/kernels/topk_quant/kernel.py:55",
            "shape": [n], "dtype": "float32", "max_abs_err": err,
            "ms": cuda_ms(lambda: ops.topk_quant(x, thr, scale, 7)),
            "plain_ms": cuda_ms(lambda: ref.topk_quant(x, thr, scale, 7)),
            "bound_ms": bms, "bound_by": bby, "library_ms": None, "library_call": None,
            "encode_ms": cuda_ms(lambda: TopKQuantCodec(0.1).encode({"x": x}, seed=3),
                                 iters=20, warmup=3)}


def phase_main_path():
    import torch
    from repro_torch.common.pytree import count_params, tree_leaves
    from repro_torch.core.client import LocalSpec
    from repro_torch.core.federation import Federation
    from repro_torch.core.metrics import ccr
    from repro_torch.data.partition import paper_noniid_partition
    from repro_torch.data.synthetic import synthetic_mnist
    from repro_torch.kernels.grad_diff_norm import ops as gd_ops
    from repro_torch.kernels.topk_quant import ops as tq_ops

    xtr, ytr, xte, yte = synthetic_mnist(7000, 2000, seed=0)
    data = paper_noniid_partition(xtr, ytr, 7, samples_per_client=1000, seed=0)
    say(f"[main] 7 clients, samples {data.counts.tolist()} (paper non-IID), "
        f"test {len(yte)}, CNNConfig() channels (16, 32) x 2 blocks")
    fed = Federation(model="cnn", data=data, test_data=(xte, yte), algorithm="vafl",
                     compressor="topk0.1_int8",
                     local=LocalSpec(batch_size=32, local_epochs=1, local_rounds=1, lr=0.1),
                     device="cuda")
    seen = {}
    ev = fed.evaluate_fn

    def capture(p):
        seen["params"] = p
        return ev(p)
    fed.evaluate_fn = capture
    fed.run(rounds=1)      # warm-up: cuDNN plans, kernel libraries loaded
    torch.cuda.synchronize()

    gd_ops.launches = 0
    tq_ops.launches = 0
    runs, launches = {}, {}
    for alg in ("vafl", "afl"):
        g0, t0 = gd_ops.launches, tq_ops.launches
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        res = fed.run(rounds=3, algorithm=alg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - h0
        runs[alg] = (res, secs)
        launches[alg] = (gd_ops.launches - g0, tq_ops.launches - t0)
        params = tree_leaves(seen["params"])
        if not all(bool(torch.isfinite(x).all()) for x in params):
            fail(f"{alg}: non-finite global parameters")
        if count_params(seen["params"]) != 42698:
            fail(f"{alg}: {count_params(seen['params'])} parameters, expected 42698")
        for r in res.records:
            if not 0.0 <= r.global_acc <= 1.0:
                fail(f"{alg}: accuracy {r.global_acc} out of [0, 1]")
            say(f"[main] {alg} round {r.round}: selected {r.selected}, "
                f"uploads so far {r.uploads_so_far}, acc {r.global_acc:.4f}")
        say(f"[main] {alg}: model_uploads {res.comm.model_uploads}, scalar_reports "
            f"{res.comm.scalar_reports}, upload bytes {res.comm.upload_payload_bytes} of "
            f"{res.comm.model_uploads * res.comm.model_bytes} uncompressed, byte_ccr "
            f"{res.byte_ccr:.4f}, best acc {res.best_acc:.4f}, {secs:.3f} s "
            f"({secs / 3:.3f} s per round), kernel launches grad_diff_norm "
            f"{launches[alg][0]}, topk_quant {launches[alg][1]}")
    total = (gd_ops.launches, tq_ops.launches)   # read just after the main path
    vafl, afl = runs["vafl"][0], runs["afl"][0]
    say(f"[main] count CCR vafl vs afl: {ccr(afl.comm.model_uploads, vafl.comm.model_uploads):.4f}")
    if vafl.comm.model_uploads > afl.comm.model_uploads:
        fail(f"vafl uploaded more than afl ({vafl.comm.model_uploads} > "
             f"{afl.comm.model_uploads})")
    if total[0] <= 0 or total[1] <= 0:
        fail(f"a kernel of the main path never launched: grad_diff_norm {total[0]}, "
             f"topk_quant {total[1]}")
    # one grad_diff_norm launch per vafl round (W = 7 values at once), none
    # for afl; one topk_quant launch per accepted upload
    if launches["vafl"][0] != 3 or launches["afl"][0] != 0:
        fail(f"grad_diff_norm launches {launches}, expected 3 for vafl and 0 for afl")
    if total[1] != vafl.comm.model_uploads + afl.comm.model_uploads:
        fail(f"topk_quant launches {total[1]} != accepted uploads")
    return total, {alg: secs for alg, (_, secs) in runs.items()}


def main() -> None:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (src/repro_torch is missing)")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA H100")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    say(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)} ({smi})")
    # fp32 convolutions in full precision (cuDNN defaults to TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say("[env] torch.backends.cudnn.allow_tf32 = False, "
        "torch.backends.cuda.matmul.allow_tf32 = False")

    phase_build()
    gd_rows, tq_rows = {}, {}
    phase_grad_diff_norm(gd_rows)
    phase_topk_quant(tq_rows)
    (gd_launches, tq_launches), secs = phase_main_path()

    for row in list(gd_rows.values()) + list(tq_rows.values()):
        say("[time] " + json.dumps(row))
    main_gd = dict(gd_rows[GD_SHAPES[0]], launches=gd_launches)
    main_tq = dict(tq_rows[TQ_SIZES[0]], launches=tq_launches)
    say(f"[time] main path seconds per round (3 rounds, host clock, synchronized): "
        f"vafl {secs['vafl'] / 3:.4f}, afl {secs['afl'] / 3:.4f}")
    say(json.dumps({"kernels": [main_gd, main_tq]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
