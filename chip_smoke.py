#!/usr/bin/env python3
"""Smoke test of repro_torch on one NVIDIA H100: build the four CUDA
kernels, hold each against its plain PyTorch version on the card, time
them, and drive the port's four main paths through their public entry
points.

1. Algorithm 1:

    Federation(model="cnn", algorithm="vafl", compressor="topk0.1_int8",
               device="cuda").run(rounds=3, mode="round")

   then afl on the same federation (kernels grad_diff_norm, and
   topk_quant's device-side topk_int8 encode).
2. The event runtime on the same federation, ``run(rounds=3,
   mode="event")``: the sequential loop for vafl, afl and eaflm (21
   events each), fedavg's round barrier, and vafl under
   ``scenario="mobile_fleet"`` (grad_diff_norm once per vafl event, the
   encode once per accepted upload); ``[event]`` lines.
3. The batched engine on the same federation, ``run(rounds=3,
   mode="event", engine="batched")``: vafl (full windows of 7), afl with
   a FedBuff buffer of 4, eaflm in windows of 3, fedasync, vafl under
   ``mobile_fleet`` and vafl with the dense int8 codec (grad_diff_norm
   once per vafl window, the encode once per accepted upload under
   topk0.1_int8); vafl at ``max_batch=1, buffer_size=1`` held bit for
   bit against the sequential vafl run; then N = 256 clients of the
   same CNN (afl, buffer 16): the batched engine over 512 events
   against the sequential loop's first 32; ``[batched]`` lines.
4. ``[round-scenario]``: vafl in round mode under ``scenario=
   "flaky_edge"`` on the card and on the CPU path, from one initial model
   and one set of permutations: the same record times, ``selected``,
   ``client_failed_rounds``, byte ledgers and clock, bit for bit.
5. ``[checkpoint]``: the round runtime (vafl under flaky_edge), fedavg's
   barrier, the sequential loop (vafl) and the batched engine (vafl in
   full windows; afl with a FedBuff buffer of 4 crossing the checkpoint)
   on the same federation, each run whole, checkpointed
   (``checkpoint_path=``, ``checkpoint_every=``) and resumed
   (``resume=True``): the resumed run bit-equal to the whole one, and
   the kernels launched over the resumed part as often as the whole run
   launched them from the checkpoint on; an extending resume (2 rounds
   to 3); a child process (``spawn``) killed with SIGKILL after its
   first checkpoint, resumed here; each bundle's bytes and save and load
   milliseconds, and the N = 256 federation's.
6. ``[obs]``: the same runs with ``obs=True``: bit-equal to obs off,
   their traces reconciled with CommStats; a profiled batched window of
   7 with the same CUDA kernels and synchronising runtime calls with obs
   on as off; a second identical run builds no kernel; ``torch_profile``
   writes a trace; seconds a window with obs off and on, in turns.
7. ``[fl-serve]``: ``Federation.serve`` on the same federation: the
   sequential bridge (vafl, afl, fedasync) bit-equal to ``run(mode=
   "event")`` with the same kernel launches; thread workers (vafl, afl:
   events/s, the card's busy share, byte ledgers reconciled, one encode
   an accepted upload); a bridge checkpoint resume; two tenants from one
   ``MultiTenantServer``; then 7 threads x 20 concurrent encodes, each
   bit-equal to the plain route of its input.  The event runs the
   bridge is held against run before the phase's launch counts are set
   to 0, so ``fl_serve_launches`` counts served runs alone.
8. ``[figures]``: the paper's Fig. 4 (experiments a-d), Fig. 5/6 and
   the value ablation (experiment d) at 3 rounds on the card, each
   printing its CSV.
9. Serving, ``repro_torch.launch.serve.serve``, for starcoder2_3b and
   rwkv6_3b at their full published configurations (random weights from
   a seed): 4 prompts of 2048 tokens, 32 greedy tokens each (kernels
   flash_attention and linear_scan in the prefill), then a prefill of
   128 tokens held against 128 stepwise decode steps.

Run it from the root of a checkout:

    python3 chip_smoke.py

Before the main paths it counts the tensor-core instructions (HMMA,
HGMMA) in each kernel's compiled functions (``cuobjdump -sass`` from
nvcc's toolkit) and fails if a bf16 route of flash_attention or
linear_scan has none.  It holds the topk_int8 encode bit-exact against
its plain route on the CNN's and the MLP's trees, on each side of the
resident route's limit, at 2^24 + 123 elements, on a tie-heavy input
and on one whose k-th magnitude is 0, and the tree-level grad_diff_norm
call against its plain version on the CNN's 22 stacked leaves, counting
the CUDA kernels each call launches (``torch.profiler``).

It exits non-zero, and prints no result, when a phase fails, when no
CUDA device is visible, or when it is not inside a checkout.  The last
line of its output is one JSON object naming the device; the line
before it is the card's name and power limit (``nvidia-smi``), and the
line before that the per-kernel JSON (launches, max error, times,
bound; ``event_*`` fields for the event path, ``batched_launches``
for the batched engine, ``round_scenario_launches``,
``checkpoint_launches``, ``obs_launches``, ``fl_serve_launches`` and
``figures_launches`` for the later paths).  It imports neither JAX
nor the JAX package.
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
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 on the tensor cores
TF32_OPS_PER_S = 495e12          # H100 SXM dense TF32 on the tensor cores
GD_SHAPES = [(7, 42698), (1, 2 ** 24 + 123)]   # main path: 7 clients x CNN params
TQ_SIZES = [42698, 2 ** 24 + 123]
RESIDENT_LIMIT = 8 * 13312 * 4   # elements of one leaf the encode's resident route takes
PROFILER_TRIES = 10              # readings of one call before an empty profile fails
# tree_grad_diff_sq_norm cases: (leaves, W); the CNN at W = 7 is a round's
# call, at W = 1 an event's
GRAD_TREES = [("cnn", 7), ("cnn1", 1), ("one", 1)]
# encode cases: (leaf layout, input); the first is the main path's update
ENC_CASES = [("cnn", "randn"), ("mlp", "randn"), ("one", RESIDENT_LIMIT),
             ("one", RESIDENT_LIMIT + 1), ("one", 2 ** 24 + 123), ("cnn", "ties"),
             ("cnn", "sparse"), ("big", "ties"), ("big", "sparse")]
TQ_OPS_PER_ELEM = 24             # 10 hash + 14 float/convert/select ops (csrc/topk_quant.cu)
# flash_attention cases: (B, S, H, KV, hd, window, dtype); the first is
# starcoder2_3b's prefill in serve(batch=4, prompt_len=2048), window 4096;
# then a ragged S, a window shorter than S, fp32, and a large shape
FA_CASES = [(4, 2048, 24, 2, 128, 4096, "bfloat16"), (4, 1000, 24, 2, 128, 4096, "bfloat16"),
            (4, 2048, 24, 2, 128, 256, "bfloat16"), (2, 1024, 24, 2, 128, None, "float32"),
            (4, 4096, 24, 2, 128, 4096, "bfloat16")]
FA_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# linear_scan cases: (B, S, H, K, V, form, la); the first is rwkv6_3b's
# prefill in serve(batch=4, prompt_len=2048): bf16 r/k/v, fp32 log-decay, u;
# then the Mamba2 form, a ragged S, decay at the clamp, a large shape, and
# batches of 1 (40 (b, h): split in two V slices) and 3 (120: one an SM)
LS_CASES = [(4, 2048, 40, 64, 64, "rwkv", "model"), (4, 2048, 40, 64, 64, "mamba", "model"),
            (4, 1000, 40, 64, 64, "rwkv", "model"), (4, 2048, 40, 64, 64, "rwkv", "clamp"),
            (8, 4096, 40, 64, 64, "rwkv", "model"), (1, 2048, 40, 64, 64, "rwkv", "model"),
            (3, 2048, 40, 64, 64, "rwkv", "model")]
LS_TOL = {"y": 3e-2, "state": 2e-4}
LS_CHUNK = 32                    # rwkv6_3b's chunk of the TPU kernel's chunked form
# what each kernel route is built from (csrc/*.cu)
DESIGN = {("flash_attention", "bfloat16"): "mma.sync m16n8k16 bf16, cp.async 2-stage K/V ring, "
                                           "128-query x 64-key tiles (8 warps x 16 rows), Q and P "
                                           "in registers, raw-score softmax on ex2.approx",
          ("flash_attention", "float32"): "fp32 FMA on the CUDA cores, 64 x 64 tiles",
          ("grad_diff_norm", "float32"): "one launch over a table of stacked leaves, 16-byte "
                                         "loads inside a leaf, the last block of a row sums its "
                                         "partials (integer ticket), no float atomics",
          ("topk_int8_encode", "resident"): "one launch: a cluster of up to 8 CTAs stages the update "
                                            "in shared memory (cp.async), radix select 11/10/10 bits, "
                                            "count, quantize, compact; merged through distributed "
                                            "shared memory",
          ("topk_int8_encode", "streaming"): "five launches: two histogram passes over the "
                                             "update (integer atomics, last block selects; the "
                                             "second gathers the candidate keys), a third and a "
                                             "count over the candidates, a quantize-and-compact "
                                             "pass",
          ("topk_quant", "float32"): "one elementwise pass, four elements a thread, counter-based "
                                     "hash",
          ("linear_scan", "bfloat16"): "chunks of 32 factored at 16 and 8 steps (no exponent > 0), "
                                       "mma.sync m16n8k16 bf16 with hi/lo splits, 8 x 8 diagonal "
                                       "blocks as running decay products, cp.async 2-stage, "
                                       "a block per (b, h), or per (32-column V slice, b, h) "
                                       "where 2 B H blocks fit one an SM"}
# the functions of each bf16 route in the compiled library (nvcc's names)
TC_FUNCS = {"flash_attention": "flash_fwd_bf16", "linear_scan": "scan_bf16"}
SERVE = dict(batch=4, prompt_len=2048, gen=32)
CONSISTENCY_LEN = 128            # prefill vs stepwise decode at full width


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


def bound_ms(nbytes: float, nops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    """The least time for the work: the larger of its bytes over the HBM rate
    and its operations over the peak rate of their type, and which it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from repro_torch.kernels import build
    t0 = time.time()
    logs = build.build()
    say(f"[build] {len(logs)} kernels built for sm_90a in {time.time() - t0:.1f} s "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    names = _demangle([line.split("'")[1] for log in logs.values() for line in log.splitlines()
                       if "Compiling entry function" in line])
    for name, log in logs.items():
        fn = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = names[line.split("'")[1]] + ": "
            elif "registers" in line or "smem" in line or "spill" in line:
                say(f"[build] {name}: {fn}{line.replace('ptxas info    :', '').strip()}")


def _demangle(mangled: list) -> dict:
    """nvcc's mangled function names through the toolkit's ``cu++filt``
    (which names the anonymous namespace ``<unnamed>``)."""
    from repro_torch.kernels import build
    if not mangled:
        return {}
    tool = Path(build.nvcc_path()).parent / "cu++filt"
    out = subprocess.run([str(tool), *mangled], capture_output=True, text=True, timeout=60,
                         stdin=subprocess.DEVNULL)
    plain = out.stdout.splitlines()
    if out.returncode != 0 or len(plain) != len(mangled):
        fail(f"cu++filt: exit {out.returncode}, {len(plain)} names for {len(mangled)}: "
             f"{out.stderr[-2000:]}")
    return {m: d.replace("<unnamed>::", "") for m, d in zip(mangled, plain)}


def phase_sass() -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in every function of the
    flash_attention and linear_scan libraries, read with ``cuobjdump
    -sass`` from nvcc's toolkit; fails if a bf16 route has none."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    counts = {}
    for name, bf16_fn in TC_FUNCS.items():
        out = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            fail(f"cuobjdump -sass {name}: exit {out.returncode}: {out.stderr[-2000:]}")
        per_fn, fn = {}, None
        for line in out.stdout.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                per_fn[fn] = 0
            elif fn is not None and ("HMMA" in line or "HGMMA" in line):
                per_fn[fn] += 1
        tc = {f: n for f, n in per_fn.items() if bf16_fn in f}
        if not tc or min(tc.values()) == 0:
            fail(f"{name}: no tensor-core instruction in its bf16 route ({per_fn})")
        counts[name] = sum(tc.values())
        plain = _demangle(list(per_fn))
        say(f"[sass] {name}: tensor-core instructions (HMMA/HGMMA): "
            + ", ".join(f"{plain[f]} {n}" for f, n in per_fn.items()))
    return counts


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
                "shape": [w, p], "dtype": "float32",
                "design": DESIGN[("grad_diff_norm", "float32")], "max_abs_err": err,
                "max_rel_err": rel,
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
            "shape": [n], "dtype": "float32", "design": DESIGN[("topk_quant", "float32")],
            "max_abs_err": err,
            "ms": cuda_ms(lambda: ops.topk_quant(x, thr, scale, 7)),
            "plain_ms": cuda_ms(lambda: ref.topk_quant(x, thr, scale, 7)),
            "bound_ms": bms, "bound_by": bby, "library_ms": None, "library_call": None}


def device_activity(fn) -> dict:
    """What one call of ``fn`` ran on the card, from ``torch.profiler``:
    {"kernels": [[name, device us], ...], "copies": [[name, us], ...]} in
    launch order, with the names the profiler gives them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, copies = [], []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            (copies if e.name.startswith(("Memcpy", "Memset")) else kernels).append(
                [e.name, e.time_range.elapsed_us()])
    return {"kernels": kernels, "copies": copies}


def _device_kernels(fn, expected: int, what: str) -> dict:
    """``device_activity`` of one call of ``fn``.  A reading with no
    kernel at all (the profiler now and then drops a call's records, on
    a loaded host three times running) is taken again, up to
    ``PROFILER_TRIES`` times; a reading of another number of CUDA kernels
    than ``expected`` fails, and so do that many empty ones."""
    for _ in range(PROFILER_TRIES):
        act = device_activity(fn)
        if act["kernels"]:
            if len(act["kernels"]) != expected:
                fail(f"{what}: {len(act['kernels'])} CUDA kernels a call, expected "
                     f"{expected}: {act}")
            return act
    fail(f"{what}: the profiler recorded no CUDA kernel in {PROFILER_TRIES} calls")


def _leaf_shapes(model: str) -> list:
    """The leaves of the port's CNN or MLP in tree-flatten order."""
    import torch
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.models.cnn import CNNConfig, MLPConfig, cnn_init, mlp_init
    init = {"cnn": lambda g: cnn_init(CNNConfig(), g), "mlp": lambda g: mlp_init(MLPConfig(), g)}
    return [tuple(x.shape) for x in tree_leaves(init[model](torch.Generator()))]


def _encode_tree(layout, what, gen) -> dict:
    """An update on the card: one leaf of ``what`` randn elements, or the
    CNN's or MLP's leaves, or one leaf of 2^20 + 3 elements (the
    streaming route), filled with randn, a tie-heavy draw
    (randint(-3, 4) / 4) or a sparse one (3 % nonzero: the k-th magnitude
    at frac 0.1 is 0)."""
    import torch
    if layout == "one":
        return {"x": torch.randn(what, generator=gen, device="cuda")}
    tree = {}
    shapes = [(2 ** 20 + 3,)] if layout == "big" else _leaf_shapes(layout)
    for i, shape in enumerate(shapes):
        if what == "randn":
            x = torch.randn(shape, generator=gen, device="cuda")
        elif what == "ties":
            x = torch.randint(-3, 4, shape, generator=gen, device="cuda").float() / 4
        else:
            x = torch.randn(shape, generator=gen, device="cuda")
            x = x * (torch.rand(shape, generator=gen, device="cuda") < 0.03)
        tree[f"p{i:02d}"] = x
    return tree


def phase_encode(rows: dict):
    """The topk0.1_int8 encode on the card (``TopKQuantCodec.encode``, one
    wrapper call of ``topk_int8_encode``) against its plain route
    (``use_kernel=False``: torch.topk, the plain quantization,
    torch.nonzero), bit for bit, with its time (``ms``: the whole call,
    host copy of the planes included; ``device_ms``: its launches alone,
    ``encode_on_device``), the CUDA kernels one call launches, and its
    bytes bound (4n read, 5 a kept entry + 4 written)."""
    import torch
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.compress.composed import TopKQuantCodec
    from repro_torch.kernels.topk_quant import ops
    gen = torch.Generator(device="cuda").manual_seed(4)
    codec, plain = TopKQuantCodec(0.1), TopKQuantCodec(0.1, use_kernel=False)
    for layout, what in ENC_CASES:
        tree = _encode_tree(layout, what, gen)
        leaves = tree_leaves(tree)
        n = sum(x.numel() for x in leaves)
        case = f"{layout} {what}" + (f" ({len(leaves)} leaves, n = {n})" if layout != "one" else "")
        before = ops.launches
        got = codec.encode(tree, seed=0x5EED)
        calls = ops.launches - before
        want = plain.encode(tree, seed=0x5EED)
        for plane in ("idx", "val"):
            if not (got.planes[plane].dtype == want.planes[plane].dtype
                    and got.planes[plane].shape == want.planes[plane].shape
                    and (got.planes[plane] == want.planes[plane]).all()):
                fail(f"topk_int8 encode {case}: {plane} plane differs from the plain route")
        if got.nbytes != want.nbytes or got.meta["scale"] != want.meta["scale"]:
            fail(f"topk_int8 encode {case}: nbytes/scale {got.nbytes}/{got.meta['scale']} vs "
                 f"{want.nbytes}/{want.meta['scale']} on the plain route")
        if calls != 1:
            fail(f"topk_int8 encode {case}: {calls} wrapper calls for one encode")
        dval = got.planes["val"].astype("int32") - want.planes["val"].astype("int32")
        err = max(abs(got.meta["scale"] - want.meta["scale"]), int(abs(dval).max(initial=0)))
        kept, k = len(got.planes["idx"]), ops.encode_k(0.1, n)
        route, size = ops.encode_route([x.numel() for x in leaves])
        act = _device_kernels(lambda: codec.encode(tree, seed=0x5EED),
                              ops.cuda_launches_per_encode([x.numel() for x in leaves]),
                              f"topk_int8 encode {case}")
        say(f"[check] topk_int8 encode {case}: idx/val planes, scale and nbytes bit-exact "
            f"({got.nbytes} bytes, {kept} kept of k = {k}); route {route} "
            f"({size} {'CTAs' if route == 'resident' else 'blocks'}), device work a call "
            f"(name, us): {act}")
        big = n > RESIDENT_LIMIT
        bms, bby = bound_ms(4 * n + 5 * kept + 4, 0)
        rows[(layout, what)] = {
            "name": "topk_int8_encode", "route": "cuda",
            "source": "src/repro_torch/csrc/topk_quant.cu",
            "replaces": "src/repro/compress/composed.py:42 (topk_threshold_scale, topk_quant_2d, "
                        "np.flatnonzero)",
            "case": case, "elements": n, "kept": kept, "k": k, "encode_route": route,
            "max_abs_err": float(err),
            "design": DESIGN[("topk_int8_encode", route)],
            "cuda_launches_per_call": len(act["kernels"]),
            "device_activity": act,
            "ms": cuda_ms(lambda: codec.encode(tree, seed=3), *((20, 3) if big else (200, 20))),
            "device_ms": cuda_ms(lambda: ops.encode_on_device(leaves, 0.1, 3),
                                 *((20, 3) if big else (200, 20))),
            "plain_ms": cuda_ms(lambda: plain.encode(tree, seed=3), *((10, 2) if big else (50, 5))),
            "bound_ms": bms, "bound_by": bby}
        row = rows[(layout, what)]
        row["bound_share"], row["device_bound_share"] = bms / row["ms"], bms / row["device_ms"]


def _stacked_pair(layout: str, w: int, gen) -> tuple:
    """Two stacked fp32 trees on the card, W = ``w`` rows of the CNN's
    leaves ("cnn", "cnn1") or of one 2^24 + 123 leaf."""
    import torch
    shapes = _leaf_shapes("cnn") if layout.startswith("cnn") else [(2 ** 24 + 123,)]
    return tuple({f"p{i:02d}": torch.randn((w,) + s, generator=gen, device="cuda")
                  for i, s in enumerate(shapes)} for _ in range(2))


def phase_grad_tree(rows: dict):
    """``tree_grad_diff_sq_norm``, the call the main path makes, on
    stacked trees with the CNN's 22 leaf shapes at W = 7 (a round's call;
    fp32, bf16) and W = 1 (an event's), and on one 2^24 + 123 leaf at
    W = 1, against the plain version
    (``flatten_stacked`` + ``ref``): rtol 1e-5 / 1e-3, bit-identical on
    rerun, one wrapper call and the CUDA kernels it launched."""
    import torch
    from repro_torch.kernels.grad_diff_norm import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(5)
    for layout, w in GRAD_TREES:
        a32, b32 = _stacked_pair(layout, w, gen)
        p = sum(x[0].numel() for x in a32.values())
        for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-3)):
            a = {k: x.to(dtype) for k, x in a32.items()}
            b = {k: x.to(dtype) for k, x in b32.items()}
            before = ops.launches
            got, again = ops.tree_grad_diff_sq_norm(a, b), ops.tree_grad_diff_sq_norm(a, b)
            calls = ops.launches - before
            want = ref.grad_diff_sq_norm_2d(ops.flatten_stacked(a), ops.flatten_stacked(b))
            torch.cuda.synchronize()
            rel = float(((got - want).abs() / want.abs()).max())
            case = f"{len(a32)} stacked leaves, W = {w}, P = {p}, {str(dtype)[6:]}"
            if not torch.allclose(got, want, rtol=rtol, atol=0):
                fail(f"tree_grad_diff_sq_norm {case}: rel err {rel:.3g} > rtol {rtol}")
            if not torch.equal(got, again):
                fail(f"tree_grad_diff_sq_norm {case}: two runs differ")
            if calls != 2:
                fail(f"tree_grad_diff_sq_norm {case}: {calls} wrapper calls for two calls")
            act = _device_kernels(lambda: ops.tree_grad_diff_sq_norm(a, b), 1,
                                  f"tree_grad_diff_sq_norm {case}")
            say(f"[check] tree_grad_diff_sq_norm {case}: max rel err {rel:.3g} (rtol {rtol}), "
                f"reruns bit-identical, CUDA kernels a call: {act['kernels']}")
            esize = 4 if dtype == torch.float32 else 2
            bms, bby = bound_ms(2 * w * p * esize + w * 4, 3 * w * p)
            rows[(layout, str(dtype)[6:])] = {
                "case": case, "cuda_launches_per_call": len(act["kernels"]),
                "ms": cuda_ms(lambda: ops.tree_grad_diff_sq_norm(a, b)),
                "plain_ms": cuda_ms(lambda: ref.grad_diff_sq_norm_2d(ops.flatten_stacked(a),
                                                                     ops.flatten_stacked(b))),
                "bound_ms": bms, "bound_by": bby}


def _pairs(S: int, window) -> int:
    """Causal (query, key) pairs of one head: key s <= query t, t - s < window."""
    w = S if window is None else min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def phase_flash_attention(rows: list):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(2)
    for B, S, H, KV, hd, window, dtype in FA_CASES:
        dt = getattr(torch, dtype)
        q = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dt)
        got = ops.gqa_flash_attention(q, k, v, window=window)
        want = ref.gqa_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        tol = FA_TOL[dtype]
        err = float((got.float() - want.float()).abs().max())
        case = f"(B {B}, S {S}, H {H}, KV {KV}, hd {hd}, window {window}) {dtype}"
        if not (bool(torch.isfinite(got).all())
                and torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)):
            fail(f"flash_attention {case}: max abs err {err:.3g} beyond rtol = atol = {tol}")
        say(f"[check] flash_attention {case}: max abs err {err:.6g} (rtol = atol = {tol})")
        esize = got.element_size()
        nbytes = B * S * (2 * H + 2 * KV) * hd * esize      # q, k, v read, o written
        nops = 4 * hd * _pairs(S, window) * B * H           # q.k and p.v, 2 ops a multiply-add
        bms, bby = bound_ms(nbytes, nops, BF16_OPS_PER_S if dtype == "bfloat16" else FP32_OPS_PER_S)
        causal_only = window is None or window >= S         # the function SDPA computes
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = (cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                              enable_gqa=True), 20, 3)
               if causal_only else None)
        rows.append({
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:68",
            "shape": [B, S, H, KV, hd], "window": window, "dtype": dtype,
            "design": DESIGN[("flash_attention", dtype)], "max_abs_err": err, "tol": tol,
            "ms": cuda_ms(lambda: ops.gqa_flash_attention(q, k, v, window=window), 20, 3),
            "plain_ms": cuda_ms(lambda: ref.gqa_attention(q, k, v, window=window), 10, 2),
            "bound_ms": bms, "bound_by": bby, "bound_bytes": nbytes, "bound_ops": nops,
            "library_ms": lib,
            "library_call": ("F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)"
                             if causal_only else None)})
        del q, k, v, got, want
    torch.cuda.empty_cache()


def _linear_scan_ops(B, S, H, K, V) -> int:
    """Operations of the TPU kernel's chunked form, which runs as matrix
    products (fp32-class, so at the TF32 tensor-core rate): per chunk of C
    steps and (b, h), the causal C x C scores against K and their product
    with V, the chunk's end state and its readout against the state (C K V
    multiply-adds each); 2 operations a multiply-add."""
    C = LS_CHUNK
    per_chunk = C * (C + 1) // 2 * (K + V) + 2 * C * K * V
    return 2 * per_chunk * B * H * -(-S // C)


def phase_linear_scan(rows: list):
    import torch
    from repro_torch.kernels.linear_scan import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(3)
    for B, S, H, K, V, form, la_kind in LS_CASES:
        bf = torch.bfloat16
        q = torch.randn(B, S, H, K, generator=gen, device="cuda").to(bf)
        k = torch.randn(B, S, H, K, generator=gen, device="cuda").to(bf)
        v = torch.randn(B, S, H, V, generator=gen, device="cuda").to(bf)
        if la_kind == "model":   # rwkv6's -exp(w0 + lora) around w0 = -0.6
            la = -torch.exp(0.5 * torch.randn(B, S, H, K, generator=gen, device="cuda") - 0.6)
        else:                    # a fifth of the entries below the clamp at -8
            la = -10.0 * torch.rand(B, S, H, K, generator=gen, device="cuda")
        u = ((torch.rand(H, K, generator=gen, device="cuda") - 0.5) if form == "rwkv" else None)
        cur = form == "mamba"
        y, st = ops.recurrence(q, k, v, la, u, include_current=cur)
        wy, ws = ref.recurrence(q, k, v, la, u, include_current=cur)
        torch.cuda.synchronize()
        err_y = float((y.float() - wy.float()).abs().max())
        err_s = float((st - ws).abs().max())
        case = f"(B {B}, S {S}, H {H}, K {K}, V {V}) {form} form, la {la_kind}, bf16 q/k/v"
        if not (bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
                and torch.allclose(y.float(), wy.float(), rtol=LS_TOL["y"], atol=LS_TOL["y"])
                and torch.allclose(st, ws, rtol=LS_TOL["state"], atol=LS_TOL["state"])):
            fail(f"linear_scan {case}: max abs err y {err_y:.3g}, final state {err_s:.3g} "
                 f"beyond {LS_TOL}")
        say(f"[check] linear_scan {case}: max abs err y {err_y:.6g} (rtol = atol = "
            f"{LS_TOL['y']}), final state {err_s:.6g} (rtol = atol = {LS_TOL['state']})")
        nbytes = (B * S * H * (2 * K * 2 + V * 2 + K * 4 + V * 2)   # q, k, v, la read; y written
                  + (H * K * 4 if u is not None else 0) + B * H * K * V * 4)
        nops = _linear_scan_ops(B, S, H, K, V)
        bms, bby = bound_ms(nbytes, nops, TF32_OPS_PER_S)
        rows.append({
            "name": "linear_scan", "route": "cuda", "source": "src/repro_torch/csrc/linear_scan.cu",
            "replaces": "src/repro/kernels/linear_scan/kernel.py:78",
            "shape": [B, S, H, K, V], "form": form, "la": la_kind, "dtype": "bfloat16",
            "design": DESIGN[("linear_scan", "bfloat16")],
            "max_abs_err": max(err_y, err_s), "max_abs_err_y": err_y, "max_abs_err_state": err_s,
            "ms": cuda_ms(lambda: ops.recurrence(q, k, v, la, u, include_current=cur), 20, 3),
            "plain_ms": cuda_ms(lambda: ref.recurrence(q, k, v, la, u, include_current=cur), 3, 1),
            "bound_ms": bms, "bound_by": bby, "bound_bytes": nbytes, "bound_ops": nops,
            "library_ms": None, "library_call": None})
        del q, k, v, la, y, wy
    torch.cuda.empty_cache()


def _reset_launches():
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.grad_diff_norm import ops as gd
    from repro_torch.kernels.linear_scan import ops as ls
    from repro_torch.kernels.topk_quant import ops as tq
    mods = {"grad_diff_norm": gd, "topk_quant": tq, "flash_attention": fa, "linear_scan": ls}
    for m in mods.values():
        m.launches = 0
    return lambda: {name: m.launches for name, m in mods.items()}


def _prefill_vs_stepwise(cfg, params) -> tuple:
    """Last-position logits of one prefill of CONSISTENCY_LEN tokens (the
    kernel path) against as many decode_step calls (plain PyTorch):
    (max abs difference, scale = max |stepwise logits|)."""
    import numpy as np
    import torch
    from repro_torch.models import decoder
    L = CONSISTENCY_LEN
    prompt = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=(2, L))).to("cuda")
    with torch.no_grad():
        lp, _, _ = decoder.prefill(cfg, params, prompt, L)
        cache = decoder.init_cache(cfg, params, 2, L)
        for t in range(L):
            ls, cache = decoder.decode_step(cfg, params, cache, prompt[:, t:t + 1], t)
    if not (bool(torch.isfinite(lp).all()) and bool(torch.isfinite(ls).all())):
        fail(f"{cfg.name}: non-finite logits in prefill or decode_step")
    return float((lp.float() - ls.float()).abs().max()), float(ls.float().abs().max())


def phase_serve(arch: str, kernel: str, check_dtype: str) -> dict:
    """serve() at the architecture's full configuration, then a full-width
    check of prefill (the kernel path) against stepwise decode (plain
    PyTorch), gated at 2e-2 of the logits' scale in ``check_dtype``."""
    import torch
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.launch.serve import serve
    from repro_torch.models import decoder
    from repro_torch.models.registry import get_config

    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    h0 = time.perf_counter()
    params = decoder.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    say(f"[serve] {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} heads "
        f"({cfg.num_kv_heads} kv) of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: "
        f"{sum(x.numel() for x in tree_leaves(params))} parameters drawn in "
        f"{cfg.param_dtype} in {time.perf_counter() - h0:.1f} s")

    def check(p):
        err, scale = _prefill_vs_stepwise(cfg.replace(compute_dtype=check_dtype), p)
        say(f"[serve] {arch}: prefill of {CONSISTENCY_LEN} tokens vs {CONSISTENCY_LEN} "
            f"decode_step calls at full width, {check_dtype} compute: last-position logits "
            f"max abs diff {err:.4g} of scale {scale:.4g} ({err / scale:.3g}; limit 2e-2)")
        if not err <= 2e-2 * scale:
            fail(f"{arch}: prefill vs stepwise decode {err:.4g} apart, beyond 2e-2 x {scale:.4g}")

    if check_dtype == "float32":
        check(params)
    params = decoder.cast_params(cfg, params)       # once; the fp32 draws are freed here
    leaves = tree_leaves(params)
    say(f"[serve] {arch}: cast to {cfg.compute_dtype}: "
        f"{sum(x.numel() * x.element_size() for x in leaves) / 1e9:.3f} GB on the card")
    serve(arch, smoke=False, batch=SERVE["batch"], prompt_len=SERVE["prompt_len"], gen=2,
          params=params, verbose=False)            # warm-up: cuBLAS handles, allocator
    stats = {}
    read = _reset_launches()
    toks = serve(arch, smoke=False, **SERVE, params=params, stats=stats, verbose=False)
    launches = read()                               # read just after the main path
    if not stats["logits_finite"]:
        fail(f"{arch}: non-finite logits in serve()")
    if toks.shape != (SERVE["batch"], SERVE["gen"]) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"{arch}: serve() returned tokens of shape {toks.shape} in "
             f"[{toks.min()}, {toks.max()}]")
    want = {k: (cfg.num_layers if k == kernel else 0) for k in launches}
    if launches != want:
        fail(f"{arch}: kernel launches {launches}, expected {want} (one {kernel} per layer "
             f"in the prefill, none in decode)")
    say(f"[serve] {arch}: serve(batch={SERVE['batch']}, prompt_len={SERVE['prompt_len']}, "
        f"gen={SERVE['gen']}): prefill {stats['prefill_s']:.4f} s, decode {stats['decode_s']:.4f} s "
        f"({stats['decode_tok_per_s']:.2f} tok/s), logits finite, kernel launches {launches}, "
        f"sample {toks[0, :8].tolist()}")
    if check_dtype == "bfloat16":
        check(params)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params, leaves
    torch.cuda.empty_cache()
    return dict(stats, launches=launches[kernel], peak_gb=peak)


def algo1_federation(device: str = "cuda", init=None):
    """The main path's federation: the CNN, 7 clients of 1,000
    synthetic-MNIST samples on the paper's non-IID partition,
    topk0.1_int8, vafl, on the card (or on ``device``).  ``init`` (a
    parameter tree) replaces the initial model drawn from the run's
    generator, whose draws differ between the card and the CPU."""
    from repro_torch.core.client import LocalSpec
    from repro_torch.core.federation import Federation
    from repro_torch.data.partition import paper_noniid_partition
    from repro_torch.data.synthetic import synthetic_mnist
    from repro_torch.models.cnn import CNNConfig, cnn_forward
    xtr, ytr, xte, yte = synthetic_mnist(7000, 2000, seed=0)
    data = paper_noniid_partition(xtr, ytr, 7, samples_per_client=1000, seed=0)
    model = "cnn" if init is None else (cnn_forward, lambda cfg, gen: init, CNNConfig())
    return Federation(model=model, data=data, test_data=(xte, yte), algorithm="vafl",
                      compressor="topk0.1_int8",
                      local=LocalSpec(batch_size=32, local_epochs=1, local_rounds=1, lr=0.1),
                      device=device)


def phase_main_path():
    import torch
    from repro_torch.common.pytree import count_params, tree_leaves
    from repro_torch.core.metrics import ccr
    from repro_torch.kernels.grad_diff_norm import ops as gd_ops
    from repro_torch.kernels.topk_quant import ops as tq_ops

    fed = algo1_federation()
    say(f"[main] 7 clients, samples {fed.data.counts.tolist()} (paper non-IID), "
        f"test 2000, CNNConfig() channels (16, 32) x 2 blocks")
    seen = {}
    ev = fed.evaluate_fn

    def capture(p):
        seen["params"] = p
        return ev(p)
    fed.evaluate_fn = capture
    fed.run(rounds=1)      # warm-up: kernel libraries loaded
    torch.cuda.synchronize()

    read = _reset_launches()
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
    counts = read()                              # read just after the main path
    total = (counts["grad_diff_norm"], counts["topk_quant"])
    if counts["flash_attention"] or counts["linear_scan"]:
        fail(f"Algorithm 1 launched a serving kernel: {counts}")
    vafl, afl = runs["vafl"][0], runs["afl"][0]
    say(f"[main] count CCR vafl vs afl: {ccr(afl.comm.model_uploads, vafl.comm.model_uploads):.4f}")
    if vafl.comm.model_uploads > afl.comm.model_uploads:
        fail(f"vafl uploaded more than afl ({vafl.comm.model_uploads} > "
             f"{afl.comm.model_uploads})")
    if total[0] <= 0 or total[1] <= 0:
        fail(f"a kernel of the main path never launched: grad_diff_norm {total[0]}, "
             f"topk_quant {total[1]}")
    # one grad_diff_norm call per vafl round (W = 7 values at once), none
    # for afl; one topk_int8 encode call per accepted upload
    if launches["vafl"][0] != 3 or launches["afl"][0] != 0:
        fail(f"grad_diff_norm launches {launches}, expected 3 for vafl and 0 for afl")
    if total[1] != vafl.comm.model_uploads + afl.comm.model_uploads:
        fail(f"topk_int8 encode calls {total[1]} != accepted uploads")
    return total, {alg: secs for alg, (_, secs) in runs.items()}


EVENT_RUNS = [("vafl", None), ("afl", None), ("eaflm", None), ("fedavg", None),
              ("vafl", "mobile_fleet")]


def busy_share(fn) -> tuple:
    """One profiled call of ``fn`` (``torch.profiler``): its CUDA kernels'
    summed device time over the call's synchronized host time, the
    number of kernels, the host seconds and ``top``: (name, launches,
    device ms) of the kernels that took the most device time.  A reading
    with no kernel at all is taken again, up to ``PROFILER_TRIES`` times;
    that many empty ones fail."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - h0
        kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and not e.name.startswith(("Memcpy", "Memset"))]
        if kernels:
            by_name = {}
            for name, us in kernels:
                n, t = by_name.get(name, (0, 0.0))
                by_name[name] = (n + 1, t + us)
            top = sorted(((name[:60], n, t / 1e3) for name, (n, t) in by_name.items()),
                         key=lambda row: -row[2])[:6]
            return sum(us for _, us in kernels) / 1e6 / wall, len(kernels), wall, top
    fail(f"the profiler recorded no CUDA kernel in {PROFILER_TRIES} profiled runs")


def host_ms(fn, reps: int = 5) -> float:
    """Mean host milliseconds of ``fn`` over ``reps`` synchronized calls,
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - h0) / reps * 1e3


def event_breakdown(fed) -> dict:
    """Host milliseconds (synchronized) of each step of one vafl event of
    ``run_event_driven``, called as the loop calls it, on client 0 of the
    main path's federation: the local update of a size-1 stack, the
    client's eval, the Eq. 1 value (the W = 1 grad_diff_norm call and the
    amplifier), the topk0.1_int8 upload (encode with error feedback) and
    the async mix."""
    import torch
    from repro_torch.common.pytree import stacked_index, tree_broadcast, tree_bytes, tree_map
    from repro_torch.core.client import make_local_update
    from repro_torch.core.metrics import CommStats
    from repro_torch.core.runtimes import common
    cfg, dev = fed.config, fed.device
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tree_map(lambda x: x.to(dev), fed.init_params_fn(gen))
    update = make_local_update(fed.loss_fn, cfg.local)
    data = {"images": torch.as_tensor(fed.data.images[:1], device=dev),
            "labels": torch.as_tensor(fed.data.labels[:1], device=dev).long(),
            "mask": torch.as_tensor(fed.data.mask[:1], device=dev)}
    one = tree_broadcast(params, 1)
    newp_s, eff_s, _ = update(one, data, gen, 0, clients=[0])
    newp = stacked_index(newp_s, 0)
    batch_eval, values_fn, _ = common._event_helpers(cfg, fed.evaluate_fn, common._value_fn(cfg))
    accs = batch_eval(newp_s)
    prev = tree_map(torch.zeros_like, eff_s)
    codec, _, ef = common._make_codecs(cfg)
    comm = CommStats(model_bytes=tree_bytes(params))
    aggregator = cfg.make_algorithm()[2]
    steps = {"local update": lambda: update(one, data, gen, 0, clients=[0]),
             "client eval": lambda: batch_eval(newp_s),
             "value": lambda: float(values_fn(prev, eff_s, accs)[0]),
             "upload encode": lambda: common._compressed_upload(codec, ef, comm, params, newp,
                                                                0, 1),
             "async mix": lambda: aggregator.mix(params, newp, 0.25)}
    return {name: host_ms(fn) for name, fn in steps.items()}


def phase_event_path():
    """``Federation.run(rounds=3, mode="event")`` on the main path's
    federation: the sequential event loop for vafl, afl and eaflm (21
    events each), fedavg's round barrier (3 rounds of 7 clients), and
    vafl again under ``scenario="mobile_fleet"``.  grad_diff_norm must
    launch once per vafl event (a W = 1 call) and never otherwise, the
    topk_int8 encode once per accepted upload, and no serving kernel."""
    import torch
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.kernels.grad_diff_norm import ops as gd_ops
    from repro_torch.kernels.topk_quant import ops as tq_ops

    fed = algo1_federation()
    seen = {}
    ev = fed.evaluate_fn

    def capture(p):
        seen["params"] = p
        return ev(p)
    fed.evaluate_fn = capture
    fed.run(rounds=1, mode="event")     # warm-up: 7 vafl events
    torch.cuda.synchronize()

    read = _reset_launches()
    runs = {}
    for alg, scenario in EVENT_RUNS:
        g0, t0 = gd_ops.launches, tq_ops.launches
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        res = fed.run(rounds=3, mode="event", algorithm=alg, scenario=scenario)
        torch.cuda.synchronize()
        secs = time.perf_counter() - h0
        gd, tq = gd_ops.launches - g0, tq_ops.launches - t0
        name = alg + (f"@{scenario}" if scenario else "")
        runs[name] = (res, secs, gd, tq)
        if name == "vafl":   # the batched phase's W = 1 run is held against it
            vafl_params = [x.detach().clone() for x in tree_leaves(seen["params"])]
        if not all(bool(torch.isfinite(x).all()) for x in tree_leaves(seen["params"])):
            fail(f"event {name}: non-finite global parameters")
        for r in res.records:
            if not 0.0 <= r.global_acc <= 1.0:
                fail(f"event {name}: accuracy {r.global_acc} out of [0, 1]")
        steps = res.records[-1].round         # events, or barrier rounds for fedavg
        unit = "round" if alg == "fedavg" else "event"
        if steps != (3 if alg == "fedavg" else 3 * len(fed.data.counts)):
            fail(f"event {name}: the last record is at {unit} {steps}")
        say(f"[event] {name}: {steps} {unit}s, model_uploads {res.comm.model_uploads}, "
            f"scalar_reports {res.comm.scalar_reports}, uplink bytes {res.comm.uplink_bytes}, "
            f"downlink bytes {res.comm.downlink_bytes}, sim_time {res.sim_time:.6f}, "
            f"idle_fraction {res.idle_fraction:.6f}, best acc {res.best_acc:.4f}, "
            f"{secs:.4f} s host ({secs / steps:.4f} s per {unit}, synchronized), kernel "
            f"launches grad_diff_norm {gd}, topk_quant {tq}")
        if alg == "vafl" and gd != steps:
            fail(f"event {name}: grad_diff_norm launched {gd} times for {steps} events")
        if alg != "vafl" and gd != 0:
            fail(f"event {name}: grad_diff_norm launched {gd} times, expected 0")
        if tq != res.comm.model_uploads:
            fail(f"event {name}: {tq} topk_int8 encode calls for {res.comm.model_uploads} "
                 f"accepted uploads")
    counts = read()                              # read just after the event path
    if counts["flash_attention"] or counts["linear_scan"]:
        fail(f"the event path launched a serving kernel: {counts}")
    vafl, afl, fedavg = runs["vafl"][0], runs["afl"][0], runs["fedavg"][0]
    if vafl.comm.model_uploads > afl.comm.model_uploads:
        fail(f"event vafl uploaded more than afl ({vafl.comm.model_uploads} > "
             f"{afl.comm.model_uploads})")
    if fedavg.idle_fraction <= afl.idle_fraction:
        fail(f"fedavg's idle fraction {fedavg.idle_fraction} is not above afl's "
             f"{afl.idle_fraction}")
    share, kernels, wall, _ = busy_share(lambda: fed.run(rounds=1, mode="event"))
    say(f"[event] one profiled vafl event run (7 events, torch.profiler): {kernels} CUDA "
        f"kernels, device busy {share:.1%} of {wall:.4f} s")
    parts = event_breakdown(fed)
    per_event = runs["vafl"][1] / runs["vafl"][0].records[-1].round * 1e3
    say("[event] a vafl event's steps (host ms, synchronized, mean of 5): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; their sum {sum(parts.values()):.3f} of {per_event:.3f} ms an event")
    return ((counts["grad_diff_norm"], counts["topk_quant"]),
            {name: secs for name, (_, secs, _, _) in runs.items()}, share,
            (runs["vafl"][0], vafl_params, kernels))


BATCHED_RUNS = [   # (name, Federation.run overrides) on the main path's federation
    ("vafl", dict(algorithm="vafl", max_batch=0, buffer_size=1)),
    ("afl K=4", dict(algorithm="afl", buffer_size=4)),
    ("eaflm W=3", dict(algorithm="eaflm", max_batch=3)),
    ("fedasync", dict(algorithm="fedasync")),
    ("vafl@mobile_fleet", dict(algorithm="vafl", scenario="mobile_fleet")),
    ("vafl int8", dict(algorithm="vafl", compressor="int8")),
]
SCALE = dict(clients=256, samples=200, buffer_size=16, seq_events=32)


class _Stop(Exception):
    pass


def _windows(events: int, clients: int, max_batch: int) -> int:
    w = max_batch if max_batch > 0 else clients
    w = max(1, min(w, clients))
    return -(-events // w)


def _run_batched(fed, name, kw, seen):
    """One batched run of 3 rounds, checked; returns (result, seconds,
    grad_diff_norm launches, encode launches, windows)."""
    import torch
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.kernels.grad_diff_norm import ops as gd_ops
    from repro_torch.kernels.topk_quant import ops as tq_ops
    g0, t0 = gd_ops.launches, tq_ops.launches
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    res = fed.run(rounds=3, mode="event", engine="batched", **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - h0
    gd, tq = gd_ops.launches - g0, tq_ops.launches - t0
    n = len(fed.data.counts)
    events = 3 * n
    windows = _windows(events, n, kw.get("max_batch", 0))
    if not all(bool(torch.isfinite(x).all()) for x in tree_leaves(seen["params"])):
        fail(f"batched {name}: non-finite global parameters")
    for r in res.records:
        if not 0.0 <= r.global_acc <= 1.0:
            fail(f"batched {name}: accuracy {r.global_acc} out of [0, 1]")
    if res.records[-1].round != events:
        fail(f"batched {name}: the last record is at event {res.records[-1].round}")
    codec = kw.get("compressor", fed.config.compressor)
    say(f"[batched] {name}: {events} events in {windows} windows, model_uploads "
        f"{res.comm.model_uploads}, scalar_reports {res.comm.scalar_reports}, uplink bytes "
        f"{res.comm.uplink_bytes}, downlink bytes {res.comm.downlink_bytes}, sim_time "
        f"{res.sim_time:.6f}, idle_fraction {res.idle_fraction:.6f}, best acc "
        f"{res.best_acc:.4f}, {secs:.4f} s host ({secs / windows:.4f} s per window, "
        f"{secs / events:.4f} s per event, {events / secs:.3f} events/s, synchronized), "
        f"kernel launches grad_diff_norm {gd}, topk_quant {tq}")
    want_gd = windows if kw["algorithm"] == "vafl" else 0
    if gd != want_gd:
        fail(f"batched {name}: grad_diff_norm launched {gd} times, expected {want_gd} "
             f"(one a vafl window)")
    want_tq = res.comm.model_uploads if codec == "topk0.1_int8" else 0
    if tq != want_tq:
        fail(f"batched {name}: {tq} topk_int8 encode calls, expected {want_tq} (one an "
             f"accepted upload under topk0.1_int8)")
    return res, secs, gd, tq, windows


def _scale_federation():
    """N = 256 clients of the paper's CNN on the IID partition, 200
    synthetic-MNIST samples each, afl, identity codec, on the card."""
    from repro_torch.core.client import LocalSpec
    from repro_torch.core.federation import Federation
    from repro_torch.data.partition import iid_partition
    from repro_torch.data.synthetic import synthetic_mnist
    n, m = SCALE["clients"], SCALE["samples"]
    xtr, ytr, xte, yte = synthetic_mnist(n * m, 2000, seed=0)
    data = iid_partition(xtr, ytr, n, samples_per_client=m, seed=0)
    return Federation(model="cnn", data=data, test_data=(xte, yte), algorithm="afl",
                      local=LocalSpec(batch_size=32, local_epochs=1, local_rounds=1, lr=0.1),
                      device="cuda")


def phase_scale():
    """N = 256: the batched engine over 2 rounds (512 events, buffer 16)
    against the sequential loop over its first 32 events, and the busy
    share of one profiled batched window."""
    import torch
    fed = _scale_federation()
    fed.run(rounds=1, mode="event", engine="batched", buffer_size=SCALE["buffer_size"])
    torch.cuda.synchronize()                      # warm-up: one window of 256
    n = SCALE["clients"]
    h0 = time.perf_counter()
    res = fed.run(rounds=2, mode="event", engine="batched", buffer_size=SCALE["buffer_size"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - h0
    if res.records[-1].round != 2 * n or not all(0 <= r.global_acc <= 1 for r in res.records):
        fail(f"N={n} batched: records {[(r.round, r.global_acc) for r in res.records]}")
    # the sequential loop, stopped after SCALE["seq_events"] events: timed
    # from its first event's local update to the start of event 33
    gen = torch.Generator(device="cuda").manual_seed(1)
    marks = {}

    def perm_fn(i, ev, e, m):
        if ev == 0 and 0 not in marks:
            torch.cuda.synchronize()
            marks[0] = time.perf_counter()
        if ev == SCALE["seq_events"]:
            torch.cuda.synchronize()
            marks[ev] = time.perf_counter()
            raise _Stop
        return torch.randperm(m, generator=gen, device="cuda")
    try:
        fed.run(rounds=1, mode="event", perm_fn=perm_fn)
        fail("the sequential loop at N=256 ran to its end instead of stopping at event 32")
    except _Stop:
        pass
    seq_secs = (marks[SCALE["seq_events"]] - marks[0]) / SCALE["seq_events"]
    share, kernels, wall, top = busy_share(lambda: fed.run(
        rounds=1, mode="event", engine="batched", buffer_size=SCALE["buffer_size"]))
    say(f"[batched] N={n} afl identity K={SCALE['buffer_size']}: {2 * n} events in 2 windows, "
        f"model_uploads {res.comm.model_uploads}, best acc {res.best_acc:.4f}, {secs:.4f} s host "
        f"({secs / 2:.4f} s per window, {secs / (2 * n):.6f} s per event, "
        f"{2 * n / secs:.3f} events/s); sequential loop {seq_secs:.4f} s per event "
        f"({1 / seq_secs:.3f} events/s, first {SCALE['seq_events']} events); batched / "
        f"sequential events/s {2 * n / secs * seq_secs:.2f}x; one profiled window of {n}: "
        f"{kernels} CUDA kernels, device busy {share:.1%} of {wall:.4f} s")
    say(f"[batched] N={n} window, top kernels by device time (name, launches, ms): {top}")
    return {"events_per_s": 2 * n / secs, "seq_events_per_s": 1 / seq_secs, "busy": share}


def phase_batched_path(seq_vafl):
    """``Federation.run(rounds=3, mode="event", engine="batched")`` on the
    main path's federation (``BATCHED_RUNS``), vafl at max_batch=1,
    buffer_size=1 held bit for bit against the event phase's sequential
    vafl, then the N = 256 federation (``phase_scale``).  grad_diff_norm
    must launch once per vafl window and never otherwise, the encode
    once per accepted upload under topk0.1_int8, and no serving kernel."""
    import torch
    from repro_torch.common.pytree import tree_leaves

    fed = algo1_federation()
    seen = {}
    ev = fed.evaluate_fn

    def capture(p):
        seen["params"] = p
        return ev(p)
    fed.evaluate_fn = capture
    fed.run(rounds=1, mode="event", engine="batched")   # warm-up: one window of 7
    torch.cuda.synchronize()

    read = _reset_launches()
    runs = {name: _run_batched(fed, name, kw, seen) for name, kw in BATCHED_RUNS}
    counts = read()                              # read just after the batched path
    if counts["flash_attention"] or counts["linear_scan"]:
        fail(f"the batched path launched a serving kernel: {counts}")
    vafl, afl = runs["vafl"][0], runs["afl K=4"][0]
    if vafl.comm.model_uploads > afl.comm.model_uploads:
        fail(f"batched vafl uploaded more than afl ({vafl.comm.model_uploads} > "
             f"{afl.comm.model_uploads})")
    # the engine contract on the card: W = 1, K = 1 is the sequential loop
    res, secs, gd, tq, windows = _run_batched(
        fed, "vafl W=1 K=1", dict(algorithm="vafl", max_batch=1, buffer_size=1), seen)
    seq, seq_params, seq_kernels = seq_vafl
    same = (vars(res.comm) == vars(seq.comm) and res.sim_time == seq.sim_time
            and res.client_uplink_bytes == seq.client_uplink_bytes
            and all(torch.equal(a, b) for a, b in zip(tree_leaves(seen["params"]), seq_params)))
    say(f"[batched] W=1 K=1 against the sequential vafl run: uploads "
        f"{res.comm.model_uploads} / {seq.comm.model_uploads}, bytes {res.comm.uplink_bytes} / "
        f"{seq.comm.uplink_bytes}, sim_time {res.sim_time!r} / {seq.sim_time!r}, final "
        f"parameters {'bit-equal' if same else 'DIFFER'}")
    if not same:
        fail("the batched engine at max_batch=1, buffer_size=1 differs from the sequential loop")
    share, kernels, wall, top = busy_share(lambda: fed.run(rounds=1, mode="event",
                                                           engine="batched"))
    say(f"[batched] one profiled full window of 7 (vafl, torch.profiler): {kernels} CUDA kernels "
        f"against {seq_kernels} for 7 sequential events, device busy {share:.1%} of "
        f"{wall:.4f} s; top kernels by device time (name, launches, ms): {top}")
    if kernels * 2 > seq_kernels:
        fail(f"a window of 7 launched {kernels} CUDA kernels, not under half of 7 sequential "
             f"events' {seq_kernels}: its local SGD is not one batched computation")
    scale = phase_scale()
    return ((counts["grad_diff_norm"], counts["topk_quant"]),
            {name: (r[1], r[4], 3 * len(fed.data.counts)) for name, r in runs.items()},
            share, scale)


# ------------------------------------------------------------------------
# This slice: the round runtime's scenario clock, checkpoint-resume in all
# four runtimes, and observability (repro_torch.checkpoint, repro_torch.obs).

CKPT_RUNS = [   # (name, Federation.run overrides, checkpoint_every) on the main federation
    ("rounds vafl@flaky_edge", dict(mode="round", algorithm="vafl", scenario="flaky_edge"), 2),
    ("barrier fedavg", dict(mode="event", algorithm="fedavg"), 2),
    ("sequential vafl", dict(mode="event", algorithm="vafl"), 8),
    ("batched vafl", dict(mode="event", algorithm="vafl", engine="batched"), 14),
    ("batched afl K=4", dict(mode="event", algorithm="afl", engine="batched", buffer_size=4), 14),
]
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
OBS_LAPS = 4                     # (off, on, on, off) turns of the overhead lap
PROFILE_PAD = 32                 # uncounted spin kernels opening a profiled region
KILL_TIMEOUT_S = 300             # the killed child's first checkpoint must land by then


def _everything(res):
    """Every number a run leaves: records with their accuracies,
    ``selected``, CommStats, byte ledgers, clock and idle fractions."""
    return ([(r.round, r.time, r.global_acc, r.uploads_so_far, r.selected, r.values,
              r.client_accs, r.boundaries_crossed) for r in res.records],
            vars(res.comm), res.sim_time, res.idle_fraction, res.client_idle,
            res.client_uplink_bytes, res.client_downlink_bytes, res.client_failed_rounds)


class _Captured:
    """The main federation with its evaluator wrapped so that a run leaves
    its last evaluated global model; ``final(path)`` falls back to the
    bundle's model when a resumed batched run reused the last accuracy
    and evaluated nothing new."""

    def __init__(self, fed):
        self.fed, self.seen = fed, {}
        ev = fed.evaluate_fn

        def capture(p):
            self.seen["params"] = p
            return ev(p)
        fed.evaluate_fn = capture

    def run(self, **kw):
        self.seen.clear()
        return self.fed.run(**kw)

    def final(self, path=None):
        if "params" in self.seen:
            leaves = self.seen["params"]
        else:
            import pickle
            from repro_torch.checkpoint import store as ck
            with open(path, "rb") as f:
                leaves = ck.tree_to_device(pickle.load(f)["state"]["global_params"], "cpu")
        from repro_torch.common.pytree import tree_leaves
        return [x.detach().cpu().clone() for x in tree_leaves(leaves)]


def _same_params(a, b) -> bool:
    import torch
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def phase_round_scenario():
    """``[round-scenario]``: vafl in round mode under ``flaky_edge`` on the
    card and on the CPU, from one initial model and one set of
    permutations: the same record times, ``selected``,
    ``client_failed_rounds``, byte ledgers and clock, bit for bit, and a
    clock of its own (a round runtime that ignored ``scenario`` would
    stamp records with the round index)."""
    import numpy as np
    import torch
    from repro_torch.kernels.grad_diff_norm import ops as gd_ops
    from repro_torch.kernels.topk_quant import ops as tq_ops
    from repro_torch.models.cnn import CNNConfig, cnn_init
    init = cnn_init(CNNConfig(), torch.Generator().manual_seed(0))
    perms = {}

    def perm_fn(i, t, e, mm):
        if (i, t) not in perms:
            perms[(i, t)] = torch.from_numpy(np.random.RandomState(1000 * t + i).permutation(mm))
        return perms[(i, t)]
    out = {}
    for device in ("cuda", "cpu"):
        fed = algo1_federation(device, init)
        g0, t0 = gd_ops.launches, tq_ops.launches
        h0 = time.perf_counter()
        res = fed.run(rounds=3, mode="round", scenario="flaky_edge", perm_fn=perm_fn)
        if device == "cuda":
            torch.cuda.synchronize()
        out[device] = (res, time.perf_counter() - h0, gd_ops.launches - g0,
                       tq_ops.launches - t0)
    (rg, sg, gg, tg), (rc, sc, gc, tc) = out["cuda"], out["cpu"]
    times = [r.time for r in rg.records]
    say(f"[round-scenario] vafl@flaky_edge, 3 rounds, card: record times {times}, selected "
        f"{[r.selected for r in rg.records]}, client_failed_rounds {rg.client_failed_rounds}, "
        f"uplink bytes {rg.client_uplink_bytes}, sim_time {rg.sim_time!r}, idle_fraction "
        f"{rg.idle_fraction!r}; {sg:.3f} s card, {sc:.3f} s CPU; kernel launches grad_diff_norm "
        f"{gg}, topk_quant {tg} (CPU path: {gc}, {tc})")
    fields = {f: (getattr(rg, f), getattr(rc, f)) for f in (
        "client_failed_rounds", "client_uplink_bytes", "client_downlink_bytes", "sim_time",
        "idle_fraction", "client_idle")}
    fields["comm"] = (vars(rg.comm), vars(rc.comm))
    for what in ("time", "selected", "uploads_so_far", "values"):
        fields[what] = ([getattr(r, what) for r in rg.records],
                        [getattr(r, what) for r in rc.records])
    differ = {f: v for f, v in fields.items() if v[0] != v[1] and f != "values"}
    same = not differ
    say(f"[round-scenario] card against the CPU path: record times, selected, "
        f"client_failed_rounds, byte ledgers, clock {'bit-equal' if same else 'DIFFER'} "
        f"(CPU times {[r.time for r in rc.records]}); Eq. 1 values card / CPU "
        f"{fields['values'][0]} / {fields['values'][1]}"
        + ("" if same else f"; differing (card, CPU): {differ}"))
    if not same:
        fail("the round runtime under flaky_edge differs between the card and the CPU path")
    if times == [1.0, 2.0, 3.0] or not rg.sim_time:
        fail(f"the round runtime ignored the scenario: record times {times}")
    if gg != 3 or gc != 0 or tg != rg.comm.model_uploads or tc != 0:
        fail(f"round-scenario launches grad_diff_norm {gg}/{gc}, topk_quant {tg}/{tc} for "
             f"{rg.comm.model_uploads} uploads")
    return gg, tg


def _kill_child(root: str, path: str) -> None:
    """The killed run of ``[checkpoint]``, in a process of its own
    (``spawn``): the main federation's sequential vafl run, checkpointing
    every 8 events into ``path``, until the parent kills it."""
    sys.path.insert(0, str(Path(root) / "src"))
    fed = algo1_federation()
    fed.run(rounds=3, mode="event", algorithm="vafl", checkpoint_path=path, checkpoint_every=8)


def _sigkill_resume(path: str, ref, ref_params, cap) -> dict:
    """Start ``_kill_child``, SIGKILL it once its first checkpoint file
    exists, and resume from that file in this process."""
    import multiprocessing
    import os
    import pickle
    import signal
    ctx = multiprocessing.get_context("spawn")
    child = ctx.Process(target=_kill_child, args=(str(ROOT), path))
    h0 = time.perf_counter()
    child.start()
    try:
        while not os.path.exists(path):
            if not child.is_alive():
                fail(f"the checkpointing child exited ({child.exitcode}) before its first "
                     f"checkpoint")
            if time.perf_counter() - h0 > KILL_TIMEOUT_S:
                fail(f"no checkpoint from the child within {KILL_TIMEOUT_S} s")
            time.sleep(0.01)
        os.kill(child.pid, signal.SIGKILL)
    finally:
        child.join(60)
        if child.is_alive():
            child.kill()
            child.join()
    if child.exitcode != -signal.SIGKILL:
        fail(f"the child was not killed mid-run (exit code {child.exitcode})")
    with open(path, "rb") as f:
        at = pickle.load(f)["state"]["event"]
    res = cap.run(rounds=3, mode="event", algorithm="vafl", checkpoint_path=path, resume=True)
    same = _everything(res) == _everything(ref) and _same_params(cap.final(path), ref_params)
    say(f"[checkpoint] SIGKILL: a spawned child ran sequential vafl with checkpoint_every=8, "
        f"was killed {time.perf_counter() - h0:.2f} s after its start once its checkpoint at "
        f"event {at} of 21 existed (exit code {child.exitcode}); resumed here from that file: "
        f"{'bit-equal' if same else 'DIFFERS'} to the uninterrupted run")
    if not same:
        fail("the run resumed after SIGKILL differs from the uninterrupted run")
    return {"killed_at_event": at}


def _bundle_figures(trace, path, load_ms) -> str:
    """The last bundle's bytes, its save time (the obs ``checkpoint``
    span of the run that wrote it) and its load time."""
    import os
    from repro_torch.obs import read_jsonl
    spans = [e["host_dur"] * 1e3 for e in read_jsonl(trace)[1] if e["name"] == "checkpoint"]
    return (f"bundle {os.path.getsize(path)} bytes, save {spans[-1]:.2f} ms (the obs "
            f"checkpoint span: device-to-host copies, pickle, fsync, rename), load "
            f"{load_ms:.2f} ms (read, unpickle, fingerprint check)")


def phase_checkpoint():
    """``[checkpoint]``: each runtime on the main federation run once
    whole, once checkpointed (obs on, for its save spans) and once
    resumed from the last checkpoint; the resumed run must equal the
    whole one bit for bit (records, ``selected``, CommStats, byte
    ledgers, clock, final parameters), and launch grad_diff_norm and the
    encode as often as the whole run did from the checkpoint on.  Then an
    extending resume (2 rounds to 3), a resume after SIGKILL, and the
    N = 256 federation's bundle.  Returns the whole runs for ``[obs]``."""
    import pickle
    import tempfile
    import torch
    from repro_torch.checkpoint import store as ck
    from repro_torch.kernels.grad_diff_norm import ops as gd_ops
    from repro_torch.kernels.topk_quant import ops as tq_ops
    from repro_torch.obs import ObsConfig

    cap = _Captured(algo1_federation())
    saves, loads = [], []
    save0, load0 = ck.save_run_state, ck.load_run_state

    def save(*a, **k):                  # the launch counts at each save
        saves.append((gd_ops.launches, tq_ops.launches))
        return save0(*a, **k)

    def load(*a, **k):
        h0 = time.perf_counter()
        out = load0(*a, **k)
        loads.append((time.perf_counter() - h0) * 1e3)
        return out
    ck.save_run_state, ck.load_run_state = save, load
    whole = {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_")
    try:
        for name, kw, every in CKPT_RUNS:
            path = f"{tmp.name}/{len(whole)}.ckpt"
            trace = f"{tmp.name}/{len(whole)}.jsonl"
            g0, t0 = gd_ops.launches, tq_ops.launches
            h0 = time.perf_counter()
            a = cap.run(rounds=3, **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - h0
            a_params = cap.final()
            la = (gd_ops.launches - g0, tq_ops.launches - t0)
            saves.clear()
            g1, t1 = gd_ops.launches, tq_ops.launches
            b = cap.run(rounds=3, checkpoint_path=path, checkpoint_every=every,
                        obs=ObsConfig(trace_jsonl=trace), **kw)
            lb = (gd_ops.launches - g1, tq_ops.launches - t1)
            at_save = (saves[-1][0] - g1, saves[-1][1] - t1)
            unperturbed = _everything(b) == _everything(a) and _same_params(cap.final(), a_params)
            g2, t2 = gd_ops.launches, tq_ops.launches
            c = cap.run(rounds=3, checkpoint_path=path, resume=True, **kw)
            lc = (gd_ops.launches - g2, tq_ops.launches - t2)
            resumed = _everything(c) == _everything(a) and _same_params(cap.final(path), a_params)
            with open(path, "rb") as f:
                st = pickle.load(f)["state"]
            unit = "round" if "round" in st else "event"
            extra = (f", buffer {len(st['buffer'])} uploads, next window "
                     f"{None if st['nxt'] is None else st['nxt'][1].tolist()}"
                     if "buffer" in st else "")
            say(f"[checkpoint] {name}: checkpoint_every={every}, last checkpoint at {unit} "
                f"{st[unit]}{extra}, EF residuals of {len(st['ef'])} clients; checkpointed run "
                f"{'bit-equal' if unperturbed else 'DIFFERS'} to the whole run ({secs:.3f} s), "
                f"resumed run {'bit-equal' if resumed else 'DIFFERS'}; launches grad_diff_norm, "
                f"topk_quant: whole {la}, from the checkpoint on {(la[0] - at_save[0], la[1] - at_save[1])}, "
                f"resumed {lc}; " + _bundle_figures(trace, path, loads[-1]))
            if not (unperturbed and resumed):
                fail(f"checkpoint {name}: a checkpointed or resumed run differs from the whole run")
            if lb != la or lc != (la[0] - at_save[0], la[1] - at_save[1]):
                fail(f"checkpoint {name}: launches whole {la}, checkpointed {lb}, resumed {lc}, "
                     f"at the checkpoint {at_save}")
            if sum(lc) == 0 or not 0 < st[unit] < (3 if unit == "round" else 21):
                fail(f"checkpoint {name}: the resumed part is empty ({unit} {st[unit]}, "
                     f"launches {lc})")
            whole[name] = (a, a_params, secs)
        # an extending resume: a 2-round checkpoint of the batched engine
        # (whose writer never popped a next window) resumed to 3 rounds
        name, kw, _ = CKPT_RUNS[3]
        path = f"{tmp.name}/ext.ckpt"
        cap.run(rounds=2, checkpoint_path=path, checkpoint_every=7, **kw)
        c = cap.run(rounds=3, checkpoint_path=path, resume=True, **kw)
        a, a_params, _ = whole[name]
        same = _everything(c) == _everything(a) and _same_params(cap.final(path), a_params)
        say(f"[checkpoint] extending resume: {name} checkpointed at the end of 2 rounds (event "
            f"14, no next window popped), resumed to 3 rounds: "
            f"{'bit-equal' if same else 'DIFFERS'} to the 3-round run")
        if not same:
            fail("an extending resume differs from the longer run")
        seq, seq_params, _ = whole["sequential vafl"]
        killed = _sigkill_resume(f"{tmp.name}/killed.ckpt", seq, seq_params, cap)
        n256 = _scale_bundle(tmp.name, loads)
    finally:
        ck.save_run_state, ck.load_run_state = save0, load0
        tmp.cleanup()
    return whole, dict(killed, **n256)


def _scale_bundle(tmp, loads) -> dict:
    """The N = 256 federation's bundle (its two client stacks, 2 x 256 x
    42,698 fp32): one window of 256 events checkpointed, then resumed."""
    import os
    from repro_torch.obs import ObsConfig
    fed = _scale_federation()
    path, trace = f"{tmp}/n256.ckpt", f"{tmp}/n256.jsonl"
    kw = dict(rounds=1, mode="event", engine="batched", buffer_size=SCALE["buffer_size"])
    a = fed.run(checkpoint_path=path, checkpoint_every=SCALE["clients"],
                obs=ObsConfig(trace_jsonl=trace), **kw)
    b = fed.run(checkpoint_path=path, resume=True, **kw)
    if _everything(a) != _everything(b):
        fail("N=256: the resumed run differs from the run that wrote its checkpoint")
    say("[checkpoint] N=256 batched afl: " + _bundle_figures(trace, path, loads[-1]))
    return {"n256_bundle_bytes": os.path.getsize(path)}


def _profile_counts(fn) -> tuple:
    """One profiled call of ``fn``: its CUDA kernels by name and its
    synchronising CUDA runtime calls (``SYNC_CALLS``) by name.  CUPTI
    sometimes misses the first kernels of a profiled region (on an H100:
    one to seven of the model's initialisation kernels in one reading of
    three, with obs on and off alike), so the region opens with
    ``PROFILE_PAD`` spin kernels that are not counted."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(10_000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = list(prof.events())
        kernels = collections.Counter(
            e.name for e in events if str(getattr(e, "device_type", "")).endswith("CUDA")
            and not e.name.startswith(("Memcpy", "Memset")) and "spin_kernel" not in e.name)
        if kernels:
            syncs = collections.Counter(e.name for e in events if e.name in SYNC_CALLS)
            return kernels, dict(sorted(syncs.items()))
    fail(f"the profiler recorded no CUDA kernel in {PROFILER_TRIES} profiled runs")


def phase_obs(whole):
    """``[obs]``: the ``[checkpoint]`` runs again with ``obs=True``:
    bit-equal to obs off, the trace reconciled with CommStats; a profiled
    batched window of 7 launches the same CUDA kernels and makes the same
    synchronising runtime calls with obs on as off; a second identical
    run builds nothing; ``torch_profile`` writes a trace; and seconds a
    window with obs off and on, in turns."""
    import collections
    import os
    import statistics
    import tempfile
    import torch
    from repro_torch.obs import ObsConfig, read_jsonl

    cap = _Captured(algo1_federation())
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_obs_")
    try:
        for k, (name, kw, _) in enumerate(CKPT_RUNS):
            trace = f"{tmp.name}/{k}.jsonl"
            h0 = time.perf_counter()
            res = cap.run(rounds=3, obs=ObsConfig(trace_jsonl=trace), **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - h0
            a, a_params, a_secs = whole[name]
            same = _everything(res) == _everything(a) and _same_params(cap.final(), a_params)
            events = read_jsonl(trace)[1]
            by = {}
            for e in events:
                by.setdefault(e["name"], []).append(e)
            up, rep = by.get("upload", []), by.get("report", [])
            bc = by.get("broadcast", [])
            c = res.comm
            ok = (len(up) == c.model_uploads and sum(e["nbytes"] for e in up) == c.upload_payload_bytes
                  and sum(e["nbytes"] for e in up) + 4 * sum(e["n"] for e in rep) == c.uplink_bytes
                  and sum(e["n"] for e in bc) == c.broadcasts
                  and sum(e["nbytes"] for e in bc) == c.downlink_bytes
                  and len(by.get("eval", [])) == len(res.records)
                  and res.metrics["counters"]["uploads"] == c.model_uploads)
            say(f"[obs] {name}: {len(events)} trace events ({', '.join(f'{n} {len(v)}' for n, v in sorted(by.items()))}); "
                f"{'bit-equal' if same else 'DIFFERS'} to obs off; upload events {len(up)} = "
                f"model_uploads {c.model_uploads}, their nbytes {sum(e['nbytes'] for e in up)} + 4 x "
                f"{sum(e['n'] for e in rep)} reports = uplink bytes {c.uplink_bytes}, broadcasts "
                f"{sum(e['n'] for e in bc)} / {c.broadcasts} with {sum(e['nbytes'] for e in bc)} / "
                f"{c.downlink_bytes} bytes: {'reconciled' if ok else 'NOT RECONCILED'}; {secs:.3f} s "
                f"(obs off {a_secs:.3f} s)")
            if not (same and ok):
                fail(f"obs {name}: numbers differ with obs on, or the trace does not reconcile")
        # a profile can miss kernels but never invents one: the complete
        # reading is the most of each kernel any reading saw; obs must
        # reach it (obs removes nothing) and no reading may pass it (obs
        # adds nothing); the synchronising calls must agree everywhere
        window = dict(rounds=1, mode="event", algorithm="vafl", engine="batched")
        turns = (False, True, True, False) * 2
        readings = [(on, *_profile_counts(lambda on=on: cap.run(obs=True if on else None,
                                                                 **window)))
                    for on in turns]
        full = collections.Counter()
        for _, k, _ in readings:
            full |= k
        complete = {on: sum(1 for o, k, _ in readings if o == on and k == full)
                    for on in (False, True)}
        syncs = {tuple(sy.items()) for _, _, sy in readings}
        say(f"[obs] profiled batched window of 7, {len(turns)} readings in turns (off, on, on, "
            f"off): CUDA kernels off {[sum(k.values()) for o, k, _ in readings if not o]}, on "
            f"{[sum(k.values()) for o, k, _ in readings if o]}; complete ({sum(full.values())} "
            f"kernels, {len(full)} names) off {complete[False]} of 4, on {complete[True]} of 4; "
            f"synchronising runtime calls {sorted(syncs)}")
        if not complete[True] or not complete[False] or len(syncs) != 1:
            fail("obs changed a window's CUDA kernels or synchronising calls")
        again = [cap.run(obs=True, **window).metrics["gauges"]["jit_compiles"] for _ in range(2)]
        say(f"[obs] jit_compiles (kernel builds during the run) of two identical runs: {again}")
        if again[1] != 0:
            fail(f"a second identical run built {again[1]} kernels")
        prof_dir = f"{tmp.name}/prof"
        cap.run(obs=ObsConfig(torch_profile=prof_dir), **window)
        files = os.listdir(prof_dir) if os.path.isdir(prof_dir) else []
        sizes = [os.path.getsize(f"{prof_dir}/{f}") for f in files]
        say(f"[obs] torch_profile: {len(files)} Chrome trace file(s), {sizes} bytes")
        if len(files) != 1 or not sizes[0]:
            fail("ObsConfig(torch_profile=...) wrote no trace")
        laps = dict(rounds=3, mode="event", algorithm="vafl", engine="batched")
        per = {False: [], True: []}
        for _ in range(OBS_LAPS):
            for on in (False, True, True, False):
                torch.cuda.synchronize()
                h0 = time.perf_counter()
                cap.run(obs=True if on else None, **laps)
                torch.cuda.synchronize()
                per[on].append((time.perf_counter() - h0) / 3)
        off_m, on_m = statistics.median(per[False]), statistics.median(per[True])
        say(f"[obs] seconds a batched window of 7 (vafl, 3 windows a run, {OBS_LAPS} x (off, on, "
            f"on, off)): off median {off_m:.4f} (range {min(per[False]):.4f}-{max(per[False]):.4f}),"
            f" on median {on_m:.4f} (range {min(per[True]):.4f}-{max(per[True]):.4f}); on / off "
            f"{on_m / off_m:.4f}")
    finally:
        tmp.cleanup()
    return {"off_s": off_m, "on_s": on_m, "window_kernels": sum(full.values()),
            "window_syncs": readings[0][2]}


FL_SERVE_BRIDGE = ("vafl", "afl", "fedasync")   # bridge runs held against run(mode="event")
FL_SERVE_THREADS = ("vafl", "afl")              # thread-worker runs
FL_SERVE_WAIT = dict(stall_timeout=120.0, recv_timeout=120.0)
CONCURRENT = dict(threads=7, encodes=20)        # the concurrent-encode check


def _served(cap, **kw):
    """One ``Federation.serve`` of the captured main federation, timed
    (synchronized) and with its kernel launches: (result, seconds,
    grad_diff_norm launches, encode launches)."""
    import torch
    from repro_torch.kernels.grad_diff_norm import ops as gd_ops
    from repro_torch.kernels.topk_quant import ops as tq_ops
    cap.seen.clear()
    g0, t0 = gd_ops.launches, tq_ops.launches
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    res = cap.fed.serve(**kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - h0, gd_ops.launches - g0, tq_ops.launches - t0


def _concurrent_encodes() -> dict:
    """7 host threads x 20 CNN-size topk_int8 encodes at once, as the
    thread workers run them: each bit-equal to the plain route of its own
    input, and the wrapper counting every call."""
    import threading
    import numpy as np
    import torch
    from repro_torch.kernels.topk_quant import ops as tq_ops
    n_t, per = CONCURRENT["threads"], CONCURRENT["encodes"]
    gen = torch.Generator(device="cuda").manual_seed(21)
    trees = [[_encode_tree("cnn", "randn", gen) for _ in range(per)] for _ in range(n_t)]
    leaves = [[[x for _, x in sorted(t.items())] for t in row] for row in trees]
    want = [[tq_ops.encode_plain(torch.cat([x.reshape(-1) for x in ls]),
                                 tq_ops.encode_k(0.1, sum(x.numel() for x in ls)),
                                 1000 * t + j) for j, ls in enumerate(row)]
            for t, row in enumerate(leaves)]
    got = [[None] * per for _ in range(n_t)]
    errors = []
    barrier = threading.Barrier(n_t)
    c0 = tq_ops.launches

    def work(t):
        try:
            barrier.wait()
            for j in range(per):
                got[t][j] = tq_ops.topk_int8_encode(leaves[t][j], 0.1, 1000 * t + j)
        except Exception as e:   # noqa: BLE001: reported below
            errors.append(e)
    threads = [threading.Thread(target=work, args=(t,)) for t in range(n_t)]
    h0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    secs = time.perf_counter() - h0
    if errors or any(th.is_alive() for th in threads):
        fail(f"[fl-serve] concurrent encodes failed: {errors or 'a thread hung'}")
    calls = tq_ops.launches - c0
    if calls != n_t * per:
        fail(f"[fl-serve] {n_t} x {per} concurrent encodes counted {calls} launches")
    bad = sum(1 for t in range(n_t) for j in range(per)
              if not (np.array_equal(got[t][j][0], want[t][j][0])
                      and np.array_equal(got[t][j][1], want[t][j][1])
                      and got[t][j][2] == want[t][j][2]))
    if bad:
        fail(f"[fl-serve] {bad} of {n_t * per} concurrent encodes differ from the plain route")
    # what the wrappers' locks add to a call with no other thread about:
    # one uncontended acquire and release of the encode's lock
    reps = 100_000
    h0 = time.perf_counter()
    for _ in range(reps):
        with tq_ops._lock:
            pass
    lock_us = (time.perf_counter() - h0) / reps * 1e6
    say(f"[fl-serve] {n_t} threads x {per} CNN-size topk_int8 encodes at once: all "
        f"{n_t * per} bit-equal to the plain route (idx, val, scale), {calls} launches "
        f"counted, {secs:.4f} s ({secs / (n_t * per) * 1e3:.4f} ms an encode); a wrapper "
        f"lock's uncontended acquire and release {lock_us:.4f} us (host, {reps} pairs)")
    return {"threads": n_t, "encodes": n_t * per, "seconds": secs, "lock_us": lock_us}


def fl_serve_references():
    """The references ``[fl-serve]``'s bridge is held against: the main
    federation (the CNN, 7 clients, topk0.1_int8, on the card) and its
    ``run(rounds=3, mode="event")`` for each of ``FL_SERVE_BRIDGE``, run
    before the serve path's launch counts are set to 0 (the event path's
    own launches are ``event_launches``).  Returns (the captured
    federation, {algorithm: (result, final parameters, host seconds,
    (grad_diff_norm, encode) launches)})."""
    import torch
    cap = _Captured(algo1_federation())
    refs = {}
    for alg in FL_SERVE_BRIDGE:
        cap.seen.clear()
        g0, t0 = _launch_pair()
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        ref = cap.fed.run(rounds=3, mode="event", algorithm=alg)
        torch.cuda.synchronize()
        ev_s = time.perf_counter() - h0
        ev_l = tuple(b - a for a, b in zip((g0, t0), _launch_pair()))
        refs[alg] = (ref, cap.final(), ev_s, ev_l)
    return cap, refs


def phase_fl_serve(cap, refs):
    """``[fl-serve]``: ``Federation.serve`` on the main federation of
    ``fl_serve_references``.  The sequential bridge for vafl, afl and
    fedasync, each bit-equal to that federation's ``run(rounds=3,
    mode="event")`` (parameters, records, CommStats, clock) with the same
    kernel launches; thread workers for vafl and afl (the run ends, byte
    ledgers reconcile with CommStats, one encode an accepted upload;
    events/s, and the card's busy share of a profiled vafl round); a
    bridge checkpoint resume of afl without error feedback, bit-equal;
    two federations (afl, vafl) of one round each served from one
    ``MultiTenantServer``.  Every launch in here is a served run's.
    Returns the numbers of the ``[time]`` line; the concurrent-encode
    check runs after the launch counts are read (``_concurrent_encodes``)."""
    import dataclasses
    import tempfile
    from repro_torch.serve import MultiTenantServer, launch_serving

    fed = cap.fed
    events = 3 * len(fed.data.counts)
    out = {"bridge": {}, "threads": {}}
    for alg in FL_SERVE_BRIDGE:
        ref, ref_p, ev_s, ev_l = refs[alg]
        res, sv_s, gd, tq = _served(cap, rounds=3, driver="sequential", algorithm=alg)
        same = _everything(res) == _everything(ref) and _same_params(cap.final(), ref_p)
        say(f"[fl-serve] bridge {alg}: serve(driver=\"sequential\") vs run(mode=\"event\"), "
            f"3 rounds ({events} events): {'bit-equal' if same else 'DIFFERENT'} "
            f"(parameters, records, CommStats, sim_time {res.sim_time:.6f}); uploads "
            f"{res.comm.model_uploads}, launches grad_diff_norm {gd} vs {ev_l[0]}, topk_quant "
            f"{tq} vs {ev_l[1]}; {sv_s / events:.4f} s an event served vs {ev_s / events:.4f} "
            f"s in the event loop (host, synchronized)")
        if not same:
            fail(f"[fl-serve] the bridge's {alg} run differs from run(mode='event')")
        if (gd, tq) != ev_l or tq != res.comm.model_uploads:
            fail(f"[fl-serve] bridge {alg} launched ({gd}, {tq}), the event run {ev_l}, "
                 f"for {res.comm.model_uploads} uploads")
        if alg == "vafl" and gd != events:
            fail(f"[fl-serve] bridge vafl launched grad_diff_norm {gd} times for {events} events")
        out["bridge"][alg] = (sv_s / events, ev_s / events)
    for alg in FL_SERVE_THREADS:
        res, secs, gd, tq = _served(cap, rounds=3, algorithm=alg, **FL_SERVE_WAIT)
        c = res.comm
        ok = (c.broadcasts == events and sum(res.client_uplink_bytes) == c.uplink_bytes
              and sum(res.client_downlink_bytes) == c.downlink_bytes
              and tq == c.model_uploads and gd == (events if alg == "vafl" else 0))
        say(f"[fl-serve] threads {alg}: 7 workers, {c.broadcasts} events, uploads "
            f"{c.model_uploads}, reports {c.scalar_reports}, uplink bytes {c.uplink_bytes} "
            f"(ledgers sum {sum(res.client_uplink_bytes)}), downlink {c.downlink_bytes} "
            f"(sum {sum(res.client_downlink_bytes)}), launches grad_diff_norm {gd}, topk_quant "
            f"{tq}; best acc {res.best_acc:.4f}; {secs:.4f} s, {events / secs:.3f} events/s")
        if not ok:
            fail(f"[fl-serve] the thread run of {alg} did not end whole or reconcile")
        out["threads"][alg] = events / secs
    share, kernels, wall, _ = busy_share(lambda: fed.serve(rounds=1, algorithm="vafl",
                                                          **FL_SERVE_WAIT))
    say(f"[fl-serve] one profiled thread-worker vafl run (7 events, torch.profiler): "
        f"{kernels} CUDA kernels, device busy {share:.1%} of {wall:.4f} s")
    out["busy"] = share
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/serve.ckpt"
        kw = dict(rounds=3, driver="sequential", algorithm="afl", error_feedback=False)
        ref, _, _, _ = _served(cap, **kw)
        ref_p = cap.final()
        _served(cap, checkpoint_path=path, checkpoint_every=10, **kw)
        res, _, gd, tq = _served(cap, checkpoint_path=path, resume=True, **kw)
        same = _everything(res) == _everything(ref) and _same_params(cap.final(), ref_p)
        say(f"[fl-serve] bridge resume of afl (error_feedback=False) from event 20: "
            f"{'bit-equal' if same else 'DIFFERENT'}, launches after it topk_quant {tq}")
        if not same:
            fail("[fl-serve] the bridge's afl resume differs from the whole run")
    cb = dict(init_params_fn=fed.init_params_fn, loss_fn=fed.loss_fn, fed_data=fed.data,
              evaluate_fn=fed.evaluate_fn, device="cuda", recv_timeout=120.0)
    # two tenants of one round each (depth cut: the thread runs above
    # took 13-15 s for 3 rounds)
    sa, wa, ta = launch_serving(dataclasses.replace(fed.config, algorithm="afl", rounds=1),
                                name="a", **cb)
    sb, wb, tb = launch_serving(dataclasses.replace(fed.config, algorithm="vafl", rounds=1),
                                name="b", **cb)
    mt = MultiTenantServer([sa, sb])
    h0 = time.perf_counter()
    mt.start()
    for w in wa + wb:
        w.start()
    try:
        res_a, res_b = mt.run(stall_timeout=120.0)
    finally:
        for w in wa + wb:
            w.stop()
        for w in wa + wb:
            w.join(timeout=30)
        ta.close()
        tb.close()
    secs = time.perf_counter() - h0
    say(f"[fl-serve] multi-tenant: afl and vafl served from one MultiTenantServer, 14 "
        f"workers: events {res_a.comm.broadcasts} and {res_b.comm.broadcasts}, uploads "
        f"{res_a.comm.model_uploads} and {res_b.comm.model_uploads}, {secs:.4f} s")
    if (res_a.comm.broadcasts, res_b.comm.broadcasts) != (7, 7) or any(
            w.error is not None or w.is_alive() for w in wa + wb):
        fail("[fl-serve] a multi-tenant federation did not complete")
    return out


def _launch_pair():
    from repro_torch.kernels.grad_diff_norm import ops as gd_ops
    from repro_torch.kernels.topk_quant import ops as tq_ops
    return gd_ops.launches, tq_ops.launches


FIGURE_ROUNDS = 3


def phase_figures():
    """``[figures]``: the paper's Fig. 4 (experiments a-d), Fig. 5/6 and
    the value ablation (experiment d) on the card at
    ``BenchScale(rounds=3)``; each prints its CSV.  Fails on an accuracy
    outside [0, 1] or a missing row."""
    from repro_torch.bench import ablation_value, fig4_convergence, fig5_clients
    from repro_torch.bench.fl_common import ALGS, EXPERIMENTS, BenchScale

    secs = {}
    h0 = time.perf_counter()
    curves = fig4_convergence.run(scale=BenchScale(rounds=FIGURE_ROUNDS), device="cuda")
    secs["fig4"] = time.perf_counter() - h0
    if sorted(curves) != sorted((e, a) for e in EXPERIMENTS for a in ALGS) or any(
            len(c) != FIGURE_ROUNDS or not all(0.0 <= acc <= 1.0 for _, acc in c)
            for c in curves.values()):
        fail("[figures] fig4_convergence: a curve is missing, short or out of [0, 1]")
    h0 = time.perf_counter()
    runs = fig5_clients.run(scale=BenchScale(rounds=FIGURE_ROUNDS), device="cuda")
    secs["fig5"] = time.perf_counter() - h0
    for exp, res in runs.items():
        n = EXPERIMENTS[exp][0]
        if len(res.records) != FIGURE_ROUNDS or any(
                len(r.client_accs) != n or not all(0.0 <= a <= 1.0 for a in r.client_accs)
                for r in res.records):
            fail(f"[figures] fig5_clients {exp}: per-client accuracies missing or out of range")
    h0 = time.perf_counter()
    rows = ablation_value.run("d", BenchScale(samples_per_client=800, rounds=FIGURE_ROUNDS,
                                              test_samples=800), device="cuda")
    secs["ablation"] = time.perf_counter() - h0
    if [r[0] for r in rows] != ["full", "no_acc", "no_diff", "random", "strong_acc"] or any(
            not 0.0 <= r[2] <= 1.0 for r in rows):
        fail(f"[figures] ablation_value rows {rows}")
    say("[figures] host seconds (synchronized by each run's evaluations): "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    return secs


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

    marks = [("start", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    phase_build()
    sass = phase_sass()
    mark("build")
    gd_rows, tq_rows, fa_rows, ls_rows, tree_rows, enc_rows = {}, {}, [], [], {}, {}
    phase_grad_diff_norm(gd_rows)
    phase_grad_tree(tree_rows)
    phase_topk_quant(tq_rows)
    phase_encode(enc_rows)
    phase_flash_attention(fa_rows)
    phase_linear_scan(ls_rows)
    mark("kernels")
    (gd_launches, tq_launches), secs = phase_main_path()
    mark("main")
    (ev_gd, ev_tq), ev_secs, ev_busy, seq_vafl = phase_event_path()
    mark("event")
    (b_gd, b_tq), b_secs, b_busy, scale = phase_batched_path(seq_vafl)
    mark("batched")
    read = _reset_launches()
    phase_round_scenario()
    rs_counts = read()                           # read just after the round-scenario path
    mark("round-scenario")
    read = _reset_launches()
    whole, ckpt = phase_checkpoint()
    ck_counts = read()                           # read just after the checkpoint path
    mark("checkpoint")
    read = _reset_launches()
    obs = phase_obs(whole)
    obs_counts = read()                          # read just after the obs path
    mark("obs")
    cap, refs = fl_serve_references()
    read = _reset_launches()
    fl_serve = phase_fl_serve(cap, refs)
    fs_counts = read()                           # read just after the fl-serve path
    fl_serve["concurrent"] = _concurrent_encodes()
    mark("fl-serve")
    read = _reset_launches()
    figures = phase_figures()
    fig_counts = read()                          # read just after the figures path
    mark("figures")
    for what, counts in (("round-scenario", rs_counts), ("checkpoint", ck_counts),
                         ("obs", obs_counts), ("fl-serve", fs_counts)):
        if counts["grad_diff_norm"] <= 0 or counts["topk_quant"] <= 0:
            fail(f"a kernel of the {what} path never launched: {counts}")
    for what, counts in (("round-scenario", rs_counts), ("checkpoint", ck_counts),
                         ("obs", obs_counts), ("fl-serve", fs_counts), ("figures", fig_counts)):
        if counts["flash_attention"] or counts["linear_scan"]:
            fail(f"the {what} path launched a serving kernel: {counts}")
    if fig_counts["grad_diff_norm"] <= 0:
        fail(f"the figures' vafl runs never launched grad_diff_norm: {fig_counts}")
    # rwkv6_3b's prefill-vs-decode check is gated in fp32: at bf16 the
    # random-weight stack's two paths drift apart with depth in the
    # reference as in the port (PERF.md §6; the bf16 gate at depth 2 is
    # tests/test_torch_llm_serve.py's gpu test), while the dense model
    # holds 2e-2 in bf16 at full depth
    served = {"starcoder2_3b": phase_serve("starcoder2_3b", "flash_attention", "bfloat16"),
              "rwkv6_3b": phase_serve("rwkv6_3b", "linear_scan", "float32")}
    mark("serve")
    say("[time] phases (host seconds): " + ", ".join(
        f"{name} {t - t0:.1f}" for (_, t0), (name, t) in zip(marks, marks[1:])))

    for row in list(gd_rows.values()) + list(tq_rows.values()) + fa_rows + ls_rows:
        say("[time] " + json.dumps(row))
    for key, row in tree_rows.items():
        say("[time] " + json.dumps(dict(row, name="tree_grad_diff_sq_norm")))
    for row in enc_rows.values():
        say("[time] " + json.dumps(row))
    tree, enc = tree_rows[("cnn", "float32")], enc_rows[ENC_CASES[0]]
    one = tree_rows[("cnn1", "float32")]
    main_gd = dict(gd_rows[GD_SHAPES[0]], launches=gd_launches, tree_case=tree["case"],
                   tree_ms=tree["ms"], tree_plain_ms=tree["plain_ms"],
                   tree_cuda_launches_per_call=tree["cuda_launches_per_call"],
                   event_launches=ev_gd, event_tree_case=one["case"], event_tree_ms=one["ms"],
                   event_tree_plain_ms=one["plain_ms"], event_tree_bound_ms=one["bound_ms"],
                   batched_launches=b_gd,
                   round_scenario_launches=rs_counts["grad_diff_norm"],
                   checkpoint_launches=ck_counts["grad_diff_norm"],
                   obs_launches=obs_counts["grad_diff_norm"],
                   fl_serve_launches=fs_counts["grad_diff_norm"],
                   figures_launches=fig_counts["grad_diff_norm"])
    # the topk_quant row times what the main path launches, the encode;
    # the elementwise entry (off the path, held against ref.topk_quant)
    # keeps its figures under elementwise_*
    ew = tq_rows[TQ_SIZES[0]]
    main_tq = dict({k: v for k, v in enc.items() if k != "device_activity"}, name="topk_quant",
                   entry="topk_int8_encode", replaces=ew["replaces"], shape=[enc["elements"]],
                   dtype="float32", launches=tq_launches, library_ms=None, library_call=None,
                   elementwise_shape=ew["shape"], elementwise_ms=ew["ms"],
                   elementwise_plain_ms=ew["plain_ms"], elementwise_bound_ms=ew["bound_ms"],
                   elementwise_bound_by=ew["bound_by"], elementwise_max_abs_err=ew["max_abs_err"],
                   event_launches=ev_tq, batched_launches=b_tq,
                   round_scenario_launches=rs_counts["topk_quant"],
                   checkpoint_launches=ck_counts["topk_quant"],
                   obs_launches=obs_counts["topk_quant"],
                   fl_serve_launches=fs_counts["topk_quant"],
                   figures_launches=fig_counts["topk_quant"])
    main_fa = dict(fa_rows[0], launches=served["starcoder2_3b"]["launches"],
                   tensor_core_instructions=sass["flash_attention"])
    main_ls = dict(ls_rows[0], launches=served["rwkv6_3b"]["launches"],
                   tensor_core_instructions=sass["linear_scan"])
    say(f"[time] main path seconds per round (3 rounds, host clock, synchronized): "
        f"vafl {secs['vafl'] / 3:.4f}, afl {secs['afl'] / 3:.4f}")
    say("[time] event path (host clock, synchronized): "
        + ", ".join(f"{name} {t / (3 if name == 'fedavg' else 21):.4f} s per "
                    f"{'round' if name == 'fedavg' else 'event'} "
                    f"({(3 if name == 'fedavg' else 21) / t:.3f}/s)"
                    for name, t in ev_secs.items())
        + f"; device busy {ev_busy:.1%} of a profiled vafl event run")
    say("[time] batched path (host clock, synchronized): "
        + ", ".join(f"{name} {t / w:.4f} s per window, {t / e:.4f} s per event ({e / t:.3f}/s)"
                    for name, (t, w, e) in b_secs.items())
        + f"; device busy {b_busy:.1%} of a profiled window of 7; N={SCALE['clients']}: "
        f"batched {scale['events_per_s']:.3f} events/s, sequential "
        f"{scale['seq_events_per_s']:.3f} events/s, device busy {scale['busy']:.1%} of a "
        f"profiled window")
    say(f"[time] obs (host clock, synchronized): a batched window of 7, median "
        f"{obs['off_s']:.4f} s off, {obs['on_s']:.4f} s on; a window's CUDA kernels "
        f"{obs['window_kernels']} and synchronising calls {obs['window_syncs']}, the same "
        f"either way; checkpoint: N={SCALE['clients']} bundle {ckpt['n256_bundle_bytes']} "
        f"bytes, SIGKILL resume from event {ckpt['killed_at_event']}")
    br = fl_serve["bridge"]
    say("[time] fl-serve (host clock, synchronized): bridge s an event served vs in the "
        "event loop: " + ", ".join(f"{a} {s:.4f} vs {e:.4f}" for a, (s, e) in br.items())
        + "; thread workers " + ", ".join(f"{a} {v:.3f} events/s"
                                          for a, v in fl_serve["threads"].items())
        + f", device busy {fl_serve['busy']:.1%} of a profiled vafl run; "
        f"{fl_serve['concurrent']['encodes']} concurrent encodes in "
        f"{fl_serve['concurrent']['seconds']:.4f} s, a lock pair "
        f"{fl_serve['concurrent']['lock_us']:.4f} us; figures: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in figures.items()))
    for arch, row in (("starcoder2_3b", main_fa), ("rwkv6_3b", main_ls)):
        st = served[arch]
        share = st["launches"] * row["ms"] / 1e3 / st["prefill_s"]
        say(f"[time] serve {arch} (host clock, synchronized): prefill {st['prefill_s']:.4f} s "
            f"for {SERVE['batch']} x {SERVE['prompt_len']} tokens, decode "
            f"{st['decode_tok_per_s']:.2f} tok/s ({SERVE['batch']} x {SERVE['gen']} tokens in "
            f"{st['decode_s']:.4f} s); {st['launches']} {row['name']} launches x {row['ms']:.4f} ms "
            f"= {share:.1%} of the prefill; peak device memory {st['peak_gb']:.2f} GB")
    say(json.dumps({"kernels": [main_gd, main_tq, main_fa, main_ls]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
