#!/usr/bin/env python3
"""Smoke test of repro_torch on one NVIDIA H100: build the CUDA kernels
(the four TPU kernels' counterparts and the flash_attention and
linear_scan backwards),
hold each against its plain PyTorch version on the card, time them, and
drive the port's main paths through their public entry points.

1. Algorithm 1:

    Federation(model="cnn", algorithm="vafl", compressor="topk0.1_int8",
               device="cuda").run(rounds=3, mode="round")

   then afl on the same federation (kernels grad_diff_norm, and
   topk_quant's device-side topk_int8 encode).
2. The event runtime on the same federation, ``run(rounds=2,
   mode="event")``: the sequential loop for vafl, afl and eaflm (14
   events each), fedavg's round barrier, and vafl under
   ``scenario="mobile_fleet"`` (grad_diff_norm once per vafl event, the
   encode once per accepted upload); ``[event]`` lines.
3. The batched engine on the same federation, ``run(rounds=2,
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
   barrier, the sequential loop (vafl, 2 rounds; the others 3) and the
   batched engine (vafl in full windows; afl with a FedBuff buffer of 4
   crossing the checkpoint) on the same federation, each run whole,
   checkpointed
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
   an accepted upload); a bridge checkpoint resume (2 rounds, from a
   checkpoint past round 1's end); two tenants from one
   ``MultiTenantServer``; then 7 threads x 20 concurrent encodes, each
   bit-equal to the plain route of its input.  The event runs the
   bridge is held against run before the phase's launch counts are set
   to 0, so ``fl_serve_launches`` counts served runs alone.
8. ``[fl-wire]``: the same federation served over the wire and its
   faults, 1 round a run (the socket threads and the chaos soak 2): the
   bridge over TCP (``transport="socket"``, vafl and afl) bit-equal to
   ``run(mode="event")`` with the same launches; thread workers over
   ``socket`` (vafl: events/s, busy share, ledgers; each worker's second
   value reads its first gradient); two ``spawn``ed process workers
   computing on the card over ``socket`` (afl, clients 0 and 1), each
   child counting its own encode launches and sending them back on a
   queue (they sum to the accepted uploads;
   ``fl_wire_child_launches``), the card's busy share from
   ``nvidia-smi``; a process worker SIGKILLed after its first upload
   (the server returns within its stall timeout); the chaos soak (afl,
   thread workers, ``ChaosTransport`` over ``inproc`` and ``socket``:
   the fault-free multiset committed, obs fault counters = the
   transport's stats); the live HTTP plane on a vafl run (all four
   endpoints mid-run, ``/clients`` = CommStats, ``/metrics`` parses).
9. ``[figures]``: the paper's Fig. 4 (experiments a-d), Fig. 5/6 and
   the value ablation (experiment d) at 3 rounds on the card, each
   printing its CSV.
10. ``[train]``: the flash_attention backward kernel against the plain
   backward (autograd through ``ref.gqa_attention``) in fp32 and bf16,
   with and without a window, at starcoder2_3b's and minicpm_2b's
   attention shapes and at zamba2_7b's head_dim of 112, timed beside its
   bound and SDPA's autograd backward; then minicpm_2b at its published
   width with the depth cut
   to 2 layers (B 4 x S 1024, bf16 compute, fp32 params): step 1's loss
   and every leaf's gradient through the kernels against the plain
   attention route on the card, ``make_train_step`` for 5 steps on one
   repeated batch twice from one seed (bit-equal, the loss falling),
   ``make_fl_train_step`` with P = 2 silos for vafl and afl (one
   grad_diff_norm launch a step), the gated collective on 2 spawned
   ranks (gloo, CUDA tensors) on the reference test's inputs, and the
   federated LM example, afl against vafl; then rwkv6_3b (2 of 32
   layers), zamba2_7b (its first 6 pattern entries: five Mamba2 layers
   and a shared-attention invocation) and granite_moe_3b_a800m (2 of 32
   layers) at their published widths: step 1's gradients through the
   kernels against the plain routes on the card (autograd through
   ``ref.recurrence`` and ``ref.gqa_attention``), leaf by leaf (granite
   also at fp32 compute, with the routes' moved router choices), and
   ``make_train_step`` for 5 steps on one repeated batch, the loss
   falling and the linear_scan and flash_attention launches, forward and
   backward, as many as the layer pattern and the checkpointing imply.
11. Serving, ``repro_torch.launch.serve.serve``, for starcoder2_3b,
   rwkv6_3b, zamba2_7b, granite_moe_3b_a800m and qwen3_moe_30b_a3b at
   their full published configurations (random weights from a seed,
   each leaf cast as it is drawn: qwen3's 30.5 B parameters are 61 GB in
   bf16): 4 prompts of 2048 tokens, 32 greedy tokens each (kernels
   flash_attention and linear_scan in the prefill: one a layer, 32 for
   granite and 48 for qwen3, and for zamba2_7b one linear_scan a Mamba2
   layer, 68, and one flash_attention a shared-attention invocation,
   13), then a prefill of 128 tokens held against 128 stepwise decode
   steps; for the MoE models the gate holds on 2 x 8 tokens (one group
   at full capacity) and the 128-token reading, whose prefill drops
   (token, choice) pairs beyond capacity, is printed with its drop count
   beside the serve prefill's drops and expert loads.  Then minicpm3_4b
   (Multi-head Latent Attention: the expanded prefill through
   flash_attention at q.k 96 / v 64, 62 launches; the absorbed decode over
   the latent cache), llava_next_mistral_7b (32) and command_r_35b
   (parallel blocks, 40; 60.6 GB in bf16, its fp32 gate on its first 4
   layers drawn alone), the same way; llava also on its prefix path:
   ``make_prefill_step`` with 1,152 stub prefix embeddings before the 4 x
   2048 prompt, ``make_serve_step`` from position 3,200, and a prefix
   prefill of n - 1 tokens plus one decode step gated against the prefill
   of all n.
12. ``[serve] whisper_small``, the encoder-decoder at its published
   configuration (12 + 12 layers, d 768, 1,500 stub audio frames): the
   encoder on the card against the CPU path, batch 1, fp32; then
   ``serve(batch=4, prompt_len=224, gen=32)``, whose prefill runs the
   encoder's non-causal self-attention, the decoder's causal
   self-attention and the cross-attention (224 queries over 1,500
   frames) through flash_attention, 12 launches each; then the prefill of
   128 tokens against 128 decode steps over the bf16 caches, gated in
   bf16.

Run it from the root of a checkout:

    python3 chip_smoke.py

The ``[flash_attention]`` rows hold the kernel against its plain
version in both modes: causal at every served model's shape, and
non-causal at whisper's encoder and cross-attention shapes, a ragged
77 queries over 1,500 keys in fp32 and a GQA case, each with its bound
over its (query, key) pairs and SDPA's time.
Before the main paths it counts the tensor-core instructions (HMMA,
HGMMA) in each kernel's compiled functions (``cuobjdump -sass`` from
nvcc's toolkit) and fails if a bf16 route of flash_attention, its
backward, linear_scan or its backward has none.  Its ``[linear_scan]``
phase also holds the linear_scan backward kernel against its plain
version at the [train] path's shapes (rwkv6_3b's per-dim form,
zamba2_7b's per-head form; bf16 and fp32; with and without a state;
bf16 also with the decays as each model is initialised), with the
decay parameter's gradient (the sum of dla la), timed beside its bound
with each of its CUDA kernels' device time.  It holds the topk_int8 encode
bit-exact against its plain route on the CNN's and the MLP's trees, on
each side of the resident route's limit, at 2^24 + 123 elements, on a
tie-heavy input and on one whose k-th magnitude is 0, and the
tree-level grad_diff_norm call against its plain version on the CNN's
22 stacked leaves, counting the CUDA kernels each call launches
(``torch.profiler``).

It exits non-zero, and prints no result, when a phase fails, when no
CUDA device is visible, or when it is not inside a checkout.  The last
line of its output is one JSON object naming the device; the line
before it is the card's name and power limit (``nvidia-smi``), and the
line before that the per-kernel JSON (launches, max error, times,
bound; ``event_*`` fields for the event path, ``batched_launches``
for the batched engine, ``round_scenario_launches``,
``checkpoint_launches``, ``obs_launches``, ``fl_serve_launches``,
``fl_wire_launches``, ``fl_wire_child_launches``, ``figures_launches``
and ``train_launches`` for the later paths; the ``flash_attention_bwd``
row's ``launches`` are the [train] path's, its
``train_step_run_launches`` one 5-step ``make_train_step`` run's; a
``linear_scan_bwd`` row per backward case and the hd-112
``flash_attention_bwd`` rows follow, each with the [train] path's
launches and each family's 5-step run's).
Before the [train] path it holds step 1 of the full-width train step
through the kernels against the plain attention route, leaf by leaf,
with the forward and the backward each swapped alone; those launches
are a comparison's and fall outside every path's counts, as are the
families' step-1 comparisons.  It imports neither JAX nor the JAX
package.
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
PROFILE_PAD = 32                 # uncounted spin kernels opening a profiled region
# tree_grad_diff_sq_norm cases: (leaves, W); the CNN at W = 7 is a round's
# call, at W = 1 an event's
GRAD_TREES = [("cnn", 7), ("cnn1", 1), ("one", 1)]
# encode cases: (leaf layout, input); the first is the main path's update
ENC_CASES = [("cnn", "randn"), ("mlp", "randn"), ("one", RESIDENT_LIMIT),
             ("one", RESIDENT_LIMIT + 1), ("one", 2 ** 24 + 123), ("cnn", "ties"),
             ("cnn", "sparse"), ("big", "ties"), ("big", "sparse")]
TQ_OPS_PER_ELEM = 24             # 10 hash + 14 float/convert/select ops (csrc/topk_quant.cu)
# flash_attention cases: (B, S, H, KV, hd, dv, window, dtype), hd the q
# and k head dim, dv v's; the first is starcoder2_3b's prefill in
# serve(batch=4, prompt_len=2048), window 4096; then a ragged S, a window
# shorter than S, fp32, and a large shape; then zamba2_7b's shared
# attention in the same serve call (head_dim 112, no GQA, causal), a
# ragged S, a window and fp32 at 112; then the MoE models' prefills in the
# same serve call, causal: granite_moe_3b_a800m's GQA 24/8 at 64 and
# qwen3_moe_30b_a3b's GQA 32/4 at 128; then minicpm3_4b's MLA prefill in
# the same serve call (q.k 96, v 64, no GQA, causal), fp32 and a ragged S
# at that pair, its smoke width's (48, 32) in both dtypes;
# llava_next_mistral_7b's prefix prefill (1,152 prefix embeddings + 2,048
# tokens, GQA 32/8 at 128) and its text-only serve prefill; command_r_35b's
# (GQA 64/8 at 128); whisper_small's decoder self-attention in
# serve(batch=4, prompt_len=224) (12 heads of 64)
FA_CASES = [(4, 2048, 24, 2, 128, 128, 4096, "bfloat16"),
            (4, 1000, 24, 2, 128, 128, 4096, "bfloat16"),
            (4, 2048, 24, 2, 128, 128, 256, "bfloat16"), (2, 1024, 24, 2, 128, 128, None, "float32"),
            (4, 4096, 24, 2, 128, 128, 4096, "bfloat16"),
            (4, 2048, 32, 32, 112, 112, None, "bfloat16"),
            (4, 1000, 32, 32, 112, 112, None, "bfloat16"),
            (4, 2048, 32, 32, 112, 112, 256, "bfloat16"),
            (2, 1024, 32, 32, 112, 112, None, "float32"),
            (4, 2048, 24, 8, 64, 64, None, "bfloat16"), (4, 2048, 32, 4, 128, 128, None, "bfloat16"),
            (4, 2048, 40, 40, 96, 64, None, "bfloat16"), (2, 1024, 40, 40, 96, 64, None, "float32"),
            (4, 1000, 40, 40, 96, 64, None, "bfloat16"), (2, 77, 4, 4, 48, 32, None, "bfloat16"),
            (2, 77, 4, 4, 48, 32, None, "float32"),
            (4, 3200, 32, 8, 128, 128, None, "bfloat16"), (4, 2048, 32, 8, 128, 128, None, "bfloat16"),
            (4, 2048, 64, 8, 128, 128, None, "bfloat16"),
            (4, 224, 12, 12, 64, 64, None, "bfloat16")]
# the kernel's non-causal mode: (B, Sq, Sk, H, KV, hd, dtype), v at hd, no
# window; whisper_small's encoder self-attention in serve(batch=4,
# prompt_len=224) over its 1,500 stub frames, that shape in fp32 at batch
# 2, its cross-attention (224 queries over the 1,500 frames), a ragged 77
# queries over 1,500 in fp32, and a GQA case (12 query heads over 4)
FA_NONCAUSAL_CASES = [(4, 1500, 1500, 12, 12, 64, "bfloat16"),
                      (2, 1500, 1500, 12, 12, 64, "float32"),
                      (4, 224, 1500, 12, 12, 64, "bfloat16"),
                      (4, 77, 1500, 12, 12, 64, "float32"),
                      (4, 224, 1500, 12, 4, 64, "bfloat16")]
# each served model's prefill shape; llava's the prefix path's (the serve
# row, "llava_serve", its text-only serve call's)
FA_MODEL = {"zamba2_7b": FA_CASES[5], "granite_moe_3b_a800m": FA_CASES[9],
            "qwen3_moe_30b_a3b": FA_CASES[10], "minicpm3_4b": FA_CASES[11],
            "llava_next_mistral_7b": FA_CASES[16], "llava_serve": FA_CASES[17],
            "command_r_35b": FA_CASES[18]}
# whisper_small's three attentions in its serve prefill, each 12 launches
FA_WHISPER = {"encoder": FA_NONCAUSAL_CASES[0], "self": FA_CASES[19],
              "cross": FA_NONCAUSAL_CASES[2]}
FA_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# linear_scan cases: (B, S, H, K, V, form, la, initial state); the first
# is rwkv6_3b's prefill in serve(batch=4, prompt_len=2048): bf16 r/k/v,
# fp32 log-decay, u; then the Mamba2 form, a ragged S, decay at the clamp,
# a large shape, and batches of 1 (40 (b, h): split in two V slices) and
# 3 (120: one an SM); then the per-head (Mamba2) form, first zamba2_7b's
# prefill in the same serve call: C and B broadcast over 112 heads, bf16,
# la -softplus(dt) per head as the model draws it; then log-decays spread
# over [-20, 0] (where a clamp at -8 would show), a ragged S, and an
# initial state
LS_CASES = [(4, 2048, 40, 64, 64, "rwkv", "model", False),
            (4, 2048, 40, 64, 64, "mamba", "model", False),
            (4, 1000, 40, 64, 64, "rwkv", "model", False),
            (4, 2048, 40, 64, 64, "rwkv", "clamp", False),
            (8, 4096, 40, 64, 64, "rwkv", "model", False),
            (1, 2048, 40, 64, 64, "rwkv", "model", False),
            (3, 2048, 40, 64, 64, "rwkv", "model", False),
            (4, 2048, 112, 64, 64, "mamba-head", "model", False),
            (4, 2048, 112, 64, 64, "mamba-head", "spread", False),
            (4, 1000, 112, 64, 64, "mamba-head", "spread", False),
            (4, 2048, 112, 64, 64, "mamba-head", "spread", True)]
LS_TOL = {"y": 3e-2, "state": 2e-4}
LS_CHUNK = 32                    # rwkv6_3b's chunk of the TPU kernel's chunked form
# linear_scan backward cases: (B, S, H, K, V, form, dtype, with state, la)
# at the [train] path's shapes: rwkv6_3b's per-dim form with u, and
# zamba2_7b's per-head Mamba2 form (C and B broadcast over 112 heads), at
# TRAIN's batch of 4 x 1024; "with state": an initial state and a final
# state's gradient; la "mild": rwkv6's -exp(w0 + lora) around w0 = -0.6,
# Mamba2's -softplus(dt); "init": the decays as each model is initialised
# in its paper, far slower, so that states and gradients cross many
# chunks (rwkv6: w0 from -6 to -1 over the channels; Mamba2: A in [1, 16]
# and dt in [1e-3, 0.1] a head)
LS_BWD_CASES = [(4, 1024, 40, 64, 64, "rwkv", dt, st, "mild") for dt in ("bfloat16", "float32")
                for st in (False, True)] + \
               [(4, 1024, 112, 64, 64, "mamba-head", dt, st, "mild")
                for dt in ("bfloat16", "float32") for st in (False, True)] + \
               [(4, 1024, 40, 64, 64, "rwkv", "bfloat16", True, "init"),
                (4, 1024, 112, 64, 64, "mamba-head", "bfloat16", True, "init")]
LS_BWD_TOL = {"bfloat16": 2e-2, "float32": 2e-4}   # of each gradient's scale
# bf16 inputs: the fp32 outputs (dla, du, d_initial_state) against the
# float64 plain version, of their scale; and the sum over (b, t) of dla la
# for each head (per dim: each (head, dim)), the gradient of the decay's
# parameter (Mamba2's A_log, rwkv6's w0), of its scale
LS_BWD_F32_OUT_TOL = 1e-3
LS_BWD_DECAY_SUM_TOL = 1e-4
# what each kernel route is built from (csrc/*.cu)
DESIGN = {("flash_attention", "bfloat16"): "mma.sync m16n8k16 bf16, cp.async 2-stage K/V ring, "
                                           "128-query x 64-key tiles (8 warps x 16 rows), Q and P "
                                           "in registers, raw-score softmax on ex2.approx",
          ("flash_attention", "float32"): "fp32 FMA on the CUDA cores, 64 x 64 tiles",
          ("flash_attention", "non-causal"): "the CAUSAL template flag false: every key tile "
                                             "of Sk loaded, only the ragged last one masked "
                                             "(key < Sk), queries bounded by Sq",
          ("flash_attention", "unequal"): "template instances at (q.k, v) = (96, 64) and (48, 32): "
                                          "Q and K rows at DQK + 8, V and O at DV + 8, DQK / 16 "
                                          "k-steps of Q K^T, DV / 8 n-tiles of O (bf16); V tiles "
                                          "of DV columns (fp32)",
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
                                       "where 2 B H blocks fit one an SM",
          ("flash_attention_bwd", "bfloat16"): "wgmma m64nNk16 bf16 for all 7 tile products, one "
                                               "warpgroup a 64-key (dK/dV) or 64-query (dQ) "
                                               "tile; S^T = K Q^T so P^T, dS^T stay in registers "
                                               "as bf16 A operands; cp.async 2-stage rings of "
                                               "swizzled bf16 tiles; GQA heads split over chunks, "
                                               "fp32 partials summed in chunk order; no atomics",
          ("flash_attention_bwd", "float32"): "three launches, no atomics: rowsum(dO o) a warp a "
                                              "row; dK, dV a 64-key tile walking its GQA group's "
                                              "heads in order; dQ a 64-query tile; fp32 FMA "
                                              "64 x 64 tiles on the CUDA cores",
          ("linear_scan_bwd", "bfloat16"): "chunked, chunk-parallel: edge_bf16 walks the "
                                           "chunks of 32 (a block a (role, b, h): each chunk's "
                                           "S_in forward, G_out backward, fp32 scratch); "
                                           "chunk_bf16 a block a (chunk, b, h): mma.sync "
                                           "m16n8k16 bf16 with hi/lo splits, decays factored at "
                                           "16 and 8 steps, 8 x 8 diagonal blocks elementwise "
                                           "(per head, Mamba2: chunk_head_bf16, the decay matrix "
                                           "L of each chunk as SSD builds it, no factoring), dla "
                                           "from the edge states and the chunk's straddling "
                                           "pairs; du summed in order; no atomics",
          ("linear_scan_bwd", "float32"): "the exact sequential recurrence with float64 states, "
                                          "products and sums on the CUDA cores, no atomics, three "
                                          "launches: bwd_forward rebuilds the state for dq (a "
                                          "block of 256 threads a (b, h), four threads a state "
                                          "row); bwd_reverse walks the state's gradient in 2 "
                                          "roles (rows: dk, dla, d_initial_state; columns: dv); "
                                          "sum_du sums du over b in order; 16 steps staged in "
                                          "shared memory a chunk; dla from the gated-linear-"
                                          "attention identity"}
# the tensor-core functions of each bf16 route in the compiled library
# (nvcc's names); each must hold HMMA or HGMMA instructions
TC_FUNCS = {"flash_attention": ("flash_fwd_bf16",), "linear_scan": ("scan_bf16",),
            "flash_attention_bwd": ("dkdv_bf16", "dq_bf16"),
            "linear_scan_bwd": ("edge_bf16", "chunk_bf16", "chunk_head_bf16")}
SERVE = dict(batch=4, prompt_len=2048, gen=32)
# whisper_small: a prompt of 224 tokens, about half the decoder's 448
# positions (the longest previous-text prompt whisper's decoding keeps),
# after 1,500 stub audio frames; the cache is 256 positions
WHISPER_SERVE = dict(batch=4, prompt_len=224, gen=32)
WHISPER_ENCODER_TOL = 1e-3       # the encoder on the card against the CPU path, fp32, of scale
CONSISTENCY_LEN = 128            # prefill vs stepwise decode at full width
MOE_GATE_LEN = 8                 # an MoE model's gated check: 2 x 8 tokens, nothing drops
MOE_BF16_LAYERS = 1              # an MoE model's bf16 gate: its first layer (_moe_bf16)
FP32_CUT_LAYERS = 4              # a bf16-served model's fp32 gate: its first 4 layers drawn
                                 # alone (qwen3_moe 11.6 GiB, command_r_35b 19.7 GB in fp32)
# zamba2_7b's fp32 prefill-vs-stepwise gap is also read at (depth, the
# decode KV cache's dtype): the first 12 layers and the full 81, with the
# serving default's bf16 cache and with an fp32 one
ZAMBA2_GAP_READINGS = ((12, "bfloat16"), (12, "float32"), (81, "float32"))


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
    flash_attention, linear_scan, flash_attention_bwd and linear_scan_bwd
    libraries, read with ``cuobjdump -sass`` from nvcc's toolkit; fails if
    a function of a bf16 route named in ``TC_FUNCS`` is missing or has
    none."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    counts = {}
    for name, bf16_fns in TC_FUNCS.items():
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
        tc = {f: n for f, n in per_fn.items() if any(b in f for b in bf16_fns)}
        if any(not any(b in f for f in tc) for b in bf16_fns) or min(tc.values()) == 0:
            fail(f"{name}: a function of its bf16 route {bf16_fns} is missing or holds no "
                 f"tensor-core instruction ({per_fn})")
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
    launch order, with the names the profiler gives them.  CUPTI sometimes
    misses the first kernel of a profiled region (on an H100: the
    streaming encode's ``stream_hist<0>``, read as 4 kernels of 5), so the
    region opens with ``PROFILE_PAD`` spin kernels that are not counted,
    as in ``_profile_counts``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(10_000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    kernels, copies = [], []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if (str(getattr(e, "device_type", "")).endswith("CUDA")
                and "spin_kernel" not in e.name):
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
    """The forward kernel as serving launches it (grad disabled: no
    logsumexp written) against its plain version, timed: the causal cases,
    then the non-causal mode's."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(2)
    with torch.no_grad():
        for case in FA_CASES:
            B, S, H, KV, hd, dv, window, dtype = case
            _flash_attention_case(rows, gen, case, B, S, S, H, KV, hd, dv, window, True, dtype)
        for case in FA_NONCAUSAL_CASES:
            B, Sq, Sk, H, KV, hd, dtype = case
            _flash_attention_case(rows, gen, case, B, Sq, Sk, H, KV, hd, hd, None, False, dtype)
    torch.cuda.empty_cache()


def _flash_attention_case(rows, gen, case, B, Sq, Sk, H, KV, hd, dv, window, causal, dtype):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    dt = getattr(torch, dtype)
    q = torch.randn(B, Sq, H, hd, generator=gen, device="cuda").to(dt)
    k = torch.randn(B, Sk, KV, hd, generator=gen, device="cuda").to(dt)
    v = torch.randn(B, Sk, KV, dv, generator=gen, device="cuda").to(dt)
    kw = dict(window=window) if causal else dict(causal=False)
    got = ops.gqa_flash_attention(q, k, v, **kw)
    want = ref.gqa_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = FA_TOL[dtype]
    err = float((got.float() - want.float()).abs().max())
    dims = f"hd {hd}" if dv == hd else f"q.k {hd} / v {dv}"
    text = (f"(B {B}, S {Sq}, H {H}, KV {KV}, {dims}, window {window}) {dtype}" if causal else
            f"non-causal (B {B}, Sq {Sq}, Sk {Sk}, H {H}, KV {KV}, {dims}) {dtype}")
    if not (tuple(got.shape) == (B, Sq, H, dv) and bool(torch.isfinite(got).all())
            and torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)):
        fail(f"flash_attention {text}: max abs err {err:.3g} beyond rtol = atol = {tol}")
    say(f"[check] flash_attention {text}: max abs err {err:.6g} (rtol = atol = {tol})")
    esize = got.element_size()
    # q read and o written at Sq, k and v read at Sk; q.k^T at hd and p.v
    # at dv over the (query, key) pairs, causal or all Sq x Sk, 2
    # operations a multiply-add
    nbytes = B * ((Sq * H + Sk * KV) * hd + (Sk * KV + Sq * H) * dv) * esize
    nops = 2 * (_pairs(Sq, window) if causal else Sq * Sk) * B * H * (hd + dv)
    bms, bby = bound_ms(nbytes, nops, BF16_OPS_PER_S if dtype == "bfloat16" else FP32_OPS_PER_S)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib, lib_note = None, None
    if not causal or window is None or window >= Sq:     # the function SDPA computes
        # SDPA takes v narrower than q and k (Ev != E) on some of its
        # backends; where it refuses, the row says so
        try:
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                                 enable_gqa=True), 20, 3)
        except RuntimeError as e:
            lib_note = f"SDPA refused this call: {str(e).splitlines()[0][:160]}"
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:68",
        "shape": [B, Sq, H, KV, hd], "sk": Sk, "causal": causal, "dv": dv, "window": window,
        "dtype": dtype, "case": case,
        "design": DESIGN[("flash_attention", dtype)] + (
            "; " + DESIGN[("flash_attention", "unequal")] if dv != hd else "")
            + ("" if causal else "; " + DESIGN[("flash_attention", "non-causal")]),
        "max_abs_err": err, "tol": tol,
        "ms": cuda_ms(lambda: ops.gqa_flash_attention(q, k, v, **kw), 20, 3),
        "plain_ms": cuda_ms(lambda: ref.gqa_attention(q, k, v, **kw), 10, 2),
        "bound_ms": bms, "bound_by": bby, "bound_bytes": nbytes, "bound_ops": nops,
        "library_ms": lib,
        "library_call": (f"F.scaled_dot_product_attention(is_causal={causal}, enable_gqa=True)"
                         if lib is not None else lib_note)})
    del q, k, v, got, want


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
    import torch.nn.functional as F
    from repro_torch.kernels.linear_scan import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16

    def draw(*shape, uniform=False):
        return (torch.rand if uniform else torch.randn)(*shape, generator=gen, device="cuda")

    for B, S, H, K, V, form, la_kind, with_state in LS_CASES:
        head = form == "mamba-head"
        if head:    # C and B (B, S, K) broadcast over the heads: head stride 0, read in place
            q, k = (draw(B, S, K).to(bf)[:, :, None].expand(B, S, H, K) for _ in range(2))
        else:
            q, k = draw(B, S, H, K).to(bf), draw(B, S, H, K).to(bf)
        v = draw(B, S, H, V).to(bf)
        la_shape = (B, S, H) if head else (B, S, H, K)
        if la_kind == "model" and head:   # -exp(A_log) softplus(dt + dt_bias) at A_log = dt_bias = 0
            la = -F.softplus(draw(*la_shape))
        elif la_kind == "model":          # rwkv6's -exp(w0 + lora) around w0 = -0.6
            la = -torch.exp(0.5 * draw(*la_shape) - 0.6)
        elif la_kind == "clamp":          # a fifth of the entries below the clamp at -8
            la = -10.0 * draw(*la_shape, uniform=True)
        else:                             # "spread": three fifths below the per-dim clamp
            la = -20.0 * draw(*la_shape, uniform=True)
        u = draw(H, K, uniform=True) - 0.5 if form == "rwkv" else None
        s0 = draw(B, H, K, V) if with_state else None
        cur = form != "rwkv"
        y, st = ops.recurrence(q, k, v, la, u, include_current=cur, initial_state=s0)
        wy, ws = ref.recurrence(q, k, v, la, u, include_current=cur, initial_state=s0)
        torch.cuda.synchronize()
        err_y = float((y.float() - wy.float()).abs().max())
        err_s = float((st - ws).abs().max())
        case = (f"(B {B}, S {S}, H {H}, K {K}, V {V}) {form} form, la {la_kind}"
                f"{', initial state' if with_state else ''}, bf16 q/k/v")
        if not (bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
                and torch.allclose(y.float(), wy.float(), rtol=LS_TOL["y"], atol=LS_TOL["y"])
                and torch.allclose(st, ws, rtol=LS_TOL["state"], atol=LS_TOL["state"])):
            fail(f"linear_scan {case}: max abs err y {err_y:.3g}, final state {err_s:.3g} "
                 f"beyond {LS_TOL}")
        say(f"[check] linear_scan {case}: max abs err y {err_y:.6g} (rtol = atol = "
            f"{LS_TOL['y']}), final state {err_s:.6g} (rtol = atol = {LS_TOL['state']})"
            f"{' against the unclamped plain scan' if head else ''}")
        # the function's bytes: q and k a head (the per-head form's C and B
        # once a (b, s); the kernel reads them once a head, L2-served), v
        # and y a head, la a (b, s, head) or a dim, u, the states
        nbytes = (B * S * (2 * K * 2 * (1 if head else H) + H * (V * 2 * 2 + 4 * (1 if head else K)))
                  + (H * K * 4 if u is not None else 0) + B * H * K * V * 4 * (2 if with_state else 1))
        nops = _linear_scan_ops(B, S, H, K, V)
        bms, bby = bound_ms(nbytes, nops, TF32_OPS_PER_S)
        design = DESIGN[("linear_scan", "bfloat16")] + (
            "; la per head read a float a step, unclamped; C and B read in place through a head "
            "stride of 0" if head else "")
        rows.append({
            "name": "linear_scan", "route": "cuda", "source": "src/repro_torch/csrc/linear_scan.cu",
            "replaces": "src/repro/kernels/linear_scan/kernel.py:78",
            "shape": [B, S, H, K, V], "form": form, "la": la_kind, "initial_state": with_state,
            "dtype": "bfloat16", "design": design,
            "max_abs_err": max(err_y, err_s), "max_abs_err_y": err_y, "max_abs_err_state": err_s,
            "ms": cuda_ms(lambda: ops.recurrence(q, k, v, la, u, include_current=cur,
                                                 initial_state=s0), 20, 3),
            "plain_ms": cuda_ms(lambda: ref.recurrence(q, k, v, la, u, include_current=cur,
                                                       initial_state=s0), 3, 1),
            "bound_ms": bms, "bound_by": bby, "bound_bytes": nbytes, "bound_ops": nops,
            "kernel_read_bytes_qk": 2 * B * S * H * K * 2,
            "library_ms": None, "library_call": None})
        del q, k, v, la, y, wy, s0
    torch.cuda.empty_cache()


def _linear_scan_bwd_ops(B, S, H, K, V) -> int:
    """Operations of a chunked backward on the same terms as
    ``_linear_scan_ops``: the forward's products recomputed, then per
    chunk and (b, h) the score gradients dy v^T and their products with k
    and q (the causal C x C triangle against V, then twice against K),
    the scores' transpose against dy, and four C K V products (dq's
    readout of the state, dk and dv against the state's gradient, that
    gradient's update)."""
    C = LS_CHUNK
    tri = C * (C + 1) // 2
    per_chunk = tri * (V + 2 * K + V) + 4 * C * K * V
    return _linear_scan_ops(B, S, H, K, V) + 2 * per_chunk * B * H * -(-S // C)


def phase_linear_scan_bwd(rows: list):
    """The linear_scan backward kernel at the [train] path's shapes
    (``LS_BWD_CASES``) against its plain version, ``ref.recurrence_bwd``
    (float64), on the same inputs: every gradient within ``LS_BWD_TOL``
    of its scale, the fp32 outputs of bf16 inputs within
    ``LS_BWD_F32_OUT_TOL``, the decay parameter's gradient (the sum of
    dla la over (b, t)) within ``LS_BWD_DECAY_SUM_TOL``, a rerun
    bit-equal; timed beside its bound and the plain backward (no single
    PyTorch call computes it), with each CUDA kernel's device time of one
    call (``torch.profiler``)."""
    import math
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.linear_scan import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(5)
    names = ("dq", "dk", "dv", "dla", "du", "d_initial_state")

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def uniform(n, lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device="cuda")

    for B, S, H, K, V, form, dtype, with_state, la_kind in LS_BWD_CASES:
        dt = getattr(torch, dtype)
        head = form == "mamba-head"
        if head:     # C and B broadcast over the heads (head stride 0), la a head
            q, k = (draw(B, S, K).to(dt)[:, :, None].expand(B, S, H, K) for _ in range(2))
            if la_kind == "init":   # -A softplus(dt_proj + dt_bias), softplus(dt_bias) in [1e-3, 0.1]
                a_head = uniform(H, 1.0, 16.0)
                dt0 = torch.exp(uniform(H, math.log(1e-3), math.log(0.1)))
                dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
                la = -a_head * F.softplus(0.5 * draw(B, S, H) + dt_bias)
            else:
                la = -F.softplus(draw(B, S, H))
        else:        # -exp(w0 + lora), u
            q, k = draw(B, S, H, K).to(dt), draw(B, S, H, K).to(dt)
            if la_kind == "init":   # w0 = -6 + 5 (n / (HK - 1))^1.35 over the channels n
                n = torch.arange(H * K, device="cuda").reshape(H, K) / (H * K - 1)
                la = -torch.exp(-6.0 + 5.0 * n ** 1.35 + 0.1 * draw(B, S, H, K))
            else:
                la = -torch.exp(0.5 * draw(B, S, H, K) - 0.6)
        v, dy = draw(B, S, H, V).to(dt), draw(B, S, H, V).to(dt)
        u = draw(H, K) * 0.5 if not head else None
        s0 = draw(B, H, K, V) if with_state else None
        ds = draw(B, H, K, V) if with_state else None
        cur = head
        got = ops._launch_bwd(q, k, v, la, u, dy, ds, cur, s0)
        again = ops._launch_bwd(q, k, v, la, u, dy, ds, cur, s0)
        want = ref.recurrence_bwd(q, k, v, la, u, dy, ds, include_current=cur, initial_state=s0)
        torch.cuda.synchronize()
        case = (f"(B {B}, S {S}, H {H}, K {K}, V {V}) {'per-head (Mamba2)' if head else 'per-dim (RWKV6, u)'} "
                f"form, la {la_kind}{', initial state and final-state gradient' if with_state else ''}"
                f", {dtype}")
        errs = {}
        for name, a, b, c in zip(names, got, want, again):
            if b is None:
                if a is not None:
                    fail(f"linear_scan backward {case}: {name} returned where the plain has none")
                continue
            tol = LS_BWD_TOL[dtype]
            if name in ("dla", "du", "d_initial_state"):
                tol = min(tol, LS_BWD_F32_OUT_TOL)
            scale = float(b.float().abs().max())
            err = float((a.float() - b.float()).abs().max())
            errs[name] = err / scale
            if not (a.dtype == b.dtype and bool(torch.isfinite(a).all()) and err <= tol * scale):
                fail(f"linear_scan backward {case}: {name} max abs err {err:.3g} beyond "
                     f"{tol} x its scale {scale:.3g}")
            if not torch.equal(a, c):
                fail(f"linear_scan backward {case}: two launches on one input differ in {name}")
        want_sum = (want[3].double() * la.double()).sum((0, 1))
        got_sum = (got[3].double() * la.double()).sum((0, 1))
        sum_err = float((got_sum - want_sum).abs().max() / want_sum.abs().max())
        if not sum_err <= LS_BWD_DECAY_SUM_TOL:
            fail(f"linear_scan backward {case}: the sum of dla la over (b, t) is {sum_err:.3g} "
                 f"of its scale from the float64 plain version's, beyond {LS_BWD_DECAY_SUM_TOL}")
        say(f"[linear_scan] backward {case}: la from {float(la.min()):.4g} to "
            f"{float(la.max()):.4g}; max abs err / scale "
            + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
            + f" (limit {LS_BWD_TOL[dtype]}; dla, du, d_initial_state "
            f"{min(LS_BWD_TOL[dtype], LS_BWD_F32_OUT_TOL)}), sum of dla la over (b, t) a "
            f"{'head' if head else '(head, dim)'} {sum_err:.3g} (limit {LS_BWD_DECAY_SUM_TOL}), "
            f"rerun bit-equal")
        esize = v.element_size()
        nbytes = (B * S * H * V * 3 * esize                     # v, dy read; dv written
                  + B * S * K * 4 * esize * (1 if head else H)  # q, k read; dq, dk written
                  + B * S * H * (1 if head else K) * 4 * 2      # la read, dla written
                  + (H * K * 4 * 2 if u is not None else 0)     # u read, du written
                  + (B * H * K * V * 4 * 3 if with_state else 0))   # s0, dS read; d_s0 written
        nops = _linear_scan_bwd_ops(B, S, H, K, V)
        bms, bby = bound_ms(nbytes, nops, TF32_OPS_PER_S)
        ms = cuda_ms(lambda: ops._launch_bwd(q, k, v, la, u, dy, ds, cur, s0), 10, 2)
        plain = cuda_ms(lambda: ref.recurrence_bwd(q, k, v, la, u, dy, ds, include_current=cur,
                                                   initial_state=s0), 1, 1)
        kernel_us = [[name.replace("void ", "").replace("(anonymous namespace)::", "")
                      .split("(")[0].split("<")[0], us] for name, us in
                     device_activity(lambda: ops._launch_bwd(q, k, v, la, u, dy, ds, cur,
                                                             s0))["kernels"]]
        say(f"[linear_scan] backward {case}: {ms:.4f} ms, bound {bms:.4f} ms ({bby}, "
            f"{nbytes / 1e9:.4f} GB), {ms / bms:.1f} x the bound; plain {plain:.2f} ms; "
            f"one call's kernels (torch.profiler, device us): "
            + ", ".join(f"{n} {us:.1f}" for n, us in kernel_us))
        rows.append({
            "name": "linear_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/linear_scan_bwd.cu",
            "replaces": "src/repro/kernels/linear_scan/kernel.py:78",
            "replaces_note": "the gradient of that forward-only TPU kernel's function; the "
                             "reference trains through its chunked jnp recurrence",
            "shape": [B, S, H, K, V], "form": form, "dtype": dtype, "state": with_state,
            "la": la_kind, "design": DESIGN[("linear_scan_bwd", dtype)],
            "max_abs_err": max(errs.values()), "max_abs_err_is": "of each gradient's scale",
            "tol": LS_BWD_TOL[dtype], "decay_sum_err": sum_err, "kernel_us": kernel_us,
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": bby,
            "bound_bytes": nbytes, "bound_ops": nops, "library_ms": None, "library_call": None})
        del q, k, v, la, dy, s0, ds, got, again, want
        torch.cuda.empty_cache()


def _reset_launches():
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.grad_diff_norm import ops as gd
    from repro_torch.kernels.linear_scan import ops as ls
    from repro_torch.kernels.topk_quant import ops as tq
    counters = {"grad_diff_norm": (gd, "launches"), "topk_quant": (tq, "launches"),
                "flash_attention": (fa, "launches"), "flash_attention_bwd": (fa, "bwd_launches"),
                "linear_scan": (ls, "launches"), "linear_scan_bwd": (ls, "bwd_launches")}
    for m, attr in counters.values():
        setattr(m, attr, 0)
    return lambda: {name: getattr(m, attr) for name, (m, attr) in counters.items()}


def _prefill_vs_stepwise(cfg, params, cache_dtype: str = "bfloat16",
                         length: int = CONSISTENCY_LEN, encoder_embeds=None) -> tuple:
    """Last-position logits of one prefill of ``length`` tokens (the
    kernel path) against as many decode_step calls (plain PyTorch) over a
    KV cache of ``cache_dtype``, batch 2, an encoder-decoder's on
    ``encoder_embeds`` (2, F, d) (decode reads the cross caches that
    ``init_cache`` fills): (max abs difference, scale = max |stepwise
    logits|)."""
    import torch
    from repro_torch.models import decoder
    prompt = _check_prompt(cfg, length)
    with torch.no_grad():
        lp, _, _ = decoder.prefill(cfg, params, prompt, length, encoder_embeds=encoder_embeds)
        cache = decoder.init_cache(cfg, params, 2, length, encoder_embeds=encoder_embeds,
                                   dtype=getattr(torch, cache_dtype))
        for t in range(length):
            ls, cache = decoder.decode_step(cfg, params, cache, prompt[:, t:t + 1], t)
    if not (bool(torch.isfinite(lp).all()) and bool(torch.isfinite(ls).all())):
        fail(f"{cfg.name}: non-finite logits in prefill or decode_step")
    lp, ls = (x[..., :cfg.vocab_size].float() for x in (lp, ls))   # not the -1e30 padding
    return float((lp - ls).abs().max()), float(ls.abs().max())


def _check_prompt(cfg, length: int):
    """The prefill-vs-stepwise check's prompt: 2 x ``length`` tokens."""
    import numpy as np
    import torch
    return torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=(2, CONSISTENCY_LEN))[:, :length]).to("cuda")


def _moe_dispatch(cfg, params, tokens) -> tuple:
    """What the MoE layers of one prefill of ``tokens`` route (a reading
    beside the path, not a kernel launch): a plain loop over the layers
    computes each layer as ``decoder._apply_layer`` does and reads
    ``moe.dispatch_counts`` on each MoE input.  Its last-position logits
    must equal ``decoder.prefill``'s bit for bit, so what it read is what
    the prefill routed.  Returns (the (token, choice) pairs dropped beyond
    capacity over all layers, [each layer's pairs routed to each
    expert])."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import decoder
    from repro_torch.models import moe
    from repro_torch.models.layers import apply_norm
    drops, loads = [], []
    with torch.no_grad():
        p = decoder.cast_params(cfg, params)
        x = decoder._embed(cfg, p, tokens)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        rs = decoder._residual_scale(cfg)
        for gp, (tag, count) in zip(p["groups"], decoder.layer_groups(cfg)):
            if tag != ("attn", True):
                fail(f"{cfg.name}: the routing reading takes attention + MoE layers, not {tag}")
            for i in range(count):
                lp = decoder._layer(gp, i)
                h = apply_norm(lp["norm1"], x, cfg.norm, cfg.norm_eps)
                x = x + attn.attention_forward(lp["attn"], cfg, h, positions,
                                               window=cfg.sliding_window) * rs
                h = apply_norm(lp["norm2"], x, cfg.norm, cfg.norm_eps)
                d, load = moe.dispatch_counts(lp["moe"], cfg, h)
                drops.append(d)
                loads.append(load)
                x = x + moe.moe_forward(lp["moe"], cfg, h)[0] * rs
        got = decoder._logits(cfg, p, x[:, -1:])
        want, _, _ = decoder.prefill(cfg, params, tokens, tokens.shape[1])
    if not torch.equal(got, want):
        fail(f"{cfg.name}: the routing reading's layer loop computed other logits than "
             f"decoder.prefill ({float((got.float() - want.float()).abs().max()):.4g} apart)")
    return int(sum(int(d) for d in drops)), [x.tolist() for x in loads]


def _prefill_launches(cfg) -> dict:
    """The kernel launches of one prefill: one flash_attention an
    attention layer or shared-attention invocation, one linear_scan an
    RWKV6 or Mamba2 layer."""
    kernel = {"attn": "flash_attention", "shared_attn": "flash_attention",
              "rwkv6": "linear_scan", "mamba2": "linear_scan"}
    want = {}
    for kind in cfg.pattern():
        want[kernel[kind]] = want.get(kernel[kind], 0) + 1
    return want


def _cut_depth(cfg, params, depth: int) -> tuple:
    """The first ``depth`` layers of ``cfg`` and ``params`` (the same
    weights: views, no copy)."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.models import decoder
    groups, n = [], 0
    for gp, (_, count) in zip(params["groups"], decoder.layer_groups(cfg)):
        take = min(count, depth - n)
        groups.append(gp if take == count else tree_map(lambda x: x[:take], gp))
        n += take
        if n == depth:
            return (cfg.replace(num_layers=depth, layer_pattern=cfg.pattern()[:depth]),
                    dict(params, groups=groups))
    fail(f"{cfg.name}: depth {depth} beyond its {cfg.num_layers} layers")


def phase_serve(arch: str, check_dtype: str, readings: tuple = (), fp32_layers: int = 0,
                prefix: bool = False) -> dict:
    """serve() at the architecture's full configuration, then a full-width
    check of prefill (the kernel path) against stepwise decode (plain
    PyTorch) over the bf16 KV cache serving uses, gated at 2e-2 of the
    logits' scale in ``check_dtype``; the same check at each of
    ``readings``, (depth, cache dtype): the first layers of the same
    weights, and the decode cache's dtype.  The weights are drawn in
    ``check_dtype``, each leaf cast as it is drawn (``init_params(dtype=)``:
    qwen3_moe_30b_a3b's and command_r_35b's fp32 draws would not fit the
    card).  With ``fp32_layers`` the first that many layers are first
    drawn alone in fp32 (the same draws as the full model's first layers)
    and gated in fp32 before the full draw.  With ``prefix`` (the VLM
    stub; ``check_dtype`` fp32) the fp32 draw is also gated on the prefix
    path (``_prefix_gate``) and the served weights run it
    (``_prefix_path``).

    An MoE model's checks are ``_moe_bf16``'s, on the served bf16
    weights, and ``_moe_stepwise``'s on the fp32 weights (the fp32 draw,
    or the ``fp32_layers`` drawn alone for a model drawn in bf16): gated
    on a prompt of 2 x ``MOE_GATE_LEN`` tokens, one group at full
    capacity, in fp32; a
    prefill of 2 x CONSISTENCY_LEN tokens drops (token, choice) pairs
    beyond the capacity that the reference's contract gives a 256-token
    group, and decode, one group of 2 tokens, drops none, so there the two
    paths differ by design: that reading is printed with the prefill's
    drop count and not gated.  So are the serve prefill's drop count and
    the expert load of its first and last MoE layer."""
    import numpy as np
    import torch
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.launch.serve import serve
    from repro_torch.models import decoder
    from repro_torch.models.moe import _capacity
    from repro_torch.models.registry import get_config

    cfg = get_config(arch)
    moe = cfg.moe is not None
    gaps = {}
    has_kv = any(kind in ("attn", "shared_attn") for kind in cfg.pattern())

    def check(c, p, cache_dtype="bfloat16", what="", compute=check_dtype):
        cc = c.replace(compute_dtype=compute)
        if moe:
            gaps.update(_moe_stepwise(arch, cc, p, what))
            return
        kv = f", {cache_dtype} {'latent' if c.mla else 'KV'} cache" if has_kv else ""
        err, scale = _prefill_vs_stepwise(cc, p, cache_dtype)
        gaps[f"{c.num_layers} layers{what}, {compute}{kv}"] = err / scale
        say(f"[serve] {arch}: prefill of {CONSISTENCY_LEN} tokens vs {CONSISTENCY_LEN} "
            f"decode_step calls at full width, {c.num_layers} layers{what}, "
            f"{cc.compute_dtype} compute{kv}: last-position logits max abs diff {err:.4g} of "
            f"scale {scale:.4g} ({err / scale:.3g}; limit 2e-2)")
        if not err <= 2e-2 * scale:
            fail(f"{arch}: prefill vs stepwise decode {err:.4g} apart at {c.num_layers} layers, "
                 f"beyond 2e-2 x {scale:.4g}")

    if moe and check_dtype != "float32" and not fp32_layers:
        fail(f"{arch}: an MoE model drawn in {check_dtype} needs fp32_layers for its fp32 gate")
    torch.cuda.reset_peak_memory_stats()
    if fp32_layers:
        cut = cfg.replace(num_layers=fp32_layers, compute_dtype="float32")
        h0 = time.perf_counter()
        p32 = decoder.init_params(cut, torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        say(f"[serve] {arch}: reduced: its first {fp32_layers} of {cfg.num_layers} layers drawn "
            f"alone in float32 ({sum(x.numel() for x in tree_leaves(p32))} parameters: the full "
            f"draw's embedding and first layers, unrounded) in {time.perf_counter() - h0:.1f} s")
        check(cut, p32, what=" (drawn alone)", compute="float32")
        del p32
        torch.cuda.empty_cache()
    h0 = time.perf_counter()
    params = decoder.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                 dtype=getattr(torch, check_dtype))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    say(f"[serve] {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} heads "
        f"({cfg.num_kv_heads} kv) of {cfg.head_dim}"
        + (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k} of d_ff "
           f"{cfg.moe.d_ff_expert}" if moe else f", d_ff {cfg.d_ff}")
        + f"{', qk-norm' if cfg.qk_norm else ''}"
        + (f", MLA q_lora {cfg.mla.q_lora_rank}, kv_lora {cfg.mla.kv_lora_rank}, q.k "
           f"{cfg.mla.qk_nope_head_dim} + {cfg.mla.qk_rope_head_dim}, v {cfg.mla.v_head_dim}"
           if cfg.mla else "")
        + (", parallel attention + FFN blocks" if cfg.parallel_block else "")
        + (f", {cfg.frontend.num_prefix_tokens} {cfg.frontend.kind} prefix embeddings"
           if cfg.frontend else "")
        + f", vocab {cfg.vocab_size}: {n_params} parameters "
        f"drawn in {cfg.param_dtype}"
        + (f", each leaf cast to {check_dtype} as drawn" if check_dtype != cfg.param_dtype else "")
        + f", in {time.perf_counter() - h0:.1f} s")

    if check_dtype == "float32":
        check(cfg, params)
        for depth, cache_dtype in readings:
            check(*_cut_depth(cfg, params, depth), cache_dtype)
        if prefix:
            gaps.update(_prefix_gate(arch, cfg, params))
    params = decoder.cast_params(cfg, params)       # once; the fp32 draws are freed here
    leaves = tree_leaves(params)
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    say(f"[serve] {arch}: in {cfg.compute_dtype}: {nbytes / 1e9:.3f} GB on the card")
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
    per_prefill = _prefill_launches(cfg)
    want = {k: per_prefill.get(k, 0) for k in launches}
    if launches != want:
        fail(f"{arch}: kernel launches {launches}, expected {want} (one a layer or shared "
             f"invocation in the prefill, none in decode)")
    say(f"[serve] {arch}: serve(batch={SERVE['batch']}, prompt_len={SERVE['prompt_len']}, "
        f"gen={SERVE['gen']}): prefill {stats['prefill_s']:.4f} s, decode {stats['decode_s']:.4f} s "
        f"({stats['decode_tok_per_s']:.2f} tok/s), logits finite, kernel launches {launches}, "
        f"sample {toks[0, :8].tolist()}")
    out = {}
    if moe:
        # serve()'s prompt (np.random.RandomState(seed=0)), read again beside the path
        prompt = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, size=(SERVE["batch"], SERVE["prompt_len"]))).to("cuda")
        dropped, loads = _moe_dispatch(cfg, params, prompt)
        pairs = SERVE["batch"] * SERVE["prompt_len"] * cfg.moe.top_k
        g = min(2048, SERVE["batch"] * SERVE["prompt_len"])
        # decode reads every expert's weights each step (the reference's
        # capacity dispatch at C = batch): its weight-read bound
        table = params["embed"]["table"]
        read_bytes = nbytes - (0 if cfg.tie_embeddings else table.numel() * table.element_size())
        out = dict(dropped_pairs=dropped, pairs=pairs,
                   load_first=(min(loads[0]), max(loads[0])),
                   load_last=(min(loads[-1]), max(loads[-1])),
                   decode_bound_ms=read_bytes / HBM_BYTES_PER_S * 1e3)
        say(f"[serve] {arch}: the serve prefill's MoE routing (not gated): groups of {g} "
            f"tokens at capacity {_capacity(g, cfg)} an expert; {dropped} of {pairs} (token, "
            f"choice) pairs a layer x {cfg.num_layers} layers dropped "
            f"({dropped / (pairs * cfg.num_layers):.3%}); pairs an expert, min / max, layer 0 "
            f"{out['load_first'][0]} / {out['load_first'][1]}, layer {cfg.num_layers - 1} "
            f"{out['load_last'][0]} / {out['load_last'][1]} (mean "
            f"{pairs / cfg.moe.num_experts:.1f}); decode reads every expert a step: "
            f"{read_bytes / 1e9:.2f} GB, a bound of {out['decode_bound_ms']:.3f} ms a step "
            f"against {stats['decode_s'] / SERVE['gen'] * 1e3:.3f} ms")
        gaps.update(_moe_bf16(arch, cfg, params))
    if prefix:
        out["prefix"] = _prefix_path(arch, cfg, params)
    if check_dtype == "bfloat16" and not moe:
        check(cfg, params)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params, leaves
    torch.cuda.empty_cache()
    return dict(stats, launches={k: launches[k] for k in per_prefill}, peak_gb=peak,
                stepwise_gap_by_depth=gaps, **out)


def _whisper_frames(cfg, batch: int):
    """serve()'s stub audio frames: 0.02 N(0, 1) of (batch, 1500, 768),
    fp32, from ``torch.Generator("cuda").manual_seed(9)``."""
    import torch
    return 0.02 * torch.randn((batch, cfg.encoder.num_frames, cfg.d_model), device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(9))


def phase_serve_whisper(seed: int = 0) -> dict:
    """``[serve] whisper_small``: the encoder-decoder at its published
    configuration (12 encoder and 12 decoder layers, d 768, 12 heads of
    64, vocab 51,865 padded to 51,968, 1,500 stub frames), weights drawn
    from ``seed`` in fp32.  First the encoder on the card against the
    port's CPU path on the same weights, batch 1, fp32, at
    WHISPER_ENCODER_TOL of its scale; then the weights cast to bf16 and
    ``serve(batch=4, prompt_len=224, gen=32)``: its prefill runs the
    encoder over serve()'s frames and the 12 decoder layers, and must
    launch flash_attention 36 times, 12 each for the encoder's
    self-attention (non-causal, 1,500 over 1,500), the decoder's causal
    self-attention (224) and the cross-attention (non-causal, 224 over
    1,500), and nothing in decode; then the prefill of CONSISTENCY_LEN
    tokens against as many decode_step calls over the bf16 cache, on
    serve()'s first 2 frame sets, gated in bf16 at 2e-2 of the logits'
    scale."""
    import torch
    from unittest import mock
    from repro_torch.common.pytree import tree_leaves, tree_map
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.serve import serve
    from repro_torch.models import decoder
    from repro_torch.models.registry import get_config
    arch = "whisper_small"
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    h0 = time.perf_counter()
    p32 = decoder.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    say(f"[serve] {arch}: {cfg.encoder.num_layers} encoder + {cfg.num_layers} decoder layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads} heads ({cfg.num_kv_heads} kv) of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, {cfg.encoder.num_frames} stub audio frames, vocab "
        f"{cfg.vocab_size} (padded to {cfg.padded_vocab()}): "
        f"{sum(x.numel() for x in tree_leaves(p32))} parameters drawn in float32 from seed "
        f"{seed} in {time.perf_counter() - h0:.1f} s")
    frames = _whisper_frames(cfg, WHISPER_SERVE["batch"])
    c32 = cfg.replace(compute_dtype="float32")
    with torch.no_grad():
        h0 = time.perf_counter()
        got = decoder._encode(c32, p32, frames[:1])
        torch.cuda.synchronize()
        h1 = time.perf_counter()
        want = decoder._encode(c32, tree_map(lambda x: x.cpu(), {"encoder": p32["encoder"]}),
                               frames[:1].cpu())
        h2 = time.perf_counter()
    enc_err, enc_scale = float((got.cpu() - want).abs().max()), float(want.abs().max())
    say(f"[serve] {arch}: the encoder over 1 x {cfg.encoder.num_frames} frames in float32, card "
        f"({h1 - h0:.3f} s) against the CPU path ({h2 - h1:.3f} s) on the same weights: max abs "
        f"diff {enc_err:.4g} of scale {enc_scale:.4g} ({enc_err / enc_scale:.3g}; limit "
        f"{WHISPER_ENCODER_TOL:g})")
    if not (bool(torch.isfinite(got).all()) and enc_err <= WHISPER_ENCODER_TOL * enc_scale):
        fail(f"{arch}: the encoder on the card is {enc_err:.4g} from the CPU path, beyond "
             f"{WHISPER_ENCODER_TOL:g} x {enc_scale:.4g}")
    params = decoder.cast_params(cfg, p32)
    del p32, got, want
    torch.cuda.empty_cache()
    nbytes = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    say(f"[serve] {arch}: in {cfg.compute_dtype}: {nbytes / 1e9:.3f} GB on the card")
    serve(arch, smoke=False, batch=WHISPER_SERVE["batch"], prompt_len=WHISPER_SERVE["prompt_len"],
          gen=2, params=params, verbose=False)      # warm-up: cuBLAS handles, allocator
    kinds = {"encoder": 0, "self": 0, "cross": 0}
    launch = fa._launch

    def seen(q, k, v, window, causal=True, need_lse=False):   # which attention, by its mode
        kinds["self" if causal else "encoder" if q.shape[1] == k.shape[1] else "cross"] += 1
        return launch(q, k, v, window, causal, need_lse)

    stats = {}
    read = _reset_launches()
    with mock.patch.object(fa, "_launch", seen):
        toks = serve(arch, smoke=False, **WHISPER_SERVE, params=params, stats=stats,
                     verbose=False)
    launches = read()                               # read just after the main path
    if not stats["logits_finite"]:
        fail(f"{arch}: non-finite logits in serve()")
    if toks.shape != (WHISPER_SERVE["batch"], WHISPER_SERVE["gen"]) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        fail(f"{arch}: serve() returned tokens of shape {toks.shape} in "
             f"[{toks.min()}, {toks.max()}]")
    want = {k: 0 for k in launches}
    want["flash_attention"] = 3 * cfg.num_layers
    if launches != want or kinds != {k: cfg.num_layers for k in kinds}:
        fail(f"{arch}: kernel launches {launches} ({kinds}), expected {want} (12 encoder, 12 "
             f"decoder self, 12 cross in the prefill, none in decode)")
    say(f"[serve] {arch}: serve(batch={WHISPER_SERVE['batch']}, prompt_len="
        f"{WHISPER_SERVE['prompt_len']}, gen={WHISPER_SERVE['gen']}) after "
        f"{WHISPER_SERVE['batch']} x {cfg.encoder.num_frames} frames: prefill "
        f"{stats['prefill_s']:.4f} s (the encoder's included), decode {stats['decode_s']:.4f} s "
        f"({stats['decode_tok_per_s']:.2f} tok/s), logits finite, kernel launches {launches} "
        f"({kinds}), sample {toks[0, :8].tolist()}")
    err, scale = _prefill_vs_stepwise(cfg, params, encoder_embeds=frames[:2])
    say(f"[serve] {arch}: prefill of {CONSISTENCY_LEN} tokens vs {CONSISTENCY_LEN} decode_step "
        f"calls at full width, {cfg.num_layers} layers, {cfg.compute_dtype} compute, bfloat16 KV "
        f"and cross cache: last-position logits max abs diff {err:.4g} of scale {scale:.4g} "
        f"({err / scale:.3g}; limit 2e-2)")
    if not err <= 2e-2 * scale:
        fail(f"{arch}: prefill vs stepwise decode {err:.4g} apart, beyond 2e-2 x {scale:.4g}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params
    torch.cuda.empty_cache()
    return dict(stats, launches={"flash_attention": launches["flash_attention"]},
                kinds=kinds, peak_gb=peak, stepwise_gap=err / scale,
                encoder_gap=enc_err / enc_scale)


def _prefix_inputs(cfg, batch: int) -> tuple:
    """The VLM stub's inputs: ``cfg.frontend.num_prefix_tokens`` prefix
    embeddings, 0.02 N(0, 1) from a seeded generator as the reference
    draws stub embeddings, in the compute dtype, and serve()'s prompt
    (``np.random.RandomState(0)``) of SERVE's prompt_len tokens."""
    import numpy as np
    import torch
    gen = torch.Generator(device="cuda").manual_seed(9)
    prefix = 0.02 * torch.randn(batch, cfg.frontend.num_prefix_tokens, cfg.d_model,
                                generator=gen, device="cuda")
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(batch, SERVE["prompt_len"]))).to("cuda")
    return prefix.to(getattr(torch, cfg.compute_dtype)), tokens


def _prefix_gap(cfg, params, prefix, tokens, whole=None) -> tuple:
    """A prefix prefill (``make_prefill_step``) of the first n - 1 of
    ``tokens`` and one ``make_serve_step`` of the last at position
    prefix + n - 1 (plain PyTorch over serving's bf16 KV cache), against
    the last logits of the prefix prefill of all n (``whole``, computed
    here unless given): (max abs difference, scale = max |stepwise
    logits|)."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    P, n = prefix.shape[1], tokens.shape[1]
    prefill_fn = make_prefill_step(cfg, fill_cache=True, cache_len=P + n)
    if whole is None:
        whole = prefill_fn(params, {"tokens": tokens, "prefix_embeds": prefix})[0][:, -1]
    _, cache = prefill_fn(params, {"tokens": tokens[:, :-1], "prefix_embeds": prefix})
    step, _ = make_serve_step(cfg)(params, cache, tokens[:, -1:], P + n - 1)
    del cache
    lw, ls = (x[..., :cfg.vocab_size].float() for x in (whole, step[:, -1]))
    if not (bool(lw.isfinite().all()) and bool(ls.isfinite().all())):
        fail(f"{cfg.name}: non-finite logits on the prefix path")
    return float((lw - ls).abs().max()), float(ls.abs().max())


def _prefix_gate(arch, cfg, params) -> dict:
    """The prefix path's gate, in fp32 compute on the fp32 draw, batch 2:
    ``_prefix_gap`` at the full prefix and prompt (1,152 + 2,048
    positions), within 2e-2 of the logits' scale.  In fp32 the two paths
    compute one function but for the bf16 KV cache decode reads."""
    cfg = cfg.replace(compute_dtype="float32")
    prefix, tokens = _prefix_inputs(cfg, 2)
    err, scale = _prefix_gap(cfg, params, prefix, tokens)
    P, n = prefix.shape[1], tokens.shape[1]
    say(f"[serve] {arch}: prefix path gate: a prefix prefill of 2 x ({P} prefix embeddings + "
        f"{n - 1} tokens) + one decode_step at position {P + n - 1} against the prefix prefill "
        f"of all {n}, float32 compute, bfloat16 KV cache: last-position logits max abs diff "
        f"{err:.4g} of scale {scale:.4g} ({err / scale:.3g}; limit 2e-2)")
    if not err <= 2e-2 * scale:
        fail(f"{arch}: prefix prefill + decode_step vs prefill {err:.4g} apart, beyond "
             f"2e-2 x {scale:.4g}")
    return {f"prefix path, {cfg.num_layers} layers, float32, bfloat16 KV cache": err / scale}


def _prefix_path(arch, cfg, params) -> dict:
    """The VLM stub's serving path on the served weights:
    ``make_prefill_step`` on ``_prefix_inputs``' prefix embeddings before
    serve()'s prompt (SERVE's batch x prompt_len tokens), then
    ``make_serve_step`` greedily decoding SERVE's gen tokens from position
    prefix + prompt_len, timed as serve() times its two halves; the
    flash_attention launches of the run counted (one a layer, in the
    prefill).  The same ``_prefix_gap`` as ``_prefix_gate``'s is read here
    in bf16 and printed, not gated: on the H100 it sits at 0.0195 of the
    scale, and 0.0190 with decode's attention scores, probabilities and
    p·v kept in fp32 (``serve_gate_probe.py``), so the rest of the two
    paths' bf16 rounding sets it (PERF.md §7).  Returns the times,
    launches and that reading."""
    import torch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    B, T, G = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    prefix, tokens = _prefix_inputs(cfg, B)
    P = prefix.shape[1]
    prefill_fn = make_prefill_step(cfg, fill_cache=True, cache_len=P + T + G)
    step_fn = make_serve_step(cfg)
    batch = {"tokens": tokens, "prefix_embeds": prefix}
    prefill_fn(params, batch)                       # warm-up at this length
    torch.cuda.synchronize()
    read = _reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill_fn(params, batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    whole = logits[:, -1]
    tok, out = torch.argmax(whole, dim=-1)[:, None], []
    for t in range(P + T, P + T + G):
        out.append(tok)
        logits, cache = step_fn(params, cache, tok, t)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0 - t_prefill
    launches = read()                               # read just after the prefix path
    want = {k: (cfg.num_layers if k == "flash_attention" else 0) for k in launches}
    if launches != want:
        fail(f"{arch}: the prefix path's kernel launches {launches}, expected {want}")
    toks = torch.cat(out, dim=1)
    if not (bool(torch.isfinite(whole).all()) and bool(torch.isfinite(logits).all())
            and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size):
        fail(f"{arch}: the prefix path gave non-finite logits or tokens out of the vocabulary")
    del cache
    err, scale = _prefix_gap(cfg, params, prefix, tokens, whole)
    res = dict(prefill_s=t_prefill, decode_s=t_decode, decode_tok_per_s=B * G / t_decode,
               launches=launches["flash_attention"], prefix=P, bf16_gap=err / scale)
    say(f"[serve] {arch}: prefix path: make_prefill_step on {B} x ({P} prefix embeddings + {T} "
        f"tokens) {t_prefill:.4f} s, make_serve_step x {G} from position {P + T} "
        f"{t_decode:.4f} s ({res['decode_tok_per_s']:.2f} tok/s), flash_attention launches "
        f"{launches['flash_attention']}, sample {toks[0, :8].tolist()}; a prefix prefill of "
        f"{T - 1} tokens + one decode_step against the prefill of all {T}, {cfg.compute_dtype} "
        f"compute, bfloat16 KV cache: max abs diff {err:.4g} of scale {scale:.4g} "
        f"({err / scale:.3g}), not gated: the two paths' bf16 roundings differ over "
        f"{cfg.num_layers} layers (gated in float32 above)")
    return res


def _moe_stepwise(arch, cfg, params, what="") -> dict:
    """An MoE model's prefill-vs-stepwise check on fp32 weights (``cfg``
    computes in fp32; a model served in bf16, qwen3_moe_30b_a3b, comes
    here as its first layers drawn alone in fp32: ``phase_serve``'s
    ``fp32_layers``), in fp32 compute over an fp32 KV cache (the cache
    then holds what the prefill attends to, so the two paths compute one
    function), gated at 2e-2 of the logits' scale on 2 x
    ``MOE_GATE_LEN`` tokens, one group at full capacity.  Not gated: over
    serving's bf16 cache (it rounds decode's k and v alone, and the
    rounding moves the router's choices), and 2 x CONSISTENCY_LEN tokens,
    whose prefill drops (token, choice) pairs beyond capacity where
    decode drops none.  Returns the gaps by reading."""
    from repro_torch.models.moe import _capacity
    gaps = {}
    L = MOE_GATE_LEN
    what = f"full width{what}"
    n = cfg.num_layers
    err, scale = _prefill_vs_stepwise(cfg, params, "float32", L)
    gaps[f"{n} layers, float32 KV cache"] = err / scale
    say(f"[serve] {arch}: prefill of {L} tokens vs {L} decode_step calls, {what}, batch 2, "
        f"{n} layers, float32 compute and KV cache: last-position logits max abs diff {err:.4g} "
        f"of scale {scale:.4g} ({err / scale:.3g}; limit 2e-2); one MoE group of {2 * L} "
        f"tokens at capacity {_capacity(2 * L, cfg)}, nothing drops")
    if not err <= 2e-2 * scale:
        fail(f"{arch}: prefill vs stepwise decode {err:.4g} apart at {n} layers, beyond "
             f"2e-2 x {scale:.4g}")
    err, scale = _prefill_vs_stepwise(cfg, params, "bfloat16", L)
    gaps[f"{n} layers, bfloat16 KV cache (not gated)"] = err / scale
    say(f"[serve] {arch}: the same over serving's bfloat16 KV cache: max abs diff {err:.4g} "
        f"of scale {scale:.4g} ({err / scale:.3g}), not gated: decode alone reads k and v "
        f"rounded to bf16, and the rounding moves the router's choices")
    L = CONSISTENCY_LEN
    err, scale = _prefill_vs_stepwise(cfg, params, "float32", L)
    dropped, _ = _moe_dispatch(cfg, params, _check_prompt(cfg, L))
    gaps[f"{n} layers, float32 KV cache, {L} tokens (not gated)"] = err / scale
    say(f"[serve] {arch}: prefill of {L} tokens vs {L} decode_step calls, {what}, batch 2, "
        f"float32 compute and KV cache: max abs diff {err:.4g} of scale {scale:.4g} "
        f"({err / scale:.3g}), not gated: the prefill routes one group of {2 * L} tokens at "
        f"capacity {_capacity(2 * L, cfg)} an expert and dropped {dropped} (token, choice) "
        f"pairs over its {n} layers; decode drops none")
    return gaps


def _moe_bf16(arch, cfg, params) -> dict:
    """Serving's own arithmetic, bf16 compute over the bf16 KV cache, on
    the served weights: a prefill of 2 x ``MOE_GATE_LEN`` tokens against
    as many decode steps, at full depth (printed, not gated) and on the
    first ``MOE_BF16_LAYERS`` layer, gated at 2e-2 of the logits' scale.
    The two paths round differently in bf16 (the attention kernel keeps
    its scores in fp32, decode rounds them to bf16 as the reference's
    einsum does), and deeper in the random stack such a rounding moves a
    near-tied router choice, so only the first layer is gated.  Returns
    the gaps by reading."""
    cfg = cfg.replace(compute_dtype="bfloat16")
    L, gaps = MOE_GATE_LEN, {}
    for c, p in ((cfg, params), _cut_depth(cfg, params, MOE_BF16_LAYERS)):
        n, gated = c.num_layers, c.num_layers == MOE_BF16_LAYERS
        err, scale = _prefill_vs_stepwise(c, p, "bfloat16", L)
        layers = f"{n} layer{'s' if n > 1 else ''}"
        gaps[f"{layers}, bfloat16 compute and KV cache" + ("" if gated else " (not gated)")] = \
            err / scale
        say(f"[serve] {arch}: prefill of {L} tokens vs {L} decode_step calls, batch 2, {layers} "
            f"of the served weights, bfloat16 compute and KV cache: max abs diff "
            f"{err:.4g} of scale {scale:.4g} ({err / scale:.3g}"
            + ("; limit 2e-2)" if gated else "), not gated: the paths' bf16 roundings differ "
               "and, deeper, move near-tied router choices"))
        if gated and not err <= 2e-2 * scale:
            fail(f"{arch}: bf16 prefill vs stepwise decode {err:.4g} apart at {n} layer(s), "
                 f"beyond 2e-2 x {scale:.4g}")
    return gaps


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
    if counts["flash_attention"] or counts["flash_attention_bwd"] or counts["linear_scan"]:
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
EVENT_ROUNDS = 2                 # rounds of each [event] and [batched] run (cut from 3)


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
    """``Federation.run(rounds=EVENT_ROUNDS, mode="event")`` on the main
    path's federation: the sequential event loop for vafl, afl and eaflm
    (14 events each), fedavg's round barrier (2 rounds of 7 clients), and
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
        res = fed.run(rounds=EVENT_ROUNDS, mode="event", algorithm=alg, scenario=scenario)
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
        if steps != (EVENT_ROUNDS if alg == "fedavg" else EVENT_ROUNDS * len(fed.data.counts)):
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
    if counts["flash_attention"] or counts["flash_attention_bwd"] or counts["linear_scan"]:
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
    """One batched run of EVENT_ROUNDS rounds, checked; returns (result, seconds,
    grad_diff_norm launches, encode launches, windows)."""
    import torch
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.kernels.grad_diff_norm import ops as gd_ops
    from repro_torch.kernels.topk_quant import ops as tq_ops
    g0, t0 = gd_ops.launches, tq_ops.launches
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    res = fed.run(rounds=EVENT_ROUNDS, mode="event", engine="batched", **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - h0
    gd, tq = gd_ops.launches - g0, tq_ops.launches - t0
    n = len(fed.data.counts)
    events = EVENT_ROUNDS * n
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
    """``Federation.run(rounds=EVENT_ROUNDS, mode="event", engine="batched")`` on the
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
    if counts["flash_attention"] or counts["flash_attention_bwd"] or counts["linear_scan"]:
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
            {name: (r[1], r[4], EVENT_ROUNDS * len(fed.data.counts)) for name, r in runs.items()},
            share, scale)


# ------------------------------------------------------------------------
# This slice: the round runtime's scenario clock, checkpoint-resume in all
# four runtimes, and observability (repro_torch.checkpoint, repro_torch.obs).

# (name, Federation.run overrides, checkpoint_every, rounds) on the main
# federation.  The sequential loop runs 2 rounds (14 events, cut from 3:
# its checkpoint at event 8 still leaves 6 to resume); the round runtime,
# the barrier and the batched engine keep 3, which their last checkpoint
# needs to fall short of the run's end (they save at a round's or a
# window's end)
SEQ_CKPT_ROUNDS = 2
CKPT_RUNS = [
    ("rounds vafl@flaky_edge", dict(mode="round", algorithm="vafl", scenario="flaky_edge"), 2, 3),
    ("barrier fedavg", dict(mode="event", algorithm="fedavg"), 2, 3),
    ("sequential vafl", dict(mode="event", algorithm="vafl"), 8, SEQ_CKPT_ROUNDS),
    ("batched vafl", dict(mode="event", algorithm="vafl", engine="batched"), 14, 3),
    ("batched afl K=4", dict(mode="event", algorithm="afl", engine="batched", buffer_size=4), 14,
     3),
]
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
OBS_LAPS = 1                     # (off, on, on, off) turns of the overhead lap (cut from 2)
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
    fed.run(rounds=SEQ_CKPT_ROUNDS, mode="event", algorithm="vafl", checkpoint_path=path,
            checkpoint_every=8)


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
    res = cap.run(rounds=SEQ_CKPT_ROUNDS, mode="event", algorithm="vafl", checkpoint_path=path,
                  resume=True)
    same = _everything(res) == _everything(ref) and _same_params(cap.final(path), ref_params)
    say(f"[checkpoint] SIGKILL: a spawned child ran sequential vafl with checkpoint_every=8, "
        f"was killed {time.perf_counter() - h0:.2f} s after its start once its checkpoint at "
        f"event {at} of {7 * SEQ_CKPT_ROUNDS} existed (exit code {child.exitcode}); resumed here from that file: "
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
        for name, kw, every, rounds in CKPT_RUNS:
            path = f"{tmp.name}/{len(whole)}.ckpt"
            trace = f"{tmp.name}/{len(whole)}.jsonl"
            g0, t0 = gd_ops.launches, tq_ops.launches
            h0 = time.perf_counter()
            a = cap.run(rounds=rounds, **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - h0
            a_params = cap.final()
            la = (gd_ops.launches - g0, tq_ops.launches - t0)
            saves.clear()
            g1, t1 = gd_ops.launches, tq_ops.launches
            b = cap.run(rounds=rounds, checkpoint_path=path, checkpoint_every=every,
                        obs=ObsConfig(trace_jsonl=trace), **kw)
            lb = (gd_ops.launches - g1, tq_ops.launches - t1)
            at_save = (saves[-1][0] - g1, saves[-1][1] - t1)
            unperturbed = _everything(b) == _everything(a) and _same_params(cap.final(), a_params)
            g2, t2 = gd_ops.launches, tq_ops.launches
            c = cap.run(rounds=rounds, checkpoint_path=path, resume=True, **kw)
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
            if sum(lc) == 0 or not 0 < st[unit] < (rounds if unit == "round" else 7 * rounds):
                fail(f"checkpoint {name}: the resumed part is empty ({unit} {st[unit]}, "
                     f"launches {lc})")
            whole[name] = (a, a_params, secs)
        # an extending resume: a 2-round checkpoint of the batched engine
        # (whose writer never popped a next window) resumed to 3 rounds
        name, kw, _, _ = CKPT_RUNS[3]
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
        for k, (name, kw, _, rounds) in enumerate(CKPT_RUNS):
            trace = f"{tmp.name}/{k}.jsonl"
            h0 = time.perf_counter()
            res = cap.run(rounds=rounds, obs=ObsConfig(trace_jsonl=trace), **kw)
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
        turns = (False, True, True, False)
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
            f"kernels, {len(full)} names) off {complete[False]} of {turns.count(False)}, on "
            f"{complete[True]} of {turns.count(True)}; "
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


FL_SERVE_ROUNDS = 1                             # bridge and thread runs (depth cut from 3, 2)
# the bridge resume: 2 rounds, from the checkpoint at event 10, past round 1's end
FL_SERVE_RESUME = dict(rounds=2, checkpoint_every=10)
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
    ``run(rounds=FL_SERVE_ROUNDS, mode="event")`` for each of ``FL_SERVE_BRIDGE``, run
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
        ref = cap.fed.run(rounds=FL_SERVE_ROUNDS, mode="event", algorithm=alg)
        torch.cuda.synchronize()
        ev_s = time.perf_counter() - h0
        ev_l = tuple(b - a for a, b in zip((g0, t0), _launch_pair()))
        refs[alg] = (ref, cap.final(), ev_s, ev_l)
    return cap, refs


def phase_fl_serve(cap, refs):
    """``[fl-serve]``: ``Federation.serve`` on the main federation of
    ``fl_serve_references``.  The sequential bridge for vafl, afl and
    fedasync, each bit-equal to that federation's ``run(rounds=
    FL_SERVE_ROUNDS, mode="event")`` (parameters, records, CommStats, clock) with the same
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
    events = FL_SERVE_ROUNDS * len(fed.data.counts)
    out = {"bridge": {}, "threads": {}}
    for alg in FL_SERVE_BRIDGE:
        ref, ref_p, ev_s, ev_l = refs[alg]
        res, sv_s, gd, tq = _served(cap, rounds=FL_SERVE_ROUNDS, driver="sequential",
                                    algorithm=alg)
        same = _everything(res) == _everything(ref) and _same_params(cap.final(), ref_p)
        say(f"[fl-serve] bridge {alg}: serve(driver=\"sequential\") vs run(mode=\"event\"), "
            f"{FL_SERVE_ROUNDS} rounds ({events} events): {'bit-equal' if same else 'DIFFERENT'} "
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
        res, secs, gd, tq = _served(cap, rounds=FL_SERVE_ROUNDS, algorithm=alg,
                                    **FL_SERVE_WAIT)
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
        kw = dict(rounds=FL_SERVE_RESUME["rounds"], driver="sequential", algorithm="afl",
                  error_feedback=False)
        ref, _, _, _ = _served(cap, **kw)
        ref_p = cap.final()
        _served(cap, checkpoint_path=path, checkpoint_every=FL_SERVE_RESUME["checkpoint_every"],
                **kw)
        res, _, gd, tq = _served(cap, checkpoint_path=path, resume=True, **kw)
        same = _everything(res) == _everything(ref) and _same_params(cap.final(), ref_p)
        say(f"[fl-serve] bridge resume of afl (error_feedback=False), {kw['rounds']} rounds, "
            f"from the checkpoint at event {FL_SERVE_RESUME['checkpoint_every']}: "
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


FL_WIRE_ROUNDS = 1                               # every [fl-wire] run but two: 7 events
FL_WIRE_THREAD_ROUNDS = 2                        # the socket threads' vafl run: 14 events, so
                                                 # each worker's 2nd value reads its 1st gradient
FL_WIRE_CHAOS_ROUNDS = 2                         # the chaos soak's laps: 14 events
FL_WIRE_BRIDGE = ("vafl", "afl")                 # the bridge over TCP, held against the event run
FL_WIRE_PROCESSES = 2                            # spawned process workers (clients 0 and 1): each
                                                 # takes seconds to hold its CUDA context
FL_WIRE_STALL = 3.0                              # stall timeout after the SIGKILL
FL_WIRE_CHAOS = dict(drop=0.15, duplicate=0.1, reorder=0.1, blackout=0.03, blackout_s=0.3,
                     seed=11)
FL_WIRE_RETRY = dict(max_attempts=8, attempt_timeout_s=0.5, base_s=0.02, max_backoff_s=0.25,
                     seed=11)
PROM_LINE = r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"' \
            r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})? (-?[0-9.e+-]+|[+-]Inf|NaN)$'


def counting_client(q, root, host, port, client, forward_fn, model_cfg, local, images, labels,
                    mask, rounds, pace_seed, device, recv_timeout=30.0):
    """A spawned process worker that reports what it did: it runs
    ``repro_torch.serve.client._process_client_main`` (the body of a
    ``ProcessClientWorker`` child) and then puts on ``q`` its kernel
    launches, kernel builds, device, peak device memory and whether any
    module of JAX or of its package was loaded.  Launch counts live in
    each process, so the parent cannot read a child's."""
    sys.path.insert(0, str(Path(root) / "src"))
    import torch
    from repro_torch.kernels.grad_diff_norm import ops as gd_ops
    from repro_torch.kernels.topk_quant import ops as tq_ops
    from repro_torch.obs import compile_tracking
    from repro_torch.serve.client import _process_client_main
    h0 = time.perf_counter()
    done = _process_client_main(host, port, client, forward_fn, model_cfg, local, images, labels,
                                mask, rounds, pace_seed, device, recv_timeout)
    on_card = torch.device(device).type == "cuda"
    q.put({"client": client, "rounds": done, "device": torch.device(device).type,
           "topk_quant": tq_ops.launches, "grad_diff_norm": gd_ops.launches,
           "builds": compile_tracking.compile_count(), "seconds": time.perf_counter() - h0,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
           "jax_free": not [m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "repro")]})


class _SmiUtilization:
    """``nvidia-smi``'s utilization.gpu sampled every 100 ms while a block
    runs: the share of each sample period in which any process's kernel
    ran on the card, the one reading that sees every process's contexts.
    ``mean`` is None when the card reports no number."""

    def __enter__(self):
        self._p = subprocess.Popen(["nvidia-smi", "--query-gpu=utilization.gpu",
                                    "--format=csv,noheader,nounits", "-lms", "100"],
                                   stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self._p.terminate()
        try:
            out, _ = self._p.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self._p.kill()
            out, _ = self._p.communicate()
        vals = []
        for line in out.splitlines():
            try:
                vals.append(float(line.strip()))
            except ValueError:
                pass
        self.samples = len(vals)
        self.mean = sum(vals) / len(vals) / 100 if vals else None
        return False


def _share(x) -> str:
    return "not measured (nvidia-smi gave no number)" if x is None else f"{x:.1%}"


def fl_wire_references(cap):
    """``run(rounds=2, mode="event")`` of the main federation for each of
    ``FL_WIRE_BRIDGE``, run before ``[fl-wire]``'s launch counts are set
    to 0: {algorithm: (result, final parameters, (grad_diff_norm, encode)
    launches)}."""
    refs = {}
    for alg in FL_WIRE_BRIDGE:
        cap.seen.clear()
        g0, t0 = _launch_pair()
        ref = cap.fed.run(rounds=FL_WIRE_ROUNDS, mode="event", algorithm=alg)
        refs[alg] = (ref, cap.final(), tuple(b - a for a, b in zip((g0, t0), _launch_pair())))
    return refs


def _wire_lap(fed, cfg, transport, **kw):
    """One thread-worker run of ``cfg`` over ``transport`` through
    ``launch_serving``, timed and with its launches and retries:
    (server, result, seconds, grad_diff_norm launches, encode launches,
    the fleet's retries)."""
    import torch
    from repro_torch.serve import launch_serving
    server, workers, tr = launch_serving(
        cfg, init_params_fn=fed.init_params_fn, loss_fn=fed.loss_fn, fed_data=fed.data,
        evaluate_fn=fed.evaluate_fn, transport=transport, device="cuda", recv_timeout=120.0,
        **kw)
    g0, t0 = _launch_pair()
    h0 = time.perf_counter()
    try:
        server.start()
        for w in workers:
            w.start()
        res = server.run(stall_timeout=120.0)
        for w in workers:
            w.stop()
        for w in workers:
            w.join(timeout=60)
        server.absorb_client_stats(workers)
        res = server.finalize()
    finally:
        tr.close()
    torch.cuda.synchronize()
    secs = time.perf_counter() - h0
    if any(w.error is not None or w.is_alive() for w in workers):
        fail(f"[fl-wire] a thread worker failed or hung: {[w.error for w in workers]}")
    g1, t1 = _launch_pair()
    return server, res, secs, g1 - g0, t1 - t0, sum(w.stats["retries"] for w in workers)


def _process_fleet(fed, cfg) -> dict:
    """A process worker (``counting_client``) a client of ``cfg`` (the
    federation's first ``cfg.num_clients`` clients) on the card over the
    socket transport: every child's encode launches there,
    the children's launches sum to the server's accepted uploads, and the
    byte ledgers reconcile.  The children start together: each waits
    for its init broadcast (up to ``KILL_TIMEOUT_S``), which the server
    sends once every child holds its CUDA context and is connected, and
    the clock starts there."""
    import multiprocessing
    import numpy as np
    import torch
    from repro_torch.models.cnn import CNNConfig, cnn_forward
    from repro_torch.serve import FLServer
    from repro_torch.serve.socket_transport import SocketTransport
    n = cfg.num_clients
    tr = SocketTransport(n, device="cuda")
    server = FLServer(cfg, init_params_fn=fed.init_params_fn, evaluate_fn=fed.evaluate_fn,
                      transport=tr, device="cuda")
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    host, port = tr.address
    d = fed.data
    procs = [ctx.Process(target=counting_client, args=(
        q, str(ROOT), host, port, i, cnn_forward, CNNConfig(), cfg.local,
        *(np.asarray(x[i:i + 1]) for x in (d.images, d.labels, d.mask)), None, None, "cuda",
        KILL_TIMEOUT_S))
        for i in range(n)]
    h_spawn = time.perf_counter()
    try:
        for p in procs:
            p.start()
        while len(tr._conns) < n:        # each child connects once its context is up
            if not all(p.is_alive() for p in procs):
                fail(f"[fl-wire] a process worker exited before connecting: "
                     f"{[p.exitcode for p in procs]}")
            if time.perf_counter() - h_spawn > KILL_TIMEOUT_S:
                fail(f"[fl-wire] process workers not connected within {KILL_TIMEOUT_S} s")
            time.sleep(0.01)
        ready = time.perf_counter() - h_spawn
        u0 = torch.cuda.max_memory_allocated()
        with _SmiUtilization() as smi:
            h0 = time.perf_counter()
            server.start()
            res = server.run(stall_timeout=120.0)
            torch.cuda.synchronize()
            secs = time.perf_counter() - h0
        counts = sorted((q.get(timeout=120) for _ in procs), key=lambda c: c["client"])
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        tr.close()
    c = res.comm
    child_tq = sum(x["topk_quant"] for x in counts)
    say(f"[fl-wire] process workers afl: {n} spawned children on the card over TCP, connected "
        f"{ready:.2f} s after the spawn; {c.broadcasts} events, uploads {c.model_uploads}, "
        f"accepted by client {[int(a) for a in server.accepted_by_client]}; the children's "
        f"encode launches {[x['topk_quant'] for x in counts]} (sum {child_tq}), grad_diff_norm "
        f"{[x['grad_diff_norm'] for x in counts]}, kernel builds {[x['builds'] for x in counts]}, "
        f"peak device memory GB {[round(x['peak_gb'], 4) for x in counts]} (the server's "
        f"process {u0 / 1e9:.4f}), devices {sorted({x['device'] for x in counts})}, JAX-free "
        f"{all(x['jax_free'] for x in counts)}; uplink bytes {c.uplink_bytes} (ledgers sum "
        f"{sum(res.client_uplink_bytes)}), downlink {c.downlink_bytes} (sum "
        f"{sum(res.client_downlink_bytes)}); {secs:.4f} s from start(), "
        f"{c.broadcasts / secs:.3f} events/s; card busy {_share(smi.mean)} "
        f"({smi.samples} nvidia-smi samples)")
    if ([p.exitcode for p in procs] != [0] * n or c.broadcasts != FL_WIRE_ROUNDS * n
            or [x["rounds"] for x in counts] != [FL_WIRE_ROUNDS] * n):
        fail(f"[fl-wire] the process fleet did not end whole: exit codes "
             f"{[p.exitcode for p in procs]}, rounds {[x['rounds'] for x in counts]}")
    if (any(x["topk_quant"] <= 0 or x["device"] != "cuda" for x in counts)
            or child_tq != c.model_uploads or sum(server.accepted_by_client) != c.model_uploads):
        fail(f"[fl-wire] children's encode launches {[x['topk_quant'] for x in counts]} against "
             f"{c.model_uploads} accepted uploads")
    if not all(x["jax_free"] for x in counts):
        fail("[fl-wire] a process worker imported JAX or the JAX package")
    if (sum(res.client_uplink_bytes) != c.uplink_bytes
            or sum(res.client_downlink_bytes) != c.downlink_bytes):
        fail("[fl-wire] the process fleet's byte ledgers do not reconcile with CommStats")
    return {"events_per_s": c.broadcasts / secs, "busy": smi.mean, "child_launches": child_tq,
            "children": n,
            "builds": sum(x["builds"] for x in counts),
            "peak_gb": max(x["peak_gb"] for x in counts)}


def _killed_worker(fed, cfg) -> dict:
    """A ``ProcessClientWorker`` on the card SIGKILLed after its first
    upload: the server finishes within its stall timeout and its upload
    count equals the events it processed."""
    import dataclasses
    from repro_torch.models.cnn import CNNConfig, cnn_forward
    from repro_torch.serve import FLServer, ProcessClientWorker
    from repro_torch.serve.socket_transport import SocketTransport
    cfg = dataclasses.replace(cfg, rounds=10_000, events_per_eval=100_000)
    tr = SocketTransport(cfg.num_clients, device="cuda")
    server = FLServer(cfg, init_params_fn=fed.init_params_fn, evaluate_fn=fed.evaluate_fn,
                      transport=tr, device="cuda")
    worker = ProcessClientWorker(tr.address, 0, forward_fn=cnn_forward, model_cfg=CNNConfig(),
                                 local=cfg.local, fed_data=fed.data, device="cuda")
    try:
        server.start()
        worker.start()
        h0 = time.perf_counter()
        while server.processed < 1 and time.perf_counter() - h0 < KILL_TIMEOUT_S:
            server.step(timeout=0.1)
        if server.processed < 1:
            fail("[fl-wire] the process worker never delivered an upload")
        worker.kill()
        h1 = time.perf_counter()
        res = server.run(stall_timeout=FL_WIRE_STALL)
        secs = time.perf_counter() - h1
        worker.join(timeout=30)
    finally:
        worker.kill()
        tr.close()
    say(f"[fl-wire] SIGKILL: a process worker on the card killed after its first upload "
        f"(exit code {worker.exitcode}); the server processed {server.processed} events, "
        f"uploads {res.comm.model_uploads}, and returned {secs:.3f} s after the kill "
        f"(stall timeout {FL_WIRE_STALL} s)")
    if (worker.exitcode is None or not 1 <= server.processed < server.total_events
            or res.comm.model_uploads != server.processed or secs > FL_WIRE_STALL + 10):
        fail("[fl-wire] the server did not finish cleanly after the SIGKILL")
    return {"seconds": secs}


def _chaos_soak(fed, cfg) -> dict:
    """afl with thread workers: a fault-free lap, then ``ChaosTransport``
    over ``inproc`` and over ``socket`` with the reference test's spec
    and retry policy, obs on.  Each chaos lap commits the fault-free
    multiset, the schedule fired, the obs fault counters equal the
    transport's stats and the encode launched for every committed
    upload."""
    import dataclasses
    from repro_torch.obs import ObsConfig
    from repro_torch.resilience import ChaosTransport, FaultSpec, RetryPolicy
    cfg = dataclasses.replace(cfg, obs=ObsConfig())
    s0, r0, base_s, _, t0, _ = _wire_lap(fed, cfg, "inproc")
    base = [int(a) for a in s0.accepted_by_client]
    say(f"[fl-wire] chaos soak, fault-free lap (inproc): accepted by client {base}, "
        f"{s0.processed} events, encode launches {t0}, {base_s:.4f} s")
    out = {"fault_free_s": base_s}
    for inner in ("inproc", "socket"):
        chaos = ChaosTransport(cfg.num_clients, inner=inner, faults=FaultSpec(**FL_WIRE_CHAOS),
                               device="cuda")
        s1, r1, secs, _, tq, retries = _wire_lap(
            fed, cfg, chaos, retry=RetryPolicy(**FL_WIRE_RETRY), exchange_timeout=30.0,
            liveness_timeout=60.0)
        got = [int(a) for a in s1.accepted_by_client]
        c = r1.metrics["counters"]
        injected = {k: v for k, v in chaos.stats.items() if k not in ("sent", "delivered") and v}
        obs_ok = (all(c.get(f"chaos_faults_{k}", 0) == v for k, v in injected.items())
                  and c.get("chaos_faults", 0) == sum(injected.values())
                  and c.get("client_retries", 0) == retries)
        say(f"[fl-wire] chaos soak over {inner}: accepted by client {got} "
            f"({'the fault-free multiset' if got == base else 'DIFFERENT'}), {s1.processed} "
            f"events, faults {injected}, sent {chaos.stats['sent']}, delivered "
            f"{chaos.stats['delivered']}, retries {retries}, duplicates {s1.duplicates}, "
            f"evictions {s1.evictions}, readmissions {s1.readmissions}; obs counters "
            f"{'equal' if obs_ok else 'DIFFER from'} the transport's stats; encode launches {tq} "
            f"for {r1.comm.model_uploads} committed uploads; {secs:.4f} s, "
            f"{secs / base_s:.2f} x the fault-free lap")
        if got != base or s1.processed != s0.processed:
            fail(f"[fl-wire] the chaos lap over {inner} did not commit the fault-free multiset")
        if not injected or ((chaos.stats["drop"] or chaos.stats["blackout"]) and retries <= 0):
            fail(f"[fl-wire] the chaos schedule over {inner} never fired or nothing retried")
        if not obs_ok or tq < r1.comm.model_uploads:
            fail(f"[fl-wire] the chaos lap over {inner}: obs counters {c}, encode launches {tq}")
        out[inner] = secs
    return out


def _live_plane(fed, cfg) -> dict:
    """A thread-worker vafl run with obs on and the HTTP plane up: all four
    endpoints answer while it runs, every line of ``/metrics`` parses, and
    after the run ``/clients``' byte totals equal CommStats'."""
    import dataclasses
    import re
    import threading
    import urllib.request
    from repro_torch.obs import ObsConfig
    from repro_torch.serve import launch_serving, resolve_live
    cfg = dataclasses.replace(cfg, algorithm="vafl", obs=ObsConfig(sample_interval=0.05))
    server, workers, tr = launch_serving(
        cfg, init_params_fn=fed.init_params_fn, loss_fn=fed.loss_fn, fed_data=fed.data,
        evaluate_fn=fed.evaluate_fn, device="cuda", recv_timeout=120.0)
    plane = resolve_live(True, [server])
    seen, stop = {}, threading.Event()

    def get(path):
        with urllib.request.urlopen(plane.url + path, timeout=10) as r:
            return r.status, r.read().decode()

    def scrape():
        while not stop.is_set():
            for path in ("/metrics", "/healthz", "/clients", "/trace?n=20"):
                try:
                    st, body = get(path)
                    seen.setdefault(path, []).append(st)
                    seen[path + " body"] = body
                except OSError:
                    pass
            stop.wait(0.05)
    poller = threading.Thread(target=scrape, daemon=True)
    try:
        poller.start()
        server.start()
        for w in workers:
            w.start()
        res = server.run(stall_timeout=120.0)
        for w in workers:
            w.stop()
        for w in workers:
            w.join(timeout=60)
        stop.set()
        poller.join(timeout=30)
        _, body = get("/clients")
        board = json.loads(body)
        _, prom = get("/metrics")
    finally:
        stop.set()
        plane.stop()
        tr.close()
    line = re.compile(PROM_LINE)
    bad = [x for x in prom.splitlines() if not (x.startswith(("# HELP ", "# TYPE "))
                                                or line.match(x))]
    mid = {p: len(seen.get(p, [])) for p in ("/metrics", "/healthz", "/clients", "/trace?n=20")}
    say(f"[fl-wire] live plane on a thread-worker vafl run: answers while running {mid}; "
        f"/clients totals up {board['totals']['up_bytes']} down {board['totals']['down_bytes']} "
        f"accepted {board['totals']['accepted_updates']} against CommStats "
        f"{res.comm.uplink_bytes} / {res.comm.downlink_bytes} / {res.comm.model_uploads}; "
        f"/metrics {len(prom.splitlines())} lines, {len(bad)} unparsed; health "
        f"{json.loads(seen.get('/healthz body', '{}')).get('status')}")
    if not all(mid.values()) or any(w.error is not None for w in workers):
        fail(f"[fl-wire] the live plane did not answer mid-run: {mid}")
    if (board["totals"]["up_bytes"], board["totals"]["down_bytes"],
            board["totals"]["accepted_updates"]) != (res.comm.uplink_bytes,
                                                     res.comm.downlink_bytes,
                                                     res.comm.model_uploads):
        fail("[fl-wire] /clients does not reconcile with CommStats")
    if bad:
        fail(f"[fl-wire] unparsable /metrics lines: {bad[:5]}")
    return {"lines": len(prom.splitlines())}


def phase_fl_wire(cap, refs, fl_serve) -> dict:
    """``[fl-wire]``: the served federation over the wire and its faults,
    1 round (7 events) a run, the socket threads' vafl run and the chaos
    soak 2 (14 events): the bridge over TCP for vafl and afl bit-equal to
    ``run(mode="event")`` with the same launches; thread workers over
    ``socket`` (vafl: each worker's second event computes Eq. 1's value
    from its first event's gradient); ``FL_WIRE_PROCESSES`` process
    workers on the card over ``socket`` (afl, clients 0 and 1), their
    launches counted in the children; a
    process worker SIGKILLed after its first upload; the chaos soak over
    ``inproc`` and ``socket``; the live HTTP plane.  Every launch counted
    here is a served run's; the children's come back separately."""
    import dataclasses
    fed = cap.fed
    n = len(fed.data.counts)
    events = FL_WIRE_ROUNDS * n
    out = {"bridge": {}}
    for alg in FL_WIRE_BRIDGE:
        ref, ref_p, ev_l = refs[alg]
        res, secs, gd, tq = _served(cap, rounds=FL_WIRE_ROUNDS, driver="sequential",
                                    algorithm=alg, transport="socket")
        same = _everything(res) == _everything(ref) and _same_params(cap.final(), ref_p)
        say(f"[fl-wire] bridge {alg} over socket: serve(driver=\"sequential\", "
            f"transport=\"socket\") vs run(mode=\"event\"), {events} events: "
            f"{'bit-equal' if same else 'DIFFERENT'} (parameters, records, CommStats, sim_time "
            f"{res.sim_time:.6f}); uploads {res.comm.model_uploads}, launches grad_diff_norm "
            f"{gd} vs {ev_l[0]}, topk_quant {tq} vs {ev_l[1]}; {secs / events:.4f} s an event")
        if not same:
            fail(f"[fl-wire] the bridge's {alg} run over socket differs from run(mode='event')")
        if (gd, tq) != ev_l or tq != res.comm.model_uploads:
            fail(f"[fl-wire] bridge {alg} over socket launched ({gd}, {tq}), the event run "
                 f"{ev_l}")
        out["bridge"][alg] = secs / events
    base = dataclasses.replace(fed.config, rounds=FL_WIRE_ROUNDS)
    t_events = FL_WIRE_THREAD_ROUNDS * n
    res, secs, gd, tq = _served(cap, rounds=FL_WIRE_THREAD_ROUNDS, algorithm="vafl",
                                transport="socket", **FL_SERVE_WAIT)
    c = res.comm
    share, kernels, wall, _ = busy_share(lambda: fed.serve(rounds=1, algorithm="vafl",
                                                          transport="socket", **FL_SERVE_WAIT))
    say(f"[fl-wire] threads vafl over socket: 7 workers, {c.broadcasts} events, uploads "
        f"{c.model_uploads}, reports {c.scalar_reports}, uplink bytes {c.uplink_bytes} (ledgers "
        f"sum {sum(res.client_uplink_bytes)}), downlink {c.downlink_bytes} (sum "
        f"{sum(res.client_downlink_bytes)}), launches grad_diff_norm {gd}, topk_quant {tq}; "
        f"{secs:.4f} s, {t_events / secs:.3f} events/s ([fl-serve] inproc "
        f"{fl_serve['threads']['vafl']:.3f}); a profiled 1-round run: {kernels} CUDA kernels, "
        f"device busy {share:.1%} of {wall:.4f} s ([fl-serve] inproc {fl_serve['busy']:.1%})")
    if (c.broadcasts != t_events or sum(res.client_uplink_bytes) != c.uplink_bytes
            or sum(res.client_downlink_bytes) != c.downlink_bytes or tq != c.model_uploads
            or gd != t_events):
        fail("[fl-wire] the thread run over socket did not end whole or reconcile")
    out["threads"] = {"events_per_s": t_events / secs, "busy": share}
    out["process"] = _process_fleet(fed, dataclasses.replace(base, algorithm="afl",
                                                             num_clients=FL_WIRE_PROCESSES))
    out["killed"] = _killed_worker(fed, dataclasses.replace(base, algorithm="afl"))
    out["chaos"] = _chaos_soak(fed, dataclasses.replace(base, algorithm="afl",
                                                        rounds=FL_WIRE_CHAOS_ROUNDS))
    out["live"] = _live_plane(fed, base)
    return out


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


# the [train] phase: the flash_attention backward, training minicpm_2b at
# its published width (depth cut), the cross-silo step, the gated
# collective on two ranks and the federated LM example
TRAIN_CUT = dict(num_layers=2)              # minicpm_2b's 40 layers cut to 2 (reduced)
TRAIN = dict(batch=4, seq=1024, steps=5, lr=1e-3)   # bf16 compute, fp32 params
FL_TRAIN = dict(pods=2, batch_per_pod=2, steps=5)
# backward cases: (B, S, H, KV, hd, window, dtype) at starcoder2_3b's and
# minicpm_2b's attention shapes, each dtype with and without a window;
# then zamba2_7b's shared attention in the [train] path (hd 112, no GQA,
# causal), each dtype
FA_BWD_CASES = [(4, 2048, 24, 2, 128, None, "bfloat16"), (4, 2048, 24, 2, 128, 256, "bfloat16"),
                (4, 2048, 24, 2, 128, None, "float32"), (4, 2048, 24, 2, 128, 256, "float32"),
                (4, 1024, 36, 36, 64, None, "bfloat16"), (4, 1024, 36, 36, 64, 128, "bfloat16"),
                (4, 1024, 36, 36, 64, None, "float32"), (4, 1024, 36, 36, 64, 128, "float32"),
                (4, 1024, 32, 32, 112, None, "bfloat16"), (4, 1024, 32, 32, 112, None, "float32")]
FA_BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}   # of each gradient's scale
# the first form's times of the cases above (fp32 FMA tiles for both
# dtypes; PERF.md §6, H100 80GB HBM3, 700 W), quoted on each case's text
# line and nowhere in the kernels line, which holds this run's numbers
FA_BWD_OLD_MS = [21.8940, 5.3066, 22.3555, 5.3772, 3.2310, 1.1166, 3.2471, 1.1396, None, None]
# step 1, kernel route vs plain route at bf16 compute, of each leaf's
# scale: at most this, and at most the run's bf16 floor, the plain
# route's own largest leaf gap to the same step at fp32 compute.  The
# worst leaf is the tied table, whose gradient comes out of a bf16
# GEMM, and its gap is the same whichever half of attention runs
# through a kernel (PERF.md, PR 23): bf16 rounding; a missing attention
# gradient moves wq, wk and wv by their whole scale
TRAIN_GRAD_TOL = 2e-2
TRAIN_CHECK_SEEDS = (0, 1, 2)
# the seeds whose step 1 also runs the four mixes of the two routes (not
# gated: they say where a gap comes from); cut from all three seeds to
# the first to make room for three more served models
TRAIN_MIX_SEEDS = (0,)
# the recurrent and MoE families in [train], each at its published width
# with its depth cut (reduced): rwkv6_3b and granite_moe_3b_a800m to 2 of
# 32 layers (TRAIN_CUT), zamba2_7b to its first 6 pattern entries (five
# Mamba2 layers and one shared-attention invocation)
TRAIN_FAMILIES = ("rwkv6_3b", "zamba2_7b", "granite_moe_3b_a800m")
ZAMBA2_TRAIN_DEPTH = 6
# Step 1 of each family through the kernels against the plain routes.
# At fp32 compute, at the [train] cut, within TRAIN_FP32_GRAD_TOL of each
# leaf's scale (the routes' sums run in other orders).  At bf16 compute
# the random-weight stacks at the cut are no yardstick: the plain route's
# own bf16 step is 0.25-1.08 of some leaf's scale from its fp32 step
# (rwkv6 at 2 layers, zamba2 at 6, granite at 1; PERF.md §6), so
# bf16 is held on the cut below (TRAIN_BF16_CUT), within
# min(TRAIN_GRAD_TOL, that cut's bf16 floor); granite's with the plain
# fp32 step's router choices replayed in both bf16 steps, since a moved
# choice changes two experts' gradients by a token's share, and the
# choices each route would have made printed beside them.
TRAIN_FP32_GRAD_TOL = 1e-3
TRAIN_BF16_CUT = {"rwkv6_3b": ("rwkv6",), "zamba2_7b": ("mamba2", "shared_attn"),
                  "granite_moe_3b_a800m": ("attn",)}
# the reference test's eight pods (tests/test_distributed.py), cut to two
# ranks twice: pods (4, 5), both above the mean, and pods (0, 5)
GATED_VALS = [0.0, 0.0, 0.0, 0.0, 9.0, 9.0, 0.0, 0.0]
GATED_WTS = [1.0, 1.0, 1.0, 1.0, 1.0, 3.0, 1.0, 1.0]
GATED_PODS = [(4, 5), (0, 5)]


def phase_flash_backward(rows: list):
    """The backward kernel against the plain backward (autograd through
    ``ref.gqa_attention``) on the card, timed beside its bound and the
    autograd backward of ``F.scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (B, S, H, KV, hd, window, dtype), old_ms in zip(FA_BWD_CASES, FA_BWD_OLD_MS):
        dt = getattr(torch, dtype)
        q = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dt)
        k, v = (torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dt) for _ in range(2))
        do = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dt)
        o, lse = ops._launch(q, k, v, window, need_lse=True)
        got = ops._launch_bwd(q, k, v, o, do, lse, window)
        again = ops._launch_bwd(q, k, v, o, do, lse, window)
        want = ref.gqa_attention_bwd(q, k, v, do, window=window)
        torch.cuda.synchronize()
        case = f"(B {B}, S {S}, H {H}, KV {KV}, hd {hd}, window {window}) {dtype}"
        errs = []
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            scale = float(b.float().abs().max())
            err = float((a.float() - b.float()).abs().max())
            errs.append(err / scale)
            if not (a.dtype == dt and bool(torch.isfinite(a).all())
                    and err <= FA_BWD_TOL[dtype] * scale):
                fail(f"flash_attention backward {case}: {name} max abs err {err:.3g} beyond "
                     f"{FA_BWD_TOL[dtype]} x its scale {scale:.3g}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"flash_attention backward {case}: two launches on one input differ")
        say(f"[train] flash_attention backward {case}: max abs err / scale dq {errs[0]:.3g}, "
            f"dk {errs[1]:.3g}, dv {errs[2]:.3g} (limit {FA_BWD_TOL[dtype]}), rerun bit-equal")
        esize = q.element_size()
        nbytes = (B * S * (4 * H + 4 * KV) * hd * esize     # q, k, v, o, dO read; dq, dk, dv
                  + B * H * S * 4)                          # written; lse read
        nops = 10 * hd * _pairs(S, window) * B * H          # 5 products of 2 ops a multiply-add
        bms, bby = bound_ms(nbytes, nops, BF16_OPS_PER_S if dtype == "bfloat16" else FP32_OPS_PER_S)
        lib = None
        if window is None:      # the function SDPA computes
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
            ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
            dot = do.transpose(1, 2)
            lib = cuda_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True),
                          20, 3)
            del qt, kt, vt, ot
        ms = cuda_ms(lambda: ops._launch_bwd(q, k, v, o, do, lse, window), 20, 3)
        chunks = ops.bwd_plan(B, S, H, KV, sms) if dtype == "bfloat16" else 1
        say(f"[train] flash_attention backward {case}: {ms:.4f} ms "
            + (f"(first form: {old_ms} ms), " if old_ms is not None else "(no first form), ")
            + (f"{ms / lib:.2f} x SDPA's autograd backward ({lib:.4f} ms), " if lib is not None
               else "no SDPA call takes a window, ")
            + f"{nops / ms / 1e9:.1f} TFLOP/s of the 5-product work, {chunks} chunk(s) a GQA "
            f"group")
        rows.append({
            "name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:68",
            "replaces_note": "the gradient of that forward-only TPU kernel's function; the "
                             "reference trains through plain jnp attention",
            "shape": [B, S, H, KV, hd], "window": window, "dtype": dtype,
            "design": DESIGN[("flash_attention_bwd", dtype)], "chunks": chunks,
            "max_abs_err": max(errs), "max_abs_err_is": "of each gradient's scale",
            "tol": FA_BWD_TOL[dtype],
            "ms": ms, "tflops": nops / ms / 1e9,
            "x_library": ms / lib if lib is not None else None,
            "plain_ms": cuda_ms(lambda: ref.gqa_attention_bwd(q, k, v, do, window=window), 3, 1),
            "bound_ms": bms, "bound_by": bby, "bound_bytes": nbytes, "bound_ops": nops,
            "library_ms": lib,
            "library_call": ("autograd backward of F.scaled_dot_product_attention(is_causal=True, "
                             "enable_gqa=True)" if lib is not None else None)})
        del q, k, v, do, o, lse, got, again, want
        torch.cuda.empty_cache()


def _train_cfg():
    from repro_torch.models.registry import get_config
    return get_config("minicpm_2b").replace(**TRAIN_CUT)


def _train_batch(cfg):
    """The full-width cell's batch: ``token_stream`` (seed 1, as
    ``launch/train.py`` draws its data), on the card."""
    import torch
    from repro_torch.data.synthetic import token_stream
    toks, labs = token_stream(TRAIN["batch"], TRAIN["seq"], cfg.vocab_size, seed=1)
    return {"tokens": torch.from_numpy(toks).long().cuda(),
            "labels": torch.from_numpy(labs).long().cuda()}


def _train_run(cfg) -> dict:
    """``make_train_step`` for TRAIN["steps"] steps on one repeated batch
    (an overfit check: the loss of a batch it trains on must fall), from
    parameters drawn from seed 0: losses, grad norms, seconds a step
    (host clock, synchronised by the loss read), the final parameters,
    and the launches of the steps (a difference of the counts, which are
    the [train] path's and are not reset here)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.grad_diff_norm import ops as gd
    from repro_torch.kernels.linear_scan import ops as ls
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import decoder
    step_fn, opt_init = make_train_step(cfg, lr=TRAIN["lr"])
    params = decoder.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt_state = opt_init(params)
    batch = _train_batch(cfg)
    torch.cuda.synchronize()
    names = ("flash_attention", "flash_attention_bwd", "grad_diff_norm", "linear_scan",
             "linear_scan_bwd")
    counters = lambda: (fa.launches, fa.bwd_launches, gd.launches, ls.launches, ls.bwd_launches)
    before = counters()
    losses, norms, secs = [], [], []
    for s in range(TRAIN["steps"]):
        h0 = time.perf_counter()
        params, opt_state, info = step_fn(params, opt_state, batch, s)
        losses.append(float(info["loss"]))
        secs.append(time.perf_counter() - h0)
        norms.append(float(info["grad_norm"]))
    counts = {name: n - b for name, n, b in zip(names, counters(), before)}
    return {"losses": losses, "grad_norms": norms, "step_s": secs, "params": params,
            "counts": counts}


def _plain_lse(q, k, window):
    """Each query row's logsumexp of its masked, scaled fp32 scores, (B,
    H, S): what the forward kernel writes for its backward."""
    import torch
    from repro_torch.kernels.flash_attention import ref
    B, S, H, hd = q.shape
    kq = torch.repeat_interleave(k, H // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kq.float()) / hd ** 0.5
    pos = torch.arange(S, device=q.device)
    keep = pos[:, None] >= pos[None, :]
    if window is not None:
        keep &= (pos[:, None] - pos[None, :]) < window
    return torch.logsumexp(s.masked_fill(~keep, ref.NEG_INF), dim=-1)


def _attention_route(fwd_kernel: bool, bwd: str):
    """The model layer's attention call with its forward through the
    kernel or the plain version (``ref``), and its backward through the
    plain version (``bwd`` "plain"), the kernel ("kernel") or the
    kernel's fp32 route on the inputs widened to fp32, its gradients
    rounded back ("fp32 route": the arithmetic of the first form of the
    bf16 route, FMA tiles without bf16 rounding of P and dS): the mixes
    that locate the step-1 gap between the two routes."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref

    class Mixed(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, window):
            if fwd_kernel:
                o, lse = ops._launch(q, k, v, window, need_lse=True)
            else:
                o, lse = ref.gqa_attention(q, k, v, window), _plain_lse(q, k, window)
            ctx.window = window
            ctx.save_for_backward(q, k, v, o, lse)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            if bwd == "kernel":
                grads = ops._launch_bwd(q, k, v, o, do.contiguous(), lse, ctx.window)
            elif bwd == "fp32 route":
                grads = [g.to(q.dtype) for g in ops._launch_bwd(
                    *(x.float() for x in (q, k, v, o, do.contiguous())), lse, ctx.window)]
            else:
                grads = ref.gqa_attention_bwd(q, k, v, do, window=ctx.window)
            return (*grads, None)

    return lambda q, k, v, window=None: Mixed.apply(q, k, v, window)


def _leaf_names(tree, prefix="") -> list:
    """Leaf paths in ``tree_flatten`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for key in sorted(tree)
                for n in _leaf_names(tree[key], f"{prefix}.{key}" if prefix else key)]
    if isinstance(tree, (list, tuple)):
        return [n for i, x in enumerate(tree) for n in _leaf_names(x, f"{prefix}[{i}]")]
    return [] if tree is None else [prefix]


def _step_one_grads(cfg, seed: int, route=None):
    """Step 1's loss and gradients at the full-width cell from parameters
    of ``seed``: the attention through the model layer's own call (the
    kernels' Function), or through ``route`` (this check only)."""
    import torch
    from unittest import mock
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import decoder
    params = decoder.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    batch = _train_batch(cfg)
    lossf = lambda p, b: decoder.loss_fn(cfg, p, b)
    if route is None:
        return value_and_grad(lossf, params, batch)
    with mock.patch.object(ops, "gqa_flash_attention", route):
        return value_and_grad(lossf, params, batch)


def _leaf_gaps(grads, want) -> list:
    """Per leaf: (max|a - b| / max|b|, max|a - b|, max|b|, the share of
    entries where a != b)."""
    from repro_torch.common.pytree import tree_leaves
    out = []
    for a, b in zip(tree_leaves(grads), tree_leaves(want)):
        diff, scale = float((a.float() - b.float()).abs().max()), float(b.float().abs().max())
        out.append((diff / scale, diff, scale, float((a != b).float().mean())))
    return out


def _worst(gaps, names) -> tuple:
    """(the largest gap of scale, its leaf's name)."""
    i = max(range(len(gaps)), key=lambda j: gaps[j][0])
    return gaps[i][0], names[i]


def _worst_entry(grads, want, gaps) -> tuple:
    """Of the leaf with the largest gap: (its largest |a - b| in units in
    the last place of bf16 at b's value there, the share of its entries
    where a != b)."""
    import math
    from repro_torch.common.pytree import tree_leaves
    i = max(range(len(gaps)), key=lambda j: gaps[j][0])
    a, b = tree_leaves(grads)[i].flatten(), tree_leaves(want)[i].flatten()
    d = (a.float() - b.float()).abs()
    at = int(d.argmax())
    ref = abs(float(b[at]))
    ulps = float(d[at]) / 2.0 ** (math.floor(math.log2(ref)) - 7) if ref > 0 else math.inf
    return ulps, gaps[i][3]


def gated_rank(q, root, rank, world, init):
    """A spawned rank of the gated collective on the card (gloo, CUDA
    tensors): the reference test's inputs cut to two pods, twice; puts
    its selections, aggregates and collective bytes on ``q``."""
    sys.path.insert(0, str(Path(root) / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import hlo
    from repro_torch.distributed.gated import make_gated_allreduce, pod_values, should_sync
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    fn = make_gated_allreduce()
    out = {"rank": rank, "cases": []}
    for pods in GATED_PODS:
        pod = pods[rank]
        hlo.reset()
        upd = {"w": torch.full((3,), float(pod), device="cuda")}
        agg, sel, any_sel = fn(upd, torch.tensor(GATED_VALS[pod], device="cuda"),
                               torch.tensor(GATED_WTS[pod], device="cuda"))
        sync = should_sync(torch.tensor(GATED_VALS[pod], device="cuda"))
        out["cases"].append({"pods": list(pods), "sel": float(sel[0]), "any": bool(any_sel),
                             "agg": agg["w"].tolist(), "device": agg["w"].device.type,
                             "sync": sync, "bytes": hlo.collective_bytes(),
                             "counts": hlo.collective_counts()})
    g = torch.Generator(device="cuda").manual_seed(rank)
    a, b = (torch.randn(1 << 20, generator=g, device="cuda") for _ in range(2))
    out["pod_value"] = float(pod_values({"x": a}, {"x": b}, 0.5, world))
    out["pod_value_plain"] = float(torch.sum((a - b) ** 2) * (1.0 + world / 1e3) ** 0.5)
    dist.destroy_process_group()
    q.put(out)


def _gated_two_ranks() -> list:
    import multiprocessing
    import queue
    import tempfile
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/rendezvous"
        procs = [ctx.Process(target=gated_rank, args=(q, str(ROOT), r, 2, init))
                 for r in range(2)]
        try:
            for p in procs:
                p.start()
            outs, h0 = [], time.perf_counter()
            while len(outs) < len(procs):
                try:
                    outs.append(q.get(timeout=1.0))
                except queue.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs) or \
                            time.perf_counter() - h0 > 180:
                        fail(f"[train] a gated-collective rank failed or hung: exit codes "
                             f"{[p.exitcode for p in procs]}")
            outs.sort(key=lambda o: o["rank"])
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return outs


def phase_train_check() -> dict:
    """Step 1 of the full-width cell through the kernels against the same
    step through the plain attention on the card, per leaf; with the
    mixes (kernel forward + plain backward, plain forward + kernel
    backward, and the plain or kernel forward + the fp32 route's
    backward; ``TRAIN_MIX_SEEDS`` only) and the plain route at fp32
    compute, which say where a gap comes from.  Each route's worst leaf is also read in bf16 ulps at
    its worst entry, with the share of that leaf's entries that differ
    from the plain route's.  A comparison, so it runs before the [train]
    path's counts are reset."""
    import torch
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.kernels.flash_attention import ref

    cfg = _train_cfg()
    plain = lambda q, k, v, window=None: ref.gqa_attention(q, k, v, window)
    out = {}
    for seed in TRAIN_CHECK_SEEDS:
        loss_k, grads_k = _step_one_grads(cfg, seed)
        loss_p, grads_p = _step_one_grads(cfg, seed, plain)
        names = _leaf_names(grads_k)
        for name, g in zip(names, tree_leaves(grads_k)):
            if not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0.0:
                fail(f"[train] seed {seed}: parameter leaf {name} {tuple(g.shape)} got a zero or "
                     f"non-finite gradient")
        if abs(float(loss_k) - float(loss_p)) > 1e-2 * abs(float(loss_p)):
            fail(f"[train] seed {seed}: step 1 loss {float(loss_k)} through the kernels, "
                 f"{float(loss_p)} plain")
        per_leaf = _leaf_gaps(grads_k, grads_p)
        gaps = {"kernels": _worst(per_leaf, names)}
        detail = {"kernels": _worst_entry(grads_k, grads_p, per_leaf)}
        mixes = (("kernel fwd + plain bwd", True, "plain"),
                 ("plain fwd + kernel bwd", False, "kernel"),
                 ("plain fwd + fp32-route bwd", False, "fp32 route"),
                 ("kernel fwd + fp32-route bwd", True, "fp32 route"))
        for what, fwd, bwd in mixes if seed in TRAIN_MIX_SEEDS else ():
            grads = _step_one_grads(cfg, seed, _attention_route(fwd, bwd))[1]
            mix = _leaf_gaps(grads, grads_p)
            gaps[what], detail[what] = _worst(mix, names), _worst_entry(grads, grads_p, mix)
            del grads
            torch.cuda.empty_cache()
        _, grads_f = _step_one_grads(cfg.replace(compute_dtype="float32"), seed, plain)
        floor_per_leaf = _leaf_gaps(grads_p, grads_f)
        to_fp32 = {"kernels": _worst(_leaf_gaps(grads_k, grads_f), names),
                   "plain": _worst(floor_per_leaf, names)}
        floor = to_fp32["plain"][0]
        say(f"[train] step 1, seed {seed}: {len(names)} parameter leaves "
            f"({sum(x.numel() for x in tree_leaves(grads_k))} parameters), every gradient "
            f"nonzero and finite; loss {float(loss_k):.6f} through the kernels, "
            f"{float(loss_p):.6f} through the plain attention; worst leaf gap to the plain "
            f"route, of its scale: "
            + ", ".join(f"{w} {e:.4g} ({n}: {detail[w][0]:.3g} bf16 ulps at its worst entry, "
                        f"{detail[w][1]:.3g} of its entries differ)"
                        for w, (e, n) in gaps.items())
            + f"; to the plain route at fp32 compute: "
            + ", ".join(f"{w} {e:.4g} ({n})" for w, (e, n) in to_fp32.items())
            + f"; limit min({TRAIN_GRAD_TOL}, bf16 floor {floor:.4g})")
        say(f"[train] step 1, seed {seed}, per leaf: kernels - plain, max abs / plain's scale "
            f"= of scale, share of entries that differ; plain bf16 - plain fp32, of scale: "
            + "; ".join(f"{n} {d:.3g} / {sc:.3g} = {e:.3g}, {sh:.3g}; {fe:.3g}"
                        for n, (e, d, sc, sh), (fe, *_) in zip(names, per_leaf, floor_per_leaf)))
        err, name = gaps["kernels"]
        if err > min(TRAIN_GRAD_TOL, floor):
            fail(f"[train] seed {seed}: leaf {name}: kernel vs plain attention route {err:.3g} "
                 f"of its gradient's scale, beyond {TRAIN_GRAD_TOL} or the bf16 floor {floor:.3g} "
                 f"(the plain route's own largest gap to fp32 compute)")
        out[seed] = {"loss_kernels": float(loss_k), "loss_plain": float(loss_p),
                     "gaps": gaps, "worst_entry": detail, "to_fp32": to_fp32, "floor": floor}
        del grads_k, grads_p, grads_f
        torch.cuda.empty_cache()
    return out


def phase_train() -> dict:
    """The training path on the card; returns its numbers for the
    ``[time]`` lines and the ``kernels`` line."""
    import numpy as np
    import torch
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.core.metrics import ccr
    from repro_torch.examples import fl_llm_finetune
    from repro_torch.launch import fl_train

    cfg = _train_cfg()
    full = cfg.replace(num_layers=40)
    say(f"[train] minicpm_2b at its published width: d_model {cfg.d_model}, {cfg.num_heads} "
        f"heads ({cfg.num_kv_heads} kv) of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size} (tied), {cfg.compute_dtype} compute, {cfg.param_dtype} params; "
        f"reduced: num_layers {full.num_layers} -> {cfg.num_layers}; batch {TRAIN['batch']} x "
        f"{TRAIN['seq']} tokens")

    # 1. make_train_step, 5 steps, twice from one seed
    _train_run(cfg)                                           # warm-up: cuBLAS, allocator
    torch.cuda.reset_peak_memory_stats()
    a = _train_run(cfg)
    b = _train_run(cfg)
    same = a["losses"] == b["losses"] and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(a["params"]), tree_leaves(b["params"])))
    if not same:
        fail(f"[train] two runs from one seed differ: losses {a['losses']} and {b['losses']}")
    if not a["losses"][-1] < a["losses"][0]:
        fail(f"[train] the loss did not fall over {TRAIN['steps']} steps: {a['losses']}")
    counts = a["counts"]
    if counts["flash_attention"] <= 0 or counts["flash_attention_bwd"] <= 0:
        fail(f"[train] the train step did not go through the attention kernels: {counts}")
    step_s = float(np.median(a["step_s"]))
    tok_s = TRAIN["batch"] * TRAIN["seq"] / step_s
    say(f"[train] make_train_step x {TRAIN['steps']} on one repeated batch, lr {TRAIN['lr']}: "
        f"losses "
        f"{[round(x, 4) for x in a['losses']]}, grad norms "
        f"{[round(x, 4) for x in a['grad_norms']]}; two runs from one seed bit-equal; "
        f"median {step_s:.4f} s a step, {tok_s:.1f} tokens/s; launches forward "
        f"{counts['flash_attention']}, backward {counts['flash_attention_bwd']}, "
        f"grad_diff_norm {counts['grad_diff_norm']}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del a, b
    torch.cuda.empty_cache()

    # 2. make_fl_train_step, P = 2, vafl and afl
    fl = {}
    for alg in ("vafl", "afl"):
        from repro_torch.kernels.grad_diff_norm import ops as gd_ops
        before = gd_ops.launches
        h0 = time.perf_counter()
        infos = fl_train.run("minicpm_2b", smoke=False, steps=FL_TRAIN["steps"],
                             pods=FL_TRAIN["pods"], batch_per_pod=FL_TRAIN["batch_per_pod"],
                             seq=TRAIN["seq"], lr=TRAIN["lr"], algorithm=alg, device="cuda",
                             cfg=cfg, verbose=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - h0
        gd = gd_ops.launches - before
        if gd != FL_TRAIN["steps"]:
            fail(f"[train] fl step {alg}: {gd} grad_diff_norm launches, expected one a step")
        masks = [i["mask"].tolist() for i in infos]
        if any(not 1 <= sum(m) <= FL_TRAIN["pods"] for m in masks) or \
                (alg == "afl" and any(sum(m) != FL_TRAIN["pods"] for m in masks)):
            fail(f"[train] fl step {alg}: masks {masks}")
        fl[alg] = {"s_per_step": secs / FL_TRAIN["steps"], "launches": gd,
                   "synced": [int(sum(m)) for m in masks]}
        say(f"[train] make_fl_train_step {alg}, P = {FL_TRAIN['pods']} x "
            f"{FL_TRAIN['batch_per_pod']} x {TRAIN['seq']} tokens: V {[[float(f'{v:.5g}') for v in i['V']] for i in infos]}, "
            f"masks {masks}, silos synced {fl[alg]['synced']}, losses "
            f"{[round(float(i['loss']), 4) for i in infos]}, {secs / FL_TRAIN['steps']:.4f} s a "
            f"step (the first step's warm-up included), grad_diff_norm launches {gd}")

    # 3. the gated collective on two spawned ranks
    h0 = time.perf_counter()
    outs = _gated_two_ranks()
    for j, pods in enumerate(GATED_PODS):
        vals = [GATED_VALS[p] for p in pods]
        wts = [GATED_WTS[p] for p in pods]
        mean = sum(vals) / len(vals)
        sel = [1.0 if v >= mean else 0.0 for v in vals]
        agg = (sum(s * w * p for s, w, p in zip(sel, wts, pods))
               / sum(s * w for s, w in zip(sel, wts)))
        got = [o["cases"][j] for o in outs]
        if [c["sel"] for c in got] != sel or not all(c["any"] and c["sync"] for c in got) or \
                any(abs(x - agg) > 1e-5 for c in got for x in c["agg"]) or \
                any(c["device"] != "cuda" for c in got):
            fail(f"[train] gated collective, pods {pods}: {got}, expected selection {sel}, "
                 f"aggregate {agg}")
        say(f"[train] gated collective, 2 ranks (gloo, CUDA tensors), the reference test's pods "
            f"{list(pods)}: selection {[c['sel'] for c in got]}, aggregate {got[0]['agg'][0]} "
            f"(expected {agg}), collective bytes a rank {got[0]['bytes']}, counts "
            f"{got[0]['counts']}")
    for o in outs:
        if abs(o["pod_value"] - o["pod_value_plain"]) > 1e-4 * abs(o["pod_value_plain"]):
            fail(f"[train] pod_values on rank {o['rank']}: {o['pod_value']} against "
                 f"{o['pod_value_plain']}")
    gated_s = time.perf_counter() - h0

    # 4. the federated LM example, afl against vafl
    h0 = time.perf_counter()
    res = fl_llm_finetune.run(device="cuda", verbose=False)
    ex_s = time.perf_counter() - h0
    afl, vafl = res["afl"], res["vafl"]
    for name, r in res.items():
        if not (np.isfinite(r.best_acc) and 0.0 < r.best_acc <= 1.0):
            fail(f"[train] FL LM example {name}: next-token accuracy {r.best_acc}")
    if vafl.comm.model_uploads > afl.comm.model_uploads:
        fail(f"[train] FL LM example: vafl uploaded more than afl ({vafl.comm.model_uploads} > "
             f"{afl.comm.model_uploads})")
    c = ccr(afl.comm.model_uploads, vafl.comm.model_uploads)
    say(f"[train] FL LM example (minicpm_2b smoke, vocab 128, 3 silos, 6 rounds): afl uploads "
        f"{afl.comm.model_uploads}, next-token acc {afl.best_acc:.4f}; vafl uploads "
        f"{vafl.comm.model_uploads}, next-token acc {vafl.best_acc:.4f}, CCR {c:.2%}; "
        f"{ex_s:.2f} s for both")
    return {"step_s": step_s, "tok_s": tok_s, "counts": counts, "fl": fl, "gated_s": gated_s,
            "example_s": ex_s, "ccr": c}


def _family_cfg(arch: str, pattern=None):
    """``arch`` at its published width, its depth cut to ``pattern`` (the
    [train] cut when None: zamba2_7b's first ``ZAMBA2_TRAIN_DEPTH``
    pattern entries, the others' first ``TRAIN_CUT`` layers)."""
    from repro_torch.models.registry import get_config
    cfg = get_config(arch)
    if pattern is None:
        depth = ZAMBA2_TRAIN_DEPTH if arch == "zamba2_7b" else TRAIN_CUT["num_layers"]
        pattern = cfg.pattern()[:depth]
    return cfg.replace(num_layers=len(pattern), layer_pattern=tuple(pattern))


def _path_launches(cfg, steps: int) -> dict:
    """The kernel launches ``steps`` train steps of ``cfg`` make: each
    layer checkpointed, so two forwards and one backward a layer a step,
    linear_scan's for an RWKV6 or Mamba2 layer, flash_attention's for an
    attention layer or shared-attention invocation."""
    pat = cfg.pattern()
    n_ls = sum(kind in ("rwkv6", "mamba2") for kind in pat)
    n_fa = sum(kind in ("attn", "shared_attn") for kind in pat)
    return {"linear_scan": 2 * n_ls * steps, "linear_scan_bwd": n_ls * steps,
            "flash_attention": 2 * n_fa * steps, "flash_attention_bwd": n_fa * steps}


def _plain_routes():
    """A context in which the model layers' scan and attention run through
    their plain versions, autograd through ``ref.recurrence`` and
    ``ref.gqa_attention`` (a comparison's route only)."""
    from contextlib import ExitStack
    from unittest import mock
    from repro_torch.kernels.flash_attention import ops as fa, ref as fa_ref
    from repro_torch.kernels.linear_scan import ops as ls, ref as ls_ref

    def scan(q, k, v, la, u=None, *, include_current=True, initial_state=None):
        return ls_ref.recurrence(q, k, v, la, u, include_current=include_current,
                                 initial_state=initial_state)

    stack = ExitStack()
    stack.enter_context(mock.patch.object(
        fa, "gqa_flash_attention", lambda q, k, v, window=None: fa_ref.gqa_attention(q, k, v,
                                                                                   window)))
    stack.enter_context(mock.patch.object(ls, "recurrence", scan))
    return stack


def _family_step_one(cfg, plain: bool, routed=None, replay=None):
    """Step 1's loss and gradients of ``cfg`` from seed 0 on the [train]
    batch, through the kernels or the plain routes.  Each MoE call's own
    router choices (T, top_k) are appended to ``routed``; with ``replay``
    (one layer's choices) every MoE call routes by them instead."""
    import torch
    from contextlib import ExitStack
    from unittest import mock
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import decoder, moe
    params = decoder.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    batch = _train_batch(cfg)
    with ExitStack() as stack:
        if plain:
            stack.enter_context(_plain_routes())
        if routed is not None:
            route = moe._route

            def recording(p, c, x2d):
                w, ids, aux = route(p, c, x2d)
                routed.append(ids.detach().clone())
                return route(p, c, x2d, replay) if replay is not None else (w, ids, aux)
            stack.enter_context(mock.patch.object(moe, "_route", recording))
        out = value_and_grad(lambda p, b: decoder.loss_fn(cfg, p, b), params, batch)
    del params
    return out


def _moved_pairs(a: list, b: list, layers: int) -> list:
    """(token, expert) pairs routed on one route and not the other, each
    of the first ``layers`` MoE layers (the forward's calls; the
    checkpoints' recomputations follow them)."""
    import torch.nn.functional as F
    out = []
    for x, y in zip(a[:layers], b[:layers]):
        E = int(max(x.max(), y.max())) + 1
        out.append(int((F.one_hot(x, E).sum(1) - F.one_hot(y, E).sum(1)).abs().sum()) // 2)
    return out


def _family_gaps(arch, cfg, kern, plain, fp32, bar_fixed=None) -> dict:
    """Check step 1 through the kernels (``kern``) against the plain
    routes (``plain``), both (loss, grads): every leaf nonzero and finite,
    the losses within 1e-2, the worst leaf within ``bar_fixed`` or, given
    the plain route at fp32 compute (``fp32``), within min(TRAIN_GRAD_TOL,
    its bf16 floor); print the leaves."""
    import torch
    from repro_torch.common.pytree import tree_leaves
    (loss_k, gk), (loss_p, gp) = kern, plain
    names = _leaf_names(gk)
    for name, g in zip(names, tree_leaves(gk)):
        if not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0.0:
            fail(f"[train] {arch}: parameter leaf {name} {tuple(g.shape)} got a zero or "
                 f"non-finite gradient through the kernels")
    if abs(float(loss_k) - float(loss_p)) > 1e-2 * abs(float(loss_p)):
        fail(f"[train] {arch}: step 1 loss {float(loss_k)} through the kernels, "
             f"{float(loss_p)} plain")
    per_leaf = _leaf_gaps(gk, gp)
    err, name = _worst(per_leaf, names)
    floor = None
    if fp32 is not None:
        floor = _worst(_leaf_gaps(gp, fp32[1]), names)[0]
    bar = bar_fixed if bar_fixed is not None else min(TRAIN_GRAD_TOL, floor)
    say(f"[train] {arch} step 1, {cfg.compute_dtype} compute, pattern {list(cfg.pattern())}: "
        f"{len(names)} leaves ({sum(x.numel() for x in tree_leaves(gk))} parameters), every "
        f"gradient nonzero and finite; loss {float(loss_k):.6f} through the kernels, "
        f"{float(loss_p):.6f} through the plain routes; worst leaf gap {err:.4g} of its scale "
        f"({name}); limit {bar:.4g}"
        + (f" = min({TRAIN_GRAD_TOL}, bf16 floor {floor:.4g}, the plain route's own largest "
           f"gap to fp32 compute)" if bar_fixed is None else "")
        + "; per leaf: " + "; ".join(f"{n} {e:.3g}" for n, (e, *_) in zip(names, per_leaf)))
    if err > bar:
        fail(f"[train] {arch}: leaf {name}: kernel vs plain routes {err:.3g} of its gradient's "
             f"scale, beyond {bar:.3g}")
    return {"worst": err, "leaf": name, "floor": floor, "bar": bar,
            "loss_kernels": float(loss_k), "loss_plain": float(loss_p)}


def phase_train_families_check() -> dict:
    """Step 1 of each ``TRAIN_FAMILIES`` cell through the kernels against
    the same step through the plain routes on the card, leaf by leaf: at
    fp32 compute at the [train] cut within TRAIN_FP32_GRAD_TOL, and at
    bf16 compute on ``TRAIN_BF16_CUT`` within min(TRAIN_GRAD_TOL, the bf16
    floor); granite's moved router choices printed, and at bf16 the plain
    fp32 step's choices replayed in both bf16 steps.  A comparison: it
    runs before the [train] path's counts are reset."""
    import torch
    out = {}
    for arch in TRAIN_FAMILIES:
        moe = arch == "granite_moe_3b_a800m"
        cfg = _family_cfg(arch).replace(compute_dtype="float32")
        rk, rp = ([], []) if moe else (None, None)
        kern = _family_step_one(cfg, False, rk)
        plain = _family_step_one(cfg, True, rp)
        out[arch] = {"fp32": _family_gaps(arch, cfg, kern, plain, None, TRAIN_FP32_GRAD_TOL)}
        if moe:
            moved = _moved_pairs(rk, rp, cfg.num_layers)
            say(f"[train] {arch} step 1, fp32 compute: (token, expert) pairs routed through "
                f"the kernels and not the plain routes, a layer: {moved} of {rk[0].numel()}")
            out[arch]["fp32_moved_pairs"] = moved
        del kern, plain
        torch.cuda.empty_cache()
        cfg1 = _family_cfg(arch, TRAIN_BF16_CUT[arch])
        replay = None
        rf, rk, rp = ([], [], []) if moe else (None, None, None)
        fp32 = _family_step_one(cfg1.replace(compute_dtype="float32"), True, rf)
        if moe:
            replay = rf[0]
        kern = _family_step_one(cfg1, False, rk, replay)
        plain = _family_step_one(cfg1, True, rp, replay)
        if moe:
            moved = {"kernels' own - replayed": _moved_pairs(rk, [replay], 1),
                     "plain's own - replayed": _moved_pairs(rp, [replay], 1)}
            say(f"[train] {arch} step 1, bf16 compute, pattern {list(cfg1.pattern())}: the "
                f"plain fp32 step's router choices replayed in both bf16 steps; (token, expert) "
                f"pairs each bf16 step would have routed otherwise: {moved} of "
                f"{replay.numel()}")
            out[arch]["bf16_moved_pairs"] = moved
        out[arch]["bf16"] = _family_gaps(arch, cfg1, kern, plain, fp32)
        del kern, plain, fp32
        torch.cuda.empty_cache()
    return out


def phase_train_families() -> dict:
    """``make_train_step`` for TRAIN["steps"] steps on one repeated batch
    for each ``TRAIN_FAMILIES`` cell: the loss falls, and the scan and
    attention kernels launch, forward and backward, as often as the
    layer pattern and the checkpointing imply; granite's run twice from
    one seed, bit-equal (its dispatch drops pairs at this width, whose
    rows the scatter's backward shares)."""
    import numpy as np
    import torch
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.models.registry import get_config
    out = {}
    for arch in TRAIN_FAMILIES:
        cfg = _family_cfg(arch)
        torch.cuda.reset_peak_memory_stats()
        a = _train_run(cfg)
        if not all(np.isfinite(a["losses"])) or not a["losses"][-1] < a["losses"][0]:
            fail(f"[train] {arch}: the loss did not fall over {TRAIN['steps']} steps: "
                 f"{a['losses']}")
        want = _path_launches(cfg, TRAIN["steps"])
        got = {k: a["counts"][k] for k in want}
        if got != want:
            fail(f"[train] {arch}: kernel launches {got}, the layer pattern implies {want}")
        same = None
        if arch == "granite_moe_3b_a800m":
            b = _train_run(cfg)
            same = a["losses"] == b["losses"] and all(
                torch.equal(x, y) for x, y in zip(tree_leaves(a["params"]),
                                                  tree_leaves(b["params"])))
            if not same:
                fail(f"[train] {arch}: two runs from one seed differ: losses {a['losses']} "
                     f"and {b['losses']}")
            del b
        step_s = float(np.median(a["step_s"]))
        peak = torch.cuda.max_memory_allocated() / 1e9
        say(f"[train] {arch} at its published width (d_model {cfg.d_model}, vocab "
            f"{cfg.vocab_size}), {cfg.compute_dtype} compute, {cfg.param_dtype} params; "
            f"reduced: num_layers {get_config(arch).num_layers} -> {cfg.num_layers} (pattern "
            f"{list(cfg.pattern())}); batch {TRAIN['batch']} x {TRAIN['seq']} tokens; "
            f"make_train_step x {TRAIN['steps']}, lr {TRAIN['lr']}: losses "
            f"{[round(x, 4) for x in a['losses']]}, grad norms "
            f"{[round(x, 4) for x in a['grad_norms']]}"
            + ("; two runs from one seed bit-equal" if same else "")
            + f"; median {step_s:.4f} s a step, {TRAIN['batch'] * TRAIN['seq'] / step_s:.1f} "
            f"tokens/s; launches {got} (as the pattern implies); peak device memory "
            f"{peak:.2f} GB")
        out[arch] = {"step_s": step_s, "counts": got, "losses": a["losses"], "peak_gb": peak}
        del a
        torch.cuda.empty_cache()
    return out


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
    ls_bwd_rows = []
    phase_linear_scan_bwd(ls_bwd_rows)
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
    wire_refs = fl_wire_references(cap)
    read = _reset_launches()
    fl_wire = phase_fl_wire(cap, wire_refs, fl_serve)
    fw_counts = read()                           # read just after the fl-wire path
    mark("fl-wire")
    read = _reset_launches()
    figures = phase_figures()
    fig_counts = read()                          # read just after the figures path
    mark("figures")
    fa_bwd_rows = []
    phase_flash_backward(fa_bwd_rows)
    train_check = phase_train_check()
    fam_check = phase_train_families_check()
    read = _reset_launches()
    train = phase_train()
    families = phase_train_families()
    tr_counts = read()                           # read just after the train path
    mark("train")
    if min(tr_counts["flash_attention"], tr_counts["flash_attention_bwd"],
           tr_counts["grad_diff_norm"], tr_counts["linear_scan"],
           tr_counts["linear_scan_bwd"]) <= 0:
        fail(f"a kernel of the train path never launched: {tr_counts}")
    for what, counts in (("round-scenario", rs_counts), ("checkpoint", ck_counts),
                         ("obs", obs_counts), ("fl-serve", fs_counts), ("fl-wire", fw_counts)):
        if counts["grad_diff_norm"] <= 0 or counts["topk_quant"] <= 0:
            fail(f"a kernel of the {what} path never launched: {counts}")
    for what, counts in (("round-scenario", rs_counts), ("checkpoint", ck_counts),
                         ("obs", obs_counts), ("fl-serve", fs_counts), ("fl-wire", fw_counts),
                         ("figures", fig_counts)):
        if (counts["flash_attention"] or counts["flash_attention_bwd"] or counts["linear_scan"]
                or counts["linear_scan_bwd"]):
            fail(f"the {what} path launched an LLM kernel: {counts}")
    if fig_counts["grad_diff_norm"] <= 0:
        fail(f"the figures' vafl runs never launched grad_diff_norm: {fig_counts}")
    # rwkv6_3b's prefill-vs-decode check is gated in fp32: at bf16 the
    # random-weight stack's two paths drift apart with depth in the
    # reference as in the port (PERF.md §6; the bf16 gate at depth 2 is
    # tests/test_torch_llm_serve.py's gpu test), while the dense model
    # holds 2e-2 in bf16 at full depth
    # zamba2_7b's is gated in fp32 as rwkv6_3b's: a recurrent stack, 81
    # layers deep; its gap is also read at 12 layers and with an fp32 cache
    served = {"starcoder2_3b": phase_serve("starcoder2_3b", "bfloat16"),
              "rwkv6_3b": phase_serve("rwkv6_3b", "float32"),
              "zamba2_7b": phase_serve("zamba2_7b", "float32", readings=ZAMBA2_GAP_READINGS)}
    mark("serve")
    # granite is drawn in fp32 (13.2 GB) and checked whole; qwen3 is drawn
    # in bf16 (its 30.5 B parameters would not fit in fp32) and checked in
    # fp32 on its first layers drawn alone (_moe_stepwise)
    served["granite_moe_3b_a800m"] = phase_serve("granite_moe_3b_a800m", "float32")
    mark("serve-granite")
    served["qwen3_moe_30b_a3b"] = phase_serve("qwen3_moe_30b_a3b", "bfloat16",
                                              fp32_layers=FP32_CUT_LAYERS)
    mark("serve-qwen3")
    # minicpm3_4b (MLA: the expanded prefill through the kernel at q.k 96 /
    # v 64, the absorbed decode over the latent cache) and llava (16.3 and
    # 29.0 GB in fp32) are drawn and gated in fp32, llava also on its
    # prefix path; command_r_35b is drawn in bf16 (60.6 GB; 121 GB in
    # fp32), gated in bf16 at full depth (its weights from seed 0 read
    # 0.0171; from seeds 1 and 2, 0.0246 and 0.0181: PERF.md §7) and in
    # fp32 on its first 4 layers drawn alone (reduced)
    served["minicpm3_4b"] = phase_serve("minicpm3_4b", "float32")
    mark("serve-minicpm3")
    served["llava_next_mistral_7b"] = phase_serve("llava_next_mistral_7b", "float32", prefix=True)
    mark("serve-llava")
    served["command_r_35b"] = phase_serve("command_r_35b", "bfloat16",
                                          fp32_layers=FP32_CUT_LAYERS)
    mark("serve-command-r")
    # whisper_small (the encoder-decoder: its encoder and cross-attention
    # through the kernel's non-causal mode) is drawn in fp32 for the
    # encoder's card-vs-CPU check and served in bf16
    whisper = phase_serve_whisper()
    mark("serve-whisper")
    say("[time] phases (host seconds): " + ", ".join(
        f"{name} {t - t0:.1f}" for (_, t0), (name, t) in zip(marks, marks[1:])))

    for row in (list(gd_rows.values()) + list(tq_rows.values()) + fa_rows + ls_rows + ls_bwd_rows
                + fa_bwd_rows):
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
                   fl_wire_launches=fw_counts["grad_diff_norm"],
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
                   fl_wire_launches=fw_counts["topk_quant"],
                   fl_wire_child_launches=fl_wire["process"]["child_launches"],
                   figures_launches=fig_counts["topk_quant"])
    # each serving row keeps its first model's shape and adds the later
    # models' under their own prefix
    fa_by = {arch: next(r for r in fa_rows if r["case"] == case) for arch, case in FA_MODEL.items()}
    ls_z = next(r for r in ls_rows if r["form"] == "mamba-head")

    def with_model(row, arch, prefix, z, launches=None):
        if launches is None:
            launches = served[arch]["launches"][row["name"]]
        return dict(row, **{f"{prefix}_{k}": z[k] for k in (
            "shape", "ms", "bound_ms", "bound_by", "plain_ms", "library_ms", "max_abs_err")},
            **{f"{prefix}_launches": launches})

    main_fa = dict(fa_rows[0], launches=served["starcoder2_3b"]["launches"]["flash_attention"],
                   tensor_core_instructions=sass["flash_attention"])
    for arch, prefix in (("zamba2_7b", "zamba2"), ("granite_moe_3b_a800m", "granite_moe"),
                         ("qwen3_moe_30b_a3b", "qwen3_moe"), ("minicpm3_4b", "minicpm3"),
                         ("command_r_35b", "command_r")):
        main_fa = with_model(main_fa, arch, prefix, fa_by[arch])
    # llava: the prefix path's prefill (1,152 + 2,048 positions) and the
    # text-only serve call's
    llava = "llava_next_mistral_7b"
    main_fa = with_model(main_fa, llava, "llava", fa_by[llava],
                         launches=served[llava]["prefix"]["launches"])
    main_fa = with_model(main_fa, llava, "llava_serve", fa_by["llava_serve"])
    main_fa["minicpm3_dv"] = fa_by["minicpm3_4b"]["dv"]
    # whisper_small: its encoder's, its decoder's and its cross-attention's
    # shapes (Sk beside each), 12 launches each of the prefill's 36
    wh_by = {kind: next(r for r in fa_rows if r["case"] == case)
             for kind, case in FA_WHISPER.items()}
    for kind, z in wh_by.items():
        main_fa = with_model(main_fa, None, f"whisper_{kind}", z,
                             launches=whisper["kinds"][kind])
        main_fa[f"whisper_{kind}_sk"], main_fa[f"whisper_{kind}_causal"] = z["sk"], z["causal"]
    main_fa["whisper_launches"] = whisper["launches"]["flash_attention"]
    main_ls = with_model(dict(ls_rows[0], launches=served["rwkv6_3b"]["launches"]["linear_scan"],
                              tensor_core_instructions=sass["linear_scan"]),
                         "zamba2_7b", "zamba2", ls_z)
    say(f"[time] main path seconds per round (3 rounds, host clock, synchronized): "
        f"vafl {secs['vafl'] / 3:.4f}, afl {secs['afl'] / 3:.4f}")
    say("[time] event path (host clock, synchronized): "
        + ", ".join(f"{name} {t / (EVENT_ROUNDS if name == 'fedavg' else 7 * EVENT_ROUNDS):.4f} s per "
                    f"{'round' if name == 'fedavg' else 'event'} "
                    f"({(EVENT_ROUNDS if name == 'fedavg' else 7 * EVENT_ROUNDS) / t:.3f}/s)"
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
    fp, fc = fl_wire["process"], fl_wire["chaos"]
    say("[time] fl-wire (host clock, synchronized): bridge over socket s an event "
        + ", ".join(f"{a} {v:.4f}" for a, v in fl_wire["bridge"].items())
        + f"; thread vafl over socket {fl_wire['threads']['events_per_s']:.3f} events/s, busy "
        f"{fl_wire['threads']['busy']:.1%} (inproc {fl_serve['threads']['vafl']:.3f}, "
        f"{fl_serve['busy']:.1%}); {fp['children']} process workers afl "
        f"{fp['events_per_s']:.3f} events/s "
        f"(thread afl inproc {fl_serve['threads']['afl']:.3f}), card busy {_share(fp['busy'])}, "
        f"a child's peak device memory {fp['peak_gb']:.4f} GB, kernel builds in children "
        f"{fp['builds']}; SIGKILL to return {fl_wire['killed']['seconds']:.3f} s; chaos soak "
        f"fault-free {fc['fault_free_s']:.4f} s, over inproc {fc['inproc']:.4f} s "
        f"({fc['inproc'] / fc['fault_free_s']:.2f} x), over socket {fc['socket']:.4f} s "
        f"({fc['socket'] / fc['fault_free_s']:.2f} x)")
    kernel_ms = {("starcoder2_3b", "flash_attention"): fa_rows[0]["ms"],
                 ("rwkv6_3b", "linear_scan"): ls_rows[0]["ms"],
                 ("zamba2_7b", "linear_scan"): ls_z["ms"],
                 **{(arch, "flash_attention"): r["ms"] for arch, r in fa_by.items()},
                 (llava, "flash_attention"): fa_by["llava_serve"]["ms"]}
    for arch, st in served.items():
        parts = [(name, n, kernel_ms[(arch, name)]) for name, n in st["launches"].items()]
        say(f"[time] serve {arch} (host clock, synchronized): prefill {st['prefill_s']:.4f} s "
            f"for {SERVE['batch']} x {SERVE['prompt_len']} tokens, decode "
            f"{st['decode_tok_per_s']:.2f} tok/s ({SERVE['batch']} x {SERVE['gen']} tokens in "
            f"{st['decode_s']:.4f} s); "
            + ", ".join(f"{n} {name} launches x {ms:.4f} ms = {n * ms / 1e3 / st['prefill_s']:.1%}"
                        for name, n, ms in parts)
            + f" of the prefill; peak device memory {st['peak_gb']:.2f} GB"
            + (f"; MoE: {st['dropped_pairs']} (token, choice) pairs dropped in the prefill, "
               f"pairs an expert at layer 0 {st['load_first'][0]}-{st['load_first'][1]}, decode's "
               f"weight-read bound {st['decode_bound_ms']:.3f} ms a step"
               if "dropped_pairs" in st else ""))
        if "prefix" in st:
            px, ms = st["prefix"], fa_by[arch]["ms"]
            say(f"[time] serve {arch} prefix path (host clock, synchronized): prefill "
                f"{px['prefill_s']:.4f} s for {SERVE['batch']} x ({px['prefix']} + "
                f"{SERVE['prompt_len']}) positions, decode {px['decode_tok_per_s']:.2f} tok/s "
                f"({SERVE['batch']} x {SERVE['gen']} tokens in {px['decode_s']:.4f} s); "
                f"{px['launches']} flash_attention launches x {ms:.4f} ms = "
                f"{px['launches'] * ms / 1e3 / px['prefill_s']:.1%} of the prefill; prefix "
                f"prefill + one decode_step vs prefill {px['bf16_gap']:.3g} of the logits' scale "
                f"in bf16 (not gated)")
    wk = whisper["kinds"]
    say(f"[time] serve whisper_small (host clock, synchronized): prefill "
        f"{whisper['prefill_s']:.4f} s for {WHISPER_SERVE['batch']} x "
        f"{WHISPER_SERVE['prompt_len']} tokens after {WHISPER_SERVE['batch']} x 1500 frames (the "
        f"encoder's included), decode {whisper['decode_tok_per_s']:.2f} tok/s "
        f"({WHISPER_SERVE['batch']} x {WHISPER_SERVE['gen']} tokens in "
        f"{whisper['decode_s']:.4f} s); flash_attention "
        + ", ".join(f"{kind} {wk[kind]} x {z['ms']:.4f} ms" for kind, z in wh_by.items())
        + f" = {sum(wk[kind] * z['ms'] for kind, z in wh_by.items()) / 1e3 / whisper['prefill_s']:.1%}"
        f" of the prefill; peak device memory {whisper['peak_gb']:.2f} GB; prefill vs stepwise "
        f"{whisper['stepwise_gap']:.3g} of the logits' scale (bf16), the encoder card vs CPU "
        f"{whisper['encoder_gap']:.3g} (fp32)")
    # the backward's row: the train path's shape (minicpm_2b, bf16, no
    # window); its launches are the [train] path's, one 5-step
    # make_train_step run's beside them
    bwd_main = next(r for r in fa_bwd_rows if r["shape"][2] == 36 and r["window"] is None
                    and r["dtype"] == "bfloat16")
    bwd_sc = next(r for r in fa_bwd_rows if r["shape"][2] == 24 and r["window"] is None
                  and r["dtype"] == "bfloat16")
    main_bwd = dict(bwd_main, launches=tr_counts["flash_attention_bwd"],
                    tensor_core_instructions=sass["flash_attention_bwd"],
                    train_step_run_launches=train["counts"]["flash_attention_bwd"],
                    step_one_worst_leaf_gap={seed: c["gaps"]["kernels"]
                                             for seed, c in train_check.items()},
                    starcoder2_shape=bwd_sc["shape"], starcoder2_ms=bwd_sc["ms"],
                    starcoder2_plain_ms=bwd_sc["plain_ms"], starcoder2_bound_ms=bwd_sc["bound_ms"],
                    starcoder2_library_ms=bwd_sc["library_ms"])
    main_gd["train_launches"] = tr_counts["grad_diff_norm"]
    main_fa["train_launches"] = tr_counts["flash_attention"]
    main_ls["train_launches"] = tr_counts["linear_scan"]
    # the rows of this slice's backward kernels: every linear_scan_bwd case
    # and the hd-112 attention backward, each with the [train] path's
    # launches (and each family's 5-step run's beside them)
    fam_launches = {arch: f["counts"] for arch, f in families.items()}
    bwd_rows = ([dict(r, launches=tr_counts["linear_scan_bwd"],
                      train_step_run_launches={a: c["linear_scan_bwd"]
                                               for a, c in fam_launches.items()})
                 for r in ls_bwd_rows]
                + [dict(r, launches=tr_counts["flash_attention_bwd"],
                        tensor_core_instructions=sass["flash_attention_bwd"],
                        train_step_run_launches={a: c["flash_attention_bwd"]
                                                 for a, c in fam_launches.items()})
                   for r in fa_bwd_rows if r["shape"][4] == 112])
    say(f"[time] train (host clock, synchronized): make_train_step minicpm_2b at full width, "
        f"2 layers, {TRAIN['batch']} x {TRAIN['seq']} tokens: {train['step_s']:.4f} s a step, "
        f"{train['tok_s']:.1f} tokens/s; make_fl_train_step P = {FL_TRAIN['pods']}: "
        + ", ".join(f"{a} {v['s_per_step']:.4f} s a step" for a, v in train["fl"].items())
        + f"; gated collective on 2 spawned ranks {train['gated_s']:.2f} s; FL LM example "
        f"{train['example_s']:.2f} s (CCR {train['ccr']:.2%}); backward kernel "
        f"{bwd_main['ms']:.4f} ms at {bwd_main['shape']} bf16 (bound {bwd_main['bound_ms']:.4f}, "
        f"SDPA backward {bwd_main['library_ms']:.4f}, {bwd_main['x_library']:.2f} x), "
        f"{bwd_sc['ms']:.4f} ms at {bwd_sc['shape']} (bound {bwd_sc['bound_ms']:.4f}, SDPA "
        f"backward {bwd_sc['library_ms']:.4f}, {bwd_sc['x_library']:.2f} x)")
    say("[time] train families (host clock, synchronized): " + ", ".join(
        f"{arch} {f['step_s']:.4f} s a step ({TRAIN['batch'] * TRAIN['seq'] / f['step_s']:.1f} "
        f"tokens/s, peak {f['peak_gb']:.2f} GB)" for arch, f in families.items())
        + "; step 1 worst leaf gap through the kernels: " + ", ".join(
            f"{arch} fp32 {c['fp32']['worst']:.4g} (limit {c['fp32']['bar']:.4g}), bf16 "
            f"{c['bf16']['worst']:.4g} (limit {c['bf16']['bar']:.4g})"
            for arch, c in fam_check.items()))
    say(json.dumps({"kernels": [main_gd, main_tq, main_fa, main_ls, main_bwd] + bwd_rows}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
