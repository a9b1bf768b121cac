// Gated linear recurrence (the RWKV6 / Mamba2 core), backward, on the
// model layer's own layout.
//
// Replaces no TPU kernel: the Pallas linear_scan
// (src/repro/kernels/linear_scan/kernel.py:78) is forward-only, and the
// reference trains through its chunked jnp recurrence
// (src/repro/models/recurrence.py).  The port's recurrent layers launch
// the forward kernel on the card (csrc/linear_scan.cu), so training
// through them needs this backward; it is the gradient of exactly that
// function, for every (b, h):
//   S_t = diag(exp(la_t)) S_{t-1} + k_t v_t^T        S: (K, V) in fp32
//   y_t = q_t^T S_t                        (include_current != 0, Mamba2)
//   y_t = q_t^T (S_{t-1} + diag(u) k_t v_t^T)        (RWKV6 bonus form)
// with a per-dim la (B, S, H, K) clipped to [-8, 0], or a per-head la
// (B, S, H) taken as it is.  Given dy (B, S, H, V) and the final state's
// gradient dS (B, H, K, V; null: zeros):
//   dq_t = S_t dy_t                    (S_{t-1} dy_t + u k_t (v_t . dy_t))
//   G_t  = dL/dS_t = diag(exp(la_{t+1})) G_{t+1} + q_t dy_t^T, from dS
//          (with the bonus the read is one step on: q_{t+1} dy_{t+1}^T)
//   dk_t = G_t v_t (+ q_t u (v_t . dy_t)),  dv_t = G_t^T k_t
//          (+ (q_t . u k_t) dy_t),  d_initial_state = G after step 0
//   du   = sum over (b, t) of q_t k_t (v_t . dy_t)
//   dla_t = exp(la_t) <S_{t-1}, G_t> over V: zero where the clamp cut
//          la; summed over K per head.
// The plain version is kernels/linear_scan/ref.py recurrence_bwd (the
// fp32 route's arithmetic, in float64); ref.recurrence_bwd_chunked is the
// bf16 route's algebra, for the CPU tests.
//
// Bound on an H100: device-memory bytes.  Each input read once and each
// output written once: q, k, v, dy read and dq, dk, dv written in the
// input type, la read and dla written in fp32.  rwkv6_3b's train shape
// (B 4, S 1024, H 40, K = V = 64) in bf16: 22 bytes an element of
// (B, S, H, 64), 0.231 GB, 0.069 ms at 3.35 TB/s.  zamba2_7b's per-head
// Mamba2 layer (B 4, S 1024, H 112, K = V = 64): v, dy, dv a head, C and
// B (q, k) read once a (b, s) and their gradients written summed over the
// heads, la and dla a (b, s, head): 0.182 GB, 0.054 ms (the chunked
// form's operations at TF32's rate, 0.057 ms, bound it there).  The
// Mamba2 form's dq and dk come out per head (B, S, H, K); the wrapper
// returns them so and the broadcast's backward (torch's expand) sums them
// over the heads: 2 B S H K elements, 0.117 GB in bf16 at zamba2_7b's
// shape, written and read again beyond the bound.
//
// Two routes, chosen by the type of q, k, v, dy:
//
// bf16 (the [train] path): a chunked form, chunk-parallel, on the tensor
// cores.  Time is cut into chunks of C = 32 steps, the forward kernel's
// chunk: 32 rows are two 16-row mma tiles, a chunk's products and operands
// fit a block's shared memory twice over an SM (102.5 KB; the per-head
// kernel's 70.6 KB three times), and B H S / 32
// blocks fill the card (5,120 at rwkv6_3b's train shape, 14,336 at
// zamba2_7b's, where the fp32 route runs 160 and 448); the edge states
// below are 2 B H K V floats a chunk, so C = 64 would halve them but needs
// a third level of factoring and leaves half the blocks.  With cum the
// chunk's inclusive cumulative (clamped) log-decay, x_t = cum_t (Mamba2)
// or cum_{t-1} (RWKV6, 0 at the first step), D[t, s] = dy_t . v_s and
// A[t, s] = sum_d q_td k_sd exp(x_td - cum_sd) the forward's scores (s <=
// t, or s < t plus the bonus sum_d q_td u_d k_td at s = t), given the
// chunk's entry state S_in and its exit state's gradient G_out:
//   dq_t = exp(x_t) (S_in dy_t) + sum_s D[t,s] k_s exp(x_t - cum_s)
//   dk_s = exp(cum_C - cum_s) (G_out v_s) + sum_t D[t,s] q_t exp(x_t - cum_s)
//   dv_s = G_out^T (k_s exp(cum_C - cum_s)) + sum_t A[t,s] dy_t
//   (plus the bonus terms), and the edges G_in = exp(cum_C) G_out +
//   (q exp(x))^T dy, S_out = exp(cum_C) S_in + (k exp(cum_C - cum))^T v.
// Launch 1 (edge_bf16) walks the chunks: a block (role, head, batch row),
// role 0 forward from the initial state writing each chunk's S_in, role 1
// backward from dS writing each G_out and the initial state's gradient,
// each one K x V update a chunk on the tensor cores with the next chunk's
// inputs arriving by cp.async meanwhile.  The edge states are fp32
// scratch, (B, H, S / 32, K, V) each: 84 MB written and read again twice
// at rwkv6_3b's shape, 235 MB at zamba2_7b's, 0.10 / 0.28 ms of traffic
// beyond the bound.  Launch 2, a block (chunk, head, batch row), does the
// chunk's products: chunk_bf16 for a per-dim la (and a per-head la with
// the bonus), chunk_head_bf16 for Mamba2's per-head form, whose decay is
// one number a step (below); launch 3 sums du's per-chunk partials in
// order.  A chunk block loads its inputs by cp.async and its edge states
// with every 16-byte load in flight at once; the two blocks an SM holds
// (three per head) overlap one block's loads with another's products.
// No exponent above 0, as the forward keeps it.  Per head the decay of a
// pair (t, s) is one number, exp(cum_t - cum_s), s <= t, so the chunk's
// C x C decay matrix multiplies the scores elementwise, as SSD builds it
// (arXiv:2405.21060), and no operand is factored.  Per dim the decay on
// a contracted index is factored about a pivot between the two sides,
// exp(x_t - cum_r) exp(cum_r - cum_s), both <= 0: level 1 takes steps
// 16..31 against 0..15 about step 15, level 2 the upper half of each
// 16-step block against its lower half about step 7 or 23, and only the
// four 8 x 8 diagonal blocks are taken elementwise (an exponential per
// (t, s, d) there); a decay on an output index multiplies the product's
// result.  Past S the inputs are
// zero and la is 0, so the state and its gradient stay as they were at
// S - 1.  Every product runs as bf16 mma.sync m16n8k16 with fp32
// accumulation: D = dy v^T, the scores (q k^T per head; levels 1 and 2
// per dim), the readouts against S_in and G_out, D's products with k and
// q (DL k, DL^T q per head; the factored ones per dim), k against G_out,
// A^T dy, and the edge updates.
// fp32 operands are split into bf16 hi + lo and take three products (hi
// hi + hi lo + lo hi), two where the other side is bf16 already (v, dy,
// q, k): single bf16 scores are not enough (linear_scan.cu says why).
// mma.sync and not wgmma: the chunk's tiles are 16 and 32 rows, and
// wgmma's 64-row tiles would need C = 64 (above).
// dla without a sum over the whole sequence: inside a chunk <S_{t-1}, G_t>
// splits into (a) exp(cum_C) <S_in, G_out>, one number a chunk and row;
// (b) the reverse cumulative sum, from t on (past t with the bonus), of
// q dq's S_in part; (c) the forward sum before t of k dk's G_out part;
// (d) the chunk's own pairs (t', s) that straddle t, s < t <= t' (s < t
// < t').  Per head (d) is the sum of W = A . D (the decayed scores times
// D) over the straddling pairs: each row's sums over s < t, then each
// column's over t' >= t.  Per dim (d) is summed straight from its pairs,
// level by level: level 1's query side (q times dq's level-1 part, steps
// 16..31) as a reverse sum over 16..31, its key side as a forward sum
// over 0..15, level 2 the same
// inside each quarter, and each 8 x 8 diagonal block's own pairs by the
// thread that forms them.  The gated-linear-attention identity (the
// reverse sum of q dq - k dk) would also give (d), but leaves the
// rounding of every pair that straddles nothing: with split operands a
// head's sum of dla la (Mamba2's A_log gradient) moved 8e-4 of its scale
// in the plain model (ref.recurrence_bwd_chunked), 3e-6 summed straight.
// No sum crosses a chunk, so fp32 states and sums suffice.
// Blocks are independent and every sum has a fixed order: no atomics, and
// two launches on one input give the same bits.
//
// fp32 (held to 2e-4 of scale, and Mamba2's A_log to 1e-4 through a
// train step): the exact sequential recurrence on the CUDA cores, with
// states, products and sums in float64.  dla comes from the gated-linear-
// attention identity over the whole sequence, the reverse cumulative sum
// over t of q_t dq_t - k_t dk_t, each over the decayed terms only, the
// query's at t + 1 with the bonus, plus dS . S_final at the last step.
// Its query and key terms nearly cancel, so in fp32 what is left of them
// is their rounding, the fp32 states' above all: Mamba2's A_log, a sum of
// every step's dla, came out 1e-4 of its scale from the float64 gradient
// (autograd through the fp32 scan: 1e-6; this form, and the plain version
// in float64: 1e-6).  dq, dk and dv are rounded once to the input type,
// dla, du and d_initial_state to fp32.  Three launches, no atomics:
//   bwd_forward   one block of 256 threads a (head, batch row), forward in
//                 time: four threads share a row of the state, 16 columns
//                 each, and rebuild S from the initial state; each step
//                 gives dq (a sum over the row's columns, two shuffles) and
//                 the query term q dq of dla, written where dla goes (a
//                 per-head term summed over K in row order); at the end
//                 dS . S_final a row, and a (b, h)'s partial of du.
//   bwd_reverse   two blocks a (head, batch row), backward in time, each
//                 walking G from dS: role 0 with a row of G over four
//                 threads (dk, and the key term k dk, sums over columns),
//                 role 1 with a column over four threads (dv, a sum over
//                 rows), so that each sum is two shuffles.  After each
//                 chunk of steps role 0's threads take the reverse
//                 cumulative sum of dla a row (a head: one thread, over
//                 the chunk's per-step sums over K), in place of the query
//                 terms; it writes the initial state's gradient.
//   sum_du        du from the (b, h) partials, summed over b in order.
// Every pass stages 16 steps of q, k, exp(la), v and dy in shared memory
// as float64 (66 KB) with coalesced loads through the inputs' strides (q
// and k may be Mamba2's C and B broadcast over the heads, head stride 0),
// all of a thread's loads in flight at once, and writes each chunk's
// outputs back coalesced; the four threads of a row read a step's row in
// 16-byte pieces that fall on 64 consecutive bytes.  The bonus form's
// per-step scalars, v . dy and q . (u k), are summed once a step by a
// warp, not by every thread, and the form (include_current) is a template
// parameter, so no branch sits in the inner loop.  The query terms pass
// from bwd_forward to bwd_reverse in a float64 scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm80.cuh"

namespace {

constexpr int kMaxK = 64;                // largest K and V
constexpr int kThreads = 256;
constexpr int kParts = 4;                // threads sharing one row (or column) of the state
constexpr int kPer = kMaxK / kParts;     // state entries a thread holds
constexpr int kL = 16;                   // time steps staged at once
constexpr int kLoads = kL * kMaxK / kThreads;  // elements of each staged array a thread loads
constexpr double kLogAMin = -8.0;

typedef __nv_bfloat16 bf16;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dy;
  const float* la;
  const float* u;     // (H, K) or null: u = 1 in the bonus form
  const float* s0;    // (B, H, K, V) or null: zeros
  const float* ds;    // (B, H, K, V) or null: zeros
  void* dq;           // (B, S, H, K), contiguous, input type
  void* dk;           // (B, S, H, K)
  void* dv;           // (B, S, H, V)
  float* dla;         // (B, S, H, K) per dim, (B, S, H) per head
  double* xq;         // fp32: dla's shape: the query terms, bwd_forward to bwd_reverse
  double* xfin;       // fp32: (B, H, K): dS . S_final a row
  double* du_part;    // fp32: (B, H, K) or null: no du
  float* edge;        // bf16: (2, B, H, nc, K, V): each chunk's S_in, then its G_out
  float* du_c;        // bf16: (B, H, nc, K) or null: no du
  float* du;          // (H, K) or null
  float* ds0;         // (B, H, K, V) or null: no initial state's gradient
  long long sq[3], sk[3], sv[3], sl[3], sd[3];  // element strides over (b, s, head)
  int B, S, H, K, V, la_per_head, nc;
};

// the sum over the four threads that share a row (or a column)
__device__ __forceinline__ double sum_parts(double x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// The state entries a thread holds: entry j of part p is column (or row)
// 2 (p + 4 (j / 2)) + j % 2, so that the four parts' 16-byte reads of a
// step's row fall on 64 consecutive bytes.
__device__ __forceinline__ int ent(int p, int j) { return 2 * (p + kParts * (j / 2)) + j % 2; }

struct __align__(16) Stage {             // one chunk of steps, zeros past S, K and V
  double q[kL][kMaxK], k[kL][kMaxK];
  double w[kL][kMaxK];                   // exp of the (clamped) la; a head's in every row
  double v[kL][kMaxK], dy[kL][kMaxK];
  double o2[kL][kMaxK];                  // the query (q dq) or key (k dk) terms of dla
  double x[kL][kMaxK];                   // role 0: the query terms read back, then dla
  float o1[kL][kMaxK];                   // the chunk's dq, dk or dv, rounded once
  float keep[kL][kMaxK];                 // 1 where the clamp left la as it was
  double sc[kL];                         // a step's v . dy (role 1: q . u k), bonus form
  double ksum[kL];                       // per head: a step's key terms summed over K
  double u[kMaxK];
};

__device__ __forceinline__ long long row_off(const Args& a, int b, int t, int h) {
  return ((long long)b * a.S + t) * a.H + h;    // (b, t, h) of a (B, S, H, .) output
}

// Steps t0 .. t0 + n - 1 of (b, h) into the stage, and with `with_x` the
// query terms bwd_forward left in xq: every load a thread makes is in
// flight before its first store.
__device__ __forceinline__ void stage(Stage& sm, const Args& a, int b, int h, int t0, int n,
                                      int tid, bool with_x) {
  const float* qg = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const float* kg = static_cast<const float*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const float* vg = static_cast<const float*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const float* dg = static_cast<const float*>(a.dy) + b * a.sd[0] + h * a.sd[2];
  const float* lg = a.la + b * a.sl[0] + h * a.sl[2];
  float rq[kLoads], rk[kLoads], rl[kLoads], rv[kLoads], rd[kLoads];
  double rx[kLoads];
#pragma unroll
  for (int e = 0; e < kLoads; ++e) {
    const int i = tid + e * kThreads, t = i / kMaxK, d = i % kMaxK;
    const long long s = t0 + t;
    const bool in = t < n, ink = in && d < a.K, inv = in && d < a.V;
    rq[e] = ink ? qg[s * a.sq[1] + d] : 0.f;
    rk[e] = ink ? kg[s * a.sk[1] + d] : 0.f;
    rl[e] = !in ? 0.f : a.la_per_head ? lg[s * a.sl[1]] : ink ? lg[s * a.sl[1] + d] : 0.f;
    rv[e] = inv ? vg[s * a.sv[1] + d] : 0.f;
    rd[e] = inv ? dg[s * a.sd[1] + d] : 0.f;
    rx[e] = !with_x ? 0.0
            : a.la_per_head ? (in && d == 0 ? a.xq[row_off(a, b, t0 + t, h)] : 0.0)
            : ink ? a.xq[row_off(a, b, t0 + t, h) * a.K + d] : 0.0;
  }
#pragma unroll
  for (int e = 0; e < kLoads; ++e) {
    const int i = tid + e * kThreads, t = i / kMaxK, d = i % kMaxK;
    const double la = rl[e];
    sm.q[t][d] = rq[e];
    sm.k[t][d] = rk[e];
    sm.w[t][d] = exp(a.la_per_head ? la : fmin(fmax(la, kLogAMin), 0.0));
    sm.keep[t][d] = (la >= kLogAMin && la <= 0.0) ? 1.f : 0.f;
    sm.v[t][d] = rv[e];
    sm.dy[t][d] = rd[e];
    sm.x[t][d] = rx[e];
  }
}

// The bonus form's per-step scalars of a staged chunk, a warp a step:
// v_t . dy_t (what 0) or q_t . (u k_t) (what 1), summed over the lanes in
// a fixed order.
__device__ __forceinline__ void step_scalars(Stage& sm, int n, int tid, int what) {
  const int warp = tid / 32, lane = tid % 32;
  for (int t = warp; t < n; t += kThreads / 32) {
    double x = what == 0
                   ? fma(sm.v[t][lane], sm.dy[t][lane], sm.v[t][lane + 32] * sm.dy[t][lane + 32])
                   : fma(sm.q[t][lane] * sm.u[lane], sm.k[t][lane],
                         sm.q[t][lane + 32] * sm.u[lane + 32] * sm.k[t][lane + 32]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) sm.sc[t] = x;
  }
}

__device__ __forceinline__ Stage& stage_of(unsigned char* raw) {
  return *reinterpret_cast<Stage*>(raw);
}

// ============================================================ fp32 route

// ------------------------------------------------------- forward in time

template <bool kCur>
__global__ void __launch_bounds__(kThreads, 2) bwd_forward(Args a) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  Stage& sm = stage_of(fwd_smem);
  const int tid = threadIdx.x, r = tid / kParts, p = tid % kParts;
  const int h = blockIdx.x, b = blockIdx.y;
  constexpr bool bonus = !kCur;
  const long long bh = (long long)b * a.H + h;
  if (tid < kMaxK) sm.u[tid] = (a.u != nullptr && tid < a.K) ? a.u[h * a.K + tid] : 1.0;
  float* dqg = static_cast<float*>(a.dq);

  double s[kPer];                         // S[r][ent(p, j)]
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = ent(p, j);
    s[j] = (a.s0 != nullptr && r < a.K && c < a.V) ? a.s0[(bh * a.K + r) * a.V + c] : 0.0;
  }
  double du = 0.0;

  for (int t0 = 0; t0 < a.S; t0 += kL) {
    const int n = min(kL, a.S - t0);
    __syncthreads();  // the previous chunk's readers of the stage are done
    stage(sm, a, b, h, t0, n, tid, false);
    __syncthreads();
    if (bonus) {
      step_scalars(sm, n, tid, 0);
      __syncthreads();
    }
    const double ur = sm.u[r];
    for (int t = 0; t < n; ++t) {
      const double w = sm.w[t][r], kr = sm.k[t][r], qr = sm.q[t][r];
      const double2* v2 = reinterpret_cast<const double2*>(&sm.v[t][0]) + p;
      const double2* d2 = reinterpret_cast<const double2*>(&sm.dy[t][0]) + p;
      double acc[2] = {0.0, 0.0};
#pragma unroll
      for (int j2 = 0; j2 < kPer / 2; ++j2) {
        const double2 vv = v2[kParts * j2], dd = d2[kParts * j2];
        const double vx[2] = {vv.x, vv.y}, dx[2] = {dd.x, dd.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 2 * j2 + e;
          if (kCur) {
            s[j] = fma(w, s[j], kr * vx[e]);
            acc[e] = fma(s[j], dx[e], acc[e]);
          } else {
            acc[e] = fma(s[j], dx[e], acc[e]);
            s[j] = fma(w, s[j], kr * vx[e]);
          }
        }
      }
      const double dqd = sum_parts(acc[0] + acc[1]);
      if (p == 0) {
        const double vdy = bonus ? sm.sc[t] : 0.0;
        sm.o1[t][r] = (float)(bonus ? fma(ur * kr, vdy, dqd) : dqd);
        sm.o2[t][r] = qr * dqd;
        du = fma(qr * kr, vdy, du);
      }
    }
    __syncthreads();
    for (int i = tid; i < n * kMaxK; i += kThreads) {
      const int t = i / kMaxK, d = i % kMaxK;
      if (d < a.K) {
        const long long off = row_off(a, b, t0 + t, h) * a.K + d;
        dqg[off] = sm.o1[t][d];
        if (!a.la_per_head) a.xq[off] = sm.o2[t][d];
      }
    }
    if (a.la_per_head && tid < n) {       // a head's query term: its rows summed in order
      double x = 0.0;
      for (int d = 0; d < a.K; ++d) x += sm.o2[tid][d];
      a.xq[row_off(a, b, t0 + tid, h)] = x;
    }
  }

  double xf = 0.0;                        // dS . S_final over this row
  if (a.ds != nullptr && r < a.K) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = ent(p, j);
      if (c < a.V) xf = fma((double)a.ds[(bh * a.K + r) * a.V + c], s[j], xf);
    }
  }
  xf = sum_parts(xf);
  if (p == 0 && r < a.K) {
    a.xfin[bh * a.K + r] = xf;
    if (a.du_part != nullptr) a.du_part[bh * a.K + r] = du;
  }
}

// ------------------------------------------------------ backward in time

template <bool kCur>
__global__ void __launch_bounds__(kThreads, 2) bwd_reverse(Args a) {
  extern __shared__ __align__(16) unsigned char rev_smem[];
  Stage& sm = stage_of(rev_smem);
  const int role = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, i = tid / kParts, p = tid % kParts;  // i: row (role 0) or column
  constexpr bool bonus = !kCur;
  const long long bh = (long long)b * a.H + h;
  if (tid < kMaxK) sm.u[tid] = (a.u != nullptr && tid < a.K) ? a.u[h * a.K + tid] : 1.0;

  double g[kPer];                         // role 0: G[i][ent(p, j)]; role 1: G[ent(p, j)][i]
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = role == 0 ? i : ent(p, j), c = role == 0 ? ent(p, j) : i;
    g[j] = (a.ds != nullptr && r < a.K && c < a.V) ? a.ds[(bh * a.K + r) * a.V + c] : 0.0;
  }
  // role 0's reverse cumulative sum of dla: thread tid < K a row, or
  // thread 0 a head; carry holds the query term one step on (bonus form)
  double acc = 0.0, xfin = 0.0;
  if (role == 0) {
    if (a.la_per_head) {
      if (tid == 0)
        for (int d = 0; d < a.K; ++d) xfin += a.xfin[bh * a.K + d];
    } else if (tid < a.K) {
      xfin = a.xfin[bh * a.K + tid];
    }
  }
  double carry = xfin;
  float* out = static_cast<float*>(role == 0 ? a.dk : a.dv);
  const int width = role == 0 ? a.K : a.V;

  for (int t0 = (a.S - 1) / kL * kL; t0 >= 0; t0 -= kL) {
    const int n = min(kL, a.S - t0);
    __syncthreads();  // the previous chunk's readers of the stage are done
    stage(sm, a, b, h, t0, n, tid, role == 0);
    __syncthreads();
    if (bonus) {
      step_scalars(sm, n, tid, role);
      __syncthreads();
    }
    if (role == 0) {
      const double ui = sm.u[i];
      for (int t = n - 1; t >= 0; --t) {
        const double w = sm.w[t][i], qr = sm.q[t][i];
        const double2* v2 = reinterpret_cast<const double2*>(&sm.v[t][0]) + p;
        const double2* d2 = reinterpret_cast<const double2*>(&sm.dy[t][0]) + p;
        double pa[2] = {0.0, 0.0};
#pragma unroll
        for (int j2 = 0; j2 < kPer / 2; ++j2) {
          const double2 vv = v2[kParts * j2], dd = d2[kParts * j2];
          const double vx[2] = {vv.x, vv.y}, dx[2] = {dd.x, dd.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 2 * j2 + e;
            if (kCur) {
              g[j] = fma(qr, dx[e], g[j]);
              pa[e] = fma(g[j], vx[e], pa[e]);
              g[j] *= w;
            } else {
              pa[e] = fma(g[j], vx[e], pa[e]);
              g[j] = fma(w, g[j], qr * dx[e]);
            }
          }
        }
        const double dkd = sum_parts(pa[0] + pa[1]);
        if (p == 0) {
          sm.o1[t][i] = (float)(bonus ? fma(qr * ui, sm.sc[t], dkd) : dkd);
          sm.o2[t][i] = sm.k[t][i] * dkd;
        }
      }
    } else {
      for (int t = n - 1; t >= 0; --t) {
        const double dyc = sm.dy[t][i];
        const double2* q2 = reinterpret_cast<const double2*>(&sm.q[t][0]) + p;
        const double2* k2 = reinterpret_cast<const double2*>(&sm.k[t][0]) + p;
        const double2* w2 = reinterpret_cast<const double2*>(&sm.w[t][0]) + p;
        double pa[2] = {0.0, 0.0};
#pragma unroll
        for (int j2 = 0; j2 < kPer / 2; ++j2) {
          const double2 qq = q2[kParts * j2], kk = k2[kParts * j2], ww = w2[kParts * j2];
          const double qx[2] = {qq.x, qq.y}, kx[2] = {kk.x, kk.y}, wx[2] = {ww.x, ww.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 2 * j2 + e;
            if (kCur) {
              g[j] = fma(qx[e], dyc, g[j]);
              pa[e] = fma(g[j], kx[e], pa[e]);
              g[j] *= wx[e];
            } else {
              pa[e] = fma(g[j], kx[e], pa[e]);
              g[j] = fma(wx[e], g[j], qx[e] * dyc);
            }
          }
        }
        const double dvd = sum_parts(pa[0] + pa[1]);
        if (p == 0) sm.o1[t][i] = (float)(bonus ? fma(sm.sc[t], dyc, dvd) : dvd);
      }
    }
    __syncthreads();
    if (role == 0) {
      if (!a.la_per_head) {
        if (tid < a.K) {
          for (int t = n - 1; t >= 0; --t) {
            double qterm;
            if (kCur) {
              qterm = sm.x[t][tid] + (t0 + t == a.S - 1 ? xfin : 0.0);
            } else {
              qterm = carry;
              carry = sm.x[t][tid];
            }
            acc += qterm - sm.o2[t][tid];
            sm.x[t][tid] = sm.keep[t][tid] != 0.f ? acc : 0.0;
          }
        }
      } else {
        if (tid < n) {
          double x = 0.0;
          for (int d = 0; d < a.K; ++d) x += sm.o2[tid][d];
          sm.ksum[tid] = x;
        }
        __syncthreads();
        if (tid == 0) {
          for (int t = n - 1; t >= 0; --t) {
            double qterm;
            if (kCur) {
              qterm = sm.x[t][0] + (t0 + t == a.S - 1 ? xfin : 0.0);
            } else {
              qterm = carry;
              carry = sm.x[t][0];
            }
            acc += qterm - sm.ksum[t];
            sm.x[t][0] = acc;
          }
        }
      }
      __syncthreads();
    }
    for (int e = tid; e < n * kMaxK; e += kThreads) {
      const int t = e / kMaxK, d = e % kMaxK;
      if (d < width) out[row_off(a, b, t0 + t, h) * width + d] = sm.o1[t][d];
      if (role == 0) {
        if (a.la_per_head) {
          if (d == 0) a.dla[row_off(a, b, t0 + t, h)] = (float)sm.x[t][0];
        } else if (d < a.K) {
          a.dla[row_off(a, b, t0 + t, h) * a.K + d] = (float)sm.x[t][d];
        }
      }
    }
  }

  if (role == 0 && a.ds0 != nullptr && i < a.K) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = ent(p, j);
      if (c < a.V) a.ds0[(bh * a.K + i) * a.V + c] = (float)g[j];
    }
  }
}

// du from the (b, h) partials, summed over b in order
__global__ void __launch_bounds__(kThreads) sum_du(const double* part, float* du, int B, int HK) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= HK) return;
  double x = 0.0;
  for (int b = 0; b < B; ++b) x += part[(long long)b * HK + e];
  du[e] = (float)x;
}

template <bool kCur>
int launch(const Args& a, cudaStream_t s) {
  const int bytes = (int)sizeof(Stage);
  cudaError_t err = cudaFuncSetAttribute(bwd_forward<kCur>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_reverse<kCur>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  bwd_forward<kCur><<<dim3((unsigned)a.H, (unsigned)a.B), kThreads, bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_reverse<kCur><<<dim3(2u, (unsigned)a.H, (unsigned)a.B), kThreads, bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (a.du != nullptr) {
    const int hk = a.H * a.K;
    sum_du<<<(unsigned)((hk + kThreads - 1) / kThreads), kThreads, 0, s>>>(a.du_part, a.du, a.B,
                                                                           hk);
  }
  return (int)cudaGetLastError();
}


// ============================================================ bf16 route
//
// Chunks of kC steps, each its own block; the edge states come from one
// launch of two sweeps (edge_bf16), every product with a chunk, K or V
// side runs as bf16 mma.sync m16n8k16 with fp32 accumulation, and fp32
// operands are split into bf16 hi + lo (hi hi + hi lo + lo hi).

constexpr int kC = 32;                   // time steps a chunk
constexpr int kTc = 256;                 // threads a block: 8 warps
constexpr int kP = kMaxK + 8;            // bf16 row pitch of 64 columns (16-byte pad)
constexpr int kPL = kMaxK + 4;           // fp32 row pitch of 64 columns
constexpr int kPA = kC + 8;              // bf16 row pitch of the chunk's scores
constexpr int kPS = 16 + 8;              // bf16 row pitch of a 16 x 16 block
constexpr int kPD = kC + 1;              // fp32 row pitch of D
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLogAMinF = -8.f;

__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float f1(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float2 f2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ void st32(bf16* p, uint32_t v) { *reinterpret_cast<uint32_t*>(p) = v; }
__device__ __forceinline__ float ex2(float x) { return mma::exp2_approx(x); }

// x0, x1 as bf16 hi + lo pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = mma::pack_bf16(x0, x1);
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = mma::pack_bf16(x0 - h.x, x1 - h.y);
}
__device__ __forceinline__ void split_to(bf16* hi, bf16* lo, float x0, float x1) {
  uint32_t h, l;
  split(x0, x1, h, l);
  st32(hi, h);
  st32(lo, l);
}

// A fragment (16 x 16) of a row-major bf16 tile at (r0, c0)
template <int P>
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16 (*x)[P], int r0, int c0,
                                     int lane) {
  mma::ldmatrix_x4(a, &x[r0 + (lane & 15)][c0 + (lane >> 4) * 8]);
}
// A fragment of the transpose: A[m][k] = X[k0 + k][m0 + m]
template <int P>
__device__ __forceinline__ void ld_at(uint32_t (&a)[4], const bf16 (*x)[P], int k0, int m0,
                                      int lane) {
  mma::ldmatrix_x4_trans(a, &x[k0 + (lane & 7) + ((lane >> 4) << 3)][m0 + ((lane >> 3) & 1) * 8]);
}
// B fragment (16 x 8, k x n) of a row-major X[k][n] at (k0, n0)
template <int P>
__device__ __forceinline__ void ld_b(uint32_t (&b)[2], const bf16 (*x)[P], int k0, int n0,
                                     int lane) {
  mma::ldmatrix_x2_trans(b, &x[k0 + (lane & 15)][n0]);
}
// B fragments of two k-steps, k0.. and k0 + 16.., of Y^T where Y[n][k] is
// row-major: b[0], b[1] the first, b[2], b[3] the second
template <int P>
__device__ __forceinline__ void ld_bt2(uint32_t (&b)[4], const bf16 (*y)[P], int n0, int k0,
                                       int lane) {
  mma::ldmatrix_x4(b, &y[n0 + (lane & 7)][k0 + (lane >> 3) * 8]);
}
__device__ __forceinline__ void mma4(float (&d)[4], const uint32_t (&a)[4], const uint32_t* b) {
  mma::mma_bf16(d, a, b[0], b[1]);
}

// Rows [t0, t0 + kC) of a (B, S, heads, n) bf16 input, n <= 64, into x,
// 16 bytes a copy, zeros past S and past n.
__device__ __forceinline__ void load_rows(bf16 (*x)[kP], const bf16* g, long long rs, int t0,
                                          int S, int n, int tid) {
  const int r = tid >> 3, c = (tid & 7) * 8;   // kC rows x 8 pieces: one a thread
  const long long t = t0 + r;
  const bool in = t < S && c < n;
  mma::cp_async16(&x[r][c], in ? g + t * rs + c : g, in ? 16 : 0);
}
// The chunk's la: per dim (rows of K floats) into la, or per head (one
// float a step) into lh; zeros past S (decay 1) and past K.
__device__ __forceinline__ void load_la(float (*la)[kPL], float* lh, const Args& a,
                                        const float* lg, int t0, int tid) {
  if (a.la_per_head) {
    if (tid < kC) {
      const long long t = t0 + tid;
      const bool in = t < a.S;
      mma::cp_async4(&lh[tid], in ? lg + t * a.sl[1] : lg, in ? 4 : 0);
    }
    return;
  }
  for (int i = tid; i < kC * 16; i += kTc) {
    const int r = i >> 4, c = (i & 15) * 4;
    const long long t = t0 + r;
    const bool in = t < a.S && c < a.K;
    mma::cp_async16(&la[r][c], in ? lg + t * a.sl[1] + c : lg, in ? 16 : 0);
  }
}

// The chunk's inclusive cumulative log-decay times log2(e), in place of
// la (per head: the head's la, the same in every column d); thread
// (column d, quarter p) scans steps 8p..8p+7, then the quarters of a
// column pass their sums on in order.  Returns the bits of the column's
// steps where the per-dim clamp left la as it was (in every lane of the
// column's four).
__device__ __forceinline__ unsigned cum_in_place(float (*la)[kPL], const float* lh,
                                                 bool per_head, int tid) {
  const int d = tid >> 2, p = tid & 3;
  float r[8], run = 0.f, off = 0.f;
  unsigned keep = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float raw = per_head ? lh[8 * p + i] : la[8 * p + i][d];
    if (raw >= kLogAMinF && raw <= 0.f) keep |= 1u << (8 * p + i);
    run += per_head ? raw : fminf(fmaxf(raw, kLogAMinF), 0.f);
    r[i] = run;
  }
#pragma unroll
  for (int q = 1; q < 4; ++q) {                       // quarter q starts at q - 1's last
    const float prev = __shfl_up_sync(0xffffffffu, off + r[7], 1, 4);
    if (p == q) off = prev;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) la[8 * p + i][d] = (off + r[i]) * kLog2e;
  keep |= __shfl_xor_sync(0xffffffffu, keep, 1);
  keep |= __shfl_xor_sync(0xffffffffu, keep, 2);
  return keep;
}

// x_t = cum_t (Mamba2) or cum_{t-1}, 0 at the chunk's first step (RWKV6)
template <bool kCur>
__device__ __forceinline__ float qexp(const float (*cm)[kPL], int t, int d) {
  return kCur ? cm[t][d] : (t > 0 ? cm[t - 1][d] : 0.f);
}
template <bool kCur>
__device__ __forceinline__ float2 qexp2(const float (*cm)[kPL], int t, int d) {
  return kCur ? f2(&cm[t][d]) : (t > 0 ? f2(&cm[t - 1][d]) : make_float2(0.f, 0.f));
}

// ------------------------------------------------ edge states: two sweeps

struct EdgeStage {                        // one chunk: a = k (or q), b = v (or dy)
  bf16 a[kC][kP], b[kC][kP];
  float la[kC][kPL];
  float lh[kC];
};
struct EdgeSmem {
  EdgeStage st[2];                        // ring: the next chunk lands while this one computes
  bf16 oh[kC][kP], ol[kC][kP];            // the decayed operand, hi + lo
};

// Block (role, head, batch row).  Role 0 walks the chunks forward from the
// initial state, S_out = exp(cum_C) S_in + (k exp(cum_C - cum))^T v, and
// writes each chunk's S_in; role 1 walks them backward from dS, G_in =
// exp(cum_C) G_out + (q exp(x))^T dy, writes each chunk's G_out and at the
// end the initial state's gradient.  The state is held as the forward
// kernel holds it: mma accumulators, warp w its columns 8w..8w + 7.
template <bool kCur>
__global__ void __launch_bounds__(kTc, 3) edge_bf16(Args a) {
  extern __shared__ __align__(16) unsigned char edge_smem[];
  EdgeSmem& sm = *reinterpret_cast<EdgeSmem*>(edge_smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const bool fwd = blockIdx.x == 0;
  const int h = blockIdx.y, b = blockIdx.z, nc = a.nc, vw = 8 * warp;
  const long long bh = (long long)b * a.H + h, kv = (long long)a.K * a.V;
  const bf16* ag = static_cast<const bf16*>(fwd ? a.k : a.q) +
                   b * (fwd ? a.sk[0] : a.sq[0]) + h * (fwd ? a.sk[2] : a.sq[2]);
  const bf16* bg = static_cast<const bf16*>(fwd ? a.v : a.dy) +
                   b * (fwd ? a.sv[0] : a.sd[0]) + h * (fwd ? a.sv[2] : a.sd[2]);
  const long long as1 = fwd ? a.sk[1] : a.sq[1], bs1 = fwd ? a.sv[1] : a.sd[1];
  const float* lg = a.la + b * a.sl[0] + h * a.sl[2];
  float* out = a.edge + (fwd ? 0 : (long long)a.B * a.H * nc * kv) + bh * nc * kv;
  const float* init = fwd ? a.s0 : a.ds;

  auto load = [&](EdgeStage& s, int ci) {
    load_rows(s.a, ag, as1, ci * kC, a.S, a.K, tid);
    load_rows(s.b, bg, bs1, ci * kC, a.S, a.V, tid);
    load_la(s.la, s.lh, a, lg, ci * kC, tid);
  };
  load(sm.st[0], fwd ? 0 : nc - 1);
  mma::cp_async_commit();

  float st[4][4];                         // rows d = 16 m + g (+ 8), columns vw + 2c (+ 1)
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * m + g + (e >> 1) * 8, v = vw + 2 * c + (e & 1);
      st[m][e] = (init != nullptr && d < a.K && v < a.V) ? init[bh * kv + (long long)d * a.V + v]
                                                         : 0.f;
    }

  for (int i = 0; i < nc; ++i) {
    const int ci = fwd ? i : nc - 1 - i;
    EdgeStage& cs = sm.st[i & 1];
    mma::cp_async_wait<0>();  // chunk ci has landed ...
    __syncthreads();          // ... for every thread, and the previous chunk is no longer read
    if (i + 1 < nc) {
      load(sm.st[(i + 1) & 1], fwd ? ci + 1 : ci - 1);
      mma::cp_async_commit();
    }
    float* o = out + ci * kv;             // S entering (or G leaving) chunk ci
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int d = 16 * m + g + 8 * r, v = vw + 2 * c;
        if (d < a.K && v < a.V)
          *reinterpret_cast<float2*>(o + (long long)d * a.V + v) =
              make_float2(st[m][2 * r], st[m][2 * r + 1]);
      }
    if (fwd && i == nc - 1) break;        // the final state is not wanted

    cum_in_place(cs.la, cs.lh, a.la_per_head != 0, tid);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kC * kMaxK / 2 / kTc; ++j) {
      const int e = tid + j * kTc, t = e >> 5, d = (e & 31) * 2;
      const float2 cm = f2(&cs.la[t][d]), av = bf2(&cs.a[t][d]);
      float2 x;
      if (fwd) {
        const float2 tot = f2(&cs.la[kC - 1][d]);
        x = make_float2(tot.x - cm.x, tot.y - cm.y);
      } else {
        x = qexp2<kCur>(cs.la, t, d);
      }
      split_to(&sm.oh[t][d], &sm.ol[t][d], av.x * ex2(x.x), av.y * ex2(x.y));
    }
    __syncthreads();

    const bf16* bcol = &cs.b[lane & 15][vw];   // + 16 ks rows: B of k-step ks
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int d0 = 16 * m;
      const float e0 = ex2(cs.la[kC - 1][d0 + g]), e8 = ex2(cs.la[kC - 1][d0 + g + 8]);
      st[m][0] *= e0;
      st[m][1] *= e0;
      st[m][2] *= e8;
      st[m][3] *= e8;
#pragma unroll
      for (int ks = 0; ks < kC / 16; ++ks) {
        uint32_t ah[4], al[4], bf[2];
        ld_at(ah, sm.oh, 16 * ks, d0, lane);
        ld_at(al, sm.ol, 16 * ks, d0, lane);
        mma::ldmatrix_x2_trans(bf, bcol + 16 * ks * kP);
        mma::mma_bf16(st[m], ah, bf[0], bf[1]);
        mma::mma_bf16(st[m], al, bf[0], bf[1]);
      }
    }
  }

  if (!fwd && a.ds0 != nullptr) {
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 16 * m + g + (e >> 1) * 8, v = vw + 2 * c + (e & 1);
        if (d < a.K && v < a.V) a.ds0[bh * kv + (long long)d * a.V + v] = st[m][e];
      }
  }
}

// ------------------------------------------------------- a chunk a block

struct ChunkSmem {
  bf16 q[kC][kP], k[kC][kP], v[kC][kP], dy[kC][kP];
  float cm[kC][kPL];                      // la, then cum * log2(e)
  union {
    struct { bf16 sh[kMaxK][kP], sl[kMaxK][kP], gh[kMaxK][kP], gl[kMaxK][kP]; } in;  // S_in, G_out
    struct { float dqi[kC][kPL], dki[kC][kPL], l1[kC][kPL], l2[kC][kPL]; } out;
  } u1;
  union {
    struct { bf16 h[kC][kP], l[kC][kP]; } kt;      // k exp(cum_C - cum), hi + lo
    struct { bf16 dv[kC][kP], dq[kC][kP]; } st;    // outputs on their way out
  } u2;
  union {
    struct { bf16 qh[16][kP], ql[16][kP], kh[16][kP], kl[16][kP]; } p1;  // level 1 operands
    struct { bf16 dk[kC][kP]; float tot[4][4][kMaxK]; } st;  // and a quarter's totals
  } u3;
  bf16 q2h[16][kP], q2l[16][kP], k2h[16][kP], k2l[16][kP];   // level 2 operands
  bf16 d1h[16][kPS], d1l[16][kPS], d2h[16][kPS], d2l[16][kPS];
  bf16 ah[kC][kPA], al[kC][kPA];          // the scores A[t, s], hi + lo
  float dd[kC][kPD];                      // D[t, s] = dy_t . v_s
  float lh[kC];
  float u[kMaxK], ssg[kMaxK];
  unsigned keep[kMaxK];
};

// Level 2's 16 rows: row i < 8 is step 8 + i, row i >= 8 step 16 + i
// (the upper halves of the two 16-step blocks), pivot 7 or 23; its 16
// columns: j < 8 is step j, j >= 8 step 8 + j (the lower halves).
__device__ __forceinline__ int l2_t(int i) { return i < 8 ? 8 + i : 16 + i; }
__device__ __forceinline__ int l2_s(int j) { return j < 8 ? j : 8 + j; }
__device__ __forceinline__ int l2_pivot(int i) { return i < 8 ? 7 : 23; }

// Block (chunk, head, batch row): every product of one chunk, given its
// S_in and G_out (edge_bf16).  Phases, each closed by a block barrier:
//  0. q, k, v, dy, la by cp.async; S_in and G_out (fp32) split into bf16
//     hi + lo, and <S_in[d], G_out[d]> a row;
//  1. cum;
//  2. operands: k exp(cum_C - cum); the factored q, k of levels 1 and 2;
//     the scores' four 8 x 8 diagonal blocks elementwise;
//  3. D = dy v^T, the scores of levels 1 and 2;
//  4. warp w, columns 8w..8w + 7 of K and of V: dq's and dk's S_in and
//     G_out parts (exp(x) (S_in dy), exp(cum_C - cum) (G_out v)), their
//     level 1 and 2 parts, dv = (k exp(cum_C - cum)) G_out + A^T dy;
//  5. thread (column d, quarter p = an 8-step block): the quarter's own
//     pairs elementwise, dla's parts summed, dq, dk, du's partial.
template <bool kCur>
__global__ void __launch_bounds__(kTc, 2) chunk_bf16(Args a) {
  extern __shared__ __align__(16) unsigned char chunk_smem[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(chunk_smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int ci = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t0 = ci * kC;
  const long long bh = (long long)b * a.H + h, kv = (long long)a.K * a.V;
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const bf16* dg = static_cast<const bf16*>(a.dy) + b * a.sd[0] + h * a.sd[2];
  const float* lg = a.la + b * a.sl[0] + h * a.sl[2];
  const bool per_head = a.la_per_head != 0;

  // 0. loads
  load_rows(sm.q, qg, a.sq[1], t0, a.S, a.K, tid);
  load_rows(sm.k, kg, a.sk[1], t0, a.S, a.K, tid);
  load_rows(sm.v, vg, a.sv[1], t0, a.S, a.V, tid);
  load_rows(sm.dy, dg, a.sd[1], t0, a.S, a.V, tid);
  load_la(sm.cm, sm.lh, a, lg, t0, tid);
  mma::cp_async_commit();
  for (int i = tid; i < kC * kPA / 2; i += kTc) {       // zero scores above the diagonal
    reinterpret_cast<uint32_t*>(&sm.ah[0][0])[i] = 0u;
    reinterpret_cast<uint32_t*>(&sm.al[0][0])[i] = 0u;
  }
  for (int i = tid; i < 16 * kPS / 2; i += kTc) {       // zero D2's two off blocks
    reinterpret_cast<uint32_t*>(&sm.d2h[0][0])[i] = 0u;
    reinterpret_cast<uint32_t*>(&sm.d2l[0][0])[i] = 0u;
  }
  if (tid < kMaxK) sm.u[tid] = (a.u != nullptr && tid < a.K) ? a.u[h * a.K + tid] : 1.f;
  {
    const float* sg = a.edge + (bh * a.nc + ci) * kv;
    const float* gg = sg + (long long)a.B * a.H * a.nc * kv;
    float4 s4[4], g4[4];                   // 64 rows x 16 pieces of four floats, all in flight
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = tid + e * kTc, d = j >> 4, v4 = (j & 15) * 4;
      s4[e] = g4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (d < a.K && v4 < a.V) {
        s4[e] = __ldg(reinterpret_cast<const float4*>(sg + (long long)d * a.V + v4));
        g4[e] = __ldg(reinterpret_cast<const float4*>(gg + (long long)d * a.V + v4));
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = tid + e * kTc, d = j >> 4, v4 = (j & 15) * 4;
      const float4 sv = s4[e], gv = g4[e];
      float x = fmaf(sv.x, gv.x, fmaf(sv.y, gv.y, fmaf(sv.z, gv.z, sv.w * gv.w)));
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if ((tid & 15) == 0) sm.ssg[d] = x;
      split_to(&sm.u1.in.sh[d][v4], &sm.u1.in.sl[d][v4], sv.x, sv.y);
      split_to(&sm.u1.in.sh[d][v4 + 2], &sm.u1.in.sl[d][v4 + 2], sv.z, sv.w);
      split_to(&sm.u1.in.gh[d][v4], &sm.u1.in.gl[d][v4], gv.x, gv.y);
      split_to(&sm.u1.in.gh[d][v4 + 2], &sm.u1.in.gl[d][v4 + 2], gv.z, gv.w);
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  // 1. cum
  {
    const unsigned keep = cum_in_place(sm.cm, sm.lh, per_head, tid);
    if ((tid & 3) == 0) sm.keep[tid >> 2] = keep;
  }
  __syncthreads();

  // 2a. k exp(cum_C - cum), hi + lo (dv's G_out part)
#pragma unroll
  for (int j = 0; j < kC * kMaxK / 2 / kTc; ++j) {
    const int e = tid + j * kTc, t = e >> 5, d = (e & 31) * 2;
    const float2 cm = f2(&sm.cm[t][d]), tot = f2(&sm.cm[kC - 1][d]), kk = bf2(&sm.k[t][d]);
    split_to(&sm.u2.kt.h[t][d], &sm.u2.kt.l[t][d], kk.x * ex2(tot.x - cm.x),
             kk.y * ex2(tot.y - cm.y));
  }
  // 2b. level 1 (steps 16..31 against 0..15, pivot 15): q_t exp(x_t - cum_15)
  // and k_s exp(cum_15 - cum_s); level 2 (the upper half of each 16-step
  // block against its lower half, pivot 7 or 23) likewise
#pragma unroll
  for (int j = 0; j < 16 * kMaxK / 2 / kTc; ++j) {
    const int e = tid + j * kTc, i = e >> 5, d = (e & 31) * 2;
    {
      const float2 pv = f2(&sm.cm[15][d]), x = qexp2<kCur>(sm.cm, 16 + i, d);
      const float2 cs = f2(&sm.cm[i][d]), qq = bf2(&sm.q[16 + i][d]), kk = bf2(&sm.k[i][d]);
      split_to(&sm.u3.p1.qh[i][d], &sm.u3.p1.ql[i][d], qq.x * ex2(x.x - pv.x),
               qq.y * ex2(x.y - pv.y));
      split_to(&sm.u3.p1.kh[i][d], &sm.u3.p1.kl[i][d], kk.x * ex2(pv.x - cs.x),
               kk.y * ex2(pv.y - cs.y));
    }
    {
      const int t = l2_t(i), s = l2_s(i);
      const float2 pv = f2(&sm.cm[l2_pivot(i)][d]), x = qexp2<kCur>(sm.cm, t, d);
      const float2 cs = f2(&sm.cm[s][d]), qq = bf2(&sm.q[t][d]), kk = bf2(&sm.k[s][d]);
      split_to(&sm.q2h[i][d], &sm.q2l[i][d], qq.x * ex2(x.x - pv.x), qq.y * ex2(x.y - pv.y));
      split_to(&sm.k2h[i][d], &sm.k2l[i][d], kk.x * ex2(pv.x - cs.x), kk.y * ex2(pv.y - cs.y));
    }
  }
  // 2c. the scores' four 8 x 8 diagonal blocks, elementwise: lane (row t,
  // eighth j8 of d) sums its eighth for each column s of the block, then
  // the eight lanes of a row reduce-scatter their sums with shuffles, lane
  // j8 ending with column blk + j8; the bonus form puts sum_d q u k on the
  // diagonal.  Warp w takes rows 4w..4w + 3.
  {
    const int t = 4 * warp + (lane >> 3), j8 = lane & 7;
    const int blk = t & ~7, s_first = kCur ? t : t - 1;   // newest decayed term
    const int jmax = (4 * warp & 7) + 3;                // this warp's last row in the block
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, bonus = 0.f;
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const int d = 8 * j8 + 2 * dd;
      const float2 qv = bf2(&sm.q[t][d]), x = qexp2<kCur>(sm.cm, t, d);
      if (!kCur) {
        const float2 kk = bf2(&sm.k[t][d]), uv = f2(&sm.u[d]);
        bonus = fmaf(qv.x * uv.x, kk.x, fmaf(qv.y * uv.y, kk.y, bonus));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j > jmax) continue;                         // warp-uniform
        const int s = blk + j;
        if (s <= s_first) {
          const float2 kk = bf2(&sm.k[s][d]), cs = f2(&sm.cm[s][d]);
          acc[j] = fmaf(qv.x * kk.x, ex2(x.x - cs.x), fmaf(qv.y * kk.y, ex2(x.y - cs.y), acc[j]));
        }
      }
    }
    const bool h4 = lane & 4, h2 = lane & 2, h1 = lane & 1;
    float r4[4], r2[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r4[i] = (h4 ? acc[i + 4] : acc[i]) + __shfl_xor_sync(0xffffffffu, h4 ? acc[i] : acc[i + 4], 4);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      r2[i] = (h2 ? r4[i + 2] : r4[i]) + __shfl_xor_sync(0xffffffffu, h2 ? r4[i] : r4[i + 2], 2);
    float sum = (h1 ? r2[1] : r2[0]) + __shfl_xor_sync(0xffffffffu, h1 ? r2[0] : r2[1], 1);
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) bonus += __shfl_xor_sync(0xffffffffu, bonus, o);
    const int s = blk + j8;                             // this lane's column
    if (!kCur && s == t) sum += bonus;
    const bf16 hi = __float2bfloat16_rn(sum);
    sm.ah[t][s] = hi;
    sm.al[t][s] = __float2bfloat16_rn(sum - __bfloat162float(hi));
  }
  __syncthreads();

  // 3. D = dy v^T (six 16 x 8 tiles on or below the diagonal: warps 0, 1,
  // 4..7), and the scores of levels 1 and 2 (warps 2, 3, a column tile each)
  if (warp != 2 && warp != 3) {
    const int mt = warp >> 2, ns = warp & 3;
    uint32_t bv[2][4];
    ld_bt2(bv[0], sm.v, 8 * ns, 0, lane);
    ld_bt2(bv[1], sm.v, 8 * ns, 32, lane);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < kMaxK / 16; ++ks) {
      uint32_t af[4];
      ld_a(af, sm.dy, 16 * mt, 16 * ks, lane);
      mma4(acc, af, &bv[ks >> 1][(ks & 1) * 2]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = 16 * mt + g + 8 * r, s = 8 * ns + 2 * c;
      const float x0 = acc[2 * r], x1 = acc[2 * r + 1];
      sm.dd[t][s] = x0;
      sm.dd[t][s + 1] = x1;
      if (t >= 16 && s < 16) split_to(&sm.d1h[t - 16][s], &sm.d1l[t - 16][s], x0, x1);
      if ((t >> 3) == 1 && (s >> 3) == 0)               // steps 8..15 against 0..7
        split_to(&sm.d2h[t - 8][s], &sm.d2l[t - 8][s], x0, x1);
      if ((t >> 3) == 3 && (s >> 3) == 2)               // steps 24..31 against 16..23
        split_to(&sm.d2h[t - 16][s - 8], &sm.d2l[t - 16][s - 8], x0, x1);
    }
  } else {
    const int nt = warp - 2;
    uint32_t b1h[2][4], b1l[2][4], b2h[2][4], b2l[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ld_bt2(b1h[j], sm.u3.p1.kh, 8 * nt, 32 * j, lane);
      ld_bt2(b1l[j], sm.u3.p1.kl, 8 * nt, 32 * j, lane);
      ld_bt2(b2h[j], sm.k2h, 8 * nt, 32 * j, lane);
      ld_bt2(b2l[j], sm.k2l, 8 * nt, 32 * j, lane);
    }
    float a1[3][4] = {}, a2[3][4] = {};   // hi hi, hi lo, lo hi
#pragma unroll
    for (int ks = 0; ks < kMaxK / 16; ++ks) {
      const int j = ks >> 1, o = (ks & 1) * 2;
      uint32_t qh[4], ql[4];
      ld_a(qh, sm.u3.p1.qh, 0, 16 * ks, lane);
      ld_a(ql, sm.u3.p1.ql, 0, 16 * ks, lane);
      mma4(a1[0], qh, &b1h[j][o]);
      mma4(a1[1], qh, &b1l[j][o]);
      mma4(a1[2], ql, &b1h[j][o]);
      ld_a(qh, sm.q2h, 0, 16 * ks, lane);
      ld_a(ql, sm.q2l, 0, 16 * ks, lane);
      mma4(a2[0], qh, &b2h[j][o]);
      mma4(a2[1], qh, &b2l[j][o]);
      mma4(a2[2], ql, &b2h[j][o]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = g + 8 * r, s = 8 * nt + 2 * c;
      split_to(&sm.ah[16 + i][s], &sm.al[16 + i][s],
               a1[0][2 * r] + a1[1][2 * r] + a1[2][2 * r],
               a1[0][2 * r + 1] + a1[1][2 * r + 1] + a1[2][2 * r + 1]);
      if (r == nt)                                       // level 2's two diagonal 8 x 8 blocks
        split_to(&sm.ah[l2_t(i)][l2_s(s)], &sm.al[l2_t(i)][l2_s(s)],
                 a2[0][2 * r] + a2[1][2 * r] + a2[2][2 * r],
                 a2[0][2 * r + 1] + a2[1][2 * r + 1] + a2[2][2 * r + 1]);
    }
  }
  __syncthreads();

  // 4. warp w: columns n0..n0 + 7 of dq, dk (d) and of dv (v)
  const int n0 = 8 * warp;
  float dqi[2][4], dki[2][4], l1q[4], l1k[4], l2q[4], l2k[4], dvv[2][4];
  {
    uint32_t bsh[2][4], bsl[2][4], bgh[2][4], bgl[2][4];   // S_in, G_out as (k = v, n = d)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ld_bt2(bsh[j], sm.u1.in.sh, n0, 32 * j, lane);
      ld_bt2(bsl[j], sm.u1.in.sl, n0, 32 * j, lane);
      ld_bt2(bgh[j], sm.u1.in.gh, n0, 32 * j, lane);
      ld_bt2(bgl[j], sm.u1.in.gl, n0, 32 * j, lane);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float q0[4] = {}, q1[4] = {}, k0[4] = {}, k1[4] = {};
#pragma unroll
      for (int ks = 0; ks < kMaxK / 16; ++ks) {
        const int j = ks >> 1, o = (ks & 1) * 2;
        uint32_t ady[4], av[4];
        ld_a(ady, sm.dy, 16 * mt, 16 * ks, lane);
        ld_a(av, sm.v, 16 * mt, 16 * ks, lane);
        mma4(q0, ady, &bsh[j][o]);
        mma4(q1, ady, &bsl[j][o]);
        mma4(k0, av, &bgh[j][o]);
        mma4(k1, av, &bgl[j][o]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 16 * mt + g + (e >> 1) * 8, d = n0 + 2 * c + (e & 1);
        dqi[mt][e] = (q0[e] + q1[e]) * ex2(qexp<kCur>(sm.cm, t, d));
        dki[mt][e] = (k0[e] + k1[e]) * ex2(sm.cm[kC - 1][d] - sm.cm[t][d]);
      }
    }
  }
  {
    // level 1: dq's rows 16..31 = D1 (k exp(cum_15 - cum)), scaled by
    // exp(x - cum_15); dk's rows 0..15 = D1^T (q exp(x - cum_15)), scaled
    // by exp(cum_15 - cum); level 2 the same on D2 with its pivots
    uint32_t a1h[4], a1l[4], t1h[4], t1l[4], a2h[4], a2l[4], t2h[4], t2l[4];
    ld_a(a1h, sm.d1h, 0, 0, lane);
    ld_a(a1l, sm.d1l, 0, 0, lane);
    ld_at(t1h, sm.d1h, 0, 0, lane);
    ld_at(t1l, sm.d1l, 0, 0, lane);
    ld_a(a2h, sm.d2h, 0, 0, lane);
    ld_a(a2l, sm.d2l, 0, 0, lane);
    ld_at(t2h, sm.d2h, 0, 0, lane);
    ld_at(t2l, sm.d2l, 0, 0, lane);
    uint32_t k1h[2], k1l[2], q1h[2], q1l[2], k2h[2], k2l[2], q2h[2], q2l[2];
    ld_b(k1h, sm.u3.p1.kh, 0, n0, lane);
    ld_b(k1l, sm.u3.p1.kl, 0, n0, lane);
    ld_b(q1h, sm.u3.p1.qh, 0, n0, lane);
    ld_b(q1l, sm.u3.p1.ql, 0, n0, lane);
    ld_b(k2h, sm.k2h, 0, n0, lane);
    ld_b(k2l, sm.k2l, 0, n0, lane);
    ld_b(q2h, sm.q2h, 0, n0, lane);
    ld_b(q2l, sm.q2l, 0, n0, lane);
    float x1[4] = {}, y1[4] = {}, x2[4] = {}, y2[4] = {};
    mma4(x1, a1h, k1h);
    mma4(x1, a1h, k1l);
    mma4(x1, a1l, k1h);
    mma4(y1, t1h, q1h);
    mma4(y1, t1h, q1l);
    mma4(y1, t1l, q1h);
    mma4(x2, a2h, k2h);
    mma4(x2, a2h, k2l);
    mma4(x2, a2l, k2h);
    mma4(y2, t2h, q2h);
    mma4(y2, t2h, q2l);
    mma4(y2, t2l, q2h);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + (e >> 1) * 8, d = n0 + 2 * c + (e & 1);
      const float p15 = sm.cm[15][d], p2 = sm.cm[l2_pivot(r)][d];
      l1q[e] = x1[e] * ex2(qexp<kCur>(sm.cm, 16 + r, d) - p15);
      l1k[e] = y1[e] * ex2(p15 - sm.cm[r][d]);
      l2q[e] = x2[e] * ex2(qexp<kCur>(sm.cm, l2_t(r), d) - p2);
      l2k[e] = y2[e] * ex2(p2 - sm.cm[l2_s(r)][d]);
    }
  }
#pragma unroll
  for (int ms = 0; ms < 2; ++ms) {        // dv: rows s = 16 ms.., columns v = n0..
    float v0[4] = {}, v1[4] = {}, v2[4] = {}, w0[4] = {}, w1[4] = {};
#pragma unroll
    for (int kd = 0; kd < kMaxK / 16; ++kd) {
      uint32_t kh[4], kl[4], gh[2], gl[2];
      ld_a(kh, sm.u2.kt.h, 16 * ms, 16 * kd, lane);
      ld_a(kl, sm.u2.kt.l, 16 * ms, 16 * kd, lane);
      ld_b(gh, sm.u1.in.gh, 16 * kd, n0, lane);
      ld_b(gl, sm.u1.in.gl, 16 * kd, n0, lane);
      mma4(v0, kh, gh);
      mma4(v1, kh, gl);
      mma4(v2, kl, gh);
    }
#pragma unroll
    for (int kt = ms; kt < kC / 16; ++kt) {
      uint32_t th[4], tl[4], yb[2];
      ld_at(th, sm.ah, 16 * kt, 16 * ms, lane);
      ld_at(tl, sm.al, 16 * kt, 16 * ms, lane);
      ld_b(yb, sm.dy, 16 * kt, n0, lane);
      mma4(w0, th, yb);
      mma4(w1, tl, yb);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) dvv[ms][e] = (v0[e] + v1[e] + v2[e]) + (w0[e] + w1[e]);
  }
  __syncthreads();                        // S_in, G_out and k exp(..) are read no more
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int d = n0 + 2 * c, i = g + 8 * r;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int t = 16 * mt + i;
      *reinterpret_cast<float2*>(&sm.u1.out.dqi[t][d]) =
          make_float2(dqi[mt][2 * r], dqi[mt][2 * r + 1]);
      *reinterpret_cast<float2*>(&sm.u1.out.dki[t][d]) =
          make_float2(dki[mt][2 * r], dki[mt][2 * r + 1]);
      st32(&sm.u2.st.dv[t][d], mma::pack_bf16(dvv[mt][2 * r], dvv[mt][2 * r + 1]));
    }
    *reinterpret_cast<float2*>(&sm.u1.out.l1[16 + i][d]) = make_float2(l1q[2 * r], l1q[2 * r + 1]);
    *reinterpret_cast<float2*>(&sm.u1.out.l1[i][d]) = make_float2(l1k[2 * r], l1k[2 * r + 1]);
    *reinterpret_cast<float2*>(&sm.u1.out.l2[l2_t(i)][d]) = make_float2(l2q[2 * r], l2q[2 * r + 1]);
    *reinterpret_cast<float2*>(&sm.u1.out.l2[l2_s(i)][d]) = make_float2(l2k[2 * r], l2k[2 * r + 1]);
  }
  __syncthreads();

  // 5. thread (column d, quarter p): steps tb..tb + 7; a warp holds 32
  // columns of one quarter
  {
    const int d = tid & (kMaxK - 1), p = tid >> 6, tb = 8 * p;
    float X[8], CM[8], Q[8], Kq[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      CM[i] = sm.cm[tb + i][d];
      X[i] = qexp<kCur>(sm.cm, tb + i, d);
      Q[i] = f1(&sm.q[tb + i][d]);
      Kq[i] = f1(&sm.k[tb + i][d]);
    }
    // the quarter's own pairs (t', s), s <= t' (s < t' with the bonus):
    // their dq, dk, and dla's straddling part: a pair adds to every step t
    // with s < t <= t' (s < t < t'), Y the row's sum over s so far
    float dq3[8], dk3[8], d3[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) dq3[i] = dk3[i] = d3[i] = 0.f;
#pragma unroll
    for (int tp = 0; tp < 8; ++tp) {
      float y = 0.f;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        if (kCur ? s > tp : s >= tp) continue;
        const float e = ex2(X[tp] - CM[s]), dts = sm.dd[tb + tp][tb + s];
        const float ke = Kq[s] * e;
        dq3[tp] = fmaf(dts, ke, dq3[tp]);
        dk3[s] = fmaf(dts, Q[tp] * e, dk3[s]);
        y = fmaf(dts * Q[tp], ke, y);
        if (s + 1 <= (kCur ? tp : tp - 1)) d3[s + 1] += y;
      }
    }
    // dla_t = exp(cum_C) <S_in, G_out> + the query sides, each a reverse
    // cumulative sum over its block from t on (past t with the bonus): S_in
    // (the chunk), level 1 (steps 16..31), level 2 (the quarter) + the key
    // sides, each a forward sum over its block before t: G_out (the
    // chunk), level 1 (steps 0..15), level 2 (the quarter) + the quarter's own
    const bool q1 = p >= 2, q2 = p & 1;    // level 1 / 2: query side here, else key side
    float av[8], bv[8], l1v[8], l2v[8], ta = 0.f, tk = 0.f, t1 = 0.f, du = 0.f;
    const float uu = sm.u[d];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = tb + i;
      const float dqi_ = sm.u1.out.dqi[t][d], dki_ = sm.u1.out.dki[t][d];
      const float l1 = sm.u1.out.l1[t][d], l2 = sm.u1.out.l2[t][d], vdy = sm.dd[t][t];
      av[i] = Q[i] * dqi_;
      bv[i] = Kq[i] * dki_;
      l1v[i] = (q1 ? Q[i] : Kq[i]) * l1;
      l2v[i] = (q2 ? Q[i] : Kq[i]) * l2;
      ta += av[i];
      tk += bv[i];
      t1 += l1v[i];
      float dq = dqi_ + (q1 ? l1 : 0.f) + (q2 ? l2 : 0.f) + dq3[i];
      float dk = dki_ + (q1 ? 0.f : l1) + (q2 ? 0.f : l2) + dk3[i];
      if (!kCur) {
        dq = fmaf(uu * Kq[i], vdy, dq);
        dk = fmaf(uu * Q[i], vdy, dk);
        du = fmaf(Q[i] * Kq[i], vdy, du);
      }
      sm.u2.st.dq[t][d] = __float2bfloat16_rn(dq);
      sm.u3.st.dk[t][d] = __float2bfloat16_rn(dk);
    }
    float (*tot)[4][kMaxK] = sm.u3.st.tot;  // the quarters' totals, passed on in order
    tot[0][p][d] = ta;
    tot[1][p][d] = tk;
    tot[2][p][d] = t1;
    tot[3][p][d] = du;
    __syncthreads();
    float ra = 0.f, rb = 0.f;
    for (int o = p + 1; o < 4; ++o) ra += tot[0][o][d];
    for (int o = 0; o < p; ++o) rb += tot[1][o][d];
    float r1 = p == 2 ? tot[2][3][d] : 0.f, r2 = 0.f;
    float res[8];
#pragma unroll
    for (int i = 7; i >= 0; --i) {
      float x;
      if (kCur) {
        ra += av[i];
        x = ra;
        if (q1) x += (r1 += l1v[i]);
        if (q2) x += (r2 += l2v[i]);
      } else {
        x = ra;
        ra += av[i];
        if (q1) { x += r1; r1 += l1v[i]; }
        if (q2) { x += r2; r2 += l2v[i]; }
      }
      res[i] = x;
    }
    float c1 = p == 1 ? tot[2][0][d] : 0.f, c2 = 0.f;
    const float edge = ex2(sm.cm[kC - 1][d]) * sm.ssg[d];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float x = rb;
      rb += bv[i];
      if (!q1) { x += c1; c1 += l1v[i]; }
      if (!q2) { x += c2; c2 += l2v[i]; }
      res[i] = edge + (res[i] + x) + d3[i];
    }
    if (per_head) {                        // summed over K below
#pragma unroll
      for (int i = 0; i < 8; ++i) sm.u1.out.dqi[tb + i][d] = res[i];
    } else if (d < a.K) {
      const unsigned keep = sm.keep[d];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = tb + i;
        if (t0 + t < a.S)
          a.dla[((long long)b * a.S + t0 + t) * a.H * a.K + (long long)h * a.K + d] =
              (keep >> t) & 1u ? res[i] : 0.f;
      }
    }
    if (!kCur && a.du_c != nullptr && p == 0 && d < a.K)
      a.du_c[(bh * a.nc + ci) * a.K + d] = ((tot[3][0][d] + tot[3][1][d]) + tot[3][2][d]) +
                                           tot[3][3][d];
  }
  __syncthreads();

  // 6. a head's dla summed over K in order; dq, dk, dv out, 16 bytes a store
  if (per_head) {
    const int t = tid >> 3, part = tid & 7;
    float x = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) x += sm.u1.out.dqi[t][8 * part + j];
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (part == 0 && t0 + t < a.S) a.dla[((long long)b * a.S + t0 + t) * a.H + h] = x;
  }
  {
    const int r = tid >> 3, cc = (tid & 7) * 8;
    const long long row = ((long long)b * a.S + t0 + r) * a.H + h;
    if (t0 + r < a.S) {
      if (cc < a.K) {
        *reinterpret_cast<uint4*>(static_cast<bf16*>(a.dq) + row * a.K + cc) =
            *reinterpret_cast<const uint4*>(&sm.u2.st.dq[r][cc]);
        *reinterpret_cast<uint4*>(static_cast<bf16*>(a.dk) + row * a.K + cc) =
            *reinterpret_cast<const uint4*>(&sm.u3.st.dk[r][cc]);
      }
      if (cc < a.V)
        *reinterpret_cast<uint4*>(static_cast<bf16*>(a.dv) + row * a.V + cc) =
            *reinterpret_cast<const uint4*>(&sm.u2.st.dv[r][cc]);
    }
  }
}

// ------------------------------------ a chunk a block, per-head decay (Mamba2)

// One log-decay a step (la_per_head, include_current): the decay of a pair
// is one number, L[t, s] = exp(cum_t - cum_s) for s <= t (SSD's decay
// matrix, arXiv:2405.21060), so no product needs a factored operand:
//   A = (q k^T) . L, DL = (dy v^T) . L,  dq = exp(cum) (S_in dy) + DL k,
//   dk = exp(cum_C - cum) (G_out v) + DL^T q,
//   dv = exp(cum_C - cum) (k G_out) + A^T dy,
// and dla's own part is a sum over pairs of W = A . D, summed straight
// into each step a pair straddles.  Phases, each closed by a block barrier:
//  0. q, k, v, dy, la by cp.async; S_in, G_out split, <S_in, G_out>;
//  1. cum (one lane a step, in order), the rows' sum of <S_in, G_out>;
//  2. D and q k^T (six 16 x 8 tiles on or below the diagonal), L, A, DL, W;
//  3. warp w, columns 8w..8w + 7: dq, dk, dv, and its columns' share of
//     the query and key sides of dla (q dq's S_in part, k dk's G_out part);
//  4. each row t' of W summed into P[t', t] = sum_{s < t} W[t', s];
//  5. one warp: dla_t = exp(cum_C) <S_in, G_out> + the reverse sum of the
//     query sides from t + the forward sum of the key sides before t +
//     sum_{t' >= t} P[t', t]; dq, dk, dv out.
struct HeadSmem {
  bf16 q[kC][kP], k[kC][kP], v[kC][kP], dy[kC][kP];
  union {
    struct { bf16 sh[kMaxK][kP], sl[kMaxK][kP], gh[kMaxK][kP], gl[kMaxK][kP]; } in;  // S_in, G_out
    struct { bf16 dq[kC][kP], dk[kC][kP], dv[kC][kP]; } st;   // outputs on their way out
  } u1;
  bf16 dlh[kC][kPA], dll[kC][kPA], ah[kC][kPA], al[kC][kPA];  // DL and A, hi + lo
  float w[kC][kPD];                       // W = A . D, then the row sums P in place
  float qi[kTc / 32][kC], ki[kTc / 32][kC];   // a warp's columns' share of dla's sides
  float lh[kC], cm[kC];                   // la, then cum * log2(e); one a step
  float ssg[kMaxK];
  float edge;                             // exp(cum_C) <S_in, G_out>
};

__global__ void __launch_bounds__(kTc, 3) chunk_head_bf16(Args a) {
  extern __shared__ __align__(16) unsigned char head_smem[];
  HeadSmem& sm = *reinterpret_cast<HeadSmem*>(head_smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int ci = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t0 = ci * kC;
  const long long bh = (long long)b * a.H + h, kv = (long long)a.K * a.V;
  const unsigned full = 0xffffffffu;

  // 0. loads
  load_rows(sm.q, static_cast<const bf16*>(a.q) + b * a.sq[0] + h * a.sq[2], a.sq[1], t0, a.S,
            a.K, tid);
  load_rows(sm.k, static_cast<const bf16*>(a.k) + b * a.sk[0] + h * a.sk[2], a.sk[1], t0, a.S,
            a.K, tid);
  load_rows(sm.v, static_cast<const bf16*>(a.v) + b * a.sv[0] + h * a.sv[2], a.sv[1], t0, a.S,
            a.V, tid);
  load_rows(sm.dy, static_cast<const bf16*>(a.dy) + b * a.sd[0] + h * a.sd[2], a.sd[1], t0, a.S,
            a.V, tid);
  load_la(nullptr, sm.lh, a, a.la + b * a.sl[0] + h * a.sl[2], t0, tid);
  mma::cp_async_commit();
  for (int i = tid; i < kC * kPD; i += kTc) (&sm.w[0][0])[i] = 0.f;
  {
    const float* sg = a.edge + (bh * a.nc + ci) * kv;
    const float* gg = sg + (long long)a.B * a.H * a.nc * kv;
    float4 s4[4], g4[4];                   // 64 rows x 16 pieces of four floats, all in flight
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = tid + e * kTc, d = j >> 4, v4 = (j & 15) * 4;
      s4[e] = g4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (d < a.K && v4 < a.V) {
        s4[e] = __ldg(reinterpret_cast<const float4*>(sg + (long long)d * a.V + v4));
        g4[e] = __ldg(reinterpret_cast<const float4*>(gg + (long long)d * a.V + v4));
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = tid + e * kTc, d = j >> 4, v4 = (j & 15) * 4;
      const float4 sv = s4[e], gv = g4[e];
      float x = fmaf(sv.x, gv.x, fmaf(sv.y, gv.y, fmaf(sv.z, gv.z, sv.w * gv.w)));
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(full, x, o);
      if ((tid & 15) == 0) sm.ssg[d] = x;
      split_to(&sm.u1.in.sh[d][v4], &sm.u1.in.sl[d][v4], sv.x, sv.y);
      split_to(&sm.u1.in.sh[d][v4 + 2], &sm.u1.in.sl[d][v4 + 2], sv.z, sv.w);
      split_to(&sm.u1.in.gh[d][v4], &sm.u1.in.gl[d][v4], gv.x, gv.y);
      split_to(&sm.u1.in.gh[d][v4 + 2], &sm.u1.in.gl[d][v4 + 2], gv.z, gv.w);
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  // 1. cum: lane t of warp 0 sums steps 0..t in order, so cum never rises
  if (warp == 0) {
    float run = 0.f;
    for (int t = 0; t <= lane; ++t) run += sm.lh[t];
    sm.cm[lane] = run * kLog2e;
  } else if (warp == 1) {
    float x = sm.ssg[lane] + sm.ssg[lane + 32];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(full, x, o);
    if (lane == 0) sm.edge = x;            // scaled by exp(cum_C) in phase 5
  }
  __syncthreads();

  // 2. D = dy v^T and q k^T, tile (rows 16 mt, columns 8 ns) a warp
  if (warp != 2 && warp != 3) {
    const int mt = warp >> 2, ns = warp & 3;
    uint32_t bv[2][4], bk[2][4];
    ld_bt2(bv[0], sm.v, 8 * ns, 0, lane);
    ld_bt2(bv[1], sm.v, 8 * ns, 32, lane);
    ld_bt2(bk[0], sm.k, 8 * ns, 0, lane);
    ld_bt2(bk[1], sm.k, 8 * ns, 32, lane);
    float dd[4] = {0.f, 0.f, 0.f, 0.f}, qk[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < kMaxK / 16; ++ks) {
      uint32_t ad[4], aq[4];
      ld_a(ad, sm.dy, 16 * mt, 16 * ks, lane);
      ld_a(aq, sm.q, 16 * mt, 16 * ks, lane);
      mma4(dd, ad, &bv[ks >> 1][(ks & 1) * 2]);
      mma4(qk, aq, &bk[ks >> 1][(ks & 1) * 2]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = 16 * mt + g + 8 * r, s = 8 * ns + 2 * c;
      const float ct = sm.cm[t];
      const float l0 = s <= t ? ex2(ct - sm.cm[s]) : 0.f;
      const float l1 = s + 1 <= t ? ex2(ct - sm.cm[s + 1]) : 0.f;
      const float a0 = qk[2 * r] * l0, a1 = qk[2 * r + 1] * l1;
      split_to(&sm.ah[t][s], &sm.al[t][s], a0, a1);
      split_to(&sm.dlh[t][s], &sm.dll[t][s], dd[2 * r] * l0, dd[2 * r + 1] * l1);
      sm.w[t][s] = a0 * dd[2 * r];
      sm.w[t][s + 1] = a1 * dd[2 * r + 1];
    }
  }
  __syncthreads();

  // 3. warp w: columns n0..n0 + 7 of dq, dk (d) and of dv (v)
  const int n0 = 8 * warp;
  const float tot = sm.cm[kC - 1];
  float dq[2][4], dk[2][4], dv[2][4];
  {
    uint32_t bsh[2][4], bsl[2][4], bgh[2][4], bgl[2][4];   // S_in, G_out as (k = v, n = d)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ld_bt2(bsh[j], sm.u1.in.sh, n0, 32 * j, lane);
      ld_bt2(bsl[j], sm.u1.in.sl, n0, 32 * j, lane);
      ld_bt2(bgh[j], sm.u1.in.gh, n0, 32 * j, lane);
      ld_bt2(bgl[j], sm.u1.in.gl, n0, 32 * j, lane);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float q0[4] = {}, k0[4] = {}, qa[4] = {}, ka[4] = {};
#pragma unroll
      for (int ks = 0; ks < kMaxK / 16; ++ks) {
        const int j = ks >> 1, o = (ks & 1) * 2;
        uint32_t ady[4], av[4];
        ld_a(ady, sm.dy, 16 * mt, 16 * ks, lane);
        ld_a(av, sm.v, 16 * mt, 16 * ks, lane);
        mma4(q0, ady, &bsh[j][o]);
        mma4(q0, ady, &bsl[j][o]);
        mma4(k0, av, &bgh[j][o]);
        mma4(k0, av, &bgl[j][o]);
      }
#pragma unroll
      for (int ks = 0; ks <= mt; ++ks) {   // DL k: s <= t
        uint32_t dh[4], dl[4], kb[2];
        ld_a(dh, sm.dlh, 16 * mt, 16 * ks, lane);
        ld_a(dl, sm.dll, 16 * mt, 16 * ks, lane);
        ld_b(kb, sm.k, 16 * ks, n0, lane);
        mma4(qa, dh, kb);
        mma4(qa, dl, kb);
      }
#pragma unroll
      for (int kt = mt; kt < kC / 16; ++kt) {   // DL^T q: t >= s
        uint32_t th[4], tl[4], qb[2];
        ld_at(th, sm.dlh, 16 * kt, 16 * mt, lane);
        ld_at(tl, sm.dll, 16 * kt, 16 * mt, lane);
        ld_b(qb, sm.q, 16 * kt, n0, lane);
        mma4(ka, th, qb);
        mma4(ka, tl, qb);
      }
      float qs[2] = {0.f, 0.f}, kss[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 16 * mt + g + (e >> 1) * 8, d = n0 + 2 * c + (e & 1);
        const float qin = q0[e] * ex2(sm.cm[t]), kin = k0[e] * ex2(tot - sm.cm[t]);
        qs[e >> 1] = fmaf(f1(&sm.q[t][d]), qin, qs[e >> 1]);
        kss[e >> 1] = fmaf(f1(&sm.k[t][d]), kin, kss[e >> 1]);
        dq[mt][e] = qin + qa[e];
        dk[mt][e] = kin + ka[e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {        // the warp's eight columns, in a fixed order
        qs[r] += __shfl_xor_sync(full, qs[r], 1);
        qs[r] += __shfl_xor_sync(full, qs[r], 2);
        kss[r] += __shfl_xor_sync(full, kss[r], 1);
        kss[r] += __shfl_xor_sync(full, kss[r], 2);
        if (c == 0) {
          sm.qi[warp][16 * mt + g + 8 * r] = qs[r];
          sm.ki[warp][16 * mt + g + 8 * r] = kss[r];
        }
      }
    }
  }
#pragma unroll
  for (int ms = 0; ms < 2; ++ms) {        // dv: rows s = 16 ms.., columns v = n0..
    float v0[4] = {}, w0[4] = {};
#pragma unroll
    for (int kd = 0; kd < kMaxK / 16; ++kd) {
      uint32_t ak[4], gh[2], gl[2];
      ld_a(ak, sm.k, 16 * ms, 16 * kd, lane);
      ld_b(gh, sm.u1.in.gh, 16 * kd, n0, lane);
      ld_b(gl, sm.u1.in.gl, 16 * kd, n0, lane);
      mma4(v0, ak, gh);
      mma4(v0, ak, gl);
    }
#pragma unroll
    for (int kt = ms; kt < kC / 16; ++kt) {
      uint32_t th[4], tl[4], yb[2];
      ld_at(th, sm.ah, 16 * kt, 16 * ms, lane);
      ld_at(tl, sm.al, 16 * kt, 16 * ms, lane);
      ld_b(yb, sm.dy, 16 * kt, n0, lane);
      mma4(w0, th, yb);
      mma4(w0, tl, yb);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = 16 * ms + g + (e >> 1) * 8;
      dv[ms][e] = v0[e] * ex2(tot - sm.cm[s]) + w0[e];
    }
  }
  __syncthreads();                        // S_in and G_out are read no more
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = 16 * mt + g + 8 * r, d = n0 + 2 * c;
      st32(&sm.u1.st.dq[t][d], mma::pack_bf16(dq[mt][2 * r], dq[mt][2 * r + 1]));
      st32(&sm.u1.st.dk[t][d], mma::pack_bf16(dk[mt][2 * r], dk[mt][2 * r + 1]));
      st32(&sm.u1.st.dv[t][d], mma::pack_bf16(dv[mt][2 * r], dv[mt][2 * r + 1]));
    }
  // 4. P[t', t] = sum_{s < t} W[t', s] for t <= t' (else 0), in place: the
  // eight lanes of row t' take four columns each and pass their sums on
  {
    const int tp = tid >> 3, j = tid & 7;
    float wv[4], part = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wv[i] = sm.w[tp][4 * j + i];
      part += wv[i];
    }
    float before = 0.f;                    // the lanes j' < j of the row, in order
#pragma unroll
    for (int o = 1; o < 8; ++o) {
      const float x = __shfl_up_sync(full, part, o, 8);
      if (j >= o) before += x;
    }
    __syncwarp();
    float run = before;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      run += wv[i];
      const int t = 4 * j + i + 1;        // the sum over s < t
      if (t < kC) sm.w[tp][t] = t <= tp ? run : 0.f;
    }
    if (j == 0) sm.w[tp][0] = 0.f;
  }
  __syncthreads();

  // 5. dla, one lane a step
  if (warp == 0) {
    const int t = lane;
    float own = 0.f, qs = 0.f, kss = 0.f;
#pragma unroll
    for (int tp = 0; tp < kC; ++tp) own += sm.w[tp][t];   // P[t', t] is 0 for t' < t
#pragma unroll
    for (int w = 0; w < kTc / 32; ++w) {
      qs += sm.qi[w][t];
      kss += sm.ki[w][t];
    }
    float rq = qs, fk = kss;               // sums over t' >= t and over s <= t
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float x = __shfl_down_sync(full, rq, o), y = __shfl_up_sync(full, fk, o);
      if (t + o < 32) rq += x;
      if (t >= o) fk += y;
    }
    const float before = __shfl_up_sync(full, fk, 1);   // over s < t
    const float dla = ex2(sm.cm[kC - 1]) * sm.edge + rq + (t > 0 ? before : 0.f) + own;
    if (t0 + t < a.S) a.dla[((long long)b * a.S + t0 + t) * a.H + h] = dla;
  }
  {
    const int r = tid >> 3, cc = (tid & 7) * 8;
    const long long row = ((long long)b * a.S + t0 + r) * a.H + h;
    if (t0 + r < a.S) {
      if (cc < a.K) {
        *reinterpret_cast<uint4*>(static_cast<bf16*>(a.dq) + row * a.K + cc) =
            *reinterpret_cast<const uint4*>(&sm.u1.st.dq[r][cc]);
        *reinterpret_cast<uint4*>(static_cast<bf16*>(a.dk) + row * a.K + cc) =
            *reinterpret_cast<const uint4*>(&sm.u1.st.dk[r][cc]);
      }
      if (cc < a.V)
        *reinterpret_cast<uint4*>(static_cast<bf16*>(a.dv) + row * a.V + cc) =
            *reinterpret_cast<const uint4*>(&sm.u1.st.dv[r][cc]);
    }
  }
}

// du from the (b, h, chunk) partials, a block a head: thread (d, part j)
// sums the partials i = j, j + 4, .. of the B nc (b, chunk) pairs in
// order, then the four parts are added in order
__global__ void __launch_bounds__(kTc) sum_du_bf16(const float* part, float* du, int B, int H,
                                                   int nc, int K) {
  __shared__ double parts[4][kMaxK];
  const int h = blockIdx.x, d = threadIdx.x & (kMaxK - 1), j = threadIdx.x >> 6;
  const int n = B * nc;
  double x = 0.0;
  if (d < K) {
    for (int i0 = j; i0 < n; i0 += 16) {
      float y[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {       // four loads in flight, added in order
        const int i = i0 + 4 * r, b = i / nc, c = i % nc;
        y[r] = i < n ? part[(((long long)b * H + h) * nc + c) * K + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) x += y[r];
    }
  }
  parts[j][d] = x;
  __syncthreads();
  if (j == 0 && d < K) du[h * K + d] = (float)(((parts[0][d] + parts[1][d]) + parts[2][d]) + parts[3][d]);
}

template <bool kCur>
int launch_bf16(const Args& a, cudaStream_t s) {
  const int eb = (int)sizeof(EdgeSmem);
  // the per-head decay of the Mamba2 form takes its own chunk kernel
  const bool head = kCur && a.la_per_head;
  const int cb = head ? (int)sizeof(HeadSmem) : (int)sizeof(ChunkSmem);
  cudaError_t err =
      cudaFuncSetAttribute(edge_bf16<kCur>, cudaFuncAttributeMaxDynamicSharedMemorySize, eb);
  if (err != cudaSuccess) return (int)err;
  err = head ? cudaFuncSetAttribute(chunk_head_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, cb)
             : cudaFuncSetAttribute(chunk_bf16<kCur>, cudaFuncAttributeMaxDynamicSharedMemorySize, cb);
  if (err != cudaSuccess) return (int)err;
  edge_bf16<kCur><<<dim3(2u, (unsigned)a.H, (unsigned)a.B), kTc, eb, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)a.nc, (unsigned)a.H, (unsigned)a.B);
  if (head)
    chunk_head_bf16<<<grid, kTc, cb, s>>>(a);
  else
    chunk_bf16<kCur><<<grid, kTc, cb, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (a.du != nullptr) {
    sum_du_bf16<<<(unsigned)a.H, kTc, 0, s>>>(a.du_c, a.du, a.B, a.H, a.nc, a.K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dy and dq, dk, dv alike; la,
// u, s0, ds and dla, du, ds0 are float32).  strides: 15 element strides,
// (b, s, head) of q, k, v, la, dy in that order; the last dim is
// unit-stride in all five.  la_per_head: 0 for la (B, S, H, K), clamped
// to [-8, 0]; else la is (B, S, H), one unclamped log-decay a head.  dq,
// dk (B, S, H, K), dv (B, S, H, V) and dla ((B, S, H, K) or (B, S, H))
// contiguous.  u, s0, ds may be null; du and its partials both null (no
// du) or both given, and only with include_current == 0; ds0 null when no
// initial state's gradient is wanted.  K and V at most 64; B and H at most
// 65535.  Scratch, by dtype:
//   float32   xq (float64, dla's shape), xfin (float64, B H K) and, with
//             du, du_part (float64, B H K); launches two kernels on
//             `stream` (three with du);
//   bfloat16  xq the edge states (float32, 2 B H ceil(S / 32) K V), xfin
//             unused and, with du, du_part its chunks' partials (float32,
//             B H ceil(S / 32) K); K and V multiples of 8, every row of q,
//             k, v, dy (and of a per-dim la) 16-byte aligned; launches two
//             kernels on `stream` (three with du).
// Returns the first CUDA error (0 on success); refuses what it does not
// take before any launch.
extern "C" int linear_scan_bwd(const void* q, const void* k, const void* v, const void* dy,
                               const float* la, const float* u, const float* s0, const float* ds,
                               void* dq, void* dk, void* dv, float* dla, void* xq, void* xfin,
                               void* du_part, float* du, float* ds0, int dtype, int B, int S,
                               int H, int K, int V, int include_current, int la_per_head,
                               const long long* strides, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || V <= 0 || K > kMaxK || V > kMaxK ||
      B > 65535 || H > 65535 || (du == nullptr) != (du_part == nullptr) ||
      (du != nullptr && include_current) || xq == nullptr || (dtype == 0 && xfin == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    // 16-byte rows: every base 16-byte aligned, every (b, s, head) stride a
    // whole number of 16 bytes (8 bf16, 4 floats), K and V multiples of 8;
    // a per-head la is read a float at a time and has no such rows
    bool rows16 = K % 8 == 0 && V % 8 == 0;
    const void* bases[5] = {q, k, v, la, dy};
    for (int i = 0; i < 5; ++i)
      rows16 = rows16 && (reinterpret_cast<uintptr_t>(bases[i]) % 16 == 0 || (i == 3 && la_per_head));
    for (int i = 0; i < 15; ++i) {
      const bool la_stride = i >= 9 && i < 12;
      rows16 = rows16 && (strides[i] % (la_stride ? 4 : 8) == 0 || (la_stride && la_per_head));
    }
    if (!rows16) return (int)cudaErrorInvalidValue;
  } else if (dtype != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dy = dy;
  a.la = la;
  a.u = u;
  a.s0 = s0;
  a.ds = ds;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dla = dla;
  a.xq = dtype == 0 ? static_cast<double*>(xq) : nullptr;
  a.xfin = static_cast<double*>(xfin);
  a.du_part = dtype == 0 ? static_cast<double*>(du_part) : nullptr;
  a.edge = dtype == 1 ? static_cast<float*>(xq) : nullptr;
  a.du_c = dtype == 1 ? static_cast<float*>(du_part) : nullptr;
  a.du = du;
  a.ds0 = ds0;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.sl[i] = strides[9 + i];
    a.sd[i] = strides[12 + i];
  }
  a.B = B;
  a.S = S;
  a.H = H;
  a.K = K;
  a.V = V;
  a.la_per_head = la_per_head;
  a.nc = (S + kC - 1) / kC;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return include_current ? launch<true>(a, s) : launch<false>(a, s);
  return include_current ? launch_bf16<true>(a, s) : launch_bf16<false>(a, s);
}
