// Gated linear recurrence (the RWKV6 / Mamba2 core), backward, on the
// model layer's own layout.
//
// Replaces no TPU kernel: the Pallas linear_scan
// (src/repro/kernels/linear_scan/kernel.py) is forward-only, and the
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
//   dla  = the reverse cumulative sum over t of q_t dq_t - k_t dk_t,
//          each taken over the decayed terms only (the gated-linear-
//          attention identity: every decayed term is exp(c_t - c_s) of
//          the cumulative log-decay c, a query's step t and a key's s),
//          the query's at t + 1 with the bonus, plus dS . S_final at the
//          last step; zero where the clamp cut la; summed over K per head.
// No state is stored: the forward pass rebuilds it.  The plain version,
// the same arithmetic in the same order of passes, is
// kernels/linear_scan/ref.py recurrence_bwd.
//
// Bound on an H100: device-memory bytes.  Each input read once and each
// output written once: q, k, v, dy read and dq, dk, dv written in the
// input type, la read and dla written in fp32.  rwkv6_3b's train shape
// (B 4, S 1024, H 40, K = V = 64) in bf16: 22 bytes an element of
// (B, S, H, 64), 0.231 GB, 0.069 ms at 3.35 TB/s.  zamba2_7b's per-head
// Mamba2 layer (B 4, S 1024, H 112, K = V = 64): v, dy, dv a head, C and
// B (q, k) read once a (b, s) and their gradients written summed over the
// heads, la and dla a (b, s, head): 0.182 GB, 0.054 ms.  A chunked form
// on the tensor cores does a few operations a byte, under the ridge.  The
// sequential recurrence here does about 12 float64 operations an entry of
// the state a step on the CUDA cores (0.20 ms of their 34 TFLOP/s at
// rwkv6's shape) and reads its inputs three times (L2 serves the repeats
// only in part); the chunked tensor-core form is later work.  The Mamba2
// form's dq and dk come out per head (B, S, H, K); the wrapper returns
// them so and the broadcast's backward (torch's expand) sums them over
// the heads: 2 B S H K elements, 0.117 GB in bf16 at zamba2_7b's shape,
// written and read again beyond the bound's 0.182.
//
// Precision: states, products and sums in float64.  dla's query and key
// terms nearly cancel (they are equal where a step's decay is near 0), so
// in fp32 what is left of them is their rounding, the fp32 states' above
// all: Mamba2's A_log, a sum of every step's dla, came out 1e-4 of its
// scale from the float64 gradient (autograd through the fp32 scan: 1e-6;
// this form, and the plain version in float64: 1e-6).  dq, dk and dv are
// rounded once to the input type, dla, du and d_initial_state to fp32.
//
// Design: three launches, no atomics, so two launches on one input give
// the same bits.
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
  double* xq;         // dla's shape: the query terms, bwd_forward to bwd_reverse
  double* xfin;       // (B, H, K): dS . S_final a row
  double* du_part;    // (B, H, K) or null: no du
  float* du;          // (H, K) or null
  float* ds0;         // (B, H, K, V) or null: no initial state's gradient
  long long sq[3], sk[3], sv[3], sl[3], sd[3];  // element strides over (b, s, head)
  int B, S, H, K, V, la_per_head;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(bf16* p, float x) { *p = __float2bfloat16(x); }

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
template <typename T>
__device__ __forceinline__ void stage(Stage& sm, const Args& a, int b, int h, int t0, int n,
                                      int tid, bool with_x) {
  const T* qg = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const T* kg = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const T* vg = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const T* dg = static_cast<const T*>(a.dy) + b * a.sd[0] + h * a.sd[2];
  const float* lg = a.la + b * a.sl[0] + h * a.sl[2];
  float rq[kLoads], rk[kLoads], rl[kLoads], rv[kLoads], rd[kLoads];
  double rx[kLoads];
#pragma unroll
  for (int e = 0; e < kLoads; ++e) {
    const int i = tid + e * kThreads, t = i / kMaxK, d = i % kMaxK;
    const long long s = t0 + t;
    const bool in = t < n, ink = in && d < a.K, inv = in && d < a.V;
    rq[e] = ink ? ld(qg + s * a.sq[1] + d) : 0.f;
    rk[e] = ink ? ld(kg + s * a.sk[1] + d) : 0.f;
    rl[e] = !in ? 0.f : a.la_per_head ? lg[s * a.sl[1]] : ink ? lg[s * a.sl[1] + d] : 0.f;
    rv[e] = inv ? ld(vg + s * a.sv[1] + d) : 0.f;
    rd[e] = inv ? ld(dg + s * a.sd[1] + d) : 0.f;
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

// ------------------------------------------------------- forward in time

template <typename T, bool kCur>
__global__ void __launch_bounds__(kThreads, 2) bwd_forward(Args a) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  Stage& sm = stage_of(fwd_smem);
  const int tid = threadIdx.x, r = tid / kParts, p = tid % kParts;
  const int h = blockIdx.x, b = blockIdx.y;
  constexpr bool bonus = !kCur;
  const long long bh = (long long)b * a.H + h;
  if (tid < kMaxK) sm.u[tid] = (a.u != nullptr && tid < a.K) ? a.u[h * a.K + tid] : 1.0;
  T* dqg = static_cast<T*>(a.dq);

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
    stage<T>(sm, a, b, h, t0, n, tid, false);
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
        st(dqg + off, sm.o1[t][d]);
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

template <typename T, bool kCur>
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
  T* out = static_cast<T*>(role == 0 ? a.dk : a.dv);
  const int width = role == 0 ? a.K : a.V;

  for (int t0 = (a.S - 1) / kL * kL; t0 >= 0; t0 -= kL) {
    const int n = min(kL, a.S - t0);
    __syncthreads();  // the previous chunk's readers of the stage are done
    stage<T>(sm, a, b, h, t0, n, tid, role == 0);
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
      if (d < width) st(out + row_off(a, b, t0 + t, h) * width + d, sm.o1[t][d]);
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

template <typename T, bool kCur>
int launch(const Args& a, cudaStream_t s) {
  const int bytes = (int)sizeof(Stage);
  cudaError_t err = cudaFuncSetAttribute(bwd_forward<T, kCur>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_reverse<T, kCur>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  bwd_forward<T, kCur><<<dim3((unsigned)a.H, (unsigned)a.B), kThreads, bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_reverse<T, kCur><<<dim3(2u, (unsigned)a.H, (unsigned)a.B), kThreads, bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (a.du != nullptr) {
    const int hk = a.H * a.K;
    sum_du<<<(unsigned)((hk + kThreads - 1) / kThreads), kThreads, 0, s>>>(a.du_part, a.du, a.B,
                                                                           hk);
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
// contiguous.  u, s0, ds may be null; du_part (B, H, K) and du (H, K)
// both null (no du) or both given, and only with include_current == 0;
// ds0 null when no initial state's gradient is wanted.  Scratch, float64:
// xq of dla's shape, xfin of B H K, du_part.  K and V at most 64; B and H
// at most 65535.  Launches two kernels on `stream` (three with du);
// returns the first CUDA error (0 on success).
extern "C" int linear_scan_bwd(const void* q, const void* k, const void* v, const void* dy,
                               const float* la, const float* u, const float* s0, const float* ds,
                               void* dq, void* dk, void* dv, float* dla, double* xq,
                               double* xfin, double* du_part, float* du, float* ds0, int dtype,
                               int B, int S, int H, int K, int V, int include_current,
                               int la_per_head, const long long* strides, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || V <= 0 || K > kMaxK || V > kMaxK ||
      B > 65535 || H > 65535 || (du == nullptr) != (du_part == nullptr) ||
      (du != nullptr && include_current) || xq == nullptr || xfin == nullptr)
    return (int)cudaErrorInvalidValue;
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
  a.xq = xq;
  a.xfin = xfin;
  a.du_part = du_part;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return include_current ? launch<float, true>(a, s) : launch<float, false>(a, s);
  if (dtype == 1) return include_current ? launch<bf16, true>(a, s) : launch<bf16, false>(a, s);
  return (int)cudaErrorInvalidValue;
}
