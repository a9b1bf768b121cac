// Gated linear recurrence (the RWKV6 / Mamba2 core), forward, on the
// model layer's own layout.
//
// Replaces the Pallas TPU kernel linear_scan
// (src/repro/kernels/linear_scan/kernel.py) together with what its
// wrapper recurrence (ops.py) does around it.  For every (b, h):
//   S_t = diag(exp(la_t)) S_{t-1} + k_t v_t^T        S: (K, V) in fp32
//   y_t = q_t^T S_t                        (include_current != 0, Mamba2)
//   y_t = q_t^T (S_{t-1} + diag(u) k_t v_t^T)        (RWKV6 bonus form)
// with la clipped to [-8, 0].  q, k, la are (B, S, H, K) and v, y
// (B, S, H, V), each read through its own strides; u is (H, K), indexed
// by head (no broadcast to (B*H, K)); an optional initial state and the
// final state are (B, H, K, V) fp32.
//
// Per-head decay (Mamba2, la_per_head != 0): la is (B, S, H), one
// log-decay a (b, t, head) that every row d of the state shares, read
// through its (b, s, head) strides one float a step, and taken as it is,
// without the clamp: the model's per-head path (repro's recurrence.py)
// does not clamp, and Mamba2's -exp(A_log) softplus(dt) falls below -8
// wherever dt is large.  Every exponent either route takes is a
// difference of a non-increasing cumulative sum, so it stays <= 0 for any
// la <= 0 and an underflow to 0 is the exact answer.  q and k may be
// Mamba2's C and B broadcast over the heads (head stride 0): they are
// read in place, once a head.  The TPU kernel keeps its state in
// scratch and drops it; the decode cache needs it, so it is written out.
//
// Bound on an H100: device-memory bytes.  Each input element is read
// once and y written once, about 4 * B * S * H * K * 4 bytes; the chunked
// form's matrix products are a few tens of operations per byte, under
// the tensor cores' ridge.  Per head (Mamba2 at zamba2_7b's prefill, B 4,
// S 2048, H 112, K = V = 64): x and y a head, la a head and C, B once a
// (b, s), 0.248 GB, 0.074 ms; this kernel reads C and B once a head (each
// block its own), which L2 mostly serves.
//
// Two routes, chosen by the type of q, k, v:
//
// bf16 (the serving path): a chunked form on mma.sync whose exponents
// never go positive.  The TPU kernel's factorised decay, k * exp(-cum),
// overflows fp32 once a chunk's summed log-decay passes about -88
// (rwkv6's decay reaches the clamp of -8, so a chunk of 32 reaches -256).
// Here time is cut into chunks of C = 32 steps, each of two sub-chunks of
// 16.  With cum_t the chunk's inclusive cumulative log-decay and
// x_t = cum_t (Mamba2) or cum_{t-1} (RWKV6, the shift cum - la):
//   y_t   = (q_t exp(x_t)) S_in + sum_s A[t,s] v_s
//   A[t,s] = sum_d q_td k_sd exp(x_td - cum_sd)   (s <= t, or s < t plus
//            the bonus sum_d q_td u_d k_td at s = t)
//   S_out = diag(exp(cum_C)) S_in + sum_s (k_s exp(cum_C - cum_s))^T v_s
// The off-diagonal sub-chunk pair (t in 16..31, s in 0..15) factors its
// decay about r = 15, which lies between them: q_t exp(x_t - cum_15) and
// k_s exp(cum_15 - cum_s), both exponents <= 0, multiply to the exact
// exp(x_t - cum_s), and underflow to 0 is the right answer.  Inside each
// 16 x 16 diagonal sub-block the same holds one level down: its lower
// 8 x 8 quadrant factors about the sub-block's step 7.  Only the four
// 8 x 8 diagonal blocks are taken elementwise on the CUDA cores, with
// exp(x_t - cum_s) formed as a running product of the decays
// exp(la) <= 1 (an exponential per (t, s, d) would make this part the
// costliest).  Every other product runs on the tensor cores as bf16
// mma.sync with fp32 accumulation, and stays fp32-accurate by splitting
// each fp32 operand into bf16 hi + lo: v is exact in bf16, so the scores
// A v and the end-state update (k exp(cum_C - cum))^T v take two
// products (hi, lo); the readout (q exp(x)) S_in and the factored scores
// split both sides and take three (hi hi + hi lo + lo hi).  Single bf16
// scores are not enough even though y is bf16: A v sums terms far larger
// than y, and their rounding breaks y's 3e-2 where they cancel.  The
// state lives in registers as mma accumulators and goes to shared memory
// as hi/lo bf16 once a chunk for the next readout.  Exponents are taken
// base 2 on cum * log2(e).
// One block of 8 warps per (V slice, head, batch row), the slice fastest
// in the grid: the scores are shared by all V columns, so a block
// computes them once, by all warps.  A slice is all 64 columns, where
// warp w owns the state's and y's columns 8w..8w+7 in the products,
// unless twice B * H blocks still find an SM each: then it is 32
// columns, and the two warps of a column group split its rows.  y goes
// out through shared memory in 16-byte stores.  The next chunk's q, k, v, la
// arrive by 16-byte cp.async (zero-filled past S and past K, V) while
// this chunk computes, so every row of q, k, v, la and y must be 16-byte
// aligned and K, V multiples of 8: the wrapper (kernels/linear_scan/ops.py)
// copies and zero-pads inputs that are not, and the launch refuses them.
// The chunk's phases are serial (three or four block barriers a chunk),
// and at rwkv6_3b's batch of 4, 160 blocks on 132 SMs leave 28 SMs two.
//
// fp32 (held to 2e-4 in the state, which TF32 products would break): the
// first kernel's exact sequential recurrence on the CUDA cores.  Every
// exponent it takes is la <= 0.  One block of 128 threads per (32-column
// slice of V, head, batch row); four threads share one column of the
// state, each holding every fourth of its K rows in registers, and add
// their parts of y with two shuffles.  A loop over 32-step chunks stages
// q, k, exp(la) and v in shared memory with coalesced loads and writes
// each chunk's y back coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm80.cuh"

namespace {

constexpr int kMaxK = 64;                // largest K and V (both routes)
constexpr float kLogAMin = -8.f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* la;
  const float* u;    // (H, K) or null: no bonus (u = 1)
  const float* s0;   // (B, H, K, V) or null: zeros
  void* y;
  float* s_out;      // (B, H, K, V)
  long long sq[3], sk[3], sv[3], sl[3], sy[3];  // element strides over (b, s, head)
  int S, H, K, V, include_current, la_per_head;
};

// ------------------------------------------------------------ bf16 route

constexpr int kC = 32;                   // time steps per chunk
constexpr int kSub = 16;                 // per sub-chunk
constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kP = kMaxK + 8;            // bf16 row pitch (16-byte pad: ldmatrix conflict-free)
constexpr int kPL = kMaxK + 4;           // fp32 row pitch of la / cum
constexpr int kPA = kC + 8;              // bf16 row pitch of the scores
constexpr float kLog2e = 1.4426950408889634f;

// NV: the V columns of one block, 64 (a block per (b, h)) or 32 (two per
// (b, h)); bf16 rows of NV columns take a pitch of NV + 8
template <int NV>
struct Stage {                           // one chunk's inputs, zero past S, K and V
  __nv_bfloat16 q[kC][kP], k[kC][kP], v[kC][NV + 8];
  float la[kC][kPL];                     // clamped la, then cum * log2(e) in place
  float lh[kC];                          // per-head la (la_per_head), one a step
};

template <int NV>
struct Smem {
  Stage<NV> st[2];                       // ring: chunk c + 1 lands while c computes
  __nv_bfloat16 qh[kC][kP], ql[kC][kP];  // q exp(x), hi + lo: A of the readout
  __nv_bfloat16 kh[kC][kP], kl[kC][kP];  // k exp(cum_C - cum), hi + lo: A^T of the update
  __nv_bfloat16 ah[kC][kPA], al[kC][kPA];  // intra-chunk scores A[t, s], hi + lo
  __nv_bfloat16 sh[kMaxK][NV + 8], sl[kMaxK][NV + 8];  // S_in (d, v), hi + lo: B of the readout
  float w[kC][kPL];                      // exp(la), the per-step decays
  __nv_bfloat16 y[kC][NV + 8];           // a chunk's y, on its way out
  float u[kMaxK];
};

__device__ __forceinline__ float2 bf2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 f2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ void st32(__nv_bfloat16* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// x0, x1 as bf16 hi + lo pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = mma::pack_bf16(x0, x1);
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = mma::pack_bf16(x0 - h.x, x1 - h.y);
}

// Chunk [t0, t0 + kC) of q, k, la and of the block's columns v0.. of v
// (vg points at column v0) into a stage, 16 bytes a copy.
template <int NV>
__device__ __forceinline__ void load_chunk(Stage<NV>& s, const Args& a, const __nv_bfloat16* qg,
                                           const __nv_bfloat16* kg, const __nv_bfloat16* vg,
                                           const float* lg, int t0, int v0, int tid) {
  for (int i = tid; i < kC * 8; i += kTcThreads) {  // q, k: 8 chunks of 16 bytes a row
    const int r = i >> 3, c = (i & 7) * 8;
    const long long t = t0 + r;
    const bool in = t < a.S && c < a.K;
    mma::cp_async16(&s.q[r][c], in ? qg + t * a.sq[1] + c : qg, in ? 16 : 0);
    mma::cp_async16(&s.k[r][c], in ? kg + t * a.sk[1] + c : kg, in ? 16 : 0);
  }
  for (int i = tid; i < kC * (NV / 8); i += kTcThreads) {  // v: NV / 8 chunks a row
    const int r = i / (NV / 8), c = i % (NV / 8) * 8;
    const long long t = t0 + r;
    const bool in = t < a.S && v0 + c < a.V;
    mma::cp_async16(&s.v[r][c], in ? vg + t * a.sv[1] + c : vg, in ? 16 : 0);
  }
  if (a.la_per_head) {
    for (int i = tid; i < kC; i += kTcThreads) {        // la per head: one float a step
      const long long t = t0 + i;
      const bool in = t < a.S;
      mma::cp_async4(&s.lh[i], in ? lg + t * a.sl[1] : lg, in ? 4 : 0);
    }
    return;
  }
  for (int i = tid; i < kC * 16; i += kTcThreads) {  // la: 16 chunks of four floats a row
    const int r = i >> 4, c = (i & 15) * 4;
    const long long t = t0 + r;
    const bool in = t < a.S && c < a.K;
    mma::cp_async16(&s.la[r][c], in ? lg + t * a.sl[1] + c : lg, in ? 16 : 0);
  }
}

// The chunk [t0, t0 + kC) of the block's y columns (yg points at column
// v0) from shared memory, 16 bytes a store.
template <int NV>
__device__ __forceinline__ void store_y(const Smem<NV>& sm, const Args& a, __nv_bfloat16* yg,
                                        int t0, int v0, int tid) {
  const int r = tid / (NV / 8), c = tid % (NV / 8) * 8;  // kC rows x NV / 8 chunks
  const long long t = t0 + r;
  if (tid < kC * (NV / 8) && t < a.S && v0 + c < a.V)
    *reinterpret_cast<uint4*>(yg + t * a.sy[1] + c) = *reinterpret_cast<const uint4*>(&sm.y[r][c]);
}

template <int NV>
__global__ void __launch_bounds__(kTcThreads) scan_bf16(Args a) {
  constexpr int kGroups = NV / 8;                 // 8-column groups of the block's V slice
  constexpr int kParts = kTcWarps / kGroups;      // warps sharing a group: 1 or 2
  constexpr int kMT = 4 / kParts;                 // state m-tiles (16 rows of K) a warp
  constexpr int kYT = kC / 16 / kParts;           // y m-tiles (16 time steps) a warp
  extern __shared__ __align__(16) unsigned char scan_smem[];
  Smem<NV>& sm = *reinterpret_cast<Smem<NV>*>(scan_smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int v0 = blockIdx.x * NV, h = blockIdx.y, b = blockIdx.z;
  const bool cur = a.include_current != 0;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.sv[0] + h * a.sv[2] + v0;
  const float* lg = a.la + b * a.sl[0] + h * a.sl[2];
  __nv_bfloat16* yg = static_cast<__nv_bfloat16*>(a.y) + b * a.sy[0] + h * a.sy[2] + v0;
  const long long st_base = ((long long)b * a.H + h) * a.K * a.V;
  // this warp's columns vw..vw + 7 of the slice (v0 + vw.. of V), its
  // state m-tiles m0..m0 + kMT - 1 and its y m-tiles mt0..mt0 + kYT - 1
  const int part = kParts == 1 ? 0 : warp / kGroups;   // 0 folds the loops below at NV 64
  const int vw = warp % kGroups * 8, m0 = part * kMT, mt0 = part * kYT;
  const bool v_ok = v0 + vw < a.V;

  load_chunk(sm.st[0], a, qg, kg, vg, lg, 0, v0, tid);
  mma::cp_async_commit();
  if (tid < kMaxK) sm.u[tid] = (a.u != nullptr && tid < a.K) ? a.u[h * a.K + tid] : 1.f;

  // the state, as accumulators of kMT 16-row m-tiles: rows d = 16 (m0 + m)
  // + g (+ 8), columns v = v0 + vw + 2c (+ 1); and its hi/lo copy for the
  // readout
  float st[kMT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * (m0 + m) + g + (e >> 1) * 8, v = v0 + vw + 2 * c + (e & 1);
      st[m][e] = (a.s0 != nullptr && d < a.K && v < a.V) ? a.s0[st_base + (long long)d * a.V + v]
                                                          : 0.f;
    }
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t hi, lo;
      split(st[m][2 * i], st[m][2 * i + 1], hi, lo);
      st32(&sm.sh[16 * (m0 + m) + g + 8 * i][vw + 2 * c], hi);
      st32(&sm.sl[16 * (m0 + m) + g + 8 * i][vw + 2 * c], lo);
    }

  // the scores' upper quadrants inside each sub-chunk stay zero; the rest
  // is written every chunk
  for (int i = tid; i < kC * kPA; i += kTcThreads) {
    (&sm.ah[0][0])[i] = __float2bfloat16_rn(0.f);
    (&sm.al[0][0])[i] = __float2bfloat16_rn(0.f);
  }

  const int nchunks = (a.S + kC - 1) / kC;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int t0 = ci * kC;
    Stage<NV>& cs = sm.st[ci & 1];
    mma::cp_async_wait<0>();  // chunk ci has landed ...
    __syncthreads();          // ... for every thread, and chunk ci - 1 is no longer read
    if (ci + 1 < nchunks) {
      load_chunk(sm.st[(ci + 1) & 1], a, qg, kg, vg, lg, t0 + kC, v0, tid);
      mma::cp_async_commit();
    }
    if (ci > 0) store_y(sm, a, yg, t0 - kC, v0, tid);  // the previous chunk's y

    // 1. cum * log2(e) of the log-decay (per dim clamped, per head as it
    // is, the same in every column d) and the decays exp(la):
    // thread (column d, quarter p) scans steps 8p..8p+7 from 0, then the
    // quarters of a column (neighbouring lanes) pass their last sums on
    // in order, so that cum never rises from one step to the next
    {
      const int d = tid >> 2, p = tid & 3;
      float r[8], run = 0.f, off = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float la = a.la_per_head ? cs.lh[8 * p + i]
                                       : fminf(fmaxf(cs.la[8 * p + i][d], kLogAMin), 0.f);
        sm.w[8 * p + i][d] = mma::exp2_approx(la * kLog2e);
        run += la;
        r[i] = run;
      }
#pragma unroll
      for (int q = 1; q < 4; ++q) {                     // quarter q starts at q - 1's last
        const float prev = __shfl_up_sync(0xffffffffu, off + r[7], 1, 4);
        if (p == q) off = prev;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) cs.la[8 * p + i][d] = (off + r[i]) * kLog2e;
    }
    __syncthreads();

    // 2a. operands of the readout and the state update, two columns a thread
#pragma unroll
    for (int j = 0; j < kC * kMaxK / 2 / kTcThreads; ++j) {
      const int i = tid + j * kTcThreads, t = i >> 5, d = (i & 31) * 2;
      const float2 cm = f2(&cs.la[t][d]), tot = f2(&cs.la[kC - 1][d]);
      const float2 x = cur ? cm : (t > 0 ? f2(&cs.la[t - 1][d]) : make_float2(0.f, 0.f));
      const float2 qv = bf2(&cs.q[t][d]), kv = bf2(&cs.k[t][d]);
      uint32_t hi, lo;
      split(qv.x * mma::exp2_approx(x.x), qv.y * mma::exp2_approx(x.y), hi, lo);
      st32(&sm.qh[t][d], hi);
      st32(&sm.ql[t][d], lo);
      split(kv.x * mma::exp2_approx(tot.x - cm.x), kv.y * mma::exp2_approx(tot.y - cm.y), hi, lo);
      st32(&sm.kh[t][d], hi);
      st32(&sm.kl[t][d], lo);
    }

    // 2b. off-diagonal scores, t in 16..31 against s in 0..15, factored
    // about r = 15: warp 0 takes s 0..7, warp 1 s 8..15
    if (warp < 2) {
      const float* r15 = cs.la[kSub - 1];
      float acc[3][4] = {};                  // hi hi, hi lo, lo hi: three chains side by side
      const int s = 8 * warp + g;
#pragma unroll
      for (int ks = 0; ks < kMaxK / 16; ++ks) {
        uint32_t afh[4], afl[4], bfh[2], bfl[2];
#pragma unroll
        for (int e = 0; e < 4; ++e) {    // A: rows t = 16 + g (+ 8), cols d
          const int t = kSub + g + (e & 1) * 8, d = 16 * ks + 2 * c + (e >> 1) * 8;
          const float2 x = f2(cur ? &cs.la[t][d] : &cs.la[t - 1][d]), r = f2(&r15[d]);
          const float2 qv = bf2(&cs.q[t][d]);
          split(qv.x * mma::exp2_approx(x.x - r.x), qv.y * mma::exp2_approx(x.y - r.y), afh[e],
                afl[e]);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {    // B: k = d, column s
          const int d = 16 * ks + 2 * c + e * 8;
          const float2 cm = f2(&cs.la[s][d]), r = f2(&r15[d]);
          const float2 kv = bf2(&cs.k[s][d]);
          split(kv.x * mma::exp2_approx(r.x - cm.x), kv.y * mma::exp2_approx(r.y - cm.y), bfh[e],
                bfl[e]);
        }
        mma::mma_bf16(acc[0], afh, bfh[0], bfh[1]);
        mma::mma_bf16(acc[1], afh, bfl[0], bfl[1]);
        mma::mma_bf16(acc[2], afl, bfh[0], bfh[1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t hi, lo;
        split(acc[0][2 * i] + acc[1][2 * i] + acc[2][2 * i],
              acc[0][2 * i + 1] + acc[1][2 * i + 1] + acc[2][2 * i + 1], hi, lo);
        st32(&sm.ah[kSub + g + 8 * i][8 * warp + 2 * c], hi);
        st32(&sm.al[kSub + g + 8 * i][8 * warp + 2 * c], lo);
      }
    }

    // 2c. inside each sub-chunk (base T = 16 (warp - 2)), the 8 x 8
    // quadrant t in T+8..T+15 against s in T..T+7, factored about
    // r = T + 7: warps 2 and 3, one mma row group (rows 8..15 zero)
    if (warp == 2 || warp == 3) {
      const int T = kSub * (warp - 2), t = T + 8 + g, s = T + g;
      const float* rr = cs.la[T + 7];
      const float* xt = cur ? cs.la[t] : cs.la[t - 1];
      float acc[3][4] = {};                  // hi hi, hi lo, lo hi
#pragma unroll
      for (int ks = 0; ks < kMaxK / 16; ++ks) {
        uint32_t afh[4] = {0u, 0u, 0u, 0u}, afl[4] = {0u, 0u, 0u, 0u}, bfh[2], bfl[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {    // a0, a2: row t, cols d; B: k = d, column s
          const int d = 16 * ks + 2 * c + e * 8;
          const float2 x = f2(&xt[d]), r = f2(&rr[d]), cm = f2(&cs.la[s][d]);
          const float2 qv = bf2(&cs.q[t][d]), kv = bf2(&cs.k[s][d]);
          split(qv.x * mma::exp2_approx(x.x - r.x), qv.y * mma::exp2_approx(x.y - r.y),
                afh[2 * e], afl[2 * e]);
          split(kv.x * mma::exp2_approx(r.x - cm.x), kv.y * mma::exp2_approx(r.y - cm.y), bfh[e],
                bfl[e]);
        }
        mma::mma_bf16(acc[0], afh, bfh[0], bfh[1]);
        mma::mma_bf16(acc[1], afh, bfl[0], bfl[1]);
        mma::mma_bf16(acc[2], afl, bfh[0], bfh[1]);
      }
      uint32_t hi, lo;
      split(acc[0][0] + acc[1][0] + acc[2][0], acc[0][1] + acc[1][1] + acc[2][1], hi, lo);
      st32(&sm.ah[t][T + 2 * c], hi);
      st32(&sm.al[t][T + 2 * c], lo);
    }

    // 2d. the four 8 x 8 diagonal blocks, elementwise.  Lane (row t,
    // eighth j8 of d) walks s from its newest term down to the block's
    // start, carrying exp(x_t - cum_s) as a running product of the
    // decays exp(la_s) <= 1: no exponential per (t, s, d).  The eight
    // lanes of a row then reduce-scatter their eight sums with shuffles,
    // lane j8 ending with column blk + j8.  Warp w takes rows 4w..4w+3.
    {
      const int t = 4 * warp + (lane >> 3), j8 = lane & 7;
      const int blk = t & ~7, s_first = cur ? t : t - 1;  // newest decayed term
      const int jmax = (4 * warp & 7) + 3;                // this warp's last row in the block
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, bonus = 0.f;
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const int d = 8 * j8 + 2 * dd;
        const float2 qv = bf2(&cs.q[t][d]);
        if (!cur) {
          const float2 kv = bf2(&cs.k[t][d]), uv = f2(&sm.u[d]);
          bonus = fmaf(qv.x * uv.x, kv.x, fmaf(qv.y * uv.y, kv.y, bonus));
        }
        float2 e = make_float2(1.f, 1.f);               // exp(x_t - cum_s) at s = s_first
#pragma unroll
        for (int j = 7; j >= 0; --j) {
          if (j > jmax) continue;                         // warp-uniform
          const int s = blk + j;
          if (s <= s_first) {
            const float2 kv = bf2(&cs.k[s][d]), w = f2(&sm.w[s][d]);
            acc[j] = fmaf(qv.x * kv.x, e.x, fmaf(qv.y * kv.y, e.y, acc[j]));
            e.x *= w.x;
            e.y *= w.y;
          }
        }
      }
      const bool h4 = lane & 4, h2 = lane & 2, h1 = lane & 1;
      float r4[4], r2[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r4[i] = (h4 ? acc[i + 4] : acc[i]) +
                __shfl_xor_sync(0xffffffffu, h4 ? acc[i] : acc[i + 4], 4);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        r2[i] = (h2 ? r4[i + 2] : r4[i]) + __shfl_xor_sync(0xffffffffu, h2 ? r4[i] : r4[i + 2], 2);
      float sum = (h1 ? r2[1] : r2[0]) + __shfl_xor_sync(0xffffffffu, h1 ? r2[0] : r2[1], 1);
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) bonus += __shfl_xor_sync(0xffffffffu, bonus, o);
      const int s = blk + j8;                             // this lane's column
      if (!cur && s == t) sum += bonus;
      const __nv_bfloat16 hi = __float2bfloat16_rn(sum);
      sm.ah[t][s] = hi;
      sm.al[t][s] = __float2bfloat16_rn(sum - __bfloat162float(hi));
    }
    __syncthreads();

    const __nv_bfloat16* vcol = &cs.v[lane & 15][vw];  // + 16 kk rows: B of k-step kk
    if (v_ok) {
      // 3a. y = (q exp(x)) S_in + A v, for rows 16 mt .. + 15; five
      // accumulators, so that the mma chains run side by side; y goes to
      // shared memory and out at the start of the next chunk
#pragma unroll
      for (int mt = mt0; mt < mt0 + kYT; ++mt) {
        float y[5][4] = {};
#pragma unroll
        for (int ks = 0; ks < kMaxK / 16; ++ks) {
          uint32_t ah[4], al[4], bh[2], bl[2];
          const int arow = 16 * mt + (lane & 15), acol = 16 * ks + (lane >> 4) * 8;
          mma::ldmatrix_x4(ah, &sm.qh[arow][acol]);
          mma::ldmatrix_x4(al, &sm.ql[arow][acol]);
          mma::ldmatrix_x2_trans(bh, &sm.sh[16 * ks + (lane & 15)][vw]);
          mma::ldmatrix_x2_trans(bl, &sm.sl[16 * ks + (lane & 15)][vw]);
          mma::mma_bf16(y[0], ah, bh[0], bh[1]);
          mma::mma_bf16(y[1], ah, bl[0], bl[1]);
          mma::mma_bf16(y[2], al, bh[0], bh[1]);
        }
#pragma unroll
        for (int kk = 0; kk <= mt; ++kk) {
          uint32_t afh[4], afl[4], bf[2];
          const int arow = 16 * mt + (lane & 15), acol = 16 * kk + (lane >> 4) * 8;
          mma::ldmatrix_x4(afh, &sm.ah[arow][acol]);
          mma::ldmatrix_x4(afl, &sm.al[arow][acol]);
          mma::ldmatrix_x2_trans(bf, vcol + 16 * kk * (NV + 8));
          mma::mma_bf16(y[3], afh, bf[0], bf[1]);
          mma::mma_bf16(y[4], afl, bf[0], bf[1]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 16 * mt + g + 8 * i;
          st32(&sm.y[r][vw + 2 * c],
               mma::pack_bf16(
                   (y[0][2 * i] + y[1][2 * i] + y[2][2 * i]) + (y[3][2 * i] + y[4][2 * i]),
                   (y[0][2 * i + 1] + y[1][2 * i + 1] + y[2][2 * i + 1]) +
                       (y[3][2 * i + 1] + y[4][2 * i + 1])));
        }
      }

      // 3b. S_out = diag(exp(cum_C)) S_in + (k exp(cum_C - cum))^T v
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const int d0 = 16 * (m0 + m);
        const float e0 = mma::exp2_approx(cs.la[kC - 1][d0 + g]);
        const float e8 = mma::exp2_approx(cs.la[kC - 1][d0 + g + 8]);
        st[m][0] *= e0;
        st[m][1] *= e0;
        st[m][2] *= e8;
        st[m][3] *= e8;
#pragma unroll
        for (int ks = 0; ks < kC / 16; ++ks) {
          uint32_t ah[4], al[4], bf[2];
          const int srow = 16 * ks + (lane & 7) + ((lane >> 4) << 3);
          const int dcol = d0 + ((lane >> 3) & 1) * 8;
          mma::ldmatrix_x4_trans(ah, &sm.kh[srow][dcol]);
          mma::ldmatrix_x4_trans(al, &sm.kl[srow][dcol]);
          mma::ldmatrix_x2_trans(bf, vcol + 16 * ks * (NV + 8));
          mma::mma_bf16(st[m], ah, bf[0], bf[1]);
          mma::mma_bf16(st[m], al, bf[0], bf[1]);
        }
      }
    }

    // 3c. the new state's hi/lo copy, once every warp that reads S_in's
    // columns vw.. (this one alone, or the kParts of its group) is done
    if (kParts > 1)
      __syncthreads();
    else
      __syncwarp();
    if (v_ok) {
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t hi, lo;
          split(st[m][2 * i], st[m][2 * i + 1], hi, lo);
          st32(&sm.sh[16 * (m0 + m) + g + 8 * i][vw + 2 * c], hi);
          st32(&sm.sl[16 * (m0 + m) + g + 8 * i][vw + 2 * c], lo);
        }
    }
  }
  __syncthreads();
  store_y(sm, a, yg, (nchunks - 1) * kC, v0, tid);

#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * (m0 + m) + g + (e >> 1) * 8, v = v0 + vw + 2 * c + (e & 1);
      if (d < a.K && v < a.V) a.s_out[st_base + (long long)d * a.V + v] = st[m][e];
    }
}

// ------------------------------------------------------------ fp32 route

constexpr int kSplit = 4;                // threads per state column
constexpr int kVT = 32;                  // state columns per block
constexpr int kThreads = kVT * kSplit;   // 128
constexpr int kRows = kMaxK / kSplit;    // state rows per thread
constexpr int kL = 32;                   // time steps staged at once

__global__ void __launch_bounds__(kThreads) scan_f32(Args a) {
  __shared__ float q_s[kL][kMaxK], k_s[kL][kMaxK], w_s[kL][kMaxK];
  __shared__ float v_s[kL][kVT], y_s[kL][kVT];
  __shared__ float u_s[kMaxK];

  const int tid = threadIdx.x, part = tid % kSplit, col = tid / kSplit;
  const int v0 = blockIdx.x * kVT, h = blockIdx.y, b = blockIdx.z;
  const int vc = v0 + col;
  const bool col_ok = vc < a.V;
  const float* qg = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const float* kg = static_cast<const float*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const float* vg = static_cast<const float*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const float* lg = a.la + b * a.sl[0] + h * a.sl[2];
  float* yg = static_cast<float*>(a.y) + b * a.sy[0] + h * a.sy[2];
  const long long st_base = ((long long)b * a.H + h) * a.K * a.V;

  float st[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int kk = j * kSplit + part;
    st[j] = (a.s0 != nullptr && kk < a.K && col_ok) ? a.s0[st_base + (long long)kk * a.V + vc]
                                                      : 0.f;
  }
  if (tid < kMaxK) u_s[tid] = (a.u != nullptr && tid < a.K) ? a.u[h * a.K + tid] : 1.f;

  for (int t0 = 0; t0 < a.S; t0 += kL) {
    const int n = min(kL, a.S - t0);
    __syncthreads();  // the previous chunk's readers of the staging arrays are done
    for (int i = tid; i < n * a.K; i += kThreads) {
      const int t = i / a.K, kk = i % a.K;
      const long long s = t0 + t;
      q_s[t][kk] = qg[s * a.sq[1] + kk];
      k_s[t][kk] = kg[s * a.sk[1] + kk];
      w_s[t][kk] = expf(a.la_per_head ? lg[s * a.sl[1]]
                                      : fminf(fmaxf(lg[s * a.sl[1] + kk], kLogAMin), 0.f));
    }
    for (int i = tid; i < n * kVT; i += kThreads) {
      const int t = i / kVT, c = i % kVT;
      v_s[t][c] = v0 + c < a.V ? vg[(t0 + t) * a.sv[1] + v0 + c] : 0.f;
    }
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const float vt = v_s[t][col];
      float y = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int kk = j * kSplit + part;
        if (kk < a.K) {
          const float kv = k_s[t][kk] * vt;
          if (a.include_current) {
            st[j] = fmaf(w_s[t][kk], st[j], kv);
            y = fmaf(q_s[t][kk], st[j], y);
          } else {
            y = fmaf(q_s[t][kk], fmaf(u_s[kk], kv, st[j]), y);
            st[j] = fmaf(w_s[t][kk], st[j], kv);
          }
        }
      }
      y += __shfl_xor_sync(0xffffffffu, y, 1);
      y += __shfl_xor_sync(0xffffffffu, y, 2);
      if (part == 0) y_s[t][col] = y;
    }
    __syncthreads();
    for (int i = tid; i < n * kVT; i += kThreads) {
      const int t = i / kVT, c = i % kVT;
      if (v0 + c < a.V) yg[(t0 + t) * a.sy[1] + v0 + c] = y_s[t][c];
    }
  }

#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int kk = j * kSplit + part;
    if (kk < a.K && col_ok) a.s_out[st_base + (long long)kk * a.V + vc] = st[j];
  }
}

template <int NV>
cudaError_t launch_bf16(const Args& a, int B, int H, int V, cudaStream_t s) {
  const int bytes = (int)sizeof(Smem<NV>);
  const cudaError_t err =
      cudaFuncSetAttribute(scan_bf16<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((V + NV - 1) / NV), (unsigned)H, (unsigned)B);  // V slice fastest
  scan_bf16<NV><<<grid, kTcThreads, bytes, s>>>(a);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and y alike; la, u and the
// states are float32).  strides: 15 element strides, (b, s, head) of q,
// k, v, la, y in that order; the last dim is unit-stride in all five.
// la_per_head: 0 for la (B, S, H, K), clamped to [-8, 0]; else la is
// (B, S, H), one unclamped log-decay a head.  u and s0 may be null.  K
// and V at most 64; for bfloat16 also multiples of 8, with every row of
// q, k, v, y (and of a per-dim la) 16-byte aligned.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int linear_scan_fwd(const void* q, const void* k, const void* v, const float* la,
                               const float* u, const float* s0, void* y, float* s_out,
                               int dtype, int B, int S, int H, int K, int V,
                               int include_current, int la_per_head, const long long* strides,
                               void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || V <= 0 || K > kMaxK || V > kMaxK)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.la = la;
  a.u = u;
  a.s0 = s0;
  a.y = y;
  a.s_out = s_out;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.sl[i] = strides[9 + i];
    a.sy[i] = strides[12 + i];
  }
  a.S = S;
  a.H = H;
  a.K = K;
  a.V = V;
  a.include_current = include_current;
  a.la_per_head = la_per_head;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((unsigned)((V + kVT - 1) / kVT), (unsigned)H, (unsigned)B);
    scan_f32<<<grid, kThreads, 0, s>>>(a);
  } else if (dtype == 1) {
    // 16-byte rows: every base 16-byte aligned, every (b, s, head) stride a
    // whole number of 16 bytes (8 bf16, 4 floats), K and V multiples of 8;
    // a per-head la is read a float at a time and has no such rows
    bool rows16 = K % 8 == 0 && V % 8 == 0;
    const void* bases[5] = {q, k, v, la, y};
    for (int i = 0; i < 5; ++i)
      rows16 = rows16 && (reinterpret_cast<uintptr_t>(bases[i]) % 16 == 0 || (i == 3 && la_per_head));
    for (int i = 0; i < 15; ++i) {
      const bool la_stride = i >= 9 && i < 12;
      rows16 = rows16 && (strides[i] % (la_stride ? 4 : 8) == 0 || (la_stride && la_per_head));
    }
    if (!rows16) return (int)cudaErrorInvalidValue;
    // a block holds the chunk's scores, which all V columns share; where
    // two blocks per (b, h) still find an SM each, V is split between them
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = 2LL * B * H <= sms ? launch_bf16<32>(a, B, H, V, s) : launch_bf16<64>(a, B, H, V, s);
    if (err != cudaSuccess) return (int)err;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
