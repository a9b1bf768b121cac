// Causal flash attention, backward, on the model layer's own layout.
//
// Replaces no TPU kernel: the Pallas flash_attention
// (src/repro/kernels/flash_attention/kernel.py) is forward-only, and the
// reference trains through plain jnp attention
// (src/repro/models/attention.py).  The port's attention layer launches
// the forward kernel on the card (csrc/flash_attention.cu), so training
// through that layer needs this backward; it is the gradient of exactly
// that function: causal softmax attention, scale 1/sqrt(D), an optional
// window (t - s < window), query head h reading kv head h / (H / KV).
//
// FlashAttention-2's backward, from the forward's per-row logsumexp
// lse[b, h, t] (natural log, scaled scores):
//   D_t  = sum_d dO[t, d] O[t, d]
//   P_ts = exp(scale q_t . k_s - lse_t)     recomputed, tile by tile
//   dV_s = sum_t P_ts dO_t
//   dS_ts = P_ts (dO_t . v_s - D_t)
//   dK_s = scale sum_t dS_ts q_t,   dQ_t = scale sum_s dS_ts k_s
// No atomics in either route, so two launches on one input give the same
// bits: dK and dV are summed by a kernel that owns a key tile, dQ by one
// that owns a query tile, and each recomputes S = Q K^T and dP = dO V^T
// for its pairs of tiles: 7 tile products a pair of tiles where 5 would
// do with atomics.
//
// Bound on an H100: operations.  The five products cost 10 D operations
// a visible (query, key) pair, hundreds of operations a byte moved at
// S = 2048: 5 products at 989 TFLOP/s (bf16 tensor cores) is the bar.
//
// Two routes, chosen by the input type:
//
// bf16 (the [train] path): FlashAttention-2's backward on Hopper's
// warpgroup product, wgmma m64nNk16 bf16 -> fp32 (csrc/wgmma_sm90.cuh),
// four launches:
//   row_stats  D and lse log2(e) of every row, 16-byte loads, into a
//              scratch of rows padded to 64 (zeros past S);
//   dkdv_bf16  one warpgroup (4 warps) a (64-key tile, kv head, batch
//              row, chunk of the GQA group's query heads), dK and dV of
//              its 64 keys in fp32 registers;
//   sum_chunks the chunks' fp32 partials of dK and dV summed in chunk
//              order and rounded (only when a group is split);
//   dq_bf16    one warpgroup a (64-query tile, head, batch row), dQ of its
//              64 rows in fp32 registers.
// What the design does about what held the first form back:
//  1. Tensor cores: every product is a wgmma.  The score products read
//     both factors from shared memory (S^T = K Q^T in dkdv_bf16, keys as
//     rows; S = Q K^T in dq_bf16), so a warpgroup reads each tile once
//     where four mma.sync warps would each read it.  P^T and dS^T (P and
//     dS in dq_bf16) come out of the accumulator in the layout of wgmma's
//     register operand: they are rounded to bf16, as FlashAttention-2
//     does, and packed in registers, never stored, so dV += P^T dO,
//     dK += dS^T Q and dQ += dS K read only their right factor from
//     shared memory.  The weights are recomputed while dP is multiplied
//     (two commit groups).  An mma.sync form of the same tiles, each warp
//     loading its right factors by ldmatrix, was built first and ran
//     slower on the card (PERF.md §6).
//  2. Asynchronous copies: Q and dO tiles (with their rows of D and lse)
//     stream through a two-stage ring by 16-byte cp.async, zero-filled
//     past S, as do K and V tiles in dq_bf16: tile j + 1 is in flight
//     while tile j is multiplied.  Tiles are stored in wgmma's 128-byte
//     swizzle (64-byte at D = 32), which also spreads the copies over the
//     banks; one copy of Q, dO or K serves as both the K-major and the
//     MN-major operand.
//  3. Shared memory holds bf16: six 64-row tiles, 100,352 bytes at
//     D = 128 (two blocks an SM), 51,200 at D = 64 (three, as registers
//     allow).  D = 112 (zamba2_7b's shared attention) rows are 224 bytes,
//     which the 128-byte swizzle does not tile: its tiles are D = 128's,
//     the last two 16-byte chunks of every row zero-filled by the copy.
//     The score products take 7 k-steps, the 112 columns alone; the
//     gradient products run at N = 128 over the zero columns (14 % more
//     of their products), whose outputs are zeros and are not stored.
//  4. Parallelism under GQA: the query heads of a group are split over
//     `chunks` blocks (the wrapper chooses the fewest that give about two
//     waves); each chunk writes an fp32 partial, which sum_chunks adds in
//     chunk order.  A group of one head writes dK and dV directly.  The
//     1-D grids launch the heaviest tiles first (the earliest key tiles,
//     the latest query tiles).  Pairs of tiles wholly above the diagonal
//     or outside the window are never visited; only the pairs that cross
//     an edge are masked.
//  5. The score products stay doubled (7 products): the price of no
//     atomics.  The softmax recompute is the forward's: one FFMA and one
//     MUFU ex2 a weight, from the forward's lse.

// fp32 (held to 1e-4 of scale, which TF32 or bf16 products would break):
// the first form, unchanged: fp32 FMA tiles on the CUDA cores, three
// launches:
//   bwd_dot   one warp a (b, t, h) row;
//   bwd_dkdv  one block a (64-key tile, kv head, batch row); it walks the
//             query heads of its GQA group in order, and for each the
//             query tiles that see its keys, and owns dK and dV of its
//             tile in registers;
//   bwd_dq    one block a (64-query tile, head, batch row), walking the
//             key tiles its rows see (the forward's loop), dQ in registers.
// Each thread owns a 4 x 4 patch of a 64 x 64 score tile and 4 rows x D/16
// columns of its block's gradient tile; D-wide tiles are padded by one
// float so that 16 rows read at one depth fall in 16 banks.  Shared
// memory: 4 D-wide tiles and two (or one) score tiles, 165,888 bytes at
// D = 128 for bwd_dkdv.  A 67 TFLOP/s ceiling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm80.cuh"
#include "wgmma_sm90.cuh"

namespace {

// ------------------------------------------------------------ fp32 route

constexpr int kT = 64;         // queries and keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPLD = kT + 1;   // row pitch of a score tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;   // (B, H, S)
  float* dvec;        // (B, H, S), written by bwd_dot
  void* dq;
  void* dk;
  void* dv;
  int B, S, H, KV, window;  // window <= 0: none
  float scale;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }

__device__ __forceinline__ bool visible(int t, int s, int S, int window) {
  return s <= t && t < S && (window <= 0 || t - s < window);
}

// rows ROWS x HD of a (B, S, heads, HD) tensor (row stride `stride`
// elements, first row s0) into fp32 shared memory of pitch HD + 1; rows
// past S are zeros
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long stride, int s0,
                                          int S, int tid) {
  for (int i = tid; i < kT * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, s = s0 + r;
    dst[r * (HD + 1) + d] = s < S ? ld(src + s * stride + d) : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) bwd_dot(Args a) {
  const long long rows = (long long)a.B * a.S * a.H;
  const long long r = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* o = static_cast<const T*>(a.o) + r * HD;
  const T* g = static_cast<const T*>(a.dout) + r * HD;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < HD; d += 32) acc = fmaf(ld(o + d), ld(g + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(r % a.H);
    const long long bs = r / a.H;  // b * S + t
    const int t = (int)(bs % a.S), b = (int)(bs / a.S);
    a.dvec[((long long)b * a.H + h) * a.S + t] = acc;
  }
}

template <int HD>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (4 * (size_t)kT * (HD + 1) + 2 * (size_t)kT * kPLD + 2 * kT);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) bwd_dkdv(Args a) {
  constexpr int LD = HD + 1;
  constexpr int CPT = HD / 16;  // gradient columns a thread owns
  extern __shared__ float dkdv_smem[];
  float* k_s = dkdv_smem;        // kT x LD
  float* v_s = k_s + kT * LD;    // kT x LD
  float* q_s = v_s + kT * LD;    // kT x LD
  float* do_s = q_s + kT * LD;   // kT x LD
  float* pt_s = do_s + kT * LD;  // P^T: kT keys x kPLD queries
  float* st_s = pt_s + kT * kPLD;  // dS^T
  float* lse_s = st_s + kT * kPLD;
  float* dd_s = lse_s + kT;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * kT;  // the earliest key tiles, which most queries see, first
  const int g = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  const long long qrow = (long long)a.H * HD, krow = (long long)a.KV * HD;
  const T* kg = static_cast<const T*>(a.k) + (long long)b * a.S * krow + (long long)g * HD;
  const T* vg = static_cast<const T*>(a.v) + (long long)b * a.S * krow + (long long)g * HD;
  load_tile<T, HD>(k_s, kg, krow, k0, a.S, tid);
  load_tile<T, HD>(v_s, vg, krow, k0, a.S, tid);

  float dk[4][CPT], dv[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk[i][c] = dv[i][c] = 0.f;

  // query tiles holding a query that sees a key of this tile
  const int k_last = min(k0 + kT, a.S) - 1;
  const int t_end = a.window > 0 ? min(a.S - 1, k_last + a.window - 1) : a.S - 1;
  for (int hh = 0; hh < G; ++hh) {
    const int h = g * G + hh;
    const T* qg = static_cast<const T*>(a.q) + (long long)b * a.S * qrow + (long long)h * HD;
    const T* dog = static_cast<const T*>(a.dout) + (long long)b * a.S * qrow + (long long)h * HD;
    const float* lseg = a.lse + ((long long)b * a.H + h) * a.S;
    const float* ddg = a.dvec + ((long long)b * a.H + h) * a.S;
    for (int qt = k0 / kT; qt <= t_end / kT; ++qt) {
      const int q0 = qt * kT;
      __syncthreads();  // the previous pair's readers of q_s, do_s, pt_s, st_s are done
      load_tile<T, HD>(q_s, qg, qrow, q0, a.S, tid);
      load_tile<T, HD>(do_s, dog, qrow, q0, a.S, tid);
      if (tid < kT) {
        const int t = q0 + tid;
        lse_s[tid] = t < a.S ? lseg[t] : 0.f;
        dd_s[tid] = t < a.S ? ddg[t] : 0.f;
      }
      __syncthreads();

      // keys ty + 16 i against queries tx + 16 j
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv[4], vv[4], qv[4], gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = k_s[(ty + 16 * i) * LD + d];
          vv[i] = v_s[(ty + 16 * i) * LD + d];
          qv[i] = q_s[(tx + 16 * i) * LD + d];
          gv[i] = do_s[(tx + 16 * i) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[i][j] = fmaf(kv[i], qv[j], sc[i][j]);
            dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = k0 + ty + 16 * i, tq = tx + 16 * j;
          const float p = visible(q0 + tq, s, a.S, a.window)
                              ? expf(fmaf(sc[i][j], a.scale, -lse_s[tq])) : 0.f;
          pt_s[(ty + 16 * i) * kPLD + tq] = p;
          st_s[(ty + 16 * i) * kPLD + tq] = p * (dp[i][j] - dd_s[tq]);
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q on keys ty + 16 i, columns tx + 16 c
#pragma unroll 4
      for (int t = 0; t < kT; ++t) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = pt_s[(ty + 16 * i) * kPLD + t];
          sv[i] = st_s[(ty + 16 * i) * kPLD + t];
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float gv = do_s[t * LD + tx + 16 * c], qv = q_s[t * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][c] = fmaf(pv[i], gv, dv[i][c]);
            dk[i][c] = fmaf(sv[i], qv, dk[i][c]);
          }
        }
      }
    }
  }

  T* dkg = static_cast<T*>(a.dk) + (long long)b * a.S * krow + (long long)g * HD;
  T* dvg = static_cast<T*>(a.dv) + (long long)b * a.S * krow + (long long)g * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= a.S) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      st(dkg + s * krow + tx + 16 * c, dk[i][c] * a.scale);
      st(dvg + s * krow + tx + 16 * c, dv[i][c]);
    }
  }
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * (size_t)kT * (HD + 1) + (size_t)kT * kPLD + 2 * kT);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) bwd_dq(Args a) {
  constexpr int LD = HD + 1;
  constexpr int CPT = HD / 16;
  extern __shared__ float dq_smem[];
  float* q_s = dq_smem;          // kT x LD
  float* do_s = q_s + kT * LD;   // kT x LD
  float* k_s = do_s + kT * LD;   // kT x LD
  float* v_s = k_s + kT * LD;    // kT x LD
  float* ds_s = v_s + kT * LD;   // dS: kT queries x kPLD keys
  float* lse_s = ds_s + kT * kPLD;
  float* dd_s = lse_s + kT;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kT;  // latest query tiles, the longest, first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.KV);
  const long long qrow = (long long)a.H * HD, krow = (long long)a.KV * HD;
  const T* qg = static_cast<const T*>(a.q) + (long long)b * a.S * qrow + (long long)h * HD;
  const T* dog = static_cast<const T*>(a.dout) + (long long)b * a.S * qrow + (long long)h * HD;
  const T* kg = static_cast<const T*>(a.k) + (long long)b * a.S * krow + (long long)g * HD;
  const T* vg = static_cast<const T*>(a.v) + (long long)b * a.S * krow + (long long)g * HD;
  load_tile<T, HD>(q_s, qg, qrow, q0, a.S, tid);
  load_tile<T, HD>(do_s, dog, qrow, q0, a.S, tid);
  if (tid < kT) {
    const int t = q0 + tid;
    lse_s[tid] = t < a.S ? a.lse[((long long)b * a.H + h) * a.S + t] : 0.f;
    dd_s[tid] = t < a.S ? a.dvec[((long long)b * a.H + h) * a.S + t] : 0.f;
  }

  float dq[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dq[i][c] = 0.f;

  // key tiles holding a key that some row of this query tile sees
  const int q_last = min(q0 + kT, a.S) - 1;
  const int k_first = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  for (int kt = k_first / kT; kt <= q_last / kT; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();  // the previous tile's readers of k_s, v_s, ds_s are done
    load_tile<T, HD>(k_s, kg, krow, k0, a.S, tid);
    load_tile<T, HD>(v_s, vg, krow, k0, a.S, tid);
    __syncthreads();

    // queries ty + 16 i against keys tx + 16 j
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = q_s[(ty + 16 * i) * LD + d];
        gv[i] = do_s[(ty + 16 * i) * LD + d];
        kv[i] = k_s[(tx + 16 * i) * LD + d];
        vv[i] = v_s[(tx + 16 * i) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tq = ty + 16 * i, s = k0 + tx + 16 * j;
        const float p = visible(q0 + tq, s, a.S, a.window)
                            ? expf(fmaf(sc[i][j], a.scale, -lse_s[tq])) : 0.f;
        ds_s[tq * kPLD + tx + 16 * j] = p * (dp[i][j] - dd_s[tq]);
      }
    __syncthreads();

    // dQ += dS K on queries ty + 16 i, columns tx + 16 c
#pragma unroll 4
    for (int s = 0; s < kT; ++s) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = ds_s[(ty + 16 * i) * kPLD + s];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float kv = k_s[s * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][c] = fmaf(sv[i], kv, dq[i][c]);
      }
    }
  }

  T* dqg = static_cast<T*>(a.dq) + (long long)b * a.S * qrow + (long long)h * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= a.S) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) st(dqg + t * qrow + tx + 16 * c, dq[i][c] * a.scale);
  }
}

template <typename T, int HD>
int launch(const Args& a, cudaStream_t s) {
  const long long rows = (long long)a.B * a.S * a.H;
  bwd_dot<T, HD><<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const unsigned tiles = (unsigned)((a.S + kT - 1) / kT);
  const size_t kv_bytes = dkdv_smem_bytes<HD>();
  err = cudaFuncSetAttribute(bwd_dkdv<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kv_bytes);
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv<T, HD><<<dim3(tiles, (unsigned)a.KV, (unsigned)a.B), kThreads, kv_bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t q_bytes = dq_smem_bytes<HD>();
  err = cudaFuncSetAttribute(bwd_dq<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)q_bytes);
  if (err != cudaSuccess) return (int)err;
  bwd_dq<T, HD><<<dim3(tiles, (unsigned)a.H, (unsigned)a.B), kThreads, q_bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int hd, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(a, s);
    case 64: return launch<T, 64>(a, s);
    case 112: return launch<T, 112>(a, s);
    case 128: return launch<T, 128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------ bf16 route

constexpr int kB = 64;           // queries and keys a tile
constexpr int kBThreads = 128;   // one warpgroup: 4 warps x 16 rows
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

struct BArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;  // (B, H, S)
  float* dvec;       // D (B, H, Sp), then lse log2(e) (B, H, Sp); zeros past S
  float* part;       // chunks > 1: partial dK (chunks, B, S, KV, HD), then dV
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int B, S, Sp, H, KV, window, chunks;  // Sp: S rounded up to kB
  float scale;
};

// The width of a head's tile: 112 columns go in a 128-column tile whose
// last 16 are zeros (224-byte rows are no whole number of 128-byte
// swizzle lines).
template <int HD>
__host__ __device__ constexpr int padded() {
  return HD == 112 ? 128 : HD;
}

// Tiles of kB rows of HD bf16 in wgmma's swizzled layout (wgmma_sm90.cuh):
// lines of kLine bytes, HD * 2 / kLine blocks of kB lines each.
template <int HD>
struct Tile {
  static constexpr int kLine = HD * 2 >= 128 ? 128 : HD * 2;
  static constexpr int kBlockBytes = kB * kLine;
  static constexpr int kBytes = kB * HD * 2;
  static constexpr uint32_t kSwizzle = kLine == 128 ? 1 : 2;
  static constexpr int kChunks = kLine / 16;  // 16-byte chunks a line

  // byte offset of 16-byte chunk c (of HD / 8) of row r
  __device__ static __forceinline__ int offset(int r, int c) {
    return (c / kChunks) * kBlockBytes + r * kLine +
           (((c % kChunks) ^ ((r * kLine >> 7) & (kChunks - 1))) << 4);
  }
  // the tile as a K-major operand (its rows are m or n), k-step ks
  __device__ static __forceinline__ uint64_t k_major(const unsigned char* t, int ks) {
    return wg::desc(t + (ks * 32 / kLine) * kBlockBytes + ks * 32 % kLine, 16, 8 * kLine,
                    kSwizzle);
  }
  // the tile as an MN-major operand (its rows are k), k-step ks
  __device__ static __forceinline__ uint64_t mn_major(const unsigned char* t, int ks) {
    return wg::desc(t + ks * 16 * kLine, kBlockBytes, 8 * kLine, kSwizzle);
  }
};

// Both tile kernels: six tiles, a ring of kB floats of D and of lse, and
// 1024 bytes to align the tiles.
template <int HD>
constexpr size_t bf16_smem_bytes() {
  return 6 * (size_t)Tile<padded<HD>()>::kBytes + sizeof(float) * 4 * kB + 1024;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = mma::smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// kB rows of HD bf16 from src (row stride `stride` elements), starting at
// sequence position s0, into a swizzled tile of padded<HD>() columns; rows
// past S and columns past HD are zeros.
template <int HD>
__device__ __forceinline__ void load_tile_bf16(unsigned char* dst, const bf16* src,
                                               long long stride, int s0, int S, int tid) {
  constexpr int kChunks = padded<HD>() / 8;  // 16-byte chunks a tile row
  static_assert(kB * kChunks % kBThreads == 0, "tile must split evenly over the block");
#pragma unroll
  for (int j = 0; j < kB * kChunks / kBThreads; ++j) {
    const int i = tid + j * kBThreads;
    const int r = i / kChunks, c = i % kChunks;
    const int s = s0 + r;
    const bool in = s < S && c < HD / 8;
    mma::cp_async16(dst + Tile<padded<HD>()>::offset(r, c), in ? src + s * stride + c * 8 : src,
                    in ? 16 : 0);
  }
}

// The accumulator registers of n-tiles 2 kk and 2 kk + 1, rounded to bf16:
// the register A of k-step kk of the next product.
__device__ __forceinline__ void pack_a(uint32_t (&r)[4], const float* d) {
  r[0] = mma::pack_bf16(d[0], d[1]);
  r[1] = mma::pack_bf16(d[2], d[3]);
  r[2] = mma::pack_bf16(d[4], d[5]);
  r[3] = mma::pack_bf16(d[6], d[7]);
}

// D_t = dO_t . O_t and lse_t log2(e) of every (b, h, t < Sp) row,
// padded<HD>() / 8 lanes a row (a power of two), 16 bytes each (the lanes
// past HD idle); rows past S get zeros.
template <int HD>
__global__ void __launch_bounds__(256) row_stats(BArgs a) {
  constexpr int L = padded<HD>() / 8;
  const long long rows = (long long)a.B * a.H * a.Sp;
  const long long r = ((long long)blockIdx.x * 256 + threadIdx.x) / L;  // (b h) Sp + t
  const int part = threadIdx.x % L;
  const int t = (int)(r % a.Sp);
  const long long bh = r / a.Sp;
  float acc = 0.f, l2 = 0.f;
  if (r < rows && t < a.S && part < HD / 8) {
    const int h = (int)(bh % a.H), b = (int)(bh / a.H);
    const long long off = (((long long)b * a.S + t) * a.H + h) * HD + part * 8;
    const uint4 ov = *reinterpret_cast<const uint4*>(a.o + off);
    const uint4 gv = *reinterpret_cast<const uint4*>(a.dout + off);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(o2[i]), y = __bfloat1622float2(g2[i]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
    l2 = a.lse[bh * a.S + t] * kLog2e;
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && part == 0) {
    a.dvec[r] = acc;
    a.dvec[rows + r] = l2;
  }
}

// Both tile kernels are one warpgroup: 4 warps, 16 rows each of every
// 64-row product.  At D <= 64 registers are capped so that three blocks
// fit an SM; at D = 128 a thread may take 255, and two blocks fit.
template <int HD>
__global__ void __launch_bounds__(kBThreads, HD <= 64 ? 3 : 1) dkdv_bf16(BArgs a) {
  using T = Tile<padded<HD>()>;
  constexpr int KS = HD / 16;            // k-steps of S^T and dP^T
  constexpr int NR = padded<HD>() / 2;   // accumulator registers of dK and of dV (64 x padded)
  extern __shared__ unsigned char dkdv_smem_bf16[];
  unsigned char* k_s = align1024(dkdv_smem_bf16);
  unsigned char* v_s = k_s + T::kBytes;
  unsigned char* q_s = v_s + T::kBytes;       // 2 stages
  unsigned char* do_s = q_s + 2 * T::kBytes;  // 2 stages
  float* dd_s = reinterpret_cast<float*>(do_s + 2 * T::kBytes);  // 2 stages x kB
  float* ll_s = dd_s + 2 * kB;                                    // 2 stages x kB

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  // the earliest key tiles, which the most queries see, launch first
  const int inner = a.KV * a.chunks * a.B;
  const int kt = blockIdx.x / inner, rem = blockIdx.x % inner;
  const int b = rem % a.B, ch = (rem / a.B) % a.chunks, grp = rem / a.B / a.chunks;
  const int G = a.H / a.KV;
  const int h0 = grp * G + ch * G / a.chunks, h1 = grp * G + (ch + 1) * G / a.chunks;
  const int k0 = kt * kB;
  // query tiles holding a query that sees a key of this tile: from the
  // diagonal's to the last the window (or S) reaches
  const int k_last = min(k0 + kB, a.S) - 1;
  const int t_end = a.window > 0 ? min(a.S - 1, k_last + a.window - 1) : a.S - 1;
  const int nq = t_end / kB - kt + 1, items = (h1 - h0) * nq;
  const long long qrow = (long long)a.H * HD, krow = (long long)a.KV * HD;
  const long long rows = (long long)a.B * a.H * a.Sp;

  load_tile_bf16<HD>(k_s, a.k + (long long)b * a.S * krow + grp * HD, krow, k0, a.S, tid);
  load_tile_bf16<HD>(v_s, a.v + (long long)b * a.S * krow + grp * HD, krow, k0, a.S, tid);
  // item i: query head h0 + i / nq, query tile kt + i % nq
  auto load_item = [&](int i, int st) {
    const int h = h0 + i / nq, q0 = (kt + i % nq) * kB;
    const long long off = (long long)b * a.S * qrow + (long long)h * HD;
    load_tile_bf16<HD>(q_s + st * T::kBytes, a.q + off, qrow, q0, a.S, tid);
    load_tile_bf16<HD>(do_s + st * T::kBytes, a.dout + off, qrow, q0, a.S, tid);
    if (tid < 32) {  // 16 chunks of D, 16 of lse
      const long long row = ((long long)b * a.H + h) * a.Sp + q0 + (tid % 16) * 4;
      mma::cp_async16((tid < 16 ? dd_s : ll_s) + st * kB + (tid % 16) * 4,
                      a.dvec + (tid < 16 ? 0 : rows) + row, 16);
    }
  };
  load_item(0, 0);
  mma::cp_async_commit();

  float dk[NR], dv[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) dk[r] = dv[r] = 0.f;
  const int kw0 = k0 + warp * 16;  // this warp's first key
  const float sl2 = a.scale * kLog2e;

  for (int i = 0; i < items; ++i) {
    const int st = i & 1;
    mma::cp_async_wait<0>();  // item i (and K, V) has landed ...
    wg::fence_proxy_async();  // ... where wgmma reads it ...
    __syncthreads();          // ... for every thread, and item i - 1 is no longer read
    if (i + 1 < items) {
      load_item(i + 1, st ^ 1);
      mma::cp_async_commit();
    }
    const int q0 = (kt + i % nq) * kB;
    const bool need_mask = q0 < kw0 + 15 || q0 + kB > a.S || kw0 + 16 > a.S ||
                           (a.window > 0 && q0 + kB - 1 - kw0 >= a.window);
    const unsigned char* qt_s = q_s + st * T::kBytes;
    const unsigned char* dot_s = do_s + st * T::kBytes;
    const float* dd = dd_s + st * kB;
    const float* ll = ll_s + st * kB;

    // S^T = K Q^T and dP^T = V dO^T: keys kw0 + g (e = 0, 1) and + 8
    // (e = 2, 3) by queries q0 + 8 j + 2 c + (e & 1), in register 4 j + e
    // (two groups: the weights are recomputed while dP^T is multiplied)
    float s[32], dpt[32];
    wg::fence_regs(s);
    wg::fence_regs(dpt);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wg::ss_m64n64(s, T::k_major(k_s, ks), T::k_major(qt_s, ks), ks > 0);
    wg::commit();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wg::ss_m64n64(dpt, T::k_major(v_s, ks), T::k_major(dot_s, ks), ks > 0);
    wg::commit();
    wg::wait<1>();
    wg::fence_regs(s);

    // P^T = 2^(s scale log2(e) - lse log2(e)), one FFMA and one ex2 a
    // weight; then dS^T = P^T (dP^T - D)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ll + 8 * j + 2 * c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = mma::exp2_approx(fmaf(s[4 * j + e], sl2, -((e & 1) ? l2.y : l2.x)));
        if (need_mask) {
          const int key = kw0 + g + (e >> 1) * 8, t = q0 + 8 * j + 2 * c + (e & 1);
          if (!visible(t, key, a.S, a.window)) p = 0.f;
        }
        s[4 * j + e] = p;
      }
    }
    wg::wait<0>();
    wg::fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(dd + 8 * j + 2 * c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * j + e] = s[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x));
    }
    uint32_t pa[kB / 16][4], sa[kB / 16][4];
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      pack_a(pa[kk], s + 8 * kk);
      pack_a(sa[kk], dpt + 8 * kk);
    }

    // dV += P^T dO, dK += dS^T Q
    wg::fence_regs(dv);
    wg::fence_regs(dk);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) wg::rs(dv, pa[kk], T::mn_major(dot_s, kk));
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) wg::rs(dk, sa[kk], T::mn_major(qt_s, kk));
    wg::commit();
    wg::wait<0>();  // before the next item's copies reuse this stage
    wg::fence_regs(dv);
    wg::fence_regs(dk);
  }

  // keys kw0 + g and kw0 + g + 8, columns 8 n + 2 c, + 1: bf16 into dK and
  // dV when the group is one chunk, else this chunk's fp32 partial
  const long long n_el = (long long)a.B * a.S * krow;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = kw0 + g + 8 * hf;
    if (key >= a.S) continue;
    if (a.chunks == 1) {
      bf16* dkr = a.dk + ((long long)b * a.S + key) * krow + grp * HD + 2 * c;
      bf16* dvr = a.dv + ((long long)b * a.S + key) * krow + grp * HD + 2 * c;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dkr + 8 * n) =
            mma::pack_bf16(dk[4 * n + 2 * hf] * a.scale, dk[4 * n + 2 * hf + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dvr + 8 * n) =
            mma::pack_bf16(dv[4 * n + 2 * hf], dv[4 * n + 2 * hf + 1]);
      }
    } else {
      float* pk = a.part + (((long long)ch * a.B + b) * a.S + key) * krow + grp * HD + 2 * c;
      float* pv = pk + a.chunks * n_el;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<float2*>(pk + 8 * n) =
            make_float2(dk[4 * n + 2 * hf] * a.scale, dk[4 * n + 2 * hf + 1] * a.scale);
        *reinterpret_cast<float2*>(pv + 8 * n) =
            make_float2(dv[4 * n + 2 * hf], dv[4 * n + 2 * hf + 1]);
      }
    }
  }
}

// dK and dV from the chunks' partials, summed in chunk order: 4 elements a
// thread over the 2 B S KV HD outputs.
__global__ void __launch_bounds__(256) sum_chunks(BArgs a, int hd) {
  const long long n_el = (long long)a.B * a.S * a.KV * hd;
  const long long i = ((long long)blockIdx.x * 256 + threadIdx.x) * 4;
  if (i >= 2 * n_el) return;
  const bool is_v = i >= n_el;
  const long long j = is_v ? i - n_el : i;
  const float* src = a.part + (is_v ? a.chunks * n_el : 0) + j;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int ch = 1; ch < a.chunks; ++ch) {
    const float4 x = *reinterpret_cast<const float4*>(src + ch * n_el);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  uint2 out;
  out.x = mma::pack_bf16(acc.x, acc.y);
  out.y = mma::pack_bf16(acc.z, acc.w);
  *reinterpret_cast<uint2*>((is_v ? a.dv : a.dk) + j) = out;
}

template <int HD>
__global__ void __launch_bounds__(kBThreads, HD <= 64 ? 3 : 1) dq_bf16(BArgs a) {
  using T = Tile<padded<HD>()>;
  constexpr int KS = HD / 16;            // k-steps of S and dP
  constexpr int NR = padded<HD>() / 2;   // accumulator registers of dQ (64 x padded)
  extern __shared__ unsigned char dq_smem_bf16[];
  unsigned char* q_s = align1024(dq_smem_bf16);
  unsigned char* do_s = q_s + T::kBytes;
  unsigned char* k_s = do_s + T::kBytes;     // 2 stages
  unsigned char* v_s = k_s + 2 * T::kBytes;  // 2 stages

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  // the latest query tiles, which see the most keys, launch first
  const int inner = a.H * a.B;
  const int tiles = (a.S + kB - 1) / kB;
  const int qt = tiles - 1 - (int)(blockIdx.x / inner), rem = blockIdx.x % inner;
  const int b = rem % a.B, h = rem / a.B;
  const int grp = h / (a.H / a.KV);
  const int q0 = qt * kB;
  const long long qrow = (long long)a.H * HD, krow = (long long)a.KV * HD;
  const bf16* kg = a.k + (long long)b * a.S * krow + grp * HD;
  const bf16* vg = a.v + (long long)b * a.S * krow + grp * HD;

  // key tiles holding a key that some row of this query tile sees
  const int q_last = min(q0 + kB, a.S) - 1;
  const int k_first = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt0 = k_first / kB, kt1 = q_last / kB;

  const long long qoff = (long long)b * a.S * qrow + (long long)h * HD;
  load_tile_bf16<HD>(q_s, a.q + qoff, qrow, q0, a.S, tid);
  load_tile_bf16<HD>(do_s, a.dout + qoff, qrow, q0, a.S, tid);
  load_tile_bf16<HD>(k_s, kg, krow, kt0 * kB, a.S, tid);
  load_tile_bf16<HD>(v_s, vg, krow, kt0 * kB, a.S, tid);
  mma::cp_async_commit();

  // this thread's rows wq0 + g and wq0 + g + 8 (both < Sp)
  const int wq0 = q0 + warp * 16;
  const long long rows = (long long)a.B * a.H * a.Sp;
  const float* dvr = a.dvec + ((long long)b * a.H + h) * a.Sp + wq0 + g;
  const float dd[2] = {dvr[0], dvr[8]}, l2[2] = {dvr[rows], dvr[rows + 8]};

  float dq[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) dq[r] = 0.f;
  const float sl2 = a.scale * kLog2e;

  for (int kt = kt0; kt <= kt1; ++kt) {
    const int st = (kt - kt0) & 1;
    mma::cp_async_wait<0>();  // tile kt has landed ...
    wg::fence_proxy_async();  // ... where wgmma reads it ...
    __syncthreads();          // ... for every thread, and tile kt - 1 is no longer read
    if (kt < kt1) {
      load_tile_bf16<HD>(k_s + (st ^ 1) * T::kBytes, kg, krow, (kt + 1) * kB, a.S, tid);
      load_tile_bf16<HD>(v_s + (st ^ 1) * T::kBytes, vg, krow, (kt + 1) * kB, a.S, tid);
      mma::cp_async_commit();
    }
    const int k0 = kt * kB;
    const bool need_mask = k0 + kB - 1 > wq0 || k0 + kB > a.S || wq0 + 16 > a.S ||
                           (a.window > 0 && wq0 + 15 - k0 >= a.window);
    const unsigned char* kt_s = k_s + st * T::kBytes;
    const unsigned char* vt_s = v_s + st * T::kBytes;

    // S = Q K^T and dP = dO V^T: rows wq0 + g (e = 0, 1) and + 8 (e = 2,
    // 3) by keys k0 + 8 j + 2 c + (e & 1), in register 4 j + e
    // (two groups: the weights are recomputed while dP is multiplied)
    float s[32], dp[32];
    wg::fence_regs(s);
    wg::fence_regs(dp);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wg::ss_m64n64(s, T::k_major(q_s, ks), T::k_major(kt_s, ks), ks > 0);
    wg::commit();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wg::ss_m64n64(dp, T::k_major(do_s, ks), T::k_major(vt_s, ks), ks > 0);
    wg::commit();
    wg::wait<1>();
    wg::fence_regs(s);

    // P recomputed as in dkdv_bf16, then dS = P (dP - D)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = mma::exp2_approx(fmaf(s[4 * j + e], sl2, -l2[e >> 1]));
        if (need_mask) {
          const int row = wq0 + g + (e >> 1) * 8, key = k0 + 8 * j + 2 * c + (e & 1);
          if (!visible(row, key, a.S, a.window)) p = 0.f;
        }
        s[4 * j + e] = p;
      }
    wg::wait<0>();
    wg::fence_regs(dp);
    uint32_t sa[kB / 16][4];
#pragma unroll
    for (int r = 0; r < 32; ++r) dp[r] = s[r] * (dp[r] - dd[(r >> 1) & 1]);
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) pack_a(sa[kk], dp + 8 * kk);

    // dQ += dS K
    wg::fence_regs(dq);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) wg::rs(dq, sa[kk], T::mn_major(kt_s, kk));
    wg::commit();
    wg::wait<0>();  // before the next tile's copies reuse this stage
    wg::fence_regs(dq);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = wq0 + g + 8 * hf;
    if (row >= a.S) continue;
    bf16* dqr = a.dq + qoff + (long long)row * qrow + 2 * c;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(dqr + 8 * n) =
          mma::pack_bf16(dq[4 * n + 2 * hf] * a.scale, dq[4 * n + 2 * hf + 1] * a.scale);
  }
}

template <int HD>
int launch_bf16(const BArgs& a, cudaStream_t s) {
  const long long threads = (long long)a.B * a.H * a.Sp * (padded<HD>() / 8);
  row_stats<HD><<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long tiles = (a.S + kB - 1) / kB;
  const size_t bytes = bf16_smem_bytes<HD>();
  err = cudaFuncSetAttribute(dkdv_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dkdv_bf16<HD><<<(unsigned)(tiles * a.KV * a.chunks * a.B), kBThreads, bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (a.chunks > 1) {
    const long long quads = (long long)a.B * a.S * a.KV * HD / 2;  // 2 n_el / 4
    sum_chunks<<<(unsigned)((quads + 255) / 256), 256, 0, s>>>(a, HD);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  err = cudaFuncSetAttribute(dq_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dq_bf16<HD><<<(unsigned)(tiles * a.H * a.B), kBThreads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv alike).
// q, o, dout, dq are contiguous (B, S, H, hd); k, v, dk, dv contiguous
// (B, S, KV, hd); for bfloat16 every base pointer 16-byte aligned.  lse
// (the forward's, natural log of the scaled scores' sum) fp32 (B, H, S).
// dvec: fp32 scratch of 2 B H Sp floats, Sp = S rounded up to 64.
// chunks: bfloat16 only, the query-head chunks of a GQA group in the dK/dV
// launch, 1 <= chunks <= H / KV; when above 1, part is fp32 scratch of
// 2 chunks B S KV hd floats (else unused, may be null); float32 takes 1.
// window <= 0 means none.  Launches three kernels on `stream` (four for
// bfloat16 with chunks > 1); returns the first CUDA error (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* dvec, void* dq,
                                   void* dk, void* dv, float* part, int chunks, int dtype, int B,
                                   int S, int H, int KV, int hd, int window, float scale,
                                   void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || B > 65535 || H > 65535 ||
      chunks < 1 || chunks > H / KV || (chunks > 1 && (dtype != 1 || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Args a;
    a.q = q;
    a.k = k;
    a.v = v;
    a.o = o;
    a.dout = dout;
    a.lse = lse;
    a.dvec = dvec;
    a.dq = dq;
    a.dk = dk;
    a.dv = dv;
    a.B = B;
    a.S = S;
    a.H = H;
    a.KV = KV;
    a.window = window;
    a.scale = scale;
    return dispatch<float>(a, hd, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  BArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = lse;
  a.dvec = dvec;
  a.part = part;
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.B = B;
  a.S = S;
  a.Sp = (S + kB - 1) / kB * kB;
  a.H = H;
  a.KV = KV;
  a.window = window;
  a.chunks = chunks;
  a.scale = scale;
  switch (hd) {
    case 32: return launch_bf16<32>(a, s);
    case 64: return launch_bf16<64>(a, s);
    case 112: return launch_bf16<112>(a, s);
    case 128: return launch_bf16<128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
