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
//   D_t  = sum_d dO[t, d] O[t, d]                          (bwd_dot)
//   P_ts = exp(scale q_t . k_s - lse_t)     recomputed, tile by tile
//   dV_s = sum_t P_ts dO_t
//   dS_ts = P_ts (dO_t . v_s - D_t)
//   dK_s = scale sum_t dS_ts q_t,   dQ_t = scale sum_s dS_ts k_s
// Three launches, no atomics, so a rerun gives the same bits:
//   bwd_dot   one warp a (b, t, h) row;
//   bwd_dkdv  one block a (64-key tile, kv head, batch row); it walks the
//             query heads of its GQA group in order, and for each the
//             query tiles that see its keys, and owns dK and dV of its
//             tile in registers;
//   bwd_dq    one block a (64-query tile, head, batch row), walking the
//             key tiles its rows see (the forward's loop), dQ in registers.
// Both tile kernels recompute S = Q K^T and dP = dO V^T for their pairs of
// tiles, so the score products are done twice: 7 tile products a pair of
// tiles against the forward's 2.
//
// Bound on an H100: operations, as for the forward (hundreds of operations
// a byte at S = 2048).  This first form computes in fp32 FMA tiles on the
// CUDA cores for both input types, bf16 inputs converted on their way into
// shared memory, gradients rounded to the input type on the way out: a
// 67 TFLOP/s ceiling against the tensor cores' 989.  The tensor-core form
// (mma.sync or wgmma, as the forward's bf16 route) is later work.
// Each thread owns a 4 x 4 patch of a 64 x 64 score tile and 4 rows x D/16
// columns of its block's gradient tile; D-wide tiles are padded by one
// float so that 16 rows read at one depth fall in 16 banks.  Shared
// memory: 4 D-wide tiles and two (or one) score tiles, 165,888 bytes at
// D = 128 for bwd_dkdv.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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
    case 128: return launch<T, 128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv alike).
// q, o, dout, dq are contiguous (B, S, H, hd); k, v, dk, dv contiguous
// (B, S, KV, hd); lse (the forward's, natural log of the scaled scores'
// sum) and dvec (scratch) fp32 (B, H, S).  window <= 0 means none.
// Launches three kernels on `stream`; returns the first CUDA error (0 on
// success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* dvec, void* dq,
                                   void* dk, void* dv, int dtype, int B, int S, int H, int KV,
                                   int hd, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, hd, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, hd, s);
  return (int)cudaErrorInvalidValue;
}
