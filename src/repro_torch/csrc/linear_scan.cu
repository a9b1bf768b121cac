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
// final state are (B, H, K, V) fp32.  The TPU kernel keeps its state in
// scratch and drops it; the decode cache needs it, so it is written out.
//
// Bound on an H100: device-memory bytes.  Each input element is read
// once and y written once, about 4 * B * S * H * K * 4 bytes, for about
// 4 K V operations per (b, t, h): tens of operations per byte, under the
// card's fp32 ridge.  The step is sequential in t, though, so a simple
// kernel is bound by the latency of its per-step chain long before the
// memory; this one does not reach the bytes bound and is measured
// against it.
//
// Design.  The TPU kernel's chunked form with factorised decay,
// k * exp(-cumsum(la)), overflows fp32 once a chunk's summed log-decay
// passes about -88 (rwkv6_3b's chunk of 32 at the clamp of -8 reaches
// -256).  This kernel steps through t exactly, as the sequential
// oracle does, and every exponent it takes is la <= 0.  One block of
// 128 threads per (32-column slice of V, head, batch row); four threads
// share one column of the state, each holding every fourth of its K
// rows in registers, and add their parts of y with two shuffles.  A loop
// over 32-step chunks stages q, k, exp(la) and v in shared memory with
// coalesced loads and writes each chunk's y back coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 4;                // threads per state column
constexpr int kVT = 32;                  // state columns per block
constexpr int kThreads = kVT * kSplit;   // 128
constexpr int kMaxK = 64;
constexpr int kRows = kMaxK / kSplit;    // state rows per thread
constexpr int kL = 32;                   // time steps staged at once
constexpr float kLogAMin = -8.f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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
  int S, H, K, V, include_current;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) scan_kernel(Args a) {
  __shared__ float q_s[kL][kMaxK], k_s[kL][kMaxK], w_s[kL][kMaxK];
  __shared__ float v_s[kL][kVT], y_s[kL][kVT];
  __shared__ float u_s[kMaxK];

  const int tid = threadIdx.x, part = tid % kSplit, col = tid / kSplit;
  const int v0 = blockIdx.x * kVT, h = blockIdx.y, b = blockIdx.z;
  const int vc = v0 + col;
  const bool col_ok = vc < a.V;
  const T* qg = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const T* kg = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const T* vg = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const float* lg = a.la + b * a.sl[0] + h * a.sl[2];
  T* yg = static_cast<T*>(a.y) + b * a.sy[0] + h * a.sy[2];
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
      q_s[t][kk] = to_f32(qg[s * a.sq[1] + kk]);
      k_s[t][kk] = to_f32(kg[s * a.sk[1] + kk]);
      w_s[t][kk] = expf(fminf(fmaxf(lg[s * a.sl[1] + kk], kLogAMin), 0.f));
    }
    for (int i = tid; i < n * kVT; i += kThreads) {
      const int t = i / kVT, c = i % kVT;
      v_s[t][c] = v0 + c < a.V ? to_f32(vg[(t0 + t) * a.sv[1] + v0 + c]) : 0.f;
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
      if (v0 + c < a.V) store(yg + (t0 + t) * a.sy[1] + v0 + c, y_s[t][c]);
    }
  }

#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int kk = j * kSplit + part;
    if (kk < a.K && col_ok) a.s_out[st_base + (long long)kk * a.V + vc] = st[j];
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and y alike; la, u and the
// states are float32).  strides: 15 element strides, (b, s, head) of q,
// k, v, la, y in that order; the last dim is unit-stride in all five.
// u and s0 may be null.  K and V at most 64.  Returns the CUDA error of
// the launch (0 on success).
extern "C" int linear_scan_fwd(const void* q, const void* k, const void* v, const float* la,
                               const float* u, const float* s0, void* y, float* s_out,
                               int dtype, int B, int S, int H, int K, int V,
                               int include_current, const long long* strides, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || V <= 0 || K > kMaxK || V > 64)
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
  const dim3 grid((unsigned)((V + kVT - 1) / kVT), (unsigned)H, (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    scan_kernel<float><<<grid, kThreads, 0, s>>>(a);
  } else if (dtype == 1) {
    scan_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
