// Causal flash attention, forward, on the model layer's own layout.
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention/kernel.py) together with what its
// wrapper gqa_flash_attention (ops.py) does around it.  It computes, for
// query head h of batch row b,
//   o[b, t, h] = sum_s softmax_s(q[b,t,h] . k[b,s,g] / sqrt(D)) v[b,s,g]
// over keys s <= t (and t - s < window when a window is given), with
// g = h / (H / KV) the kv head of h's group, in fp32 whatever the input
// type, masked scores at -1e30 and o = acc / max(l, 1e-30), as the TPU
// kernel does.  q is (B, S, H, D) and k, v (B, S, KV, D), each read
// through its own strides with D unit-stride, so neither the kv repeat
// nor the (B*H, S, D) transpose of the TPU wrapper is materialised.
//
// Bound on an H100: operations.  The causal product costs about
// 2 * B * H * S^2 * D multiply-adds over about 2 * B * S * (H + 2 KV) * D
// elements moved, hundreds of operations per byte at S = 2048.  This is
// the simple first kernel: plain fp32 FMA tiles in shared memory, no
// tensor cores (mma/wgmma are a later change), so it runs far below the
// bf16 tensor-core bound and is measured against it.
//
// Design.  One block of 256 threads per (64-query tile, head, batch
// row), heaviest (latest) query tiles launched first.  The query tile
// stays in shared memory; a loop walks the 64-key tiles that hold at
// least one unmasked key for some row of the tile: tiles wholly above
// the diagonal or wholly outside the window are never loaded.  Each
// thread owns a 4 x 4 patch of the score tile and 4 rows x D/16 columns
// of the output accumulator, in registers, with its rows' running max
// and denominator; a row's 16 owners sit in one half-warp and reduce
// with shuffles.  Rows and keys past S (a ragged last tile) are masked,
// so any S works.  K rows are padded by one float in shared memory so
// that 16 rows read at one depth fall in 16 banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per inner tile
constexpr int kThreads = 256;  // 16 x 16: thread (ty, tx) owns rows ty + 16 i, keys tx + 16 j
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sq[3], sk[3], sv[3], so[3];  // element strides over (b, s, head)
  int S, H, KV, window;                  // window <= 0: none
  float scale;
};

constexpr size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)kBQ * (hd + 1) + (size_t)kBK * (hd + 1) +
                          (size_t)kBK * hd + (size_t)kBQ * (kBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd(Args a) {
  extern __shared__ float smem[];
  constexpr int QLD = HD + 1;
  constexpr int PLD = kBK + 1;
  constexpr int CPT = HD / 16;  // output columns per thread
  float* q_s = smem;             // kBQ x QLD
  float* k_s = q_s + kBQ * QLD;  // kBK x QLD
  float* v_s = k_s + kBK * QLD;  // kBK x HD
  float* p_s = v_s + kBK * HD;   // kBQ x PLD

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.KV);
  const T* qg = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const T* kg = static_cast<const T*>(a.k) + b * a.sk[0] + g * a.sk[2];
  const T* vg = static_cast<const T*>(a.v) + b * a.sv[0] + g * a.sv[2];
  T* og = static_cast<T*>(a.o) + b * a.so[0] + h * a.so[2];

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    q_s[r * QLD + d] = s < a.S ? to_f32(qg[s * a.sq[1] + d]) : 0.f;
  }

  float acc[4][CPT], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // key tiles holding an unmasked key for some row of this query tile
  const int q_last = min(q0 + kBQ, a.S) - 1;
  const int k_first = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  for (int kt = k_first / kBK; kt <= q_last / kBK; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers of k_s, v_s, p_s are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, s = k0 + r;
      const bool in = s < a.S;
      k_s[r * QLD + d] = in ? to_f32(kg[s * a.sk[1] + d]) : 0.f;
      v_s[r * HD + d] = in ? to_f32(vg[s * a.sv[1] + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * QLD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * QLD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp <= qp && kp < a.S && (a.window <= 0 || qp - kp < a.window);
        sc[i][j] = ok[j] ? sc[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        rs += p;
        p_s[(ty + 16 * i) * PLD + tx + 16 * j] = p;
      }
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * PLD + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = v_s[kk * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= a.S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c) store(og + qp * a.so[1] + tx + 16 * c, acc[i][c] / den);
  }
}

template <typename T, int HD>
int launch(const Args& a, int B, cudaStream_t s) {
  const size_t bytes = smem_bytes(HD);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.S + kBQ - 1) / kBQ), (unsigned)a.H, (unsigned)B);
  flash_fwd<T, HD><<<grid, kThreads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const Args& a, int B, int hd, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(a, B, s);
    case 64: return launch<T, 64>(a, B, s);
    case 128: return launch<T, 128>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  strides: 12
// element strides, (b, s, head) of q, k, v, o in that order; the head
// dim is unit-stride in all four.  window <= 0 means no window.
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int S, int H, int KV, int hd,
                                   const long long* strides, int window, float scale,
                                   void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.window = window;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(a, B, hd, s);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(a, B, hd, s);
  return (int)cudaErrorInvalidValue;
}
