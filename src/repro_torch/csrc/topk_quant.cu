// Fused magnitude-threshold selection + stochastic int8 quantization.
//
// Replaces the Pallas TPU kernel topk_quant_2d
// (src/repro/kernels/topk_quant/kernel.py), the hot path of the
// topk<r>_int8 codec.  For every element i of the flat update x:
//
//   keep    = |x| >= thr
//   u       = hash_uniform(i, seed)         (uint32 multiply-xorshift)
//   q       = clip(floor(clip(x / scale, -127, 127) + u), -127, 127)
//   q[i]    = keep ? q : 0,  mask[i] = keep
//
// bit for bit as the reference's oracle (repro/kernels/topk_quant/ref.py).
// That needs IEEE division, a round-to-nearest uint32 -> float
// conversion and an unfused add, so those are written as explicit
// intrinsics (__fdiv_rn, __uint2float_rn, __fmul_rn, __fadd_rn) and the
// file must not be built with --use_fast_math.  thr and scale are device
// scalars written by the caller's prologue (torch.topk), so no host sync
// sits between the prologue and the kernel.
//
// Bound on an H100: device-memory bytes.  One pass reads 4 bytes and
// writes 2 bytes per element for about 25 integer and float operations,
// under the ~20 operations per byte at which the card's 32-bit rate
// would take over.  Each thread handles four consecutive elements per
// step: one 16-byte load and two 4-byte stores, so a warp moves full
// 128-byte lines.  The ragged tail (n % 4) is masked here, so the caller
// pads nothing; the hash keys on the global flat index, which is why the
// port's unpadded buffer gives the reference's padded result.  At the
// main path's size (n = 42,698, 0.26 MB) the call is bound by launch
// latency instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kQmax = 127.0f;

__device__ __forceinline__ float hash_uniform(uint32_t idx, uint32_t seed) {
  uint32_t x = idx * 2654435761u + seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return __fmul_rn(__uint2float_rn(x), 2.3283064365386963e-10f);  // 2^-32
}

__device__ __forceinline__ void quant_one(float v, uint32_t i, float thr, float scale,
                                          uint32_t seed, int8_t* q, int8_t* m) {
  const bool keep = fabsf(v) >= thr;
  const float y = fminf(fmaxf(__fdiv_rn(v, scale), -kQmax), kQmax);
  const float r = fminf(fmaxf(floorf(__fadd_rn(y, hash_uniform(i, seed))), -kQmax), kQmax);
  *q = keep ? (int8_t)(int)r : (int8_t)0;
  *m = keep ? (int8_t)1 : (int8_t)0;
}

__global__ void __launch_bounds__(kThreads)
topk_quant_kernel(const float* __restrict__ x, const float* __restrict__ thr_p,
                  const float* __restrict__ scale_p, uint32_t seed,
                  int8_t* __restrict__ q, int8_t* __restrict__ mask, long long n) {
  const float thr = *thr_p, scale = *scale_p;
  const long long n4 = n / 4;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < n4; v += step) {
    const float4 xv = reinterpret_cast<const float4*>(x)[v];
    const uint32_t i = (uint32_t)(v * 4);
    char4 qv, mv;
    quant_one(xv.x, i + 0, thr, scale, seed, (int8_t*)&qv.x, (int8_t*)&mv.x);
    quant_one(xv.y, i + 1, thr, scale, seed, (int8_t*)&qv.y, (int8_t*)&mv.y);
    quant_one(xv.z, i + 2, thr, scale, seed, (int8_t*)&qv.z, (int8_t*)&mv.z);
    quant_one(xv.w, i + 3, thr, scale, seed, (int8_t*)&qv.w, (int8_t*)&mv.w);
    reinterpret_cast<char4*>(q)[v] = qv;
    reinterpret_cast<char4*>(mask)[v] = mv;
  }
  if (blockIdx.x == 0 && threadIdx.x < n - n4 * 4) {
    const long long i = n4 * 4 + threadIdx.x;
    quant_one(x[i], (uint32_t)i, thr, scale, seed, q + i, mask + i);
  }
}

}  // namespace

// x: n floats, 16-byte aligned; q, mask: n bytes each, 4-byte aligned;
// thr, scale: one float each on the device.  n < 2^32 (the hash index is
// uint32).  Returns the CUDA error of the launch (0 on success).
extern "C" int topk_quant(const float* x, const float* thr, const float* scale,
                          uint32_t seed, int8_t* q, int8_t* mask, long long n,
                          int blocks, void* stream) {
  topk_quant_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, thr, scale, seed, q, mask, n);
  return (int)cudaGetLastError();
}
