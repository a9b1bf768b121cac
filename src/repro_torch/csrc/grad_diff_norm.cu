// Row-wise squared difference norm: out[w] = sum_p (a[w,p] - b[w,p])^2.
//
// Replaces the Pallas TPU kernel grad_diff_sq_norm_2d
// (src/repro/kernels/grad_diff_norm/kernel.py), the squared gradient
// difference of VAFL's Eq. 1.  The TPU kernel reduces one padded
// (M, 128) buffer per call over a sequential grid; this one takes the W
// clients of a call as the rows of a (W, P) buffer, with P unpadded, and
// returns W values from one call.
//
// Bound on an H100: device-memory bytes.  Each element is read once from
// each operand (2 * W * P * 4 bytes in fp32, half that in bf16) for three
// floating-point operations, far below the ~20 operations per byte at
// which the card's fp32 rate would take over.  The design streams both
// operands once with coalesced loads, keeps the running sum in a
// register, and never writes the difference: stage 1 gives each block a
// fixed slice of one row and stores one fp32 partial sum; stage 2 sums a
// row's partials in a fixed order.  No float atomics, so reruns with the
// same shapes are bit-identical.  The ragged edge of each row is masked
// here, so the caller pads nothing.  At the main path's shape (W = 7,
// P = 42,698, about 2.4 MB) the call is bound by launch latency instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Sum of `v` over the block, in a fixed order; valid in thread 0.
__device__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// grid (G, W): block (g, w) sums elements g*256 + t, stepping by G*256,
// of row w, and writes partial[w * G + g].
template <typename T>
__global__ void __launch_bounds__(kThreads)
partial_sums(const T* __restrict__ a, const T* __restrict__ b,
             float* __restrict__ partial, long long P) {
  const long long row = blockIdx.y;
  const T* ra = a + row * P;
  const T* rb = b + row * P;
  const long long step = (long long)gridDim.x * kThreads;
  float acc = 0.0f;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < P; i += step) {
    const float d = to_f32(ra[i]) - to_f32(rb[i]);
    acc = fmaf(d, d, acc);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[row * gridDim.x + blockIdx.x] = acc;
}

// grid (W): block w sums partial[w, 0..G) into out[w].
__global__ void __launch_bounds__(kThreads)
row_sums(const float* __restrict__ partial, float* __restrict__ out, int G) {
  const float* row = partial + (long long)blockIdx.x * G;
  float acc = 0.0f;
  for (int g = threadIdx.x; g < G; g += kThreads) acc += row[g];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  partial holds W * G floats.
// Returns the CUDA error of the launches (0 on success).
extern "C" int grad_diff_sq_norm(const void* a, const void* b, int dtype,
                                 float* partial, float* out, long long W,
                                 long long P, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1((unsigned)G, (unsigned)W);
  if (dtype == 0) {
    partial_sums<float><<<grid1, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), partial, P);
  } else if (dtype == 1) {
    partial_sums<__nv_bfloat16><<<grid1, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        partial, P);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  row_sums<<<(unsigned)W, kThreads, 0, s>>>(partial, out, G);
  return (int)cudaGetLastError();
}
