// Row-wise squared difference norm over stacked trees:
//   out[w] = sum over leaves L, p of (a_L[w, p] - b_L[w, p])^2.
//
// Replaces the Pallas TPU kernel grad_diff_sq_norm_2d
// (src/repro/kernels/grad_diff_norm/kernel.py), the squared gradient
// difference of VAFL's Eq. 1.  The TPU kernel reduces one padded
// (M, 128) buffer per call over a sequential grid; this one takes the W
// clients of a call as the rows of stacked leaves (W, ...) and returns W
// values from one launch, reading every leaf where it lies: no
// concatenated copy of the trees is made.
//
// Bound on an H100: device-memory bytes.  Each element is read once from
// each operand (2 * W * P * 4 bytes in fp32, half that in bf16) for three
// floating-point operations, far below the ~20 operations per byte at
// which the card's fp32 rate would take over.  The design:
//
// - A leaf table passed by value (a kernel-parameter struct) gives each
//   stacked leaf's two base pointers and per-row numel.  A row's index
//   space is the concatenation of its leaves, each cut into groups of V
//   elements (one 16-byte vector: 4 fp32 or 8 bf16); a leaf's last group
//   may be short.  Grid (G, W): block (g, w) sums a fixed slice of row
//   w's groups across the leaf boundaries.  A 16-byte load never crosses
//   a leaf; a short group or a row that is not 16-byte aligned (leaves
//   of 10 or 144 elements give such rows) is read element by element, in
//   the same order, so which thread sums which element, and in what
//   order, depends on the shapes alone.
// - The last block of a row to finish, found by __threadfence() and an
//   integer ticket per row, sums the row's G partials in a fixed order
//   into out[w] and resets the ticket for the next call.  No float
//   atomics: reruns with the same shapes are bit-identical.
//
// One launch per call.  At the main path's shape (W = 7, P = 42,698,
// about 2.4 MB) the call is bound by launch latency instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 64;

struct LeafTable {
  const void* a[kMaxLeaves];
  const void* b[kMaxLeaves];
  long long numel[kMaxLeaves];        // elements of one row of the leaf
  long long goff[kMaxLeaves + 1];     // first group of each leaf in the row's group space
  int count;
};

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

template <typename T>
__device__ __forceinline__ float sq_diff_vec(uint4 va, uint4 vb, float acc) {
  constexpr int V = 16 / sizeof(T);
  const T* ea = reinterpret_cast<const T*>(&va);
  const T* eb = reinterpret_cast<const T*>(&vb);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float d = to_f32(ea[j]) - to_f32(eb[j]);
    acc = fmaf(d, d, acc);
  }
  return acc;
}

// grid (G, W).  partial: W * G floats; tickets: W zeros on entry, left
// at zero on exit.
template <typename T>
__global__ void __launch_bounds__(kThreads)
diff_sq_rows(const __grid_constant__ LeafTable t, long long groups_per_block,
             float* __restrict__ partial, float* __restrict__ out,
             unsigned* __restrict__ tickets) {
  constexpr int V = 16 / sizeof(T);
  const int G = gridDim.x;
  const long long w = blockIdx.y;
  const long long lo = blockIdx.x * groups_per_block;
  const long long hi = min(lo + groups_per_block, t.goff[t.count]);
  float acc = 0.0f;
  for (int L = 0; L < t.count; ++L) {
    const long long q0 = max(lo, t.goff[L]), q1 = min(hi, t.goff[L + 1]);
    if (q0 >= q1) continue;
    const long long numel = t.numel[L];
    const T* ra = static_cast<const T*>(t.a[L]) + w * numel;
    const T* rb = static_cast<const T*>(t.b[L]) + w * numel;
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(ra) | reinterpret_cast<uintptr_t>(rb)) & 15) == 0;
    for (long long q = q0 + threadIdx.x; q < q1; q += kThreads) {
      const long long e0 = (q - t.goff[L]) * V;
      if (aligned && e0 + V <= numel) {
        acc = sq_diff_vec<T>(__ldg(reinterpret_cast<const uint4*>(ra + e0)),
                             __ldg(reinterpret_cast<const uint4*>(rb + e0)), acc);
      } else {
        for (long long e = e0; e < e0 + V && e < numel; ++e) {
          const float d = to_f32(ra[e]) - to_f32(rb[e]);
          acc = fmaf(d, d, acc);
        }
      }
    }
  }
  acc = block_sum(acc);

  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[w * G + blockIdx.x] = acc;
    __threadfence();                          // the partial is visible before the ticket
    last = atomicAdd(&tickets[w], 1u) == (unsigned)(G - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s = 0.0f;
  for (int g = threadIdx.x; g < G; g += kThreads) s += __ldcg(&partial[w * G + g]);
  s = block_sum(s);
  if (threadIdx.x == 0) {
    out[w] = s;
    tickets[w] = 0u;                          // ready for the next call on this stream
  }
}

}  // namespace

// a, b: nleaves base pointers of stacked leaves (W, ...), contiguous, one
// dtype (0 = float32, 1 = bfloat16); numel: each leaf's elements per row.
// partial holds W * G floats; tickets W unsigned zeros (left at zero).
// Returns the CUDA error of the launch (0 on success).
extern "C" int grad_diff_sq_norm(const void* const* a, const void* const* b,
                                 const long long* numel, int nleaves, int dtype,
                                 float* partial, float* out, unsigned* tickets,
                                 long long W, int G, void* stream) {
  if (nleaves < 1 || nleaves > kMaxLeaves || G < 1 || W < 1 || W > 65535)
    return (int)cudaErrorInvalidValue;
  const int V = dtype == 0 ? 4 : 8;
  LeafTable t = {};
  t.count = nleaves;
  t.goff[0] = 0;
  for (int i = 0; i < nleaves; ++i) {
    t.a[i] = a[i];
    t.b[i] = b[i];
    t.numel[i] = numel[i];
    t.goff[i + 1] = t.goff[i] + (numel[i] + V - 1) / V;
  }
  const long long per_block = (t.goff[nleaves] + G - 1) / G;
  const dim3 grid((unsigned)G, (unsigned)W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    diff_sq_rows<float><<<grid, kThreads, 0, s>>>(t, per_block, partial, out, tickets);
  } else if (dtype == 1) {
    diff_sq_rows<__nv_bfloat16><<<grid, kThreads, 0, s>>>(t, per_block, partial, out, tickets);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
