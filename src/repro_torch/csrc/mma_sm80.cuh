// Warp-level tensor-core and asynchronous-copy primitives shared by the
// port's bf16 kernels (flash_attention.cu, linear_scan.cu; the copies,
// packing and 2^x also flash_attention_bwd.cu): 16-byte (and 4-byte)
// cp.async with zero fill, ldmatrix (plain and transposed),
// mma.sync m16n8k16 bf16 -> fp32, and the MUFU unit's 2^x.  All of them
// exist from sm_80 on and run on Hopper (sm_90a) unchanged.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + c, g = lane / 4,
// c = lane % 4), which the kernels index by hand:
//   A (16 x 16, row-major), 4 registers of two bf16:
//     a0 (row g,     cols 2c, 2c+1)   a1 (row g + 8, cols 2c, 2c+1)
//     a2 (row g,     cols 2c+8, +9)   a3 (row g + 8, cols 2c+8, +9)
//   B (16 x 8, k-major "col"), 2 registers:
//     b0 (k rows 2c, 2c+1, col g)     b1 (k rows 2c+8, +9, col g)
//   C/D (16 x 8, fp32), 4 registers:
//     d0, d1 (row g, cols 2c, 2c+1)   d2, d3 (row g + 8, cols 2c, 2c+1)
// The lower 16 bits of a packed register hold the lower column (or k).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
// (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes global -> shared (the L1-allocating .ca form, the only one
// below 16 bytes); src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// Two 8x8 matrices, transposed; lanes 0..15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

// d += a * b, bf16 operands, fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one register of bf16 (round to nearest): lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x in one MUFU instruction (ex2.approx.ftz: about 2 ulp; results
// below 2^-126 flush to 0).  Without fast-math, exp2f adds instructions
// around the same MUFU op to keep subnormal results.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace mma
