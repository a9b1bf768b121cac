// Flash attention, forward, on the model layer's own layout: causal, or
// non-causal with queries and keys of their own lengths.
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention/kernel.py) together with what its
// wrapper gqa_flash_attention (ops.py) does around it.  It computes, for
// query head h of batch row b,
//   o[b, t, h] = sum_s softmax_s(q[b,t,h] . k[b,s,g] / sqrt(D)) v[b,s,g]
// over keys s <= t (and t - s < window when a window is given), with
// g = h / (H / KV) the kv head of h's group, softmax in fp32 whatever the
// input type, masked scores at -1e30 and o = acc / max(l, 1e-30), as the
// TPU kernel does.  q is (B, S, H, D) and k, v (B, S, KV, D), each read
// through its own strides with D unit-stride, so neither the kv repeat
// nor the (B*H, S, D) transpose of the TPU wrapper is materialised.
// The non-causal mode (the CAUSAL template flag false) sums over every
// key s < Sk of k, v (B, Sk, KV, D) for each query t < Sq of q (B, Sq, H,
// D): the reference model's plain attention with a mask of all ones,
// which whisper's encoder self-attention (Sq = Sk = 1500 frames) and its
// cross-attention (the decoder's Sq queries over the encoder's Sk frames)
// run.  The TPU kernel is causal only; no window is taken without it.
// v (and o) may be narrower than q and k: Multi-head Latent Attention's
// expanded form (minicpm3_4b) has q.k head dim DQK = 96 and v head dim
// DV = 64, and D above reads DQK for q and k, DV for v and o; the scale
// stays 1 / sqrt(DQK).
// Rows past Sq and keys past Sk (a ragged last tile) are masked, so any
// lengths work; causal, key tiles wholly above the diagonal or wholly
// outside the window are never loaded, and non-causal every key tile is.  For training, both routes also write each row's
// logsumexp of the scaled scores when given an lse buffer, which the
// backward (flash_attention_bwd.cu) recomputes the weights from; serving
// passes none and runs the same code with one untaken branch a row.
//
// Bound on an H100: operations.  The causal product costs about
// B * H * S^2 * (DQK + DV) / 2 multiply-adds over about
// B * S * ((H + KV) * DQK + (KV + H) * DV) elements moved, hundreds of
// operations per byte at S = 2048: the bf16 tensor-core rate is the bar.
// Non-causal it is B * H * Sq * Sk * (DQK + DV) multiply-adds; at
// whisper's cross-attention (224 queries, 1500 keys, hd 64) the bytes
// are the larger term.
//
// Two routes, chosen by the input type:
//
// bf16 (the serving path): FlashAttention-2 on mma.sync.  One block of
// 8 warps per (128-query tile, head, batch row), latest query tiles
// first; each warp owns 16 query rows.  The Q tile is copied to shared
// memory once and kept in registers as bf16 A fragments.  K and V tiles
// of 64 keys arrive by 16-byte cp.async (zero-filled past S) in a
// two-stage ring, so tile j + 1 is in flight while tile j is multiplied;
// rows are padded by 16 bytes, which puts the eight rows of every
// ldmatrix in distinct banks.  S = Q K^T and O += P V run as
// mma.sync.m16n8k16 bf16 -> fp32.  The softmax stays in fp32 registers
// on raw scores: each row's running max is reduced over the four lanes
// that hold it with two shuffles, and each weight costs one FFMA (scale
// and max folded into a base-2 exponent) and one MUFU ex2; its
// denominator is summed per lane and reduced once at the end.  The
// softmax's instruction count, more than the tensor cores, sets this
// kernel's pace (PERF.md §6), hence the one FFMA and one ex2 a weight
// and no subnormal handling around the ex2.  P is rescaled and packed to
// bf16 in registers: the S accumulator's layout is the A-operand layout
// of the next mma, so P never touches shared memory.
// A warp skips a key tile that is wholly masked for its 16 rows and masks
// only the tiles that cross its diagonal, the window's edge or Sk
// (non-causal: only the last, ragged one).  Rows
// must be 16-byte aligned for cp.async; the wrapper (ops.py) copies a
// tensor whose base or strides are not.  Shared memory: (128 + 2 * 64)
// rows of DQK + 8 bf16 (Q, and K's two stages) and 2 * 64 rows of DV + 8
// (V's), 104,448 bytes at D = 128, 92,160 at D = 112 (zamba2_7b's shared
// attention; a row of 240 bytes still puts the eight rows of an ldmatrix
// in distinct banks) and 71,680 at (96, 64) (rows of 208 and 144 bytes:
// distinct banks too).  At unequal dims QK^T takes DQK / 16 k-steps and
// O has DV / 8 n-tiles.
//
// fp32 (held to 2e-5, which TF32 products would break): the first
// kernel's plain fp32 FMA tiles on the CUDA cores.  One block of 256
// threads per (64-query tile, head, batch row); the query tile stays in
// shared memory and each thread owns a 4 x 4 patch of the score tile and
// 4 rows x DV/16 columns of the output accumulator, in registers, with its
// rows' running max and denominator; a row's 16 owners sit in one
// half-warp and reduce with shuffles.  K rows are padded by one float so
// that 16 rows read at one depth fall in 16 banks.
//
// Head dims 32, 64, 112 and 128, and the unequal (DQK, DV) pairs (96, 64)
// and (48, 32) (minicpm3_4b and its smoke width), a template instance
// each, in both modes: the mode is a template flag, so the causal
// instances compile to the code they had before the non-causal mode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm80.cuh"

namespace {

constexpr int kBK = 64;        // keys per inner tile (both routes)
constexpr int kThreads = 256;  // both routes
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                            // (B, H, S) fp32 or null
  long long sq[3], sk[3], sv[3], so[3];  // element strides over (b, s, head)
  int Sq, Sk;                            // query and key positions (equal when causal)
  int H, KV, window;                     // window <= 0: none (causal only)
  float scale;
};

// ------------------------------------------------------------ bf16 route

constexpr int kBQ = 128;       // queries per block: 8 warps x 16 rows

template <int DQK, int DV>
constexpr size_t bf16_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         ((size_t)(DQK + 8) * (kBQ + 2 * kBK) + (size_t)(DV + 8) * 2 * kBK);
}

// ROWS rows of HD bf16 from src (row stride `stride` elements) into dst
// (pitch HD + 8), starting at sequence position s0; rows past S (q's Sq or
// k's and v's Sk) are zeros.
// A tile whose chunks do not split evenly over the block (64 rows at
// HD = 112: 896 chunks over 256 threads; at HD = 48, 384) ends in a
// guarded pass.
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int s0, int S, int tid) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  constexpr int kTotal = ROWS * kChunks;
#pragma unroll
  for (int j = 0; j < (kTotal + kThreads - 1) / kThreads; ++j) {
    const int i = tid + j * kThreads;
    if (kTotal % kThreads != 0 && i >= kTotal) break;
    const int r = i / kChunks, c = i % kChunks;
    const int s = s0 + r;
    const bool in = s < S;
    mma::cp_async16(dst + r * (HD + 8) + c * 8, in ? src + s * stride + c * 8 : src, in ? 16 : 0);
  }
}

template <int DQK, int DV, bool CAUSAL>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(Args a) {
  constexpr int P = DQK + 8;   // shared-memory row pitch of Q and K, bf16 elements
  constexpr int PV = DV + 8;   // ... of V
  constexpr int KS = DQK / 16; // k-steps of Q K^T
  constexpr int NT = DV / 8;   // n-tiles of O
  extern __shared__ __align__(16) unsigned char bf16_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(bf16_smem);  // kBQ x P
  __nv_bfloat16* k_s = q_s + kBQ * P;                                 // 2 stages x kBK x P
  __nv_bfloat16* v_s = k_s + 2 * kBK * P;                             // 2 stages x kBK x PV

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (a.H / a.KV);
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + b * a.sk[0] + grp * a.sk[2];
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + b * a.sv[0] + grp * a.sv[2];
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o) + b * a.so[0] + h * a.so[2];

  // key tiles holding an unmasked key for some row of this query tile
  const int q_last = min(q0 + kBQ, a.Sq) - 1;
  const int k_first = CAUSAL && a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt0 = k_first / kBK, kt1 = CAUSAL ? q_last / kBK : (a.Sk - 1) / kBK;

  load_rows<DQK, kBQ>(q_s, qg, a.sq[1], q0, a.Sq, tid);
  mma::cp_async_commit();
  load_rows<DQK, kBK>(k_s, kg, a.sk[1], kt0 * kBK, a.Sk, tid);
  load_rows<DV, kBK>(v_s, vg, a.sv[1], kt0 * kBK, a.Sk, tid);
  mma::cp_async_commit();
  mma::cp_async_wait<1>();  // the Q group has landed
  __syncthreads();

  const int wq0 = q0 + warp * 16;  // this warp's first query row
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    mma::ldmatrix_x4(qf[ks], q_s + (warp * 16 + lane % 16) * P + ks * 16 + (lane / 16) * 8);

  float o[NT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  const float scale_log2 = a.scale * 1.4426950408889634f;

  for (int kt = kt0; kt <= kt1; ++kt) {
    const int st = (kt - kt0) & 1;
    mma::cp_async_wait<0>();  // tile kt has landed ...
    __syncthreads();          // ... for every thread, and tile kt - 1 is no longer read
    if (kt < kt1) {
      load_rows<DQK, kBK>(k_s + (st ^ 1) * kBK * P, kg, a.sk[1], (kt + 1) * kBK, a.Sk, tid);
      load_rows<DV, kBK>(v_s + (st ^ 1) * kBK * PV, vg, a.sv[1], (kt + 1) * kBK, a.Sk, tid);
      mma::cp_async_commit();
    }
    const int k0 = kt * kBK;
    if (wq0 >= a.Sq ||
        (CAUSAL && (k0 > wq0 + 15 || (a.window > 0 && wq0 - (k0 + kBK - 1) >= a.window))))
      continue;  // every key of the tile is masked for this warp's rows
    const bool need_mask =
        CAUSAL ? k0 + kBK - 1 > wq0 || k0 + kBK > a.Sk ||
                     (a.window > 0 && wq0 + 15 - k0 >= a.window)
               : k0 + kBK > a.Sk;
    const __nv_bfloat16* kt_s = k_s + st * kBK * P;
    const __nv_bfloat16* vt_s = v_s + st * kBK * PV;

    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t kb[4];  // B fragments of key n-tiles 2 np and 2 np + 1
        mma::ldmatrix_x4(kb, kt_s + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + ks * 16 +
                                 ((lane >> 3) & 1) * 8);
        mma::mma_bf16(s[2 * np], qf[ks], kb[0], kb[1]);
        mma::mma_bf16(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // online softmax on rows wq0 + g (e = 0, 1) and wq0 + g + 8 (e = 2, 3),
    // kept in raw scores: the scale goes into the exponent's FFMA.  Only
    // a tile that crosses the diagonal, the window's edge or Sk masks.
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = wq0 + g + (e >> 1) * 8, key = k0 + j * 8 + 2 * c + (e & 1);
          if (!(key < a.Sk && (!CAUSAL || (key <= row &&
                                           (a.window <= 0 || row - key < a.window)))))
            s[j][e] = kNegInf;
        }
    }
    float mx[2] = {kNegInf, kNegInf}, alpha[2], mb[2];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = mma::exp2_approx((m[i] - m_new) * scale_log2);
      m[i] = m_new;
      l[i] *= alpha[i];
      // a row with no unmasked key yet: every weight exp2(-inf) = 0
      mb[i] = m_new == kNegInf ? __int_as_float(0x7f800000) : m_new * scale_log2;
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = mma::exp2_approx(fmaf(s[j][e], scale_log2, -mb[e >> 1]));
        s[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P's accumulator fragments of key n-tiles 2 kk, 2 kk + 1
    // are the A fragment of key k-step kk
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DV / 16; ++dp) {
        uint32_t vb[4];  // B fragments of output n-tiles 2 dp and 2 dp + 1
        mma::ldmatrix_x4_trans(vb, vt_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * PV +
                                       dp * 16 + (lane >> 4) * 8);
        mma::mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma::mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = wq0 + g + 8 * i;
    if (row >= a.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    // the weights were exp((s - m) scale), so the row's logsumexp of the
    // scaled scores is m scale + log l
    if (a.lse != nullptr && c == 0)
      a.lse[((long long)b * a.H + h) * a.Sq + row] = m[i] * a.scale + logf(l[i]);
    __nv_bfloat16* orow = og + row * a.so[1] + 2 * c;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          mma::pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
}

// ------------------------------------------------------------ fp32 route

constexpr int kF32BQ = 64;     // queries per block

// Q and K tiles at pitch DQK + 1, V at DV, P at kBK + 1 floats
constexpr size_t f32_smem_bytes(int dqk, int dv) {
  return sizeof(float) * ((size_t)kF32BQ * (dqk + 1) + (size_t)kBK * (dqk + 1) +
                          (size_t)kBK * dv + (size_t)kF32BQ * (kBK + 1));
}

template <int DQK, int DV, bool CAUSAL>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(Args a) {
  extern __shared__ float f32_smem[];
  constexpr int QLD = DQK + 1;
  constexpr int PLD = kBK + 1;
  constexpr int CPT = DV / 16;  // output columns per thread
  float* q_s = f32_smem;              // kF32BQ x QLD
  float* k_s = q_s + kF32BQ * QLD;    // kBK x QLD
  float* v_s = k_s + kBK * QLD;       // kBK x DV
  float* p_s = v_s + kBK * DV;        // kF32BQ x PLD

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kF32BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.KV);
  const float* qg = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const float* kg = static_cast<const float*>(a.k) + b * a.sk[0] + g * a.sk[2];
  const float* vg = static_cast<const float*>(a.v) + b * a.sv[0] + g * a.sv[2];
  float* og = static_cast<float*>(a.o) + b * a.so[0] + h * a.so[2];

  for (int i = tid; i < kF32BQ * DQK; i += kThreads) {
    const int r = i / DQK, d = i % DQK, s = q0 + r;
    q_s[r * QLD + d] = s < a.Sq ? qg[s * a.sq[1] + d] : 0.f;
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
  const int q_last = min(q0 + kF32BQ, a.Sq) - 1;
  const int k_first = CAUSAL && a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt1 = CAUSAL ? q_last / kBK : (a.Sk - 1) / kBK;
  for (int kt = k_first / kBK; kt <= kt1; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers of k_s, v_s, p_s are done
    for (int i = tid; i < kBK * DQK; i += kThreads) {
      const int r = i / DQK, d = i % DQK, s = k0 + r;
      k_s[r * QLD + d] = s < a.Sk ? kg[s * a.sk[1] + d] : 0.f;
    }
    for (int i = tid; i < kBK * DV; i += kThreads) {
      const int r = i / DV, d = i % DV, s = k0 + r;
      v_s[r * DV + d] = s < a.Sk ? vg[s * a.sv[1] + d] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DQK; ++d) {
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
        ok[j] = kp < a.Sk && (!CAUSAL || (kp <= qp && (a.window <= 0 || qp - kp < a.window)));
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
        const float vv = v_s[kk * DV + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= a.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (a.lse != nullptr && tx == 0)
      a.lse[((long long)b * a.H + h) * a.Sq + qp] = m[i] + logf(l[i]);  // m is scaled here
#pragma unroll
    for (int c = 0; c < CPT; ++c) og[qp * a.so[1] + tx + 16 * c] = acc[i][c] / den;
  }
}

template <int DQK, int DV, bool CAUSAL>
int launch_mode(const Args& a, int B, int dtype, cudaStream_t s) {
  static_assert(DQK % 16 == 0 && DV % 16 == 0, "head dims are whole k-steps and column groups");
  if (dtype == 0) {
    const size_t bytes = f32_smem_bytes(DQK, DV);
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32<DQK, DV, CAUSAL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((a.Sq + kF32BQ - 1) / kF32BQ), (unsigned)a.H, (unsigned)B);
    flash_fwd_f32<DQK, DV, CAUSAL><<<grid, kThreads, bytes, s>>>(a);
  } else {
    const size_t bytes = bf16_smem_bytes<DQK, DV>();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16<DQK, DV, CAUSAL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((a.Sq + kBQ - 1) / kBQ), (unsigned)a.H, (unsigned)B);
    flash_fwd_bf16<DQK, DV, CAUSAL><<<grid, kThreads, bytes, s>>>(a);
  }
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch(const Args& a, int B, int dtype, bool causal, cudaStream_t s) {
  return causal ? launch_mode<DQK, DV, true>(a, B, dtype, s)
                : launch_mode<DQK, DV, false>(a, B, dtype, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  Sq is q's and
// o's positions, Sk k's and v's; causal != 0 needs Sq == Sk, and a window
// (window > 0) needs causal.  hd is q's and k's head dim, dv v's and o's:
// equal (32, 64, 112, 128) or one of the pairs (96, 64) and (48, 32).
// strides: 12 element strides, (b, s, head) of q, k, v, o in that order;
// the head dim is unit-stride in all four.  For bfloat16 every row of q,
// k, v must start 16-byte aligned (base pointers and strides), and o's
// rows 4-byte aligned.  window <= 0 means no window.  lse, when not null,
// receives each row's logsumexp of the scaled scores, fp32 (B, H, Sq)
// contiguous, which the backward (csrc/flash_attention_bwd.cu) reads;
// serving passes null.  Returns the CUDA error of the launch (0 on
// success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Sq, int Sk, int H, int KV, int hd,
                                   int dv, const long long* strides, int window, int causal,
                                   float scale, float* lse, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      (dtype != 0 && dtype != 1) || (causal ? Sq != Sk : window > 0))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.KV = KV;
  a.window = window;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dv == hd) {
    switch (hd) {
      case 32: return launch<32, 32>(a, B, dtype, causal != 0, s);
      case 64: return launch<64, 64>(a, B, dtype, causal != 0, s);
      case 112: return launch<112, 112>(a, B, dtype, causal != 0, s);
      case 128: return launch<128, 128>(a, B, dtype, causal != 0, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (hd == 96 && dv == 64) return launch<96, 64>(a, B, dtype, causal != 0, s);
  if (hd == 48 && dv == 32) return launch<48, 32>(a, B, dtype, causal != 0, s);
  return (int)cudaErrorInvalidValue;
}
