// The topk<r>_int8 codec on the device: magnitude-threshold selection,
// stochastic int8 quantization and compaction into the wire planes.
//
// Replaces the Pallas TPU kernel topk_quant_2d
// (src/repro/kernels/topk_quant/kernel.py) and, around it, the
// reference's prologue (lax.top_k for the threshold and scale) and its
// index compaction (np.flatnonzero).  For every element i of the flat
// update x (the update's leaves in tree-flatten order):
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
// file must not be built with --use_fast_math.
//
// Two entry points share quant_value():
//
// - topk_quant: the elementwise pass, the one-for-one counterpart of
//   topk_quant_2d.  thr and scale are device scalars from the caller.
//   Each thread handles four consecutive elements per step (one 16-byte
//   load, two 4-byte stores).  Bound: device-memory bytes (6 a element).
//
// - topk_int8_encode: the whole codec.  It finds
//     thr   = max(k-th largest |x|, 1e-12)
//     scale = max(max |x|, 1e-12) * fl32(1/127)
//   and writes  [count | idx int32 x count | val int8 x count | scale]
//   with the kept entries in ascending flat index (np.flatnonzero's
//   order).  The k-th largest |x| is found by radix select on the bits:
//   for finite |x| the uint32 pattern (sign bit cleared) orders like the
//   value, so three histogram passes over the digits 30..20, 19..10 and
//   9..0 give the exact k-th largest key, ties included (what
//   lax.top_k(...)[k-1] and torch.topk(...).values[-1] return).  max |x|
//   is an integer max over the same keys, folded into the first pass.
//   The update arrives as a table of leaves (pointer, numel), passed by
//   value; each leaf is cut into groups of four elements, the last one
//   short and padded with zeros.  Zeros never change the k-th largest
//   magnitude (they sit below any positive one, and when it is 0 it
//   stays 0) and are never kept (thr >= 1e-12), so the padding needs no
//   mask.  A 16-byte copy never crosses a leaf; a group at a ragged edge
//   or in a leaf that is not 16-byte aligned is read element by element.
//   Two routes:
//     resident (one launch): the update fits the shared memory of one
//       thread-block cluster (up to 8 CTAs of 1024 threads, 13,312 groups
//       a CTA; the wrapper spreads even a small update over up to 4).
//       Each CTA stages its slice once with cp.async, runs the three
//       select passes, the count and the quantize-and-compact pass over
//       shared memory, and merges histograms, the max and the compaction
//       offsets across the cluster through distributed shared memory;
//       every CTA sums the same remote values in the same order.
//     streaming (five launches, no host sync between them), for larger
//       updates: per-block shared histograms merged into device memory by
//       integer atomics, and the last block to finish (found by a ticket)
//       selects each digit.  Pass 0 reads the update (and takes the max);
//       pass 1 reads it again, counts per block the keys above the first
//       digit's bin and gathers the keys in that bin (the candidates, a
//       few percent of a dense update) into one run a block; pass 2 and
//       the count pass read only the candidates; the quantize-and-compact
//       pass reads the update a third time and writes the planes at each
//       block's offset.  Where the candidates overflow their space, or
//       the 1e-12 clamp raises the threshold above the k-th key, pass 2
//       and the count read the update instead.
//   Histograms take one shared-memory atomic a key (a warp whose keys
//   share one bin adds once).  Bound: device-memory bytes (4n read, 5 a
//   kept entry + 8 written).  Integer atomics only, and the selection
//   does not depend on their order: reruns are bit-identical.  Keys
//   compare as the bits of |x|, so a NaN counts above +inf; the plain
//   route drops it.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;             // elementwise pass, streaming passes
constexpr float kQmax = 127.0f;
constexpr int kMaxLeaves = 64;
constexpr int kResThreads = 1024;         // resident route: one CTA of 1024 threads an SM
constexpr int kResGroups = 13312;         // groups of 4 floats a CTA stages (212,992 bytes)
constexpr int kMaxCluster = 8;            // portable cluster size
constexpr int kBins0 = 2048;              // digit 0: key bits 30..20
constexpr int kBins = 1024;               // digits 1 and 2: bits 19..10, 9..0
constexpr int kUnroll = 4;                // groups a thread takes per streaming step
constexpr int kBlockGroups = 4096;        // groups a streaming block covers
constexpr int kBlockCand = 4096;          // candidates a streaming block gathers in pass 1

__device__ __forceinline__ float hash_uniform(uint32_t idx, uint32_t seed) {
  uint32_t x = idx * 2654435761u + seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return __fmul_rn(__uint2float_rn(x), 2.3283064365386963e-10f);  // 2^-32
}

__device__ __forceinline__ int8_t quant_value(float v, uint32_t i, float scale, uint32_t seed) {
  const float y = fminf(fmaxf(__fdiv_rn(v, scale), -kQmax), kQmax);
  const float r = fminf(fmaxf(floorf(__fadd_rn(y, hash_uniform(i, seed))), -kQmax), kQmax);
  return (int8_t)(int)r;
}

__device__ __forceinline__ void quant_one(float v, uint32_t i, float thr, float scale,
                                          uint32_t seed, int8_t* q, int8_t* m) {
  const bool keep = fabsf(v) >= thr;
  *q = keep ? quant_value(v, i, scale, seed) : (int8_t)0;
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

// ------------------------------------------------------------ encode ---

struct Leaves {
  const float* ptr[kMaxLeaves];
  long long numel[kMaxLeaves];
  long long foff[kMaxLeaves];         // first flat index of each leaf
  long long goff[kMaxLeaves + 1];     // first group of each leaf; goff[count] = Q
  int count;
};

// Device state of the streaming route, zero at rest (each call's last
// blocks reset what they accumulated).
struct StreamState {
  unsigned hist[kBins0];
  unsigned maxkey, prefix, krem, ticket, total, ncand, overflow;
  float thr, scale;
  unsigned pad[7];
};

// The streaming route's scratch: the state, then per block its count
// (pass 1: keys above the first digit's bin; the count pass: kept
// entries; then their exclusive offsets), the start and length of its
// run of candidates (keys in the first digit's bin), and the candidates.
struct StreamScratch {
  StreamState* st;
  unsigned* blockcnt;
  unsigned* segbase;
  unsigned* segcnt;
  unsigned* cand;
  unsigned cand_cap;
};

__device__ __forceinline__ unsigned key_of(float v) { return __float_as_uint(v) & 0x7FFFFFFFu; }

__device__ __forceinline__ int leaf_of(const Leaves& t, long long g) {
  int lo = 0, hi = t.count - 1;           // the last leaf with goff <= g
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.goff[mid] <= g) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Group g (in leaf L, found by advancing the cursor) as four floats,
// zeros past the leaf's end; *flat0 = flat index of its first element.
__device__ __forceinline__ float4 load_group(const Leaves& t, long long g, int& L, uint32_t* flat0) {
  while (g >= t.goff[L + 1]) ++L;
  const long long e0 = (g - t.goff[L]) * 4;
  const float* src = t.ptr[L] + e0;
  *flat0 = (uint32_t)(t.foff[L] + e0);
  const long long valid = t.numel[L] - e0;
  if (valid >= 4 && (reinterpret_cast<uintptr_t>(src) & 15) == 0)
    return __ldg(reinterpret_cast<const float4*>(src));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  v.x = __ldg(src);
  if (valid > 1) v.y = __ldg(src + 1);
  if (valid > 2) v.z = __ldg(src + 2);
  if (valid > 3) v.w = __ldg(src + 3);
  return v;
}

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Exclusive prefix sum of v over a block of kT threads, in thread order;
// *total = the block's sum.  scratch: kT / 32 words.
template <int kT>
__device__ unsigned block_scan(unsigned v, unsigned* scratch, unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned o = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < kT / 32 ? scratch[lane] : 0u;
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned o = __shfl_up_sync(0xFFFFFFFFu, w, off);
      if (lane >= off) w += o;
    }
    if (lane < kT / 32) scratch[lane] = w;
  }
  __syncthreads();
  const unsigned before = warp ? scratch[warp - 1] : 0u;
  *total = scratch[kT / 32 - 1];
  __syncthreads();                        // scratch is free again
  return before + incl - v;
}

// One histogram increment; all 32 lanes call it.  A warp whose lanes
// all fall into one bin (the zeros of a sparse update) adds once; any
// other warp adds lane by lane (a shared-memory atomic serialises only
// the lanes that share a bin: a few for a digit of randn data).
__device__ __forceinline__ void hist_add(unsigned* h, unsigned bin, bool in) {
  const unsigned b0 = __shfl_sync(0xFFFFFFFFu, bin, 0);
  if (__all_sync(0xFFFFFFFFu, in && bin == b0)) {
    if ((threadIdx.x & 31) == 0) atomicAdd(&h[b0], 32u);
  } else if (in) {
    atomicAdd(&h[bin], 1u);
  }
}

// Digit d of a key, and whether the key matches the higher digits found.
template <int D>
__device__ __forceinline__ bool digit_of(unsigned key, unsigned prefix, unsigned* bin) {
  if (D == 0) { *bin = key >> 20; return true; }
  if (D == 1) { *bin = (key >> 10) & (kBins - 1); return (key >> 20) == (prefix >> 20); }
  *bin = key & (kBins - 1);
  return (key >> 10) == (prefix >> 10);
}

__host__ __device__ constexpr int shift_of(int d) { return d == 0 ? 20 : d == 1 ? 10 : 0; }

// Given this thread's bins (per = bins / kT consecutive bins, thread t
// owning [t*per, t*per+per)), find the bin that holds the krem-th largest
// key: above(b) < krem <= above(b) + h[b].  Writes (bin, krem - above)
// to sel.  Every thread of the block must call it.
template <int kT, int per>
__device__ void select_bin(const unsigned (&h)[per], unsigned krem, unsigned* scratch,
                           unsigned* sel) {
  unsigned s = 0, total;
#pragma unroll
  for (int j = 0; j < per; ++j) s += h[j];
  const unsigned excl = block_scan<kT>(s, scratch, &total);
  unsigned above = total - excl - s;      // keys in the bins of higher threads
#pragma unroll
  for (int j = per - 1; j >= 0; --j) {
    if (above < krem && krem <= above + h[j]) {
      sel[0] = threadIdx.x * per + j;
      sel[1] = krem - above;
    }
    above += h[j];
  }
  __syncthreads();
}

__device__ __forceinline__ void store_scale(uint8_t* p, float scale) {
  const unsigned bits = __float_as_uint(scale);
  p[0] = bits & 0xFF; p[1] = (bits >> 8) & 0xFF; p[2] = (bits >> 16) & 0xFF; p[3] = bits >> 24;
}

// Shared memory of one resident CTA, after its staged groups.
struct ResidentShared {
  unsigned hist0[kBins0], hist1[kBins], hist2[kBins];
  unsigned scratch[32];
  unsigned sel[2];
  unsigned maxkey, cta_total;
};

constexpr size_t kResSmem = (size_t)kResGroups * 16 + sizeof(ResidentShared);
static_assert(kResSmem <= 232448, "resident CTA exceeds the 227 KB of shared memory");

template <int D>
__device__ __forceinline__ void resident_hist(const float4* data, int ng, unsigned prefix,
                                              unsigned* h, unsigned* lmax) {
  for (int base = 0; base < ng; base += kResThreads) {
    const int i = base + threadIdx.x;
    const float4 v = i < ng ? data[i] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned key = key_of(lane_of(v, j));
      unsigned bin;
      const bool in = digit_of<D>(key, prefix, &bin) && i < ng;
      if (D == 0) *lmax = max(*lmax, key);
      hist_add(h, bin, in);
    }
  }
}

// Merge digit D's histograms across the cluster and select its bin.
template <int D>
__device__ void resident_select(cg::cluster_group& cluster, ResidentShared* sh,
                                unsigned* hist, unsigned* prefix, unsigned* krem) {
  constexpr int per = (D == 0 ? kBins0 : kBins) / kResThreads;
  cluster.sync();                         // every CTA's histogram is complete
  const unsigned c = cluster.num_blocks();
  unsigned h[per];
#pragma unroll
  for (int j = 0; j < per; ++j) {
    unsigned s = 0;
    for (unsigned r = 0; r < c; ++r) s += cluster.map_shared_rank(hist, r)[threadIdx.x * per + j];
    h[j] = s;
  }
  select_bin<kResThreads, per>(h, *krem, sh->scratch, sh->sel);
  *prefix |= sh->sel[0] << shift_of(D);
  *krem = sh->sel[1];
}

// grid = cluster = c CTAs of kResThreads; CTA r takes groups
// [r * per_cta, (r + 1) * per_cta).  out: 8 + 5 * n bytes.
__global__ void __launch_bounds__(kResThreads, 1)
encode_resident(const __grid_constant__ Leaves t, long long per_cta, unsigned k, uint32_t seed,
                float inv_qmax, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) float4 data[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  ResidentShared* sh = reinterpret_cast<ResidentShared*>(data + per_cta);
  const long long Q = t.goff[t.count];
  const long long g_lo = min((long long)rank * per_cta, Q);
  const int ng = (int)(min(g_lo + per_cta, Q) - g_lo);

  for (int i = threadIdx.x; i < kBins0; i += kResThreads) sh->hist0[i] = 0u;
  for (int i = threadIdx.x; i < kBins; i += kResThreads) sh->hist1[i] = sh->hist2[i] = 0u;
  if (threadIdx.x == 0) sh->maxkey = 0u;

  // stage the slice: 16-byte cp.async where a group is whole and aligned
  int L = leaf_of(t, min(g_lo + threadIdx.x, Q - 1));
  for (int i = threadIdx.x; i < ng; i += kResThreads) {
    const long long g = g_lo + i;
    while (g >= t.goff[L + 1]) ++L;
    const long long e0 = (g - t.goff[L]) * 4;
    const float* src = t.ptr[L] + e0;
    if (t.numel[L] - e0 >= 4 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      __pipeline_memcpy_async(&data[i], src, 16);
    } else {
      uint32_t f;
      data[i] = load_group(t, g, L, &f);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // select: three digits, histograms merged across the cluster
  unsigned prefix = 0u, krem = k, lmax = 0u;
  resident_hist<0>(data, ng, 0u, sh->hist0, &lmax);
  lmax = __reduce_max_sync(0xFFFFFFFFu, lmax);
  if ((threadIdx.x & 31) == 0) atomicMax(&sh->maxkey, lmax);
  resident_select<0>(cluster, sh, sh->hist0, &prefix, &krem);
  resident_hist<1>(data, ng, prefix, sh->hist1, &lmax);
  resident_select<1>(cluster, sh, sh->hist1, &prefix, &krem);
  resident_hist<2>(data, ng, prefix, sh->hist2, &lmax);
  resident_select<2>(cluster, sh, sh->hist2, &prefix, &krem);
  unsigned maxkey = 0u;
  for (unsigned r = 0; r < cluster.num_blocks(); ++r)
    maxkey = max(maxkey, *cluster.map_shared_rank(&sh->maxkey, r));
  const float thr = fmaxf(__uint_as_float(prefix), 1e-12f);
  const float scale = __fmul_rn(fmaxf(__uint_as_float(maxkey), 1e-12f), inv_qmax);

  // count: thread t owns a contiguous run of groups, in flat order
  const int run = (ng + kResThreads - 1) / kResThreads;
  const int i0 = min(ng, (int)threadIdx.x * run), i1 = min(ng, i0 + run);
  unsigned cnt = 0u;
  for (int i = i0; i < i1; ++i) {
    const float4 v = data[i];
    cnt += (fabsf(v.x) >= thr) + (fabsf(v.y) >= thr) + (fabsf(v.z) >= thr) + (fabsf(v.w) >= thr);
  }
  unsigned cta_total;
  unsigned pos = block_scan<kResThreads>(cnt, sh->scratch, &cta_total);
  if (threadIdx.x == 0) sh->cta_total = cta_total;
  cluster.sync();
  unsigned base = 0u, total = 0u;
  for (unsigned r = 0; r < cluster.num_blocks(); ++r) {
    const unsigned c = *cluster.map_shared_rank(&sh->cta_total, r);
    base += r < rank ? c : 0u;
    total += c;
  }
  pos += base;

  // quantize the kept entries and write them in flat order
  int32_t* idx = reinterpret_cast<int32_t*>(out + 4);
  int8_t* val = reinterpret_cast<int8_t*>(out + 4 + 4 * (size_t)total);
  if (i0 < i1) L = leaf_of(t, g_lo + i0);
  for (int i = i0; i < i1; ++i) {
    const long long g = g_lo + i;
    while (g >= t.goff[L + 1]) ++L;
    const uint32_t flat0 = (uint32_t)(t.foff[L] + (g - t.goff[L]) * 4);
    const float4 v = data[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = lane_of(v, j);
      if (fabsf(x) >= thr) {
        idx[pos] = (int32_t)(flat0 + j);
        val[pos] = quant_value(x, flat0 + j, scale, seed);
        ++pos;
      }
    }
  }
  if (rank == 0 && threadIdx.x == 0) {
    *reinterpret_cast<unsigned*>(out) = total;
    store_scale(out + 4 + 5 * (size_t)total, scale);
  }
  cluster.sync();                         // no CTA leaves while another reads its shared memory
}

// The last block of a streaming launch to finish: true in every thread
// of that block.  All threads' device-memory writes precede the ticket.
__device__ bool last_block(unsigned* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Histogram pass D over the update (D = 0, 1), or over the candidates
// pass 1 gathered (D = 2, unless they overflowed).  Pass 1 also counts,
// per block, the keys above the first digit's bin, and gathers the keys
// in it (the candidates) into one run a block.
template <int D>
__global__ void __launch_bounds__(kThreads)
stream_hist(const __grid_constant__ Leaves t, unsigned k, float inv_qmax, const StreamScratch sc) {
  constexpr int nbins = D == 0 ? kBins0 : kBins;
  __shared__ unsigned h[nbins];
  __shared__ unsigned scratch[32], sel[2];
  __shared__ unsigned cand[D == 1 ? kBlockCand : 1];
  __shared__ unsigned ncand, cand_base;
  StreamState* st = sc.st;
  for (int i = threadIdx.x; i < nbins; i += kThreads) h[i] = 0u;
  if (threadIdx.x == 0) ncand = 0u;
  __syncthreads();
  const long long Q = t.goff[t.count];
  const unsigned prefix = D == 0 ? 0u : st->prefix;
  const unsigned lane = threadIdx.x & 31;
  unsigned lmax = 0u, above = 0u;
  if (D == 2 && !st->overflow) {
    const long long nc = st->ncand;
    for (long long base = (long long)blockIdx.x * kThreads; base < nc;
         base += (long long)gridDim.x * kThreads) {
      const long long i = base + threadIdx.x;
      const unsigned key = i < nc ? sc.cand[i] : 0u;
      unsigned bin;
      const bool in = digit_of<2>(key, prefix, &bin) && i < nc;
      hist_add(h, bin, in);
    }
  } else {
    const long long g_block = (long long)blockIdx.x * kBlockGroups;
    int L = leaf_of(t, min(g_block + threadIdx.x * kUnroll, Q - 1));
    for (int s = 0; s < kBlockGroups / (kThreads * kUnroll); ++s) {
      const long long g0 = g_block + ((long long)s * kThreads + threadIdx.x) * kUnroll;
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        uint32_t f;
        v[u] = g0 + u < Q ? load_group(t, g0 + u, L, &f) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned key = key_of(lane_of(v[u], j));
          unsigned bin;
          const bool in = digit_of<D>(key, prefix, &bin);
          if (D == 0) lmax = max(lmax, key);
          hist_add(h, bin, in);
          if (D == 1) {
            above += (key >> 20) > (prefix >> 20);
            const unsigned m = __ballot_sync(0xFFFFFFFFu, in);
            if (m) {
              unsigned base = 0u;
              if (lane == __ffs(m) - 1) base = atomicAdd(&ncand, __popc(m));
              base = __shfl_sync(0xFFFFFFFFu, base, __ffs(m) - 1);
              const unsigned pos = base + __popc(m & ((1u << lane) - 1u));
              if (in && pos < kBlockCand) cand[pos] = key;
            }
          }
        }
      }
    }
  }
  if (D == 0) {
    lmax = __reduce_max_sync(0xFFFFFFFFu, lmax);
    if (lane == 0 && lmax) atomicMax(&st->maxkey, lmax);
  }
  if (D == 1) {
    unsigned total_above;
    block_scan<kThreads>(above, scratch, &total_above);   // ends in __syncthreads
    if (threadIdx.x == 0) {
      unsigned base = 0u;
      if (ncand > kBlockCand) {
        atomicOr(&st->overflow, 1u);
      } else {
        base = atomicAdd(&st->ncand, ncand);
        if ((unsigned long long)base + ncand > sc.cand_cap) atomicOr(&st->overflow, 1u);
      }
      cand_base = base;
      sc.blockcnt[blockIdx.x] = total_above;
      sc.segbase[blockIdx.x] = base;
      sc.segcnt[blockIdx.x] = ncand;
    }
    __syncthreads();
    if (ncand <= kBlockCand && (unsigned long long)cand_base + ncand <= sc.cand_cap)
      for (unsigned i = threadIdx.x; i < ncand; i += kThreads) sc.cand[cand_base + i] = cand[i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nbins; i += kThreads)
    if (h[i]) atomicAdd(&st->hist[i], h[i]);
  if (!last_block(&st->ticket)) return;

  // the last block selects this digit's bin and clears the histogram
  constexpr int per = nbins / kThreads;
  unsigned hb[per];
#pragma unroll
  for (int j = 0; j < per; ++j) {
    hb[j] = __ldcg(&st->hist[threadIdx.x * per + j]);
    st->hist[threadIdx.x * per + j] = 0u;
  }
  const unsigned krem = D == 0 ? k : st->krem;
  select_bin<kThreads, per>(hb, krem, scratch, sel);
  if (threadIdx.x == 0) {
    const unsigned p = prefix | (sel[0] << shift_of(D));
    st->prefix = p;
    st->krem = sel[1];
    st->ticket = 0u;
    if (D == 2) {
      st->thr = fmaxf(__uint_as_float(p), 1e-12f);
      st->scale = __fmul_rn(fmaxf(__uint_as_float(__ldcg(&st->maxkey)), 1e-12f), inv_qmax);
      st->maxkey = 0u;
    }
  }
}

// This thread's kUnroll groups of a streaming step, and how many of their
// keys reach the threshold key.
__device__ __forceinline__ unsigned stream_keep(const Leaves& t, long long g0, long long Q,
                                                unsigned thr_key, int& L, float4 (&v)[kUnroll],
                                                uint32_t (&flat0)[kUnroll]) {
  unsigned cnt = 0u;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    v[u] = g0 + u < Q ? load_group(t, g0 + u, L, &flat0[u]) : make_float4(0.f, 0.f, 0.f, 0.f);
    cnt += (key_of(v[u].x) >= thr_key) + (key_of(v[u].y) >= thr_key) +
           (key_of(v[u].z) >= thr_key) + (key_of(v[u].w) >= thr_key);
  }
  return cnt;
}

// blockcnt[b] = kept entries of block b: its keys above the first digit's
// bin plus its candidates at or above the threshold key, or, when the
// candidates overflowed or the 1e-12 clamp raised the threshold, a count
// over its slice of the update.  The last block turns the counts into
// exclusive offsets and writes the header count and the scale.
__global__ void __launch_bounds__(kThreads)
stream_count(const __grid_constant__ Leaves t, const StreamScratch sc, uint8_t* __restrict__ out) {
  __shared__ unsigned scratch[32];
  StreamState* st = sc.st;
  const long long Q = t.goff[t.count];
  const unsigned thr_key = __float_as_uint(st->thr);
  const bool from_cand = !st->overflow && thr_key == st->prefix;
  unsigned cnt = 0u;
  if (from_cand) {
    const unsigned base = sc.segbase[blockIdx.x], n = sc.segcnt[blockIdx.x];
    for (unsigned i = threadIdx.x; i < n; i += kThreads) cnt += sc.cand[base + i] >= thr_key;
  } else {
    const long long g_block = (long long)blockIdx.x * kBlockGroups;
    int L = leaf_of(t, min(g_block + threadIdx.x * kUnroll, Q - 1));
    for (int s = 0; s < kBlockGroups / (kThreads * kUnroll); ++s) {
      float4 v[kUnroll];
      uint32_t f[kUnroll];
      cnt += stream_keep(t, g_block + ((long long)s * kThreads + threadIdx.x) * kUnroll, Q,
                         thr_key, L, v, f);
    }
  }
  unsigned total;
  block_scan<kThreads>(cnt, scratch, &total);
  if (threadIdx.x == 0) sc.blockcnt[blockIdx.x] = total + (from_cand ? sc.blockcnt[blockIdx.x] : 0u);
  if (!last_block(&st->ticket)) return;

  // exclusive scan over the blocks' counts, a run of them a thread
  const int nb = gridDim.x, run = (nb + kThreads - 1) / kThreads;
  const int b0 = min(nb, (int)threadIdx.x * run), b1 = min(nb, b0 + run);
  unsigned mine = 0u;
  for (int b = b0; b < b1; ++b) mine += __ldcg(&sc.blockcnt[b]);
  unsigned off = block_scan<kThreads>(mine, scratch, &total);
  for (int b = b0; b < b1; ++b) {
    const unsigned c = __ldcg(&sc.blockcnt[b]);
    sc.blockcnt[b] = off;
    off += c;
  }
  if (threadIdx.x == 0) {
    st->total = total;
    st->ticket = 0u;
    st->ncand = 0u;
    st->overflow = 0u;
    *reinterpret_cast<unsigned*>(out) = total;
    store_scale(out + 4 + 5 * (size_t)total, st->scale);
  }
}

__global__ void __launch_bounds__(kThreads)
stream_compact(const __grid_constant__ Leaves t, const StreamScratch sc, uint32_t seed,
               uint8_t* __restrict__ out) {
  __shared__ unsigned scratch[32];
  const StreamState* st = sc.st;
  const long long Q = t.goff[t.count];
  const float scale = st->scale;
  const unsigned thr_key = __float_as_uint(st->thr);
  int32_t* idx = reinterpret_cast<int32_t*>(out + 4);
  int8_t* val = reinterpret_cast<int8_t*>(out + 4 + 4 * (size_t)st->total);
  const long long g_block = (long long)blockIdx.x * kBlockGroups;
  int L = leaf_of(t, min(g_block + threadIdx.x * kUnroll, Q - 1));
  unsigned base = sc.blockcnt[blockIdx.x];
  for (int s = 0; s < kBlockGroups / (kThreads * kUnroll); ++s) {
    float4 v[kUnroll];
    uint32_t flat0[kUnroll];
    const unsigned cnt = stream_keep(
        t, g_block + ((long long)s * kThreads + threadIdx.x) * kUnroll, Q, thr_key, L, v, flat0);
    unsigned step_total;
    unsigned pos = base + block_scan<kThreads>(cnt, scratch, &step_total);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = lane_of(v[u], j);
        if (key_of(x) >= thr_key) {
          idx[pos] = (int32_t)(flat0[u] + j);
          val[pos] = quant_value(x, flat0[u] + j, scale, seed);
          ++pos;
        }
      }
    }
    base += step_total;
  }
}

int set_resident_smem() {
  static int done = 0;
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      encode_resident, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kResSmem);
  if (err == cudaSuccess) done = 1;
  return (int)err;
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

// ptrs, numel: nleaves fp32 leaves (contiguous, each non-empty) in
// tree-flatten order, n = sum(numel) < 2^32; 1 <= k <= n.  cluster: the
// resident route's CTAs (1, 2, 4 or 8; the groups must fit), or 0 for
// the streaming route, whose state holds the StreamState words (zero at
// rest), three words a block and cand_cap candidate words.  out:
// 8 + 5 n bytes; on return (stream order) it holds
// [count | idx | val | scale].  Returns the first CUDA error of the
// launches (0 on success).
extern "C" int topk_int8_encode(const float* const* ptrs, const long long* numel, int nleaves,
                                unsigned k, uint32_t seed, float inv_qmax, int cluster,
                                uint8_t* out, unsigned* state, unsigned cand_cap,
                                void* stream) {
  if (nleaves < 1 || nleaves > kMaxLeaves) return (int)cudaErrorInvalidValue;
  Leaves t = {};
  t.count = nleaves;
  t.goff[0] = 0;
  long long flat = 0;
  for (int i = 0; i < nleaves; ++i) {
    if (numel[i] < 1) return (int)cudaErrorInvalidValue;
    t.ptr[i] = ptrs[i];
    t.numel[i] = numel[i];
    t.foff[i] = flat;
    flat += numel[i];
    t.goff[i + 1] = t.goff[i] + (numel[i] + 3) / 4;
  }
  const long long Q = t.goff[nleaves];
  if (flat >= (1LL << 32) || k < 1 || (long long)k > flat) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  if (cluster > 0) {
    if (cluster > kMaxCluster || (cluster & (cluster - 1)) ||
        Q > (long long)cluster * kResGroups)
      return (int)cudaErrorInvalidValue;
    int err = set_resident_smem();
    if (err) return err;
    const long long per_cta = (Q + cluster - 1) / cluster;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)cluster);
    cfg.blockDim = dim3(kResThreads);
    cfg.dynamicSmemBytes = (size_t)per_cta * 16 + sizeof(ResidentShared);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = (int)cudaLaunchKernelEx(&cfg, encode_resident, t, per_cta, k, seed, inv_qmax, out);
    if (err) return err;
    return (int)cudaGetLastError();
  }

  const unsigned blocks = (unsigned)((Q + kBlockGroups - 1) / kBlockGroups);
  StreamScratch sc;
  sc.st = reinterpret_cast<StreamState*>(state);
  sc.blockcnt = state + sizeof(StreamState) / 4;
  sc.segbase = sc.blockcnt + blocks;
  sc.segcnt = sc.segbase + blocks;
  sc.cand = sc.segcnt + blocks;
  sc.cand_cap = cand_cap;
  stream_hist<0><<<blocks, kThreads, 0, s>>>(t, k, inv_qmax, sc);
  stream_hist<1><<<blocks, kThreads, 0, s>>>(t, k, inv_qmax, sc);
  stream_hist<2><<<blocks, kThreads, 0, s>>>(t, k, inv_qmax, sc);
  stream_count<<<blocks, kThreads, 0, s>>>(t, sc, out);
  stream_compact<<<blocks, kThreads, 0, s>>>(t, sc, seed, out);
  return (int)cudaGetLastError();
}
