// GRASP hot-region gather kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/hot_gather/hot_gather.py:
//   K1 hot_gather        <- _hot_gather_kernel   (launched by hot_gather_hot_part
//                                                 and hot_gather_two_tier)
//   K2 gather_segsum     <- _gather_seg_kernel   (launched by hot_gather_segment_sum)
//
// What bounds them: bytes. A gather does no arithmetic (K2 adds one float
// per gathered element), so the least time is the index stream read once,
// the output written once and each referenced row read once, over the
// 3.35 TB/s of device memory. What costs more than that bound is re-reading
// hot rows from device memory after they were evicted from L2, and, at the
// small launches of the serving cache, the fixed cost of a launch.
//
// What K1's design does about it: the TPU kernel pinned the hot prefix in
// VMEM as a constant-index block and left the cold rows to a separate
// fixup pass over HBM. Hopper has no software-managed memory of that size,
// but both tiers live in one device memory behind a 50 MB L2 that takes
// per-load eviction hints, which is the paper's own setting (an LLC steered
// by software reuse hints). So one launch reads both tiers: loads from the
// High Reuse Region [0, H) carry an L2 evict_last policy (GRASP's insertion
// rule as a hint), loads of cold rows [H, N) an evict_first policy, and the
// index and output streams pass through with evict-first (.cs) loads and
// stores. The hot-part mode (hot_gather_hot_part) is the same kernel with
// N = H: every index outside [0, H) gives zeros. The two-tier mode
// (hot_gather_two_tier) gives zeros for a negative index and NaN for one
// >= N, and, given each cold index's inclusive rank in flat order, zeros
// for cold indices ranked past the cold capacity. Either way it does no
// arithmetic on the values, so it is bit-exact.
//
// Three layouts of the row, one kernel each, chosen per launch:
//   d == 1: one edge a thread, and a grid that covers E in one pass, so
//     every SM is full with no grid-stride loop; each warp's index load,
//     row load and store cover 32 consecutive edges.
//     scripts/k1_d1_layouts.py times this layout on the card against the
//     earlier grid-stride loop, 2, 4 and 8 edges a thread interleaved across
//     the warp, 4 and 8 consecutive edges a thread with 16-byte index
//     loads and stores, and loads without L2 hints.
//   rows of a 16-byte multiple (d % 4 == 0 f32, d % 8 == 0 bf16, aligned):
//     a power-of-two group of G lanes owns one row; its first lane loads
//     and resolves the index and shuffles it to the group, and each lane
//     moves 16-byte slices. Index arithmetic is shifts, not division.
//   other d: one element a thread, with 32-bit index arithmetic.
// No padding of d or E: the TPU's 128-lane padding would multiply the
// bytes by 128 for d = 1.
//
// K2's design is set out above gather_segsum_kernel.
//
// C interface for ctypes: every entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 8;  // K2: row loads a lane issues before it adds them

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// Row loads, raw bits, with an L2 cache policy.
__device__ __forceinline__ uint32_t ld_hot(const uint32_t* p, uint64_t policy) {
  uint32_t v;
  asm("ld.global.L2::cache_hint.b32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ uint16_t ld_hot(const uint16_t* p, uint64_t policy) {
  uint16_t v;
  asm("ld.global.L2::cache_hint.b16 %0, [%1], %2;" : "=h"(v) : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ uint4 ld_hot(const uint4* p, uint64_t policy) {
  uint4 v;
  asm("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

// Add one loaded piece of a row to float32 accumulators: a 16-byte slice
// of four f32 or eight bf16 (element 2i in the low half of word i), or one
// element. bf16 widens to f32 exactly.
__device__ __forceinline__ void add_to(float (&acc)[4], uint4 v, uint32_t) {
  acc[0] += __uint_as_float(v.x);
  acc[1] += __uint_as_float(v.y);
  acc[2] += __uint_as_float(v.z);
  acc[3] += __uint_as_float(v.w);
}

__device__ __forceinline__ void add_to(float (&acc)[8], uint4 v, uint16_t) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] += __uint_as_float(w[i] << 16);
    acc[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void add_to(float (&acc)[1], uint32_t v, uint32_t) {
  acc[0] += __uint_as_float(v);
}

__device__ __forceinline__ void add_to(float (&acc)[1], uint16_t v, uint16_t) {
  acc[0] += __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// The quiet NaN that torch writes for float("nan"), as raw bits.
template <typename W>
__device__ __forceinline__ W nan_bits() {
  return static_cast<W>(sizeof(W) == 4 ? 0x7fc00000u : 0x7fc0u);
}

// What an index resolves to: a row to load (>= 0), zeros or NaN.
constexpr int32_t kZeros = -1;
constexpr int32_t kNaN = -2;

struct Tiers {
  const int32_t* rank;  // inclusive rank of each cold index in flat order, or null
  int32_t H;            // rows [0, H) are hot: loads carry evict_last
  int32_t N;            // rows [H, N) are cold: loads carry evict_first
  int32_t cap;          // with rank: cold indices ranked past cap give zeros
  int32_t past_n;       // what an index >= N gives: kNaN (two-tier) or kZeros (hot part)
};

__device__ __forceinline__ int32_t resolve(int32_t v, int64_t e, const Tiers& t) {
  if (v < 0) return kZeros;
  if (v < t.H) return v;
  if (t.rank != nullptr && __ldg(t.rank + e) > t.cap) return kZeros;
  return v < t.N ? v : t.past_n;
}

// K1, d == 1: thread e gathers edge e.
template <typename W>
__global__ void __launch_bounds__(kThreads) gather_col_kernel(
    const W* __restrict__ table, const int32_t* __restrict__ idx, W* __restrict__ out,
    int64_t E, Tiers t) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= E) return;
  const int32_t c = resolve(__ldcs(idx + e), e, t);
  W x = c == kNaN ? nan_bits<W>() : W(0);
  if (c >= 0) x = ld_hot(table + c, c < t.H ? evict_last_policy() : evict_first_policy());
  __stcs(out + e, x);
}

// K1, rows of S 16-byte slices: a group of G = 2^kLogG lanes owns one row.
// The group's first lane loads and resolves the index and shuffles the
// result to the others; lane g moves slices g, g + G, ...
template <int kLogG>
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const uint4* __restrict__ table, const int32_t* __restrict__ idx, uint4* __restrict__ out,
    int64_t E, int32_t S, uint4 nan, Tiers t) {
  constexpr int G = 1 << kLogG;
  const int g = threadIdx.x & (G - 1);
  const int64_t e = static_cast<int64_t>(blockIdx.x) * (kThreads >> kLogG) +
                    (threadIdx.x >> kLogG);
  int32_t c = kZeros;
  if (g == 0 && e < E) c = resolve(__ldcs(idx + e), e, t);
  // every lane of the warp reaches the shuffle, live or not
  if constexpr (G > 1) c = __shfl_sync(0xffffffffu, c, 0, G);
  if (e >= E) return;
  const uint64_t policy = c < t.H ? evict_last_policy() : evict_first_policy();
  const uint4* src = table + static_cast<int64_t>(c) * S;
  uint4* dst = out + e * S;
  for (int32_t s = g; s < S; s += G)
    __stcs(dst + s, c >= 0 ? ld_hot(src + s, policy) : (c == kNaN ? nan : make_uint4(0, 0, 0, 0)));
}

// K1, any other d: one element a thread. Block b owns rows [b*R, (b+1)*R),
// R = max(1, kThreads / d), so a thread finds its row and column with
// 32-bit arithmetic; each thread resolves its row's index itself.
template <typename W>
__global__ void __launch_bounds__(kThreads) gather_scalar_kernel(
    const W* __restrict__ table, const int32_t* __restrict__ idx, W* __restrict__ out,
    int64_t E, int32_t d, int32_t R, Tiers t) {
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * R;
  const int32_t n = static_cast<int32_t>(E - r0 < R ? E - r0 : R) * d;
  W* dst = out + r0 * d;
  for (int32_t i = threadIdx.x; i < n; i += kThreads) {
    const int32_t r = i / d;
    const int32_t c = resolve(__ldcs(idx + r0 + r), r0 + r, t);
    W x = c == kNaN ? nan_bits<W>() : W(0);
    if (c >= 0)
      x = ld_hot(table + static_cast<int64_t>(c) * d + (i - r * d),
                 c < t.H ? evict_last_policy() : evict_first_policy());
    __stcs(dst + i, x);
  }
}

// K2: fused hot gather + destination segment-sum over the aligned layout of
// ops.build_aligned_edges. Block b owns edge tile b and the output rows
// [b*spt, (b+1)*spt); no other block writes them, so there are no atomics
// on device memory. Edge k of the tile belongs to local segment
// key[k] = seg[k] - b*spt, or to none (key spt) when it is padding (idx < 0)
// or names another block's segment; an edge whose row is not hot (idx >= H)
// keeps its key and adds nothing.
//
// What bounds it: bytes, as for K1 (one add per gathered element). The
// earlier form of this kernel sat at ~10x its bound: a staging pass with
// shared-memory atomics on every edge, one (segment, column) pair a thread
// so that lanes of short runs idled, 4-byte loads, and one row load in
// flight a thread, each behind the last.
//
// The tile is staged in shared memory with its keys, and one block-wide
// vote says whether the keys are sorted, as the layout builds them (CSR
// order, padding last). Sorted: segment s's edges are the run
// [lo[s], lo[s+1]), and each lo[s] is found from its neighbours, by the one
// edge k with key[k-1] < s <= key[k]: one writer each, no atomics. Any
// other order, which the contract allows as the TPU's one-hot product does,
// takes the same kernel's other branch: the first and one-past-last edge of
// each segment by shared-memory atomicMin/atomicMax, and a walk over that
// range that skips edges of other segments.
//
// Then a group of L lanes owns a segment, lane g the row's 16-byte slices
// g, g + L, ... (2 lanes at d = 8 f32, 1 at d = 8 bf16). The group walks
// the segment's range kLoads edges at a time: it reads their indices from
// shared memory, issues all kLoads row loads into registers, then adds them
// in edge order. So each lane has several row loads in flight, the sum is
// taken in edge order on either branch, and the result is deterministic.
//
// Not wgmma: the TPU kernel's one-hot (spt x tile_e) @ (tile_e x d) product
// does spt = 256 times the adds the sum needs, and the tensor cores take
// f32 inputs only as TF32, which keeps about three decimal digits and would
// break the 1e-5 tolerance against the plain f32 sum.
template <typename W, int L, bool kVec>
__global__ void __launch_bounds__(kThreads) gather_segsum_kernel(
    const W* __restrict__ hot, const int32_t* __restrict__ idx,
    const int32_t* __restrict__ seg, float* __restrict__ out, int32_t tile_e, int32_t spt,
    int32_t d, int32_t H) {
  constexpr int kPer = kVec ? 16 / static_cast<int>(sizeof(W)) : 1;
  using Piece = typename std::conditional<kVec, uint4, W>::type;
  extern __shared__ int32_t smem[];
  int32_t* t_key = smem;             // [tile_e] local segment of each edge, spt for none
  int32_t* t_idx = t_key + tile_e;   // [tile_e]
  int32_t* lo = t_idx + tile_e;      // [spt + 1] first edge of each segment's range
  int32_t* hi = lo + spt + 1;        // [spt] one past its last edge (unsorted tiles)

  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile_e;
  const int64_t seg0 = static_cast<int64_t>(blockIdx.x) * spt;
  for (int k = threadIdx.x; k < tile_e; k += kThreads) {
    const int32_t v = __ldcs(idx + base + k);
    const int64_t ls = __ldcs(seg + base + k) - seg0;
    t_idx[k] = v;
    t_key[k] = v >= 0 && ls >= 0 && ls < spt ? static_cast<int32_t>(ls) : spt;
  }
  __syncthreads();
  int in_order = 1;
  for (int k = threadIdx.x + 1; k < tile_e; k += kThreads)
    in_order &= t_key[k - 1] <= t_key[k];
  const bool sorted = __syncthreads_and(in_order);
  if (sorted) {
    // edge k opens the runs of segments (key[k-1], key[k]]; k = tile_e closes the tile
    for (int k = threadIdx.x; k <= tile_e; k += kThreads) {
      const int32_t prev = k == 0 ? -1 : t_key[k - 1];
      const int32_t cur = k == tile_e ? spt : t_key[k];
      for (int32_t s = prev + 1; s <= cur; ++s) lo[s] = k;
    }
  } else {
    for (int s = threadIdx.x; s < spt; s += kThreads) {
      lo[s] = tile_e;
      hi[s] = 0;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < tile_e; k += kThreads) {
      const int32_t s = t_key[k];
      if (s < spt) {
        atomicMin(lo + s, k);
        atomicMax(hi + s, k + 1);
      }
    }
  }
  __syncthreads();

  const int nslice = d / kPer;  // a row's length in Pieces
  const Piece* rows = reinterpret_cast<const Piece*>(hot);
  const uint64_t policy = evict_last_policy();
  const int g = threadIdx.x % L;
  for (int s = threadIdx.x / L; s < spt; s += kThreads / L) {
    const int32_t begin = lo[s];
    const int32_t end = sorted ? lo[s + 1] : hi[s];
    for (int c = g; c < nslice; c += L) {
      float acc[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) acc[k] = 0.f;
      for (int32_t k0 = begin; k0 < end; k0 += kLoads) {
        int32_t v[kLoads];
        Piece x[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int32_t k = k0 + u;
          v[u] = k < end && t_key[k] == s ? t_idx[k] : -1;
          if (v[u] >= H) v[u] = -1;
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u)
          x[u] = v[u] >= 0 ? ld_hot(rows + static_cast<int64_t>(v[u]) * nslice + c, policy)
                           : Piece{};
#pragma unroll
        for (int u = 0; u < kLoads; ++u)
          if (v[u] >= 0) add_to(acc, x[u], W{});
      }
      float* o = out + (seg0 + s) * d + static_cast<int64_t>(c) * kPer;
      if constexpr (kVec) {
#pragma unroll
        for (int k = 0; k < kPer / 4; ++k)
          __stcs(reinterpret_cast<float4*>(o) + k,
                 make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]));
      } else {
        __stcs(o, acc[0]);
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

unsigned blocks_for(int64_t items, int64_t per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

template <int kLogG>
void launch_rows(const void* table, const int32_t* idx, void* out, int64_t E, int32_t S,
                 uint4 nan, const Tiers& t, cudaStream_t st) {
  gather_rows_kernel<kLogG><<<blocks_for(E, kThreads >> kLogG), kThreads, 0, st>>>(
      static_cast<const uint4*>(table), idx, static_cast<uint4*>(out), E, S, nan, t);
}

template <typename W>
int launch_hot_gather(const void* table, const void* idx_v, const void* rank, void* out_v,
                      int64_t E, int32_t d, int32_t H, int32_t N, int32_t cap,
                      int32_t nan_past_n, void* stream) {
  if (E > 0 && d > 0) {
    const Tiers t{static_cast<const int32_t*>(rank), H, N, cap, nan_past_n ? kNaN : kZeros};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const W* tab = static_cast<const W*>(table);
    const int32_t* idx = static_cast<const int32_t*>(idx_v);
    W* out = static_cast<W*>(out_v);
    constexpr int kPer = 16 / static_cast<int>(sizeof(W));  // elements in 16 bytes
    if (d == 1) {
      gather_col_kernel<W><<<blocks_for(E, kThreads), kThreads, 0, st>>>(tab, idx, out, E, t);
    } else if (d % kPer == 0 && aligned16(table) && aligned16(out)) {
      const int32_t S = d / kPer;
      int log_g = 0;  // the smallest power of two covering the row's slices, at most a warp
      while ((1 << log_g) < S && log_g < 5) ++log_g;
      const uint32_t nb = sizeof(W) == 4 ? 0x7fc00000u : 0x7fc07fc0u;
      const uint4 nan = make_uint4(nb, nb, nb, nb);
      switch (log_g) {
        case 0: launch_rows<0>(table, idx, out, E, S, nan, t, st); break;
        case 1: launch_rows<1>(table, idx, out, E, S, nan, t, st); break;
        case 2: launch_rows<2>(table, idx, out, E, S, nan, t, st); break;
        case 3: launch_rows<3>(table, idx, out, E, S, nan, t, st); break;
        case 4: launch_rows<4>(table, idx, out, E, S, nan, t, st); break;
        default: launch_rows<5>(table, idx, out, E, S, nan, t, st); break;
      }
    } else {
      const int32_t R = d >= kThreads ? 1 : kThreads / d;
      gather_scalar_kernel<W><<<blocks_for(E, R), kThreads, 0, st>>>(tab, idx, out, E, d, R, t);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

struct SegsumLaunch {
  const void* hot;
  const void* idx;
  const void* seg;
  void* out;
  int32_t num_tiles, tile_e, spt, d, H;
  size_t smem;
  cudaStream_t stream;
};

template <typename W, int L, bool kVec>
void launch_segsum(const SegsumLaunch& a) {
  auto* kernel = gather_segsum_kernel<W, L, kVec>;
  if (a.smem > 48 * 1024)  // beyond the default, dynamic shared memory must be asked for
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(a.smem));
  kernel<<<a.num_tiles, kThreads, a.smem, a.stream>>>(
      static_cast<const W*>(a.hot), static_cast<const int32_t*>(a.idx),
      static_cast<const int32_t*>(a.seg), static_cast<float*>(a.out), a.tile_e, a.spt, a.d,
      a.H);
}

template <typename W, bool kVec>
void launch_segsum_lanes(int lanes, const SegsumLaunch& a) {
  switch (lanes) {
    case 1: launch_segsum<W, 1, kVec>(a); break;
    case 2: launch_segsum<W, 2, kVec>(a); break;
    case 4: launch_segsum<W, 4, kVec>(a); break;
    case 8: launch_segsum<W, 8, kVec>(a); break;
    case 16: launch_segsum<W, 16, kVec>(a); break;
    default: launch_segsum<W, 32, kVec>(a); break;
  }
}

template <typename W>
int launch_gather_segsum(const void* hot, const void* idx, const void* seg, void* out,
                         int32_t num_tiles, int32_t tile_e, int32_t spt, int32_t d, int32_t H,
                         void* stream) {
  if (num_tiles > 0 && d > 0) {
    const size_t smem = (2 * static_cast<size_t>(tile_e) + 2 * static_cast<size_t>(spt) + 1) *
                        sizeof(int32_t);
    const SegsumLaunch a{hot, idx, seg, out, num_tiles, tile_e, spt, d, H, smem,
                         static_cast<cudaStream_t>(stream)};
    constexpr int kPer = 16 / static_cast<int>(sizeof(W));  // elements in 16 bytes
    const bool vec = d % kPer == 0 && aligned16(hot) && aligned16(out);
    const int nslice = vec ? d / kPer : d;
    int lanes = 1;  // the smallest power of two covering the row's slices, at most a warp
    while (lanes < nslice && lanes < 32) lanes <<= 1;
    if (vec)
      launch_segsum_lanes<W, true>(lanes, a);
    else
      launch_segsum_lanes<W, false>(lanes, a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* cuda_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

// K1 over the (N, d) table: rows [0, H) hot, [H, N) cold. The hot part
// passes N = H and nan_past_n = 0; rank is null or the (E,) inclusive rank
// of each cold index, with cold indices ranked past cap giving zeros.
int hot_gather_f32(const void* table, const void* idx, const void* rank, void* out, int64_t E,
                   int32_t d, int32_t H, int32_t N, int32_t cap, int32_t nan_past_n,
                   void* stream) {
  return launch_hot_gather<uint32_t>(table, idx, rank, out, E, d, H, N, cap, nan_past_n,
                                     stream);
}

int hot_gather_bf16(const void* table, const void* idx, const void* rank, void* out, int64_t E,
                    int32_t d, int32_t H, int32_t N, int32_t cap, int32_t nan_past_n,
                    void* stream) {
  return launch_hot_gather<uint16_t>(table, idx, rank, out, E, d, H, N, cap, nan_past_n,
                                     stream);
}

int gather_segsum_f32(const void* hot, const void* idx, const void* seg, void* out,
                      int32_t num_tiles, int32_t tile_e, int32_t spt, int32_t d, int32_t H,
                      void* stream) {
  return launch_gather_segsum<uint32_t>(hot, idx, seg, out, num_tiles, tile_e, spt, d, H,
                                        stream);
}

int gather_segsum_bf16(const void* hot, const void* idx, const void* seg, void* out,
                       int32_t num_tiles, int32_t tile_e, int32_t spt, int32_t d, int32_t H,
                       void* stream) {
  return launch_gather_segsum<uint16_t>(hot, idx, seg, out, num_tiles, tile_e, spt, d, H,
                                        stream);
}

}  // extern "C"
