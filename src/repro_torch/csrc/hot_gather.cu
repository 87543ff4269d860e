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
// What the design does about it: the TPU kernel pinned the hot prefix in
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
// C interface for ctypes: every entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// Raw bits -> float: f32 as is, bf16 as the upper half of an f32.
__device__ __forceinline__ float to_float(uint32_t bits) { return __uint_as_float(bits); }
__device__ __forceinline__ float to_float(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
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
// [b*spt, (b+1)*spt); no other block writes them, so there are no atomics.
// Edges are CSR-sorted by destination within a tile (padding, idx = -1,
// follows), so thread (s, c) sums its segment's run in edge order: the
// result is deterministic. A pass over the tile first records, per local
// segment, the first and last edge that names it; the sum then walks only
// that range and skips edges of other segments, which keeps it exact for
// any order of the tile's edges.
template <typename W>
__global__ void gather_segsum_kernel(const W* __restrict__ hot, const int32_t* __restrict__ idx,
                                     const int32_t* __restrict__ seg, float* __restrict__ out,
                                     int32_t tile_e, int32_t spt, int32_t d, int32_t H) {
  extern __shared__ int32_t smem[];
  int32_t* first = smem;             // [spt]
  int32_t* last = first + spt;       // [spt]
  int32_t* t_seg = last + spt;       // [tile_e] local segment of each edge
  int32_t* t_idx = t_seg + tile_e;   // [tile_e]

  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile_e;
  const int32_t seg0 = blockIdx.x * spt;
  for (int s = threadIdx.x; s < spt; s += blockDim.x) {
    first[s] = tile_e;
    last[s] = -1;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < tile_e; k += blockDim.x) {
    const int32_t ls = __ldcs(seg + base + k) - seg0;
    t_seg[k] = ls;
    t_idx[k] = __ldcs(idx + base + k);
    if (ls >= 0 && ls < spt) {
      atomicMin(first + ls, k);
      atomicMax(last + ls, k);
    }
  }
  __syncthreads();

  const uint64_t policy = evict_last_policy();
  for (int p = threadIdx.x; p < spt * d; p += blockDim.x) {
    const int s = p / d;
    const int c = p - s * d;
    float acc = 0.f;
    for (int k = first[s]; k <= last[s]; ++k) {
      const int32_t v = t_idx[k];
      if (t_seg[k] == s && v >= 0 && v < H)
        acc += to_float(ld_hot(hot + static_cast<int64_t>(v) * d + c, policy));
    }
    out[static_cast<int64_t>(seg0 + s) * d + c] = acc;
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

template <typename W>
int launch_gather_segsum(const void* hot, const void* idx, const void* seg, void* out,
                         int32_t num_tiles, int32_t tile_e, int32_t spt, int32_t d, int32_t H,
                         void* stream) {
  if (num_tiles > 0) {
    const size_t smem = (2 * static_cast<size_t>(spt) + 2 * static_cast<size_t>(tile_e)) *
                        sizeof(int32_t);
    cudaFuncSetAttribute(gather_segsum_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    gather_segsum_kernel<W><<<num_tiles, 256, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const W*>(hot), static_cast<const int32_t*>(idx),
        static_cast<const int32_t*>(seg), static_cast<float*>(out), tile_e, spt, d, H);
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
