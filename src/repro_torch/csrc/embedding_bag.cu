// Hot-cached embedding bag (K3) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _bag_kernel of
// src/repro/kernels/embedding_bag/embedding_bag.py (launched by
// hot_bag_hot_part) and, in its two-tier mode, the cold fixup of the JAX
// package's ops.hot_bag as well. Over a (V, d) table whose rows [0, H) are
// hot, bag b of the (B, hlen) ids and mask is
//   out[b] = hot_sum + cold_sum, in float32, where
//   hot_sum  adds table[id] over masked-in positions with 0 <= id < H,
//   cold_sum adds table[id] over masked-in positions with H <= id < V, and
//            a NaN for each masked-in id >= V (jnp.take's fill),
// each sum taken one position after the other in history order. A negative
// or masked-out id adds nothing; given each position's inclusive rank among
// the masked-in ids >= H in flat order, a cold position ranked past the cold
// capacity adds nothing. That is the JAX route's `out + fix`: its kernel's
// hot sum plus the capacity-bounded, compacted cold gather summed per bag.
// The hot-part mode (hot_bag_hot_part) is the same kernel with V = H and no
// NaN: every id outside [0, H) adds nothing, as the TPU kernel computes.
//
// What bounds it: bytes, in principle. The least traffic is the ids and
// mask read once, the output written once and each distinct referenced row
// read once (at MIND's serve_bulk: 262,144 bags x 50, d = 64, about 0.09 ms
// on the card). But a bag sum re-reads popular rows many times over: at
// serve_bulk 8.5M hot references of 256 B each, 2.2 GB of row reads against
// 49 MB of distinct hot rows, most of them hits in L1 and L2. So in practice
// the kernel is bound by how many loads and instructions the SMs issue per
// position, and by how many warps are resident to cover the latency of the
// loads that miss; the cold rows (3.3M references, half a million distinct
// rows) add reads from device memory.
//
// What the design does about it:
// - Tiers by L2 hint, in one launch. The TPU kernel pinned the hot prefix
//   as a constant-index VMEM block and left the cold rows to a compaction
//   pass over HBM. Both tiers lie in one device memory here, behind a 50 MB
//   L2 that takes per-load eviction hints, and the port's default hot
//   region is sized to it. So hot-row loads carry an L2 evict_last policy,
//   cold-row loads evict_first (two predicated loads, each with one policy
//   for the whole warp), and the ids, the mask and the output stream through
//   with evict-first (.cs) loads and stores. The capacity rule needs only
//   each cold position's rank, a device-side scan the caller makes, read
//   only where an id is cold: no compaction, no host sync, no atomics, and a
//   deterministic order.
// - A group of G lanes owns one bag (G = 16 at d = 64 f32: half a warp);
//   lane g owns the row's 16-byte slices g, g + G, ... The group loads G of
//   its bag's ids and mask bytes at a time, coalesced, each lane resolving
//   one, and passes each resolved id round by shuffle. The loop over those
//   positions has no branch in its body (predicated loads, predicated adds,
//   a NaN noted in a flag and added to the cold sum at the end, which leaves
//   it NaN as an add in place would), so ptxas, with the loop unrolled,
//   issues the next positions' row loads before this one's adds; the adds,
//   and so the bits, stay in position order. The hot-part mode is its own
//   instance with no cold code, unrolled 4 (32 registers, as the earlier
//   kernel); the two-tier mode, which holds two accumulators and issues two
//   load instructions a position, is unrolled 2: more registers would cost
//   resident warps.
//   scripts/k3_layouts.py times this against other layouts at serve_bulk:
//   an explicit batch of 2, 4 or 8 positions' loads in registers before
//   their adds, with branches or predicated, 8 or 4 lanes a bag with 2 or 4
//   slices a lane, register caps, L2 policies chosen per lane, one policy
//   for all rows, no hint, cold rows prefetched into L2, and the earlier
//   kernel (one position at a time).
// - Rows whose width is not a multiple of 16 bytes are not 16-byte aligned,
//   so for them (and unaligned tables) each lane loads single elements. No
//   padding of d or B (the TPU padded d to 128 lanes and B to its 256-bag
//   tile).
//
// C interface for ctypes: every entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// Row loads, raw bits: ld_row with one L2 policy; ld_tier a hot row with
// evict_last where hot holds and a cold row with evict_first where cold
// holds, as two predicated loads, each with one policy for every lane (a
// policy chosen per lane would have to be made uniform for each load).
// Where ld_tier loads nothing its result is undefined; the caller adds it
// only under the same predicates.
__device__ __forceinline__ uint32_t ld_row(const uint32_t* p, uint64_t policy) {
  uint32_t v;
  asm volatile("ld.global.L2::cache_hint.b32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ uint32_t ld_tier(const uint32_t* p, bool hot, bool cold,
                                            uint64_t keep, uint64_t pass) {
  uint32_t v;
  asm volatile(
      "{\n\t.reg .pred ph, pc;\n\tsetp.ne.b32 ph, %1, 0;\n\tsetp.ne.b32 pc, %2, 0;\n\t"
      "@ph ld.global.L2::cache_hint.b32 %0, [%3], %4;\n\t"
      "@pc ld.global.L2::cache_hint.b32 %0, [%3], %5;\n\t}"
      : "=r"(v)
      : "r"(static_cast<int>(hot)), "r"(static_cast<int>(cold)), "l"(p), "l"(keep), "l"(pass));
  return v;
}

__device__ __forceinline__ uint16_t ld_row(const uint16_t* p, uint64_t policy) {
  uint16_t v;
  asm volatile("ld.global.L2::cache_hint.b16 %0, [%1], %2;" : "=h"(v) : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ uint16_t ld_tier(const uint16_t* p, bool hot, bool cold,
                                            uint64_t keep, uint64_t pass) {
  uint16_t v;
  asm volatile(
      "{\n\t.reg .pred ph, pc;\n\tsetp.ne.b32 ph, %1, 0;\n\tsetp.ne.b32 pc, %2, 0;\n\t"
      "@ph ld.global.L2::cache_hint.b16 %0, [%3], %4;\n\t"
      "@pc ld.global.L2::cache_hint.b16 %0, [%3], %5;\n\t}"
      : "=h"(v)
      : "r"(static_cast<int>(hot)), "r"(static_cast<int>(cold)), "l"(p), "l"(keep), "l"(pass));
  return v;
}

__device__ __forceinline__ uint4 ld_row(const uint4* p, uint64_t policy) {
  uint4 v;
  asm volatile("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ uint4 ld_tier(const uint4* p, bool hot, bool cold, uint64_t keep,
                                         uint64_t pass) {
  uint4 v;
  asm volatile(
      "{\n\t.reg .pred ph, pc;\n\tsetp.ne.b32 ph, %4, 0;\n\tsetp.ne.b32 pc, %5, 0;\n\t"
      "@ph ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%6], %7;\n\t"
      "@pc ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%6], %8;\n\t}"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "r"(static_cast<int>(hot)), "r"(static_cast<int>(cold)), "l"(p), "l"(keep), "l"(pass));
  return v;
}

// Add one loaded piece of a row to a lane's accumulators: a 16-byte slice
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

// What a position resolves to: a row to load (>= 0), nothing or a NaN.
constexpr int32_t kNothing = -1;
constexpr int32_t kNaN = -2;

struct Tiers {
  const int32_t* rank;  // inclusive rank of each cold position in flat order, or null
  int32_t H;            // rows [0, H) are hot: loads carry evict_last, sums go to hot_sum
  int32_t V;            // rows [H, V) are cold: loads carry evict_first, sums go to cold_sum
  int32_t cap;          // with rank: cold positions ranked past cap add nothing
  int32_t past_v;       // what a masked-in id >= V adds: kNaN (two-tier) or kNothing (hot part)
};

__device__ __forceinline__ int32_t resolve(int32_t v, bool m, int64_t pos, const Tiers& t) {
  if (!m || v < 0) return kNothing;
  if (v < t.H) return v;
  if (t.rank != nullptr && __ldg(t.rank + pos) > t.cap) return kNothing;
  return v < t.V ? v : t.past_v;
}

// K3. W is the table's raw element (uint32_t for f32, uint16_t for bf16);
// G lanes own one bag; kVec: 16-byte slices (d a multiple of 16 / sizeof(W));
// kTwoTier: the two-tier mode (cold rows, a cold sum, NaN), else the hot
// part; kUnroll: the position loop's unroll, 4 as the earlier kernel had it
// from the compiler, 2 for the two-tier mode's larger body.
template <typename W, int G, bool kVec, bool kTwoTier, int kUnroll = kTwoTier ? 2 : 4>
__global__ void __launch_bounds__(kThreads) hot_bag_kernel(
    const W* __restrict__ table, const int32_t* __restrict__ ids,
    const uint8_t* __restrict__ mask, float* __restrict__ out, int64_t B, int32_t hlen,
    int32_t d, Tiers t) {
  constexpr int kPer = kVec ? 16 / static_cast<int>(sizeof(W)) : 1;
  using Piece = typename std::conditional<kVec, uint4, W>::type;
  const int g = threadIdx.x & (G - 1);
  const int64_t bag = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / G;
  const bool live = bag < B;
  const int64_t base = live ? bag * hlen : 0;
  const int nslice = d / kPer;  // a row's length in Pieces
  const uint64_t keep = evict_last_policy();
  const uint64_t pass = evict_first_policy();
  // every lane of the warp runs the same trip counts: the shuffles need them all
  for (int c0 = 0; c0 < nslice; c0 += G) {
    const int c = c0 + g;
    const bool mine = live && c < nslice;
    // a resolved id v is hot where v < hot_lim and cold where v - H < cold_lim,
    // as unsigned numbers (negative codes are huge); both 0 for a lane past the row
    const uint32_t hot_lim = mine ? t.H : 0;
    const uint32_t cold_lim = mine ? t.V - t.H : 0;
    const Piece* col = reinterpret_cast<const Piece*>(table) + c;
    float hot[kPer] = {}, cold[kPer] = {};
    bool nan_seen = false;
    for (int h0 = 0; h0 < hlen; h0 += G) {
      int32_t id = kNothing;
      if (live && h0 + g < hlen)
        id = resolve(__ldcs(ids + base + h0 + g), __ldcs(mask + base + h0 + g) != 0,
                     base + h0 + g, t);
      const int n = min(G, hlen - h0);
      // no branch in the body: ptxas issues the next positions' loads before
      // this one's adds, and the adds stay in position order
#pragma unroll kUnroll
      for (int j = 0; j < n; ++j) {
        const uint32_t v =
            static_cast<uint32_t>(G > 1 ? __shfl_sync(0xffffffffu, id, j, G) : id);
        const bool is_hot = v < hot_lim;
        const Piece* p = col + static_cast<uint64_t>(v) * nslice;
        if constexpr (kTwoTier) {
          const bool is_cold = v - static_cast<uint32_t>(t.H) < cold_lim;
          const Piece x = ld_tier(p, is_hot, is_cold, keep, pass);
          if (is_hot) add_to(hot, x, W{});
          if (is_cold) add_to(cold, x, W{});
          nan_seen |= v == static_cast<uint32_t>(kNaN);
        } else {  // every resolved id is hot, or kNothing
          if (is_hot) add_to(hot, ld_row(p, keep), W{});
        }
      }
    }
    if (mine) {
      // a NaN added to the cold sum at any position leaves it NaN, as here
      const float nan = __uint_as_float(0x7fc00000u);  // torch's quiet NaN
#pragma unroll
      for (int k = 0; k < kPer; ++k) hot[k] += nan_seen ? cold[k] + nan : cold[k];
      float* o = out + bag * d + static_cast<int64_t>(c) * kPer;
      if constexpr (kVec) {
#pragma unroll
        for (int k = 0; k < kPer / 4; ++k)
          __stcs(reinterpret_cast<float4*>(o) + k,
                 make_float4(hot[4 * k], hot[4 * k + 1], hot[4 * k + 2], hot[4 * k + 3]));
      } else {
        __stcs(o, hot[0]);
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename W, int G, bool kVec>
void launch_g(const void* table, const void* ids, const void* mask, void* out, int64_t B,
              int32_t hlen, int32_t d, const Tiers& t, cudaStream_t stream) {
  const int64_t bags_per_block = kThreads / G;
  const unsigned blocks = static_cast<unsigned>((B + bags_per_block - 1) / bags_per_block);
  const auto* tab = static_cast<const W*>(table);
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<float*>(out);
  if (t.past_v == kNaN)
    hot_bag_kernel<W, G, kVec, true><<<blocks, kThreads, 0, stream>>>(tab, i, m, o, B, hlen,
                                                                      d, t);
  else
    hot_bag_kernel<W, G, kVec, false><<<blocks, kThreads, 0, stream>>>(tab, i, m, o, B, hlen,
                                                                       d, t);
}

template <typename W, bool kVec>
void launch_vec(int group, const void* table, const void* ids, const void* mask, void* out,
                int64_t B, int32_t hlen, int32_t d, const Tiers& t, cudaStream_t st) {
  switch (group) {
    case 1: launch_g<W, 1, kVec>(table, ids, mask, out, B, hlen, d, t, st); break;
    case 2: launch_g<W, 2, kVec>(table, ids, mask, out, B, hlen, d, t, st); break;
    case 4: launch_g<W, 4, kVec>(table, ids, mask, out, B, hlen, d, t, st); break;
    case 8: launch_g<W, 8, kVec>(table, ids, mask, out, B, hlen, d, t, st); break;
    case 16: launch_g<W, 16, kVec>(table, ids, mask, out, B, hlen, d, t, st); break;
    default: launch_g<W, 32, kVec>(table, ids, mask, out, B, hlen, d, t, st); break;
  }
}

template <typename W>
int launch_hot_bag(const void* table, const void* ids, const void* mask, const void* rank,
                   void* out, int64_t B, int32_t hlen, int32_t d, int32_t H, int32_t V,
                   int32_t cap, int32_t nan_past_v, void* stream) {
  if (B > 0 && d > 0) {
    const Tiers t{static_cast<const int32_t*>(rank), H, V, cap, nan_past_v ? kNaN : kNothing};
    constexpr int kPer = 16 / static_cast<int>(sizeof(W));  // elements in 16 bytes
    const bool vec = d % kPer == 0 && aligned16(table) && aligned16(out);
    const int nslice = vec ? d / kPer : d;
    int group = 1;  // the smallest power of two covering the row's slices, at most a warp
    while (group < nslice && group < 32) group <<= 1;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec)
      launch_vec<W, true>(group, table, ids, mask, out, B, hlen, d, t, st);
    else
      launch_vec<W, false>(group, table, ids, mask, out, B, hlen, d, t, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* cuda_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

// K3 over the (V, d) table: rows [0, H) hot, [H, V) cold. The hot part
// passes V = H and nan_past_v = 0; rank is null or the (B, hlen) inclusive
// rank of each masked-in id >= H in flat order, with those ranked past cap
// adding nothing.
int hot_bag_f32(const void* table, const void* ids, const void* mask, const void* rank,
                void* out, int64_t B, int32_t hlen, int32_t d, int32_t H, int32_t V,
                int32_t cap, int32_t nan_past_v, void* stream) {
  return launch_hot_bag<uint32_t>(table, ids, mask, rank, out, B, hlen, d, H, V, cap,
                                  nan_past_v, stream);
}

int hot_bag_bf16(const void* table, const void* ids, const void* mask, const void* rank,
                 void* out, int64_t B, int32_t hlen, int32_t d, int32_t H, int32_t V,
                 int32_t cap, int32_t nan_past_v, void* stream) {
  return launch_hot_bag<uint16_t>(table, ids, mask, rank, out, B, hlen, d, H, V, cap,
                                  nan_past_v, stream);
}

}  // extern "C"
