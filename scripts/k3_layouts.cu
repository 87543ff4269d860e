// Layouts of K3's inner loop (the hot embedding bag), for
// scripts/k3_layouts.py: MIND's serve_bulk rows (d = 64 f32, 16-byte
// slices), both of K3's modes. Every variant sums each bag's hot rows and
// cold rows into two float32 accumulators in position order, as K3 does
// (src/repro_torch/csrc/embedding_bag.cu), so all give K3's bits, except
// the earlier kernel, which has K3's hot-part sum only.
//
// Variants (template parameters of `bag`):
//   G lanes own a bag, each lane S 16-byte slices of the row (G * S = 16);
//   U positions' row loads are issued before their adds;
//   kPred: predicated loads and selected adds, no branches; else each load
//     and each add sits in a branch, as in K3;
//   kMinBlocks: __launch_bounds__'s minimum of resident blocks per SM,
//     which caps the registers;
//   kHint: how the rows' L2 policies are given (see `bag`).
// Plus `runloop`: a run-time loop over positions, unrolled, with no branch
// in its body; `lean`: the same with fewer instructions a position; `lean2`:
// `lean` without zeroing and with cold rows prefetched into L2; and
// `earlier`: the earlier K3, one position at a time, hot
// part only.
//
// C interface for ctypes: run() returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlices = 16;  // 16-byte slices of a 64-wide f32 row

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

__device__ __forceinline__ uint64_t evict_normal_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint4 ld_row(const uint4* p, uint64_t policy) {
  uint4 v;
  asm volatile("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ uint4 ld_row_nohint(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// A hot row's load with the evict_last policy where hot holds, a cold
// row's with evict_first where cold holds, zeros elsewhere: two predicated
// loads whose policies are the same in every lane.
__device__ __forceinline__ uint4 ld_row_tiers(const uint4* p, bool hot, bool cold,
                                              uint64_t keep, uint64_t pass) {
  uint4 v = make_uint4(0, 0, 0, 0);
  asm volatile(
      "{\n\t.reg .pred ph, pc;\n\tsetp.ne.b32 ph, %4, 0;\n\tsetp.ne.b32 pc, %5, 0;\n\t"
      "@ph ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%6], %7;\n\t"
      "@pc ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%6], %8;\n\t}"
      : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w)
      : "r"(static_cast<int>(hot)), "r"(static_cast<int>(cold)), "l"(p), "l"(keep), "l"(pass));
  return v;
}

// The load only where pred holds; zeros elsewhere, with no branch.
__device__ __forceinline__ uint4 ld_row_if(const uint4* p, bool pred, uint64_t policy) {
  uint4 v = make_uint4(0, 0, 0, 0);
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %4, 0;\n\t"
      "@p ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%5], %6;\n\t}"
      : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w)
      : "r"(static_cast<int>(pred)), "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ void add4(float* acc, uint4 v) {
  acc[0] += __uint_as_float(v.x);
  acc[1] += __uint_as_float(v.y);
  acc[2] += __uint_as_float(v.z);
  acc[3] += __uint_as_float(v.w);
}

__device__ __forceinline__ void add4_if(float* acc, uint4 v, bool pred) {
  acc[0] += pred ? __uint_as_float(v.x) : 0.f;
  acc[1] += pred ? __uint_as_float(v.y) : 0.f;
  acc[2] += pred ? __uint_as_float(v.z) : 0.f;
  acc[3] += pred ? __uint_as_float(v.w) : 0.f;
}

constexpr int32_t kNothing = -1;
constexpr int32_t kNaN = -2;

struct Tiers {
  int32_t H, V, past_v;
};

__device__ __forceinline__ int32_t resolve(int32_t v, bool m, const Tiers& t) {
  if (!m || v < 0) return kNothing;
  if (v < t.H) return v;
  return v < t.V ? v : t.past_v;
}

// kHint: 0 each load's policy chosen per lane (hot evict_last, cold
// evict_first), as K3; 1 evict_last for every row; 2 no hint; 3 (with
// kPred) a hot load and a cold load, each predicated, each with one policy.
template <int G, int S, int U, bool kPred, int kMinBlocks, int kHint = 0>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bag(
    const uint4* __restrict__ table, const int32_t* __restrict__ ids,
    const uint8_t* __restrict__ mask, float* __restrict__ out, int64_t B, int32_t hlen,
    Tiers t) {
  static_assert(G * S == kSlices, "a lane group covers the row");
  constexpr int P = G > U ? G : U;
  const int g = threadIdx.x & (G - 1);
  const int64_t bag = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / G;
  const bool live = bag < B;
  const int64_t base = live ? bag * hlen : 0;
  const uint64_t keep = evict_last_policy(), pass = evict_first_policy();
  const float nan = __uint_as_float(0x7fc00000u);
  float hot[S][4], cold[S][4];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int k = 0; k < 4; ++k) hot[s][k] = cold[s][k] = 0.f;
  for (int h0 = 0; h0 < hlen; h0 += P) {
    int32_t r[P / G];
#pragma unroll
    for (int q = 0; q < P / G; ++q) {
      const int h = h0 + q * G + g;
      r[q] = kNothing;
      if (live && h < hlen) r[q] = resolve(__ldcs(ids + base + h), __ldcs(mask + base + h), t);
    }
#pragma unroll
    for (int j0 = 0; j0 < P; j0 += U) {
      if (h0 + j0 >= hlen) break;
      int32_t id[U];
      uint4 x[U][S];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
        id[u] = G > 1 ? __shfl_sync(0xffffffffu, r[j / G], j % G, G) : r[j / G];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint4* row = table + static_cast<int64_t>(id[u] < 0 ? 0 : id[u]) * kSlices + g;
        const uint64_t policy = id[u] < t.H ? keep : pass;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if constexpr (kHint == 3) {
            x[u][s] = ld_row_tiers(row + s * G, live && id[u] >= 0 && id[u] < t.H,
                                   live && id[u] >= t.H, keep, pass);
          } else if constexpr (kPred) {
            x[u][s] = ld_row_if(row + s * G, live && id[u] >= 0, kHint ? keep : policy);
          } else {
            x[u][s] = make_uint4(0, 0, 0, 0);
            if (live && id[u] >= 0)
              x[u][s] = kHint == 2 ? ld_row_nohint(row + s * G)
                                   : ld_row(row + s * G, kHint ? keep : policy);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if constexpr (kPred) {
            add4_if(hot[s], x[u][s], id[u] >= 0 && id[u] < t.H);
            add4_if(cold[s], x[u][s], id[u] >= t.H);
            if (id[u] == kNaN)
#pragma unroll
              for (int k = 0; k < 4; ++k) cold[s][k] += nan;
          } else if (id[u] >= 0) {
            add4(id[u] < t.H ? hot[s] : cold[s], x[u][s]);
          } else if (id[u] == kNaN) {
#pragma unroll
            for (int k = 0; k < 4; ++k) cold[s][k] += nan;
          }
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < S; ++s)
      __stcs(reinterpret_cast<float4*>(out + bag * kSlices * 4) + g + s * G,
             make_float4(hot[s][0] + cold[s][0], hot[s][1] + cold[s][1],
                         hot[s][2] + cold[s][2], hot[s][3] + cold[s][3]));
  }
}

// 16 lanes a bag, positions walked by a loop whose trip count is known only
// at run time, unrolled kUnroll times, its body free of branches: each
// position's row is one of two predicated loads (hot or cold, each with its
// own L2 policy), a NaN is a select, and the add goes to one of two
// accumulators by predicate. With no branch in the unrolled body, ptxas can
// issue the next positions' loads before this one's adds.
template <int kUnroll, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks) runloop(
    const uint4* __restrict__ table, const int32_t* __restrict__ ids,
    const uint8_t* __restrict__ mask, float* __restrict__ out, int64_t B, int32_t hlen,
    Tiers t) {
  constexpr int G = 16;
  const int g = threadIdx.x & (G - 1);
  const int64_t bag = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / G;
  const bool live = bag < B;
  const int64_t base = live ? bag * hlen : 0;
  const uint64_t keep = evict_last_policy(), pass = evict_first_policy();
  const uint32_t nb = 0x7fc00000u;
  float hot[4] = {0.f, 0.f, 0.f, 0.f}, cold[4] = {0.f, 0.f, 0.f, 0.f};
  for (int h0 = 0; h0 < hlen; h0 += G) {
    int32_t id = kNothing;
    if (live && h0 + g < hlen)
      id = resolve(__ldcs(ids + base + h0 + g), __ldcs(mask + base + h0 + g), t);
    const int n = min(G, hlen - h0);
#pragma unroll kUnroll
    for (int j = 0; j < n; ++j) {
      const int32_t v = __shfl_sync(0xffffffffu, id, j, G);
      const bool is_hot = static_cast<uint32_t>(v) < static_cast<uint32_t>(t.H);
      uint4 x = ld_row_tiers(table + static_cast<int64_t>(v < 0 ? 0 : v) * kSlices + g,
                             live && is_hot, live && v >= t.H, keep, pass);
      if (v == kNaN) x = make_uint4(nb, nb, nb, nb);
      if (is_hot)
        add4(hot, x);
      else
        add4(cold, x);
    }
  }
  if (live)
    __stcs(reinterpret_cast<float4*>(out + bag * kSlices * 4) + g,
           make_float4(hot[0] + cold[0], hot[1] + cold[1], hot[2] + cold[2], hot[3] + cold[3]));
}

template <int kUnroll, int kMinBlocks>
void launch_runloop(const void* table, const void* ids, const void* mask, void* out, int64_t B,
                    int32_t hlen, const Tiers& t, cudaStream_t st) {
  runloop<kUnroll, kMinBlocks><<<static_cast<unsigned>((B + 15) / 16), kThreads, 0, st>>>(
      static_cast<const uint4*>(table), static_cast<const int32_t*>(ids),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), B, hlen, t);
}

// Two predicated loads into the same registers, a hot row's with the
// evict_last policy, a cold row's with evict_first; where neither holds the
// registers are left as they were (the caller adds them under the same
// predicates).
__device__ __forceinline__ uint4 ld_tiers(const uint4* p, bool hot, bool cold, uint64_t keep,
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

// Few instructions a position: G = 16 / S lanes a bag, S slices a lane; a
// run-time loop over positions unrolled kUnroll times with no branch in its
// body; tier tests by unsigned compares against per-lane limits (0 for a
// lane past the row); the row address by one wide multiply-add; the adds
// predicated; a NaN noted in a flag and added to the cold sum at the end
// (NaN + x is NaN, so the sum is NaN either way); in the hot-part mode
// (!kTwoTier) no cold load, add or flag at all.
// kCold: the cold rows' L2 policy: 0 evict_first, 1 evict_last (as the
// hot rows'), 2 evict_normal.
template <int S, int kUnroll, int kMinBlocks, bool kTwoTier, int kCold = 0>
__global__ void __launch_bounds__(kThreads, kMinBlocks) lean(
    const uint4* __restrict__ table, const int32_t* __restrict__ ids,
    const uint8_t* __restrict__ mask, float* __restrict__ out, int64_t B, int32_t hlen,
    Tiers t) {
  constexpr int G = kSlices / S;
  const int g = threadIdx.x & (G - 1);
  const int64_t bag = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / G;
  const bool live = bag < B;
  const int64_t base = live ? bag * hlen : 0;
  const uint64_t keep = evict_last_policy();
  const uint64_t pass = kCold == 0 ? evict_first_policy()
                        : kCold == 1 ? keep : evict_normal_policy();
  const uint32_t hot_lim = live ? t.H : 0, cold_lim = live ? t.V - t.H : 0;
  const uint4* rows = table + g;
  float hot[S][4] = {}, cold[S][4] = {};
  bool nan_seen = false;
  for (int h0 = 0; h0 < hlen; h0 += G) {
    int32_t id = kNothing;
    if (live && h0 + g < hlen)
      id = resolve(__ldcs(ids + base + h0 + g), __ldcs(mask + base + h0 + g), t);
    const int n = min(G, hlen - h0);
#pragma unroll kUnroll
    for (int j = 0; j < n; ++j) {
      const uint32_t v = static_cast<uint32_t>(__shfl_sync(0xffffffffu, id, j, G));
      const bool is_hot = v < hot_lim;
      const bool is_cold = kTwoTier && v - static_cast<uint32_t>(t.H) < cold_lim;
      const uint4* p = rows + static_cast<uint64_t>(v) * kSlices;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const uint4 x = kTwoTier ? ld_tiers(p + s * G, is_hot, is_cold, keep, pass)
                                 : ld_row_if(p + s * G, is_hot, keep);
        if (is_hot) add4(hot[s], x);
        if (kTwoTier && is_cold) add4(cold[s], x);
      }
      if (kTwoTier) nan_seen |= v == static_cast<uint32_t>(kNaN);
    }
  }
  if (live) {
    const float nan = __uint_as_float(0x7fc00000u);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (nan_seen)
#pragma unroll
        for (int k = 0; k < 4; ++k) cold[s][k] += nan;
      __stcs(reinterpret_cast<float4*>(out + bag * kSlices * 4) + g + s * G,
             make_float4(hot[s][0] + cold[s][0], hot[s][1] + cold[s][1],
                         hot[s][2] + cold[s][2], hot[s][3] + cold[s][3]));
    }
  }
}

template <int S, int kUnroll, int kMinBlocks, int kCold = 0>
void launch_lean(const void* table, const void* ids, const void* mask, void* out, int64_t B,
                 int32_t hlen, const Tiers& t, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads * S / kSlices - 1) /
                                                (kThreads * S / kSlices));
  const auto* tab = static_cast<const uint4*>(table);
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<float*>(out);
  if (t.V > t.H)
    lean<S, kUnroll, kMinBlocks, true, kCold><<<blocks, kThreads, 0, st>>>(tab, i, m, o, B, hlen,
                                                                           t);
  else
    lean<S, kUnroll, kMinBlocks, false><<<blocks, kThreads, 0, st>>>(tab, i, m, o, B, hlen, t);
}

__device__ __forceinline__ uint4 ld_pred(const uint4* p, bool pred, uint64_t policy) {
  uint4 v;
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %4, 0;\n\t"
      "@p ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%5], %6;\n\t}"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "r"(static_cast<int>(pred)), "l"(p), "l"(policy));
  return v;
}

// `lean`, and: the hot-part load leaves its registers as they were where it
// does not load (no zeroing: the add is predicated alike); in the two-tier
// mode the lane that resolves a cold position prefetches its row into L2
// when it resolves it, up to G positions before the group reaches it.
template <int S, int kUnroll, int kMinBlocks, bool kTwoTier>
__global__ void __launch_bounds__(kThreads, kMinBlocks) lean2(
    const uint4* __restrict__ table, const int32_t* __restrict__ ids,
    const uint8_t* __restrict__ mask, float* __restrict__ out, int64_t B, int32_t hlen,
    Tiers t) {
  constexpr int G = kSlices / S;
  const int g = threadIdx.x & (G - 1);
  const int64_t bag = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / G;
  const bool live = bag < B;
  const int64_t base = live ? bag * hlen : 0;
  const uint64_t keep = evict_last_policy(), pass = evict_first_policy();
  const uint32_t hot_lim = live ? t.H : 0, cold_lim = live ? t.V - t.H : 0;
  const uint4* rows = table + g;
  float hot[S][4] = {}, cold[S][4] = {};
  bool nan_seen = false;
  for (int h0 = 0; h0 < hlen; h0 += G) {
    int32_t id = kNothing;
    if (live && h0 + g < hlen)
      id = resolve(__ldcs(ids + base + h0 + g), __ldcs(mask + base + h0 + g), t);
    if (kTwoTier && id >= t.H) {
      const char* row = reinterpret_cast<const char*>(table + static_cast<int64_t>(id) * kSlices);
      asm volatile("prefetch.global.L2 [%0];" ::"l"(row));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(row + 128));
    }
    const int n = min(G, hlen - h0);
#pragma unroll kUnroll
    for (int j = 0; j < n; ++j) {
      const uint32_t v = static_cast<uint32_t>(__shfl_sync(0xffffffffu, id, j, G));
      const bool is_hot = v < hot_lim;
      const bool is_cold = kTwoTier && v - static_cast<uint32_t>(t.H) < cold_lim;
      const uint4* p = rows + static_cast<uint64_t>(v) * kSlices;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const uint4 x = kTwoTier ? ld_tiers(p + s * G, is_hot, is_cold, keep, pass)
                                 : ld_pred(p + s * G, is_hot, keep);
        if (is_hot) add4(hot[s], x);
        if (kTwoTier && is_cold) add4(cold[s], x);
      }
      if (kTwoTier) nan_seen |= v == static_cast<uint32_t>(kNaN);
    }
  }
  if (live) {
    const float nan = __uint_as_float(0x7fc00000u);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (nan_seen)
#pragma unroll
        for (int k = 0; k < 4; ++k) cold[s][k] += nan;
      __stcs(reinterpret_cast<float4*>(out + bag * kSlices * 4) + g + s * G,
             make_float4(hot[s][0] + cold[s][0], hot[s][1] + cold[s][1],
                         hot[s][2] + cold[s][2], hot[s][3] + cold[s][3]));
    }
  }
}

template <int S, int kUnroll, int kMinBlocks>
void launch_lean2(const void* table, const void* ids, const void* mask, void* out, int64_t B,
                  int32_t hlen, const Tiers& t, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads * S / kSlices - 1) /
                                                (kThreads * S / kSlices));
  const auto* tab = static_cast<const uint4*>(table);
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<float*>(out);
  if (t.V > t.H)
    lean2<S, kUnroll, kMinBlocks, true><<<blocks, kThreads, 0, st>>>(tab, i, m, o, B, hlen, t);
  else
    lean2<S, kUnroll, kMinBlocks, false><<<blocks, kThreads, 0, st>>>(tab, i, m, o, B, hlen, t);
}

// The earlier K3 at d = 64 f32 (16 lanes a bag, one position at a time).
__global__ void __launch_bounds__(kThreads) earlier(
    const uint4* __restrict__ hot, const int32_t* __restrict__ ids,
    const uint8_t* __restrict__ mask, float* __restrict__ out, int64_t B, int32_t hlen,
    int32_t H) {
  constexpr int G = 16;
  const int g = threadIdx.x & (G - 1);
  const int64_t bag = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const bool live = bag < B;
  const int64_t base = live ? bag * hlen : 0;
  const uint64_t policy = evict_last_policy();
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int h0 = 0; h0 < hlen; h0 += G) {
    int32_t id = -1;
    if (live && h0 + g < hlen) {
      const int32_t v = __ldcs(ids + base + h0 + g);
      const bool m = __ldcs(mask + base + h0 + g) != 0;
      if (m && v >= 0 && v < H) id = v;
    }
    const int n = min(G, hlen - h0);
    for (int j = 0; j < n; ++j) {
      const int32_t v = __shfl_sync(0xffffffffu, id, j, G);
      if (v >= 0 && live) add4(acc, ld_row(hot + static_cast<int64_t>(v) * kSlices + g, policy));
    }
  }
  if (live)
    __stcs(reinterpret_cast<float4*>(out + bag * kSlices * 4) + g,
           make_float4(acc[0], acc[1], acc[2], acc[3]));
}

template <int G, int S, int U, bool kPred, int kMinBlocks, int kHint = 0>
void launch(const void* table, const void* ids, const void* mask, void* out, int64_t B,
            int32_t hlen, const Tiers& t, cudaStream_t st) {
  const int64_t per_block = kThreads / G;
  bag<G, S, U, kPred, kMinBlocks, kHint>
      <<<static_cast<unsigned>((B + per_block - 1) / per_block), kThreads, 0, st>>>(
      static_cast<const uint4*>(table), static_cast<const int32_t*>(ids),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), B, hlen, t);
}

}  // namespace

// variant: 0 earlier (hot part only), then the rows of VARIANTS in
// scripts/k3_layouts.py. H, V, nan_past_v: K3's modes (hot part: V = H, 0).
extern "C" int run(int variant, const void* table, const void* ids, const void* mask, void* out,
                   int64_t B, int32_t hlen, int32_t H, int32_t V, int32_t nan_past_v,
                   void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Tiers t{H, V, nan_past_v ? kNaN : kNothing};
  switch (variant) {
    case 0:
      earlier<<<static_cast<unsigned>((B + 15) / 16), kThreads, 0, st>>>(
          static_cast<const uint4*>(table), static_cast<const int32_t*>(ids),
          static_cast<const uint8_t*>(mask), static_cast<float*>(out), B, hlen, H);
      break;
    case 1: launch<16, 1, 1, false, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 2: launch<16, 1, 2, false, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 3: launch<16, 1, 4, false, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 4: launch<16, 1, 8, false, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 5: launch<16, 1, 2, true, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 6: launch<16, 1, 4, true, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 7: launch<16, 1, 8, true, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 8: launch<16, 1, 4, true, 6>(table, ids, mask, out, B, hlen, t, st); break;
    case 9: launch<16, 1, 8, false, 4>(table, ids, mask, out, B, hlen, t, st); break;
    case 10: launch<8, 2, 2, true, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 11: launch<8, 2, 4, true, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 12: launch<4, 4, 2, true, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 13: launch<4, 4, 1, true, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 14: launch<16, 1, 1, false, 1, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 15: launch<16, 1, 1, false, 1, 2>(table, ids, mask, out, B, hlen, t, st); break;
    case 16: launch<16, 1, 8, false, 1, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 17: launch<16, 1, 8, false, 1, 2>(table, ids, mask, out, B, hlen, t, st); break;
    case 18: launch<16, 1, 8, true, 1, 3>(table, ids, mask, out, B, hlen, t, st); break;
    case 19: launch<16, 1, 4, true, 1, 3>(table, ids, mask, out, B, hlen, t, st); break;
    case 20: launch<16, 1, 2, true, 1, 3>(table, ids, mask, out, B, hlen, t, st); break;
    case 21: launch<4, 4, 1, true, 1, 3>(table, ids, mask, out, B, hlen, t, st); break;
    case 22: launch<8, 2, 2, true, 1, 3>(table, ids, mask, out, B, hlen, t, st); break;
    case 23: launch_runloop<1, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 24: launch_runloop<2, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 25: launch_runloop<4, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 26: launch_runloop<8, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 27: launch_runloop<4, 8>(table, ids, mask, out, B, hlen, t, st); break;
    case 28: launch_runloop<8, 8>(table, ids, mask, out, B, hlen, t, st); break;
    case 29: launch_lean<1, 2, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 30: launch_lean<1, 4, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 31: launch_lean<1, 8, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 32: launch_lean<1, 4, 8>(table, ids, mask, out, B, hlen, t, st); break;
    case 33: launch_lean<2, 2, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 34: launch_lean<2, 4, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 35: launch_lean<2, 4, 6>(table, ids, mask, out, B, hlen, t, st); break;
    case 36: launch_lean<4, 2, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 37: launch_lean2<1, 1, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 38: launch_lean2<1, 2, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 39: launch_lean2<1, 4, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 40: launch_lean2<1, 2, 6>(table, ids, mask, out, B, hlen, t, st); break;
    case 41: launch_lean2<1, 4, 8>(table, ids, mask, out, B, hlen, t, st); break;
    case 42: launch_lean2<2, 2, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 43: launch_lean2<2, 1, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 44: launch_lean<1, 2, 1, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 45: launch_lean<1, 2, 1, 2>(table, ids, mask, out, B, hlen, t, st); break;
    case 46: launch_lean<1, 1, 1, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 47: launch_lean<1, 4, 1, 1>(table, ids, mask, out, B, hlen, t, st); break;
    case 48: launch_lean<2, 2, 1, 1>(table, ids, mask, out, B, hlen, t, st); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
