// Layouts of K1's d = 1 body (f32), timed against each other and against
// the kernel in src/repro_torch/csrc/hot_gather.cu by
// scripts/k1_d1_layouts.py. Each variant computes what K1 computes for
// d = 1 without cold ranks: out[e] = table[idx[e]] for 0 <= idx[e] < N
// (rows below H with an L2 evict_last hint, the others evict_first), zeros
// for a negative index and `past` bits (zeros or NaN) for one >= N.
//
// C interface: int run(variant, table, idx, out, E, H, N, past, stream)
// returns cudaGetLastError(), or -1 for an unknown variant.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint32_t ld_hint(const uint32_t* p, uint64_t policy) {
  uint32_t v;
  asm("ld.global.L2::cache_hint.b32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(policy));
  return v;
}

struct Tiers {
  int32_t H, N;
  uint32_t past;  // the bits an index >= N gives
};

// One edge's value; kHint = false reads the row with a plain load.
template <bool kHint>
__device__ __forceinline__ uint32_t gather_one(const uint32_t* table, int32_t v, const Tiers& t) {
  if (v < 0) return 0u;
  if (v >= t.N) return t.past;
  if (!kHint) return table[v];
  return ld_hint(table + v, v < t.H ? evict_last_policy() : evict_first_policy());
}

// K1's earlier layout: a grid capped at 32 blocks of 256 per SM, each thread
// striding over E one edge a turn.
__global__ void __launch_bounds__(kThreads) grid_stride(
    const uint32_t* __restrict__ table, const int32_t* __restrict__ idx,
    uint32_t* __restrict__ out, int64_t E, Tiers t) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; e < E;
       e += stride)
    __stcs(out + e, gather_one<true>(table, __ldcs(idx + e), t));
}

// K edges a thread, interleaved across the warp: load k of each thread
// covers 32 consecutive edges. K = 1 is the layout of K1 in
// hot_gather.cu; kHint = false drops the L2 hints.
template <int K, bool kHint>
__global__ void __launch_bounds__(kThreads) interleaved(
    const uint32_t* __restrict__ table, const int32_t* __restrict__ idx,
    uint32_t* __restrict__ out, int64_t E, Tiers t) {
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5)) * (32 * K) +
      (threadIdx.x & 31);
  int32_t v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = base + 32 * k < E ? __ldcs(idx + base + 32 * k) : -1;
  uint32_t r[K];
#pragma unroll
  for (int k = 0; k < K; ++k) r[k] = gather_one<kHint>(table, v[k], t);
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (base + 32 * k < E) __stcs(out + base + 32 * k, r[k]);
}

// 4 * Q consecutive edges a thread: Q 16-byte evict-first index loads, the
// row loads issued independently, Q 16-byte .cs stores, a scalar tail.
// Needs idx and out 16-byte aligned.
template <int Q>
__global__ void __launch_bounds__(kThreads) consecutive(
    const uint32_t* __restrict__ table, const int32_t* __restrict__ idx,
    uint32_t* __restrict__ out, int64_t E, Tiers t) {
  const int64_t e0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * (4 * Q);
  if (e0 >= E) return;
  if (e0 + 4 * Q > E) {
    for (int64_t e = e0; e < E; ++e) __stcs(out + e, gather_one<true>(table, __ldcs(idx + e), t));
    return;
  }
  int4 q[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) q[j] = __ldcs(reinterpret_cast<const int4*>(idx + e0) + j);
  uint4 r[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j)
    r[j] = make_uint4(gather_one<true>(table, q[j].x, t), gather_one<true>(table, q[j].y, t),
                      gather_one<true>(table, q[j].z, t), gather_one<true>(table, q[j].w, t));
#pragma unroll
  for (int j = 0; j < Q; ++j) __stcs(reinterpret_cast<uint4*>(out + e0) + j, r[j]);
}

unsigned blocks_for(int64_t items, int64_t per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

}  // namespace

extern "C" int run(int variant, const void* table_v, const void* idx_v, void* out_v, int64_t E,
                   int32_t H, int32_t N, int32_t past, void* stream) {
  if (E <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* table = static_cast<const uint32_t*>(table_v);
  const int32_t* idx = static_cast<const int32_t*>(idx_v);
  uint32_t* out = static_cast<uint32_t*>(out_v);
  const Tiers t{H, N, static_cast<uint32_t>(past)};
  switch (variant) {
    case 0: {
      int dev = 0, sms = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      const unsigned cap = static_cast<unsigned>(sms) * 32;
      const unsigned nb = blocks_for(E, kThreads);
      grid_stride<<<nb < cap ? nb : cap, kThreads, 0, st>>>(table, idx, out, E, t);
      break;
    }
    case 1: interleaved<1, true><<<blocks_for(E, kThreads), kThreads, 0, st>>>(table, idx, out, E, t); break;
    case 2: interleaved<2, true><<<blocks_for(E, 2 * kThreads), kThreads, 0, st>>>(table, idx, out, E, t); break;
    case 3: interleaved<4, true><<<blocks_for(E, 4 * kThreads), kThreads, 0, st>>>(table, idx, out, E, t); break;
    case 4: interleaved<8, true><<<blocks_for(E, 8 * kThreads), kThreads, 0, st>>>(table, idx, out, E, t); break;
    case 5: consecutive<1><<<blocks_for(E, 4 * kThreads), kThreads, 0, st>>>(table, idx, out, E, t); break;
    case 6: consecutive<2><<<blocks_for(E, 8 * kThreads), kThreads, 0, st>>>(table, idx, out, E, t); break;
    case 7: interleaved<1, false><<<blocks_for(E, kThreads), kThreads, 0, st>>>(table, idx, out, E, t); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
