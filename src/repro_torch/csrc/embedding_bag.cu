// Hot-cached embedding bag (K3) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _bag_kernel of
// src/repro/kernels/embedding_bag/embedding_bag.py (launched by
// hot_bag_hot_part): for each bag b,
//   out[b] = sum over h of hot[ids[b, h]]  where mask[b, h] and 0 <= ids[b, h] < H,
// in float32. Cold and masked-out positions add nothing; the caller's
// cold fixup (ops.hot_bag) adds the cold rows.
//
// What bounds it: bytes. The least traffic is the ids and mask read once,
// the output written once and each referenced hot row read once (at MIND's
// serve_bulk: 262,144 bags x 50, d = 64, about 185 MB). But a bag sum
// re-reads popular rows many times over: at serve_bulk 11.8M references of
// 256 B each, about 3 GB of row reads against some 50 MB of distinct hot
// rows. So what sets the kernel's time is how fast those re-reads are
// served, and they are cheap only while the hot rows stay in L2.
//
// What the design does about it: the TPU kernel pinned the whole hot
// prefix as one constant-index VMEM block. Hopper has no software memory
// of that size, but its 50 MB L2 takes per-load eviction hints, and the
// port's default hot region is sized to it. Hot-row loads carry an L2
// evict_last policy (as K1's do), so the hot rows stay resident while the
// ids, the mask and the output stream through with evict-first (.cs)
// loads and stores. A group of G lanes owns one bag (G = 16 at d = 64
// f32: half a warp). The group loads G of the bag's ids and mask bytes at
// a time, coalesced, and passes each id round by shuffle; every lane then
// loads its 16-byte slice of that row and adds it to float32 registers,
// position after position, so the sum is taken in history order and is
// deterministic. Rows whose width is not a multiple of 16 bytes are not
// 16-byte aligned, so for them (and unaligned tables) each lane loads
// single elements instead. No padding of d or B (the TPU padded d to 128
// lanes and B to its 256-bag tile).
//
// C interface for ctypes: every entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// Hot-row loads, raw bits, with the L2 evict_last cache policy.
__device__ __forceinline__ uint4 ld_hot_v4(const void* p, uint64_t policy) {
  uint4 v;
  asm("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

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

// Raw bits -> float: f32 as is, bf16 as the upper half of an f32.
__device__ __forceinline__ float to_float(uint32_t bits) { return __uint_as_float(bits); }
__device__ __forceinline__ float to_float(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// Add one 16-byte slice of a row to the lane's accumulators: four f32, or
// eight bf16 (element 2i in the low half of word i).
__device__ __forceinline__ void add_slice(float (&acc)[4], uint4 v, uint32_t) {
  acc[0] += __uint_as_float(v.x);
  acc[1] += __uint_as_float(v.y);
  acc[2] += __uint_as_float(v.z);
  acc[3] += __uint_as_float(v.w);
}

__device__ __forceinline__ void add_slice(float (&acc)[8], uint4 v, uint16_t) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] += __uint_as_float(w[i] << 16);
    acc[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
  }
}

// K3. W is the table's raw element (uint32_t for f32, uint16_t for bf16);
// G lanes own one bag; kVec: 16-byte slices (d a multiple of 16 / sizeof(W)).
template <typename W, int G, bool kVec>
__global__ void __launch_bounds__(256) hot_bag_kernel(
    const W* __restrict__ hot, const int32_t* __restrict__ ids,
    const uint8_t* __restrict__ mask, float* __restrict__ out, int64_t B, int32_t hlen,
    int32_t d, int32_t H) {
  constexpr int kPer = kVec ? 16 / static_cast<int>(sizeof(W)) : 1;
  const int g = threadIdx.x & (G - 1);
  const int64_t bag = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const bool live = bag < B;
  const int64_t base = live ? bag * hlen : 0;
  const int nslice = d / kPer;
  const uint64_t policy = evict_last_policy();
  // every lane of the warp runs the same trip counts: the shuffles need them all
  for (int c0 = 0; c0 < nslice; c0 += G) {
    const int c = c0 + g;
    const bool mine = live && c < nslice;
    float acc[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) acc[k] = 0.f;
    for (int h0 = 0; h0 < hlen; h0 += G) {
      int32_t id = -1;  // -1: this position adds nothing
      if (live && h0 + g < hlen) {
        const int32_t v = __ldcs(ids + base + h0 + g);
        const bool m = __ldcs(mask + base + h0 + g) != 0;
        if (m && v >= 0 && v < H) id = v;
      }
      const int n = min(G, hlen - h0);
      for (int j = 0; j < n; ++j) {
        const int32_t v = __shfl_sync(0xffffffffu, id, j, G);
        if (v >= 0 && mine) {
          const W* row = hot + static_cast<int64_t>(v) * d + static_cast<int64_t>(c) * kPer;
          if constexpr (kVec) {
            add_slice(acc, ld_hot_v4(row, policy), W{});
          } else {
            acc[0] += to_float(ld_hot(row, policy));
          }
        }
      }
    }
    if (mine) {
      float* o = out + bag * d + static_cast<int64_t>(c) * kPer;
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

template <typename W, int G, bool kVec>
void launch_g(const void* hot, const void* ids, const void* mask, void* out, int64_t B,
              int32_t hlen, int32_t d, int32_t H, cudaStream_t stream) {
  const int threads = 256;
  const int64_t bags_per_block = threads / G;
  const int64_t blocks = (B + bags_per_block - 1) / bags_per_block;
  hot_bag_kernel<W, G, kVec><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const W*>(hot), static_cast<const int32_t*>(ids),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), B, hlen, d, H);
}

template <typename W, bool kVec>
void launch_vec(int group, const void* hot, const void* ids, const void* mask, void* out,
                int64_t B, int32_t hlen, int32_t d, int32_t H, cudaStream_t st) {
  switch (group) {
    case 1: launch_g<W, 1, kVec>(hot, ids, mask, out, B, hlen, d, H, st); break;
    case 2: launch_g<W, 2, kVec>(hot, ids, mask, out, B, hlen, d, H, st); break;
    case 4: launch_g<W, 4, kVec>(hot, ids, mask, out, B, hlen, d, H, st); break;
    case 8: launch_g<W, 8, kVec>(hot, ids, mask, out, B, hlen, d, H, st); break;
    case 16: launch_g<W, 16, kVec>(hot, ids, mask, out, B, hlen, d, H, st); break;
    default: launch_g<W, 32, kVec>(hot, ids, mask, out, B, hlen, d, H, st); break;
  }
}

template <typename W>
int launch_hot_bag(const void* hot, const void* ids, const void* mask, void* out, int64_t B,
                   int32_t hlen, int32_t d, int32_t H, int32_t vec, void* stream) {
  if (B > 0 && d > 0) {
    const int per = vec ? 16 / static_cast<int>(sizeof(W)) : 1;
    const int nslice = d / per;
    int group = 1;  // the smallest power of two covering the row's slices, at most a warp
    while (group < nslice && group < 32) group <<= 1;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec)
      launch_vec<W, true>(group, hot, ids, mask, out, B, hlen, d, H, st);
    else
      launch_vec<W, false>(group, hot, ids, mask, out, B, hlen, d, H, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* cuda_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

// vec != 0: 16-byte slices; the caller guarantees d % (16 / element size) == 0
// and a 16-byte aligned table.
int hot_bag_f32(const void* hot, const void* ids, const void* mask, void* out, int64_t B,
                int32_t hlen, int32_t d, int32_t H, int32_t vec, void* stream) {
  return launch_hot_bag<uint32_t>(hot, ids, mask, out, B, hlen, d, H, vec, stream);
}

int hot_bag_bf16(const void* hot, const void* ids, const void* mask, void* out, int64_t B,
                 int32_t hlen, int32_t d, int32_t H, int32_t vec, void* stream) {
  return launch_hot_bag<uint16_t>(hot, ids, mask, out, B, hlen, d, H, vec, stream);
}

}  // extern "C"
