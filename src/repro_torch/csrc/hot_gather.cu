// GRASP hot-region gather kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/hot_gather/hot_gather.py:
//   K1 hot_gather        <- _hot_gather_kernel   (launched by hot_gather_hot_part)
//   K2 gather_segsum     <- _gather_seg_kernel   (launched by hot_gather_segment_sum)
//
// What bounds them: bytes. A gather does no arithmetic (K2 adds one float
// per gathered element), so the least time is the index stream read once,
// the output written once and each referenced hot row read once, over the
// 3.35 TB/s of device memory. What costs more than that bound is re-reading
// hot rows from device memory after they were evicted from L2.
//
// What the design does about it: the TPU kernel pinned the hot prefix in
// VMEM as a constant-index block. Hopper has no software-managed memory of
// that size, but it has a 50 MB L2 that takes per-load eviction hints, which
// is the paper's own setting (an LLC steered by software reuse hints). Loads
// from the High Reuse Region [0, H) carry an L2 evict_last policy (GRASP's
// insertion rule as a hint), so hot rows stay resident while the streaming
// index and output arrays pass through with evict-first (.cs) loads and
// stores. Indices outside [0, H) produce zeros; the caller's bounded cold
// fixup fills them (ops.hot_gather). No padding of d or E: the TPU's
// 128-lane padding would multiply the bytes by 128 for d = 1.
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

int grid_for(int64_t work, int threads) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int64_t blocks = (work + threads - 1) / threads;
  const int64_t cap = static_cast<int64_t>(sms) * 32;
  return static_cast<int>(blocks < cap ? blocks : cap);
}

// K1: out[e, c] = hot[idx[e], c] if 0 <= idx[e] < H else 0.
// Grid-stride over the E*d output elements, so neighbouring threads write
// neighbouring columns (coalesced along d) or, for d == 1, neighbouring edges.
template <typename W, bool kOneCol>
__global__ void hot_gather_kernel(const W* __restrict__ hot, const int32_t* __restrict__ idx,
                                  W* __restrict__ out, int64_t total, int32_t d, int32_t H) {
  const uint64_t policy = evict_last_policy();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t e = kOneCol ? i : i / d;
    const int32_t c = kOneCol ? 0 : static_cast<int32_t>(i - e * d);
    const int32_t v = __ldcs(idx + e);
    W val = 0;
    if (v >= 0 && v < H) val = ld_hot(hot + static_cast<int64_t>(v) * d + c, policy);
    __stcs(out + i, val);
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

template <typename W>
int launch_hot_gather(const void* hot, const void* idx, void* out, int64_t E, int32_t d,
                      int32_t H, void* stream) {
  const int64_t total = E * d;
  if (total > 0) {
    const int threads = 256;
    const int blocks = grid_for(total, threads);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (d == 1)
      hot_gather_kernel<W, true><<<blocks, threads, 0, st>>>(
          static_cast<const W*>(hot), static_cast<const int32_t*>(idx), static_cast<W*>(out),
          total, d, H);
    else
      hot_gather_kernel<W, false><<<blocks, threads, 0, st>>>(
          static_cast<const W*>(hot), static_cast<const int32_t*>(idx), static_cast<W*>(out),
          total, d, H);
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

int hot_gather_f32(const void* hot, const void* idx, void* out, int64_t E, int32_t d,
                   int32_t H, void* stream) {
  return launch_hot_gather<uint32_t>(hot, idx, out, E, d, H, stream);
}

int hot_gather_bf16(const void* hot, const void* idx, void* out, int64_t E, int32_t d,
                    int32_t H, void* stream) {
  return launch_hot_gather<uint16_t>(hot, idx, out, E, d, H, stream);
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
