// K1's L2 rule for the kernels that gather rows through the hot tier
// (csrc/hot_gather.cu): a row below the High Reuse Region's end loads with
// an L2 evict_last policy, so the hot prefix stays in the 50 MB L2, and any
// other row with evict_first, so the cold rows stream through it without
// pushing the hot ones out. Included by csrc/softmax_aggr.cu; the older
// kernels keep their own copies (ptxas schedules them as they are).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace l2_hint {

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

// 16 bytes at p (16-byte aligned) under an L2 policy.
__device__ __forceinline__ float4 ld4(const float* p, uint64_t policy) {
  float4 v;
  asm("ld.global.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

}  // namespace l2_hint
