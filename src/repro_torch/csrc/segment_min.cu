// Segment minimum of float32 messages for NVIDIA Hopper (sm_90a).
//
// out[s] = min(+inf, min{data[e] : seg[e] == s}), as torch's
// scatter_reduce_(..., "amin", include_self=True) over a +inf base, which is
// what the port's engine.min_reduce computed before (SSSP's relaxation).
// It replaces no Pallas kernel: the JAX package's segment_min is XLA's
// jax.ops.segment_min. It was added because scatter_reduce_ amin was most
// of an SSSP iteration on the card: it reads int64 ids only, so SSSP kept an
// (E,) int64 copy of its targets, and it does a read and a compare-and-swap
// loop (there is no native float atomic min) for every message, the +inf
// ones included.
//
// What bounds it: the message stream, 4 B a message read once, plus a
// random read-modify-write into out for each live message (one not equal
// to +inf) and its 4 B id. On the graph cells out is 128 MiB, 2.6x the
// 50 MB L2, so a live message's access usually misses L2; these random
// accesses, not the stream, set the time while a frontier's messages are a
// fifth of E.
//
// What the design does about it:
//   - A message equal to the identity (+inf) cannot change a minimum that
//     starts at +inf, so it issues nothing: not its id's load, not an
//     atomic. A frontier's edges are 19-27% of SSSP's messages.
//   - Floats are mapped to int32 keys that order as the floats do
//     (negative values get their magnitude bits flipped), so the live
//     message is one native red.global.min.s32: fire-and-forget, no CAS
//     loop. out holds keys during the pass; a positive float's key is its
//     own bits, so the +inf base needs no encoding, and a second small
//     kernel decodes the negative keys in place (one pass over N).
//   - A live message first reads its target from L2 and issues the atomic
//     only if it would lower it. A target gets several messages a pass
//     (about 6 on urand), and in a random order only the first and the
//     few that beat all before them lower it. The reads take the place of
//     most atomics: at the SSSP cells' shapes an iteration's pass took
//     6.1 ms (kron) and 14.0 ms (urand) without them, 4.2 and 9.4 with
//     them (H100 80GB HBM3, 700 W). Loading the four targets of a quad
//     before any compare, prefetching the next quad, or reading through
//     L1 did not help on urand.
//   - NaN gets the lowest key, so a NaN message makes its segment NaN, as
//     the plain version does; it is written back as torch's quiet NaN.
//   - Persistent blocks walk the messages in a grid-stride loop, four a
//     thread with one 16-byte streaming load; the four ids are loaded
//     (one more 16-byte load) only if one of the four is live. SSSP's
//     messages come grouped by source, so a quad is mostly all live or all
//     dead.
//   - Ids are int32, as a CSR's targets are: no widening copy (int64 ids
//     stay with scatter_reduce_, whose result is the same bits).
//     A live message's id outside [0, N) fails a device-side assert, as
//     scatter_reduce_'s index check does: the launch's stream is then
//     dead, and the next call that waits for it raises.
// A minimum has no order, so the result is the plain version's, bit for
// bit, on any input without NaN and without both signed zeros in one
// segment (the keys order -0.0 below +0.0).
//
// C interface for ctypes: every entry point returns cudaGetLastError().

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kInfBits = 0x7f800000u;  // +inf, the identity: also its own key
constexpr int32_t kNaNKey = INT32_MIN;      // below every float's key
constexpr int32_t kQuietNaN = 0x7fc00000;   // what torch writes for float("nan")

__device__ __forceinline__ int32_t order_key(uint32_t b) {
  if ((b & 0x7fffffffu) > kInfBits) return kNaNKey;
  return static_cast<int32_t>(b) >= 0 ? static_cast<int32_t>(b)
                                      : static_cast<int32_t>(b ^ 0x7fffffffu);
}

__device__ __forceinline__ int32_t decode_key(int32_t k) {
  return k == kNaNKey ? kQuietNaN : (k < 0 ? k ^ 0x7fffffff : k);
}

// Reduce one live message into out. The L2 load first is safe without a
// lock: out only falls during the pass, so a key not below a value read
// from it cannot lower it.
__device__ __forceinline__ void reduce_one(int32_t* out, int64_t n, int32_t id, uint32_t bits) {
  assert(static_cast<uint64_t>(static_cast<int64_t>(id)) < static_cast<uint64_t>(n));
  const int32_t key = order_key(bits);
  if (__ldcg(out + id) > key)
    asm volatile("red.global.min.s32 [%0], %1;" ::"l"(out + id), "r"(key) : "memory");
}

__device__ __forceinline__ int32_t load_id(const int32_t* seg, int64_t e) {
  return __ldcs(seg + e);
}

__device__ __forceinline__ void load_ids(const int32_t* seg, int64_t q, int32_t (&id)[4]) {
  const int4 v = __ldcs(reinterpret_cast<const int4*>(seg) + q);
  id[0] = v.x, id[1] = v.y, id[2] = v.z, id[3] = v.w;
}

// kVec: data and seg are 16-byte aligned, so quads of four messages are
// read as one vector; the last E % 4 messages (all of them without kVec)
// are read one a thread.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) segment_min_kernel(
    const float* __restrict__ data, const int32_t* __restrict__ seg, int64_t E,
    int32_t* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t quads = kVec ? E / 4 : 0;
  for (int64_t q = t; q < quads; q += stride) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(data) + q);
    const uint32_t b[4] = {__float_as_uint(v.x), __float_as_uint(v.y), __float_as_uint(v.z),
                           __float_as_uint(v.w)};
    if (b[0] == kInfBits && b[1] == kInfBits && b[2] == kInfBits && b[3] == kInfBits) continue;
    int32_t id[4];
    load_ids(seg, q, id);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (b[j] != kInfBits) reduce_one(out, n, id[j], b[j]);
  }
  for (int64_t e = 4 * quads + t; e < E; e += stride) {
    const uint32_t b = __float_as_uint(__ldcs(data + e));
    if (b != kInfBits) reduce_one(out, n, load_id(seg, e), b);
  }
}

// Keys back to floats, in place: only negative keys differ from their bits.
__global__ void __launch_bounds__(kThreads) decode_kernel(int32_t* __restrict__ keys,
                                                          int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t quads = n / 4;  // keys come from a fresh allocation: 16-byte aligned
  for (int64_t q = t; q < quads; q += stride) {
    int4* p = reinterpret_cast<int4*>(keys) + q;
    const int4 k = *p;
    if ((k.x | k.y | k.z | k.w) < 0)
      *p = make_int4(decode_key(k.x), decode_key(k.y), decode_key(k.z), decode_key(k.w));
  }
  for (int64_t i = 4 * quads + t; i < n; i += stride)
    if (keys[i] < 0) keys[i] = decode_key(keys[i]);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Blocks for `work` items of kThreads each, at most as many as the card
// keeps resident at once (the persistent grid).
template <typename K>
int grid_for(K kernel, int64_t work) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t need = (work + kThreads - 1) / kThreads;
  return static_cast<int>(need < resident ? (need > 0 ? need : 1) : resident);
}

template <bool kVec>
void launch_reduce(const float* data, const int32_t* seg, int64_t E, int32_t* out, int64_t n,
                   cudaStream_t stream) {
  auto* kernel = segment_min_kernel<kVec>;
  const int64_t work = kVec ? E / 4 + E % 4 : E;
  kernel<<<grid_for(kernel, work), kThreads, 0, stream>>>(data, seg, E, out, n);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

// out: (n,) float32 filled with +inf by the caller, min-reduced in place.
int segment_min_f32_i32(const void* data, const void* seg, int64_t E, void* out, int64_t n,
                        void* stream) {
  const auto* d = static_cast<const float*>(data);
  const auto* s = static_cast<const int32_t*>(seg);
  auto* keys = static_cast<int32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (E > 0) {
    if (aligned16(d) && aligned16(s))
      launch_reduce<true>(d, s, E, keys, n, st);
    else
      launch_reduce<false>(d, s, E, keys, n, st);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (n > 0) decode_kernel<<<grid_for(decode_kernel, n / 4 + n % 4), kThreads, 0, st>>>(keys, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
