// Segment minimum of float32 messages, and SSSP's relaxation over an out-CSR,
// for NVIDIA Hopper (sm_90a).
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
//     few that beat all before them lower it, so the reads take the place
//     of most atomics (timings in PERF.md, section 6).
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
// SSSP's relaxation (relax_min_kernel, settle_kernel) produces its own
// messages: one Bellman-Ford iteration over the out-CSR's rows, in place of
// the (E,) candidate array that segment_min_kernel reduces. It replaces no
// Pallas kernel either: the JAX package relaxes with a gather, jnp.where and
// jax.ops.segment_min over all E edges. Only the out-edges of active rows
// can lower a distance, and they are what it reads.
//
// What bounds it: a frontier's edges, 8 B each (target and weight), read
// once, and a random probe and red.min into keys for each, as above; the
// active flags and offsets of every row (5N B) and one settling pass over
// N (about 14N B).
//
// What the design does about it:
//   - Merge-path partition of the N row ends and E edges (as
//     segment_sum.cu's, kRelaxTile items a block), so a hub's edges span
//     many blocks and every block owns the same number of items.
//   - A block first reads the active flags of its rows. A block whose rows
//     are all inactive returns; otherwise each thread walks its part of the
//     merged list in shared memory and gives each edge its row's dist (or a
//     skip mark), and the block then reads its edges coalesced, issuing no
//     load of an inactive row's target or weight.
//   - The random probes and atomics set the time, so each thread loads five
//     edges' targets and weights, then their five probes, then issues their
//     atomics, and the kernel is held to 40 registers so six blocks fit an
//     SM (the variants timed against it are in PERF.md, section 6).
//   - The iteration stays Jacobi: the candidates come from dist as it was
//     before the pass, and only settle_kernel, after it, writes dist. The
//     add is dist[src] + w in float32, as the plain path's, and a minimum
//     has no order, so distances and frontiers equal the plain path's.
//   - settle_kernel decodes each key, sets active = best < dist and dist =
//     min(dist, best) (NaN if either is), puts +inf back into the keys it
//     finds lowered (so the next iteration needs no fill), and raises a
//     device flag when a vertex is active: the host reads one word an
//     iteration.
//   - Each block adds the edges it relaxed to a device int64 with one
//     atomic: the sum over the iterations of the active rows' out-degrees.
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

__device__ __forceinline__ void red_min(int32_t* p, int32_t key) {
  asm volatile("red.global.min.s32 [%0], %1;" ::"l"(p), "r"(key) : "memory");
}

__device__ __forceinline__ void check_id(int32_t id, int64_t n) {
  assert(static_cast<uint64_t>(static_cast<int64_t>(id)) < static_cast<uint64_t>(n));
}

// Reduce one live message into out. The L2 load first is safe without a
// lock: out only falls during the pass, so a key not below a value read
// from it cannot lower it.
__device__ __forceinline__ void reduce_one(int32_t* out, int64_t n, int32_t id, uint32_t bits) {
  check_id(id, n);
  const int32_t key = order_key(bits);
  if (__ldcg(out + id) > key) red_min(out + id, key);
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

// --- SSSP's relaxation over the out-CSR ------------------------------------

constexpr int kRelaxPerThread = 15;                     // merged items a thread walks
constexpr int kRelaxTile = kThreads * kRelaxPerThread;  // row ends + edges a block owns
constexpr int kRelaxBlocksPerSM = 6;                    // caps registers at 40 a thread
constexpr int kBatch = 5;                               // edges a thread probes at once
constexpr uint32_t kSkip = 0xffffffffu;  // an inactive row's mark: a NaN no active row keeps
constexpr int kIntMax = 0x7fffffff;

// Where the merged list's diagonal d crosses: (row ends taken). A row's end
// comes after its edges: edge e is taken before row end r while e < ends(r).
template <typename Ends>
__device__ __forceinline__ int64_t merge_path(int64_t d, int64_t rows, int64_t edges,
                                              Ends ends) {
  int64_t lo = d > edges ? d - edges : 0, hi = d < rows ? d : rows;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (ends(mid) <= d - mid - 1) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// coords[t] = (rows, edges) before tile t, for t in [0, tiles]:
// coords[tiles] = (n, E).
__global__ void __launch_bounds__(kThreads) relax_partition_kernel(
    const int32_t* __restrict__ indptr, int64_t n, int64_t E, int64_t tiles,
    int2* __restrict__ coords) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t > tiles) return;
  if (t == 0) assert(indptr[0] == 0 && indptr[n] == E);
  const int64_t d = t * kRelaxTile < n + E ? t * kRelaxTile : n + E;
  const int64_t rows = merge_path(d, n, E, [&](int64_t r) { return indptr[r + 1]; });
  coords[t] = make_int2(static_cast<int>(rows), static_cast<int>(d - rows));
}

// One block a tile: reduces dist[u] + weights[e] into keys[indices[e]] for
// each edge e of the tile whose row u is active (weights null: 1), and adds
// the count of those edges to *relaxed.
__global__ void __launch_bounds__(kThreads, kRelaxBlocksPerSM) relax_min_kernel(
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
    const float* __restrict__ weights, const float* __restrict__ dist,
    const uint8_t* __restrict__ active, int64_t n, const int2* __restrict__ coords,
    int32_t* __restrict__ keys, unsigned long long* __restrict__ relaxed) {
  // row values, then row ends, then each edge's source value: rows + 1 +
  // rows + edges <= 2 * kRelaxTile + 1 words
  __shared__ uint32_t smem[2 * kRelaxTile + 1];
  __shared__ unsigned block_count;

  const int2 c0 = coords[blockIdx.x], c1 = coords[blockIdx.x + 1];
  const int row0 = c0.x, edge0 = c0.y;
  const int rows = c1.x - row0, edges = c1.y - edge0;
  if (edges == 0) return;  // row ends only
  // the rows that end in the tile, and the row the tile ends inside
  const int nrow = static_cast<int>(min(static_cast<int64_t>(rows) + 1, n - row0));
  uint32_t* val = smem;  // val[i]: row row0 + i's dist bits if it is active, else kSkip
  bool any = false;
  for (int i = threadIdx.x; i < nrow; i += kThreads) {
    uint32_t v = kSkip;
    if (active[row0 + i]) {
      v = __float_as_uint(dist[row0 + i]);
      if (v == kSkip) v = static_cast<uint32_t>(kQuietNaN);  // a NaN all the same
      any = true;
    }
    val[i] = v;
  }
  if (threadIdx.x == 0) block_count = 0;
  if (!__syncthreads_or(any)) return;

  int32_t* ends = reinterpret_cast<int32_t*>(smem + nrow);  // from edge0
  uint32_t* src = smem + nrow + rows;                        // src[j]: edge edge0 + j's
  for (int i = threadIdx.x; i < rows; i += kThreads) ends[i] = indptr[row0 + i + 1] - edge0;
  __syncthreads();

  // this thread's items [d, d + kRelaxPerThread) of the tile
  const int total = rows + edges;
  const int d = min(static_cast<int>(threadIdx.x) * kRelaxPerThread, total);
  int i = static_cast<int>(merge_path(d, rows, edges, [&](int64_t r) { return ends[r]; }));
  int j = d - i;
  int next_end = i < rows ? ends[i] : kIntMax;
  uint32_t v = i < nrow ? val[i] : kSkip;
#pragma unroll
  for (int k = 0; k < kRelaxPerThread; ++k) {
    if (d + k < total) {
      if (next_end <= j) {  // row i ends
        ++i;
        next_end = i < rows ? ends[i] : kIntMax;
        v = i < nrow ? val[i] : kSkip;
      } else {
        src[j++] = v;
      }
    }
  }
  __syncthreads();

  // kBatch edges at once: their targets and weights, then their probes, then
  // the atomics, so a thread has kBatch random reads in flight. A probe read
  // before another thread's atomic only lets an atomic through that would
  // not lower the key: keys only fall during the pass.
  unsigned count = 0;
  for (int base = threadIdx.x; base < edges; base += kThreads * kBatch) {
    int32_t id[kBatch], key[kBatch], probe[kBatch];
    bool live[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int jj = base + b * kThreads;
      const uint32_t s = jj < edges ? src[jj] : kSkip;
      live[b] = s != kSkip;
      if (live[b]) {
        const int64_t e = static_cast<int64_t>(edge0) + jj;
        const float w = weights != nullptr ? __ldcs(weights + e) : 1.0f;
        id[b] = __ldcs(indices + e);
        key[b] = order_key(__float_as_uint(__uint_as_float(s) + w));
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (live[b]) {
        check_id(id[b], n);
        probe[b] = __ldcg(keys + id[b]);
      }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (live[b]) {
        ++count;
        if (probe[b] > key[b]) red_min(keys + id[b], key[b]);
      }
  }
  count = __reduce_add_sync(0xffffffffu, count);
  if ((threadIdx.x & 31) == 0 && count) atomicAdd(&block_count, count);
  __syncthreads();
  if (threadIdx.x == 0 && block_count) atomicAdd(relaxed, static_cast<unsigned long long>(block_count));
}

// For each v: best = the key decoded; active[v] = best < dist[v]; dist[v] =
// min(dist[v], best), NaN if either is; keys[v] back to +inf. *flag = 1 if
// a vertex is active (the caller zeroes it first).
__global__ void __launch_bounds__(kThreads) settle_kernel(int32_t* __restrict__ keys,
                                                          float* __restrict__ dist,
                                                          uint8_t* __restrict__ active,
                                                          int64_t n, int32_t* __restrict__ flag) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  bool any = false;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; v < n;
       v += stride) {
    const int32_t k = keys[v];
    bool now = false;
    if (k != static_cast<int32_t>(kInfBits)) {  // a candidate arrived
      const float best = __int_as_float(decode_key(k));
      const float d = dist[v];
      now = best < d;
      if (now || (best != best && d == d)) dist[v] = best;  // a NaN best wins
      keys[v] = static_cast<int32_t>(kInfBits);
    }
    active[v] = now;
    any = any || now;
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) *flag = 1;
}

int64_t relax_tiles(int64_t n, int64_t E) { return (n + E + kRelaxTile - 1) / kRelaxTile; }

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


// One Bellman-Ford iteration over an out-CSR, in place. indptr: (n + 1,)
// int32 from 0 to E; indices: (E,) int32 targets; weights: (E,) float32, or
// null for weights of 1; dist: (n,) float32 and active: (n,) bool, read and
// then settled; keys: (n,) int32 holding +inf's bits, and again on return;
// flag: one int32, set to whether a vertex is active on return; relaxed: one
// int64, increased by the out-degrees of the rows active on entry; scratch:
// 8-byte aligned, at least 8 * (ceil((n + E) / 3840) + 1) bytes. Up to four
// operations on `stream`: zero the flag, the partition and the relaxation
// (when E > 0), the settling (when n > 0).
int relax_min_f32_i32(const void* indptr, const void* indices, const void* weights,
                      void* dist, void* active, void* keys, int64_t n, int64_t E, void* flag,
                      void* relaxed, void* scratch, int64_t scratch_bytes, void* stream) {
  const int64_t tiles = relax_tiles(n, E);
  if (E > 0 && scratch_bytes < 8 * (tiles + 1)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* f = static_cast<int32_t*>(flag);
  cudaMemsetAsync(f, 0, sizeof(int32_t), st);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto* k = static_cast<int32_t*>(keys);
  auto* d = static_cast<float*>(dist);
  auto* a = static_cast<uint8_t*>(active);
  if (E > 0) {
    const auto* ptr = static_cast<const int32_t*>(indptr);
    auto* coords = static_cast<int2*>(scratch);
    const auto blocks = static_cast<unsigned>((tiles + kThreads) / kThreads);  // tiles + 1
    relax_partition_kernel<<<blocks, kThreads, 0, st>>>(ptr, n, E, tiles, coords);
    relax_min_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
        ptr, static_cast<const int32_t*>(indices), static_cast<const float*>(weights), d, a, n,
        coords, k, static_cast<unsigned long long*>(relaxed));
  }
  settle_kernel<<<grid_for(settle_kernel, n), kThreads, 0, st>>>(k, d, a, n, f);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
