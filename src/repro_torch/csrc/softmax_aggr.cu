// DeeperGCN's softmax aggregation over a destination-sorted CSR, for NVIDIA
// Hopper (sm_90a).
//
// For every row i and channel c, over the items j of N_in(i) and i itself
// (the self loop), GENConv's message and its softmax over the row:
//   q_jc = ReLU(u_jc) + eps,   w_jc = exp(t q_jc - max_j t q_jc)
//   out[i, c] = u_ic + sum_j w_jc q_jc / sum_j w_jc
// (Li et al., DeeperGCN, arXiv:2006.07739, the "softmax" aggregator at a
// fixed t). It replaces no Pallas kernel: the JAX package has no DeeperGCN.
// It was added for DeeperGCN's full-graph inference (configs/deepergcn.py):
// no kernel of the port takes a softmax per channel over a vertex's
// variable-length in-edges, with a score for every element of every message;
// built from torch's operations it writes and reads (E, 128) tensors several
// times, 33 GB each at kron21's 65.6M items a layer.
//
// What bounds it: three things at once. Each item reads a 512 B row of u,
// once per in-edge: the least bytes read each row, offset and id once and
// write each output row once (2.41 GB a layer at kron21, 0.72 ms at 3.35
// TB/s), so the time is set by how many row reads the L2 serves. Each item
// also takes 128 exponentials, (N + E) * 128 = 8.4e9 a layer at kron21: at
// the special-function unit's 16 a clock an SM, about 2 ms. And each
// element takes about seven float32 operations beside its exponential.
//
// What the design does about it:
//   - One pass, softmax and sum together (an online softmax per channel):
//     lane l of a warp owns channels 4l .. 4l + 3 of the row it works on and
//     keeps, for each, the running maximum of the base-2 scores t log2(e) q,
//     the sum of the weights and the weighted sum of q in registers. A row
//     of u is one 16-byte load a lane, the warp's 32 side by side.
//   - Batches of kBatch items: a lane loads kBatch rows (kBatch loads in
//     flight), takes each channel's maximum over the batch in its own
//     registers (no shuffle: a lane owns its channels), rescales its sums
//     once, then adds each item's weight. An element costs one exponential
//     and a batch four more a lane, 1 + 1/kBatch an element; the weight is
//     ex2.approx of the exact difference fma(q, t log2(e), -max). On kron21
//     (H100 80GB HBM3, 700 W) a layer took 7.55 ms at 4 rows a batch (61
//     registers, four blocks an SM), against 8.93 at 8 (80 registers),
//     7.91 at 3, 8.36 at 6, 9.00 at 2 and 11.15 at 16; register caps for
//     five or six blocks an SM, blocks of 4 warps, or tiles of 512 or 2,048
//     items were slower.
//   - Rows below `hot` (the High Reuse Region, core.plan.make_plan's rows at
//     512 B) load with an L2 evict_last policy and the others with
//     evict_first, K1's rule (l2_hint.cuh), and each output row is stored
//     with st.global.cs, so the written rows do not push the hot ones out.
//   - Merge-path tiles (as csrc/gat_attend.cu): the N + E items (each row's
//     in-edges, then its self loop) are one list, and each warp owns kTile
//     consecutive items of it, so every warp does the same work whatever the
//     rows' lengths. A partition kernel finds each tile's first row by a
//     binary search of indptr.
//   - Rows that span tiles: each tile leaves the (maximum, sum, weighted
//     sum) partial of the row it ends inside, and of the row it starts
//     inside if that row ends in it; a merge kernel folds a row's partials in
//     tile order and writes the row. So every launch on the same input gives
//     the same bits.
//
// Hub rows: kron21's largest in-degree, 102,580, spans 101 tiles, so 101
// warps share it evenly and one warp of the merge kernel folds its 101
// partials of 1.5 KB in sequence (four loads in flight), about as long as
// one tile's walk.
//
// Error: u_ic is added exactly once, so the output's error is the error of
// m_ic = sum_j w_j q_j / sum_j w_j, plus one rounding of u_ic + m_ic. Both
// sums are of positive terms, each a chain of at most kTile adds in a tile,
// R = kTile / kBatch + tiles rescales and 3 roundings a tile the row spans
// in the merge, so the ratio is within 2 (kTile + R + 3 tiles) roundings. A
// weight's relative error is at most 4 roundings (ex2.approx, 2 ulp) each
// rescale and its own, plus ln(2) (|x| + 4 S) for base-2 scores below S (the
// roundings of t log2(e), of q and of its difference x from the maximum),
// and moves m by at most twice that, times m (q > 0). So |out - exact| <=
// (2 kTile + 10 R + 6 tiles + 16 + 7 S) 2^-24 m_ic + 2^-24 |u_ic + m_ic|,
// S = t log2(e) max q; ref.error_bound computes it. A sum overflows only
// where q reaches ~1e38 / (N + E).
//
// NaN: a NaN in u_jc makes channel c of every row that reads row j NaN (its
// weight is NaN; the maximum passes NaN by), and +inf the same (inf - inf).
// A row without in-edges gives u_i + ReLU(u_i) + eps.
//
// An id outside [0, N) fails a device-side assert, and so do offsets that
// do not run from 0 to E (raised at the next call that waits for the
// stream).
//
// C interface for ctypes: the entry point returns a cudaError_t, the
// launches' (cudaGetLastError()), or cudaErrorInvalidValue for a width other
// than 128, rows that are not 16-byte aligned, or a scratch too small.

#include <assert.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "l2_hint.cuh"

namespace {

constexpr int kWidth = 128;          // channels a row, 4 a lane
constexpr int kWarps = 8;            // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 1024;          // items of the merged list a warp owns
constexpr int kBatch = 4;            // rows a lane has in flight; one rescale a batch
constexpr double kLog2e = 1.4426950408889634;

struct Args {
  const int32_t* indptr;  // (n + 1,), 0 .. E
  const int32_t* src;     // (E,), rows by destination
  const float* u;         // (n, 128), contiguous, 16-byte aligned
  float* out;             // (n, 128), contiguous, 16-byte aligned
  int64_t E, items, tiles;
  int32_t n, hot;
  float c;                // t log2(e): the scores in base 2
  float eps;
  int32_t* first_row;     // (tiles,): the row of each tile's first item
  int32_t* head_row;      // (tiles,): the row whose head partial a tile left, or -1
  float4* rec;            // (tiles, 2, 3, 32): head and tail partials (max, sum, weighted sum)
};

__device__ __forceinline__ float& comp(float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 2^(from - to), 1 where they are equal (also both -inf).
__device__ __forceinline__ float rescale(float from, float to) {
  return from == to ? 1.0f : ex2(from - to);
}

// ReLU(v) + eps, NaN kept.
__device__ __forceinline__ float message(float v, float eps) {
  return (v < 0.0f ? 0.0f : v) + eps;
}

// One row's partial in this lane's four channels.
struct Partial {
  float4 m, l, s;  // maximum of the base-2 scores, sum of weights, sum of weight times q

  __device__ __forceinline__ void clear() {
    m = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    l = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    s = l;
  }
};

// Fold the first `count` (1 .. kBatch) of rows v (raw u) into p: the
// batch's maximum, one rescale, then each item's weight.
__device__ __forceinline__ void fold(const Args& a, float4 (&v)[kBatch], int count,
                                     Partial& p) {
  float4 top = p.m;
#pragma unroll
  for (int b = 0; b < kBatch; ++b)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      comp(v[b], k) = message(comp(v[b], k), a.eps);
      if (b < count) comp(top, k) = fmaxf(comp(top, k), comp(v[b], k) * a.c);
    }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float up = rescale(comp(p.m, k), comp(top, k));
    comp(p.l, k) *= up;
    comp(p.s, k) *= up;
  }
  p.m = top;
#pragma unroll
  for (int b = 0; b < kBatch; ++b)
    if (b < count) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float q = comp(v[b], k);
        const float w = ex2(fmaf(q, a.c, -comp(top, k)));
        comp(p.l, k) += w;
        comp(p.s, k) = fmaf(w, q, comp(p.s, k));
      }
    }
}

// Fold items [k0, k1) of row r (item k < deg is in-edge indptr[r] + k, item
// deg the self loop) into p: ids 32 at a time, rows kBatch at a time.
__device__ __forceinline__ void walk(const Args& a, uint64_t keep, uint64_t pass, int lane,
                                     int32_t r, int64_t e0, int deg, int k0, int k1,
                                     Partial& p) {
  const float* col = a.u + 4 * lane;
  for (int base = k0; base < k1; base += 32) {
    const int count = min(32, k1 - base);
    const int k = base + lane;
    int32_t j = r;
    if (lane < count && k < deg) {
      j = __ldcs(a.src + e0 + k);
      assert(static_cast<uint32_t>(j) < static_cast<uint32_t>(a.n));
    }
    for (int b0 = 0; b0 < count; b0 += kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int32_t jb = __shfl_sync(0xffffffffu, j, (b0 + b) & 31);
        v[b] = b0 + b < count
                   ? l2_hint::ld4(col + static_cast<int64_t>(jb) * kWidth, jb < a.hot ? keep : pass)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      fold(a, v, count - b0, p);
    }
  }
}

// Row r's output from its whole partial: u_r + the weighted mean of q.
__device__ __forceinline__ void finish(const Args& a, int lane, int32_t r, const Partial& p) {
  const int64_t off = static_cast<int64_t>(r) * kWidth + 4 * lane;
  float4 o = __ldg(reinterpret_cast<const float4*>(a.u + off));
#pragma unroll
  for (int k = 0; k < 4; ++k) comp(o, k) += comp(p.s, k) / comp(p.l, k);
  __stcs(reinterpret_cast<float4*>(a.out + off), o);
}

__device__ __forceinline__ void store(const Args& a, int64_t rec, int lane, const Partial& p) {
  float4* at = a.rec + rec * 3 * 32 + lane;
  at[0] = p.m;
  at[32] = p.l;
  at[64] = p.s;
}

// p <- p merged with the partial in record rec.
__device__ __forceinline__ void merge(const Args& a, int64_t rec, int lane, Partial& p) {
  const float4* at = a.rec + rec * 3 * 32 + lane;
  const float4 m = at[0], l = at[32], s = at[64];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float top = fmaxf(comp(p.m, k), comp(m, k));
    const float up = rescale(comp(p.m, k), top), in = rescale(comp(m, k), top);
    comp(p.l, k) = comp(p.l, k) * up + comp(l, k) * in;
    comp(p.s, k) = comp(p.s, k) * up + comp(s, k) * in;
    comp(p.m, k) = top;
  }
}

// first_row[t] = the row of item t * kTile: the first row whose end (its
// self loop, at indptr[r + 1] + r) is at or past it.
__global__ void __launch_bounds__(kThreads) softmax_aggr_partition_kernel(Args a) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= a.tiles) return;
  if (t == 0) assert(a.indptr[0] == 0 && a.indptr[a.n] == a.E);
  const int64_t d = t * kTile;
  int32_t lo = 0, hi = a.n - 1;
  while (lo < hi) {
    const int32_t mid = lo + (hi - lo) / 2;
    if (static_cast<int64_t>(a.indptr[mid + 1]) + mid < d) lo = mid + 1; else hi = mid;
  }
  a.first_row[t] = lo;
}

// One warp a tile: writes every row that lies in the tile, and leaves the
// partials of the rows that cross its ends.
__global__ void __launch_bounds__(kThreads) softmax_aggr_kernel(Args a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (t >= a.tiles) return;
  const uint64_t keep = l2_hint::evict_last_policy(), pass = l2_hint::evict_first_policy();
  const int64_t d0 = t * kTile, d1 = min(d0 + kTile, a.items);
  int32_t r = a.first_row[t], head = -1;
  // indptr[r0 + lane], 32 rows at a time
  int32_t r0 = r, ptr = a.indptr[min(r0 + lane, a.n)];
  Partial p;
  while (true) {
    if (r + 1 - r0 >= 32) {
      r0 = r;
      ptr = a.indptr[min(r0 + lane, a.n)];
    }
    const int64_t e0 = __shfl_sync(0xffffffffu, ptr, r - r0);
    const int64_t e1 = __shfl_sync(0xffffffffu, ptr, r + 1 - r0);
    const int64_t start = e0 + r, end = e1 + r + 1;  // the row's items in the merged list
    const int64_t lo = max(start, d0), hi = min(end, d1);
    p.clear();
    walk(a, keep, pass, lane, r, e0, static_cast<int>(e1 - e0), static_cast<int>(lo - start),
         static_cast<int>(hi - start), p);
    if (hi < end) {  // the row goes on past the tile: the tail partial
      store(a, 2 * t + 1, lane, p);
      break;
    }
    if (lo > start) {  // the row began in an earlier tile: the head partial
      store(a, 2 * t, lane, p);
      head = r;
    } else {
      finish(a, lane, r, p);
    }
    if (hi == d1) break;
    ++r;
  }
  if (lane == 0) a.head_row[t] = head;
}

// One warp a tile whose head partial is a row's last: folds the tail
// partials of the row's earlier tiles in order, then the head, and writes
// the row.
__global__ void __launch_bounds__(kThreads) softmax_aggr_merge_kernel(Args a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (t >= a.tiles) return;
  const int32_t r = a.head_row[t];
  if (r < 0) return;
  const int64_t first = (static_cast<int64_t>(a.indptr[r]) + r) / kTile;
  Partial p;
  p.clear();
#pragma unroll 4
  for (int64_t v = first; v < t; ++v) merge(a, 2 * v + 1, lane, p);
  merge(a, 2 * t, lane, p);
  finish(a, lane, r, p);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

// Bytes of scratch a call needs, -1 for shapes the kernel does not take.
int64_t softmax_aggr_scratch_bytes(int64_t n, int64_t E, int32_t width) {
  if (n <= 0 || E < 0 || width != kWidth) return -1;
  const int64_t tiles = (n + E + kTile - 1) / kTile;
  return tiles * (2 * 3 * 32 * 16 + 8);
}

// indptr: (n + 1,) int32 from 0 to E; src: (E,) int32 in [0, n); u, out:
// (n, 128) float32, contiguous and 16-byte aligned; rows [0, hot) of u load
// with evict_last; scratch: 16-byte aligned, softmax_aggr_scratch_bytes of
// it. Three launches on `stream`.
int softmax_aggr_f32(const void* indptr, const void* src, int64_t E, const void* u, void* out,
                     int64_t n, int32_t width, int32_t hot, double t, float eps, void* scratch,
                     int64_t scratch_bytes, void* stream) {
  const int64_t need = softmax_aggr_scratch_bytes(n, E, width);
  if (need < 0 || scratch_bytes < need || reinterpret_cast<uintptr_t>(u) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.indptr = static_cast<const int32_t*>(indptr);
  a.src = static_cast<const int32_t*>(src);
  a.u = static_cast<const float*>(u);
  a.out = static_cast<float*>(out);
  a.E = E;
  a.items = n + E;
  a.tiles = (a.items + kTile - 1) / kTile;
  a.n = static_cast<int32_t>(n);
  a.hot = hot;
  a.c = static_cast<float>(t * kLog2e);
  a.eps = eps;
  a.rec = static_cast<float4*>(scratch);
  a.first_row = reinterpret_cast<int32_t*>(a.rec + a.tiles * 2 * 3 * 32);
  a.head_row = a.first_row + a.tiles;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto blocks = static_cast<unsigned>((a.tiles + kWarps - 1) / kWarps);
  softmax_aggr_partition_kernel<<<static_cast<unsigned>((a.tiles + kThreads - 1) / kThreads),
                                  kThreads, 0, st>>>(a);
  softmax_aggr_kernel<<<blocks, kThreads, 0, st>>>(a);
  softmax_aggr_merge_kernel<<<blocks, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
