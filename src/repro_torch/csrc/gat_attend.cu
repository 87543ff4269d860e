// GAT's attention over a destination-sorted CSR, for NVIDIA Hopper (sm_90a).
//
// For every row i and head k, over the items j of N_in(i) and i itself (the
// self loop):
//   e_j = LeakyReLU(s_src[j, k] + s_dst[i, k]),  p_j = exp(e_j - max_j e_j)
//   o[i, k, :] = sum_j p_j z[j, k, :] / sum_j p_j
// and out[i] is o[i] with its heads concatenated (H*C wide) or averaged (C
// wide). It replaces no Pallas kernel: the JAX package has no GAT. It was
// added for GAT's full-graph inference (configs/gat.py), where no kernel of
// the port computes a softmax over a vertex's variable-length in-edges
// followed by a weighted sum of its neighbours' rows: built from torch's
// operations it writes and reads (E, H*C) messages, 130 GB a layer at
// kron21's 63.5M edges and 2 KB rows.
//
// What bounds it: the rows. Each item loads a row of z (2 KB at 4 heads of
// 128, 752 B at 4 of 47) and its H scores; the least bytes read each row,
// score and id once and write each output row once (20.14 GB a forward at
// kron21), but rows are read once per in-edge, so its time is set by how
// many of those reads the L2 serves.
//
// What the design does about it:
//   - One pass, softmax and sum together: a warp keeps, for the row it
//     works on, each head's running maximum and sum of exp and the weighted
//     sum of rows in registers, rescaling them when a batch of 32 items
//     raises the maximum (an online softmax). It reads each id and score
//     once and writes nothing per edge.
//   - Row loads in 16-byte slices, the lanes of a warp side by side along
//     the row (a 2 KB row is four loads a lane); rows below `hot` (the High
//     Reuse Region, core.plan.make_plan's rows at the row's width) load with
//     an L2 evict_last policy and the others with evict_first, K1's rule
//     (csrc/hot_gather.cu), so the hot prefix stays in L2 while the cold
//     rows stream through it. A z that is not 16-byte aligned, or whose row
//     stride is not a multiple of 4 floats, is read a float at a time
//     (ops.project pads its product so that it never is). That branch also
//     sets the aligned loads' schedule: without it ptxas gave the 752 B
//     rows' instance 104 registers instead of 125 and fewer loads in
//     flight, and a layer took 29.5 ms instead of 23.4 (2 KB: 48.4 against
//     46.0, with the instances cut to these two); a warp barrier, volatile loads or unrolling did not restore it.
//     A warp has 16 floats a lane of rows in flight (one 2 KB row, two of
//     752 B): on kron21 (H100 80GB HBM3, 700 W) a layer took 48.0 / 23.4 ms
//     so, against 52.9 / 25.2 with twice as many (more registers, fewer
//     warps an SM); registers capped for two or three blocks an SM, four
//     times as many in flight, or tiles of 512 or 2,048 items were slower.
//   - Merge-path tiles (as csrc/segment_sum.cu): the N + E items (each row's
//     in-edges, then its self loop) are one list, and each warp owns kTile
//     consecutive items of it, so every warp does the same work whatever the
//     rows' lengths: a hub of 102,700 in-edges spans a hundred warps, and a
//     run of rows without edges is one warp's. A partition kernel finds each
//     tile's first row by a binary search of indptr.
//   - Rows that span tiles: each tile leaves the (maximum, sum, accumulator)
//     partial of the row it ends inside, and of the row it starts inside if
//     that row ends in it; a merge kernel folds a row's partials in tile
//     order and writes the row. So every launch on the same input gives the
//     same bits.
// Error: each head's sum is a chain of float32 roundings no longer than the
// items a warp walks of its row (kTile at most) plus the tiles the row spans,
// each with a rescale, so it is within (kTile + tiles + 8) roundings of the
// row's sum of p|z|, over a sum of p that is at least 1.
//
// NaN: a NaN score makes its row's head NaN, a NaN in a row of z the same
// element of its rows' outputs. A row without in-edges gives z_i.
//
// An id outside [0, N) fails a device-side assert, and so do offsets that
// do not run from 0 to E (raised at the next call that waits for the
// stream).
//
// Instances: GAT's 4 heads, with rows of 129-256 floats (two slices a lane;
// its last layer's 188) or 257-512 (four; its 512), a multiple of 4 floats.
//
// C interface for ctypes: the entry point returns a cudaError_t, the launches'
// (cudaGetLastError()), or cudaErrorInvalidValue for heads other than 4, rows
// outside those widths, or a scratch too small.

#include <assert.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 1024;          // items of the merged list a warp owns
constexpr int kHeads = 4;            // the instances' heads

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

__device__ __forceinline__ float ld1(const float* p, uint64_t policy) {
  float v;
  asm("ld.global.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p, uint64_t policy) {
  float4 v;
  asm("ld.global.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The same sum in every lane: lane 0's.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

// exp(from - to), 1 where they are equal (also both -inf).
__device__ __forceinline__ float rescale(float from, float to) {
  return from == to ? 1.0f : expf(from - to);
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ float& comp(float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

struct Args {
  const int32_t* indptr;  // (n + 1,), 0 .. E
  const int32_t* src;     // (E,), rows by destination
  const float* z;         // (n, width) at row stride z_stride
  const float* s_src;     // (n, heads) at row stride s_src_stride
  const float* s_dst;     // (n, heads) at row stride s_dst_stride
  float* out;             // (n, width) or (n, width / heads), contiguous
  int64_t z_stride, s_src_stride, s_dst_stride;
  int64_t E, items, tiles;
  int32_t n, width, channels, hot;
  float slope;
  bool mean, vec;         // vec: z's rows load in 16-byte slices
  int32_t* first_row;     // (tiles,): the row of each tile's first item
  int32_t* head_row;      // (tiles,): the row whose head partial a tile left, or -1
  float4* acc_rec;        // (tiles, 2, kS, 32): head and tail partials' accumulators
  float* ml_rec;          // (tiles, 2, 2, kH): their maxima and sums
};

// One row's partial: per head the maximum and sum of exp, and this lane's
// slices of the weighted sum (slice s covers floats 4 (lane + 32 s) .. + 3).
template <int kH, int kS>
struct Partial {
  float m[kH], l[kH];
  float4 acc[kS];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      m[h] = -INFINITY;
      l[h] = 0.0f;
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) acc[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
};

// Which head each of this lane's floats belongs to.
template <int kH, int kS>
struct Heads {
  int8_t of[kS][4];

  __device__ __forceinline__ Heads(int lane, int channels) {
#pragma unroll
    for (int s = 0; s < kS; ++s)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = (4 * (lane + 32 * s) + c) / channels;
        of[s][c] = static_cast<int8_t>(h < kH ? h : kH - 1);
      }
  }

  // v[head of float (s, c)], by selects (no indexing of registers)
  __device__ __forceinline__ float pick(const float (&v)[kH], int s, int c) const {
    float w = v[0];
#pragma unroll
    for (int h = 1; h < kH; ++h) w = of[s][c] == h ? v[h] : w;
    return w;
  }

  __device__ __forceinline__ void scale(float4 (&acc)[kS], const float (&v)[kH]) const {
#pragma unroll
    for (int s = 0; s < kS; ++s)
#pragma unroll
      for (int c = 0; c < 4; ++c) comp(acc[s], c) *= pick(v, s, c);
  }
};

// This lane's slices of z's row j (0 past the row's end).
template <int kS>
__device__ __forceinline__ void load_row(const Args& a, int lane, int32_t j, float4 (&row)[kS]) {
  const uint64_t policy = j < a.hot ? evict_last_policy() : evict_first_policy();
  const float* base = a.z + static_cast<int64_t>(j) * a.z_stride;
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int f = 4 * (lane + 32 * s);
    if (a.vec) {
      row[s] = f < a.width ? ld4(base + f, policy) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) comp(row[s], c) = f + c < a.width ? ld1(base + f + c, policy) : 0.0f;
    }
  }
}

// Fold items [k0, k1) of row r (item k < deg is in-edge indptr[r] + k, item
// deg the self loop) into p, 32 items at a time.
template <int kH, int kS>
__device__ __forceinline__ void walk(const Args& a, const Heads<kH, kS>& heads, int lane,
                                     int32_t r, int64_t e0, int deg, int k0, int k1,
                                     Partial<kH, kS>& p) {
  constexpr int kU = kS >= 4 ? 1 : 4 / kS;  // rows in flight a lane
  float sd[kH];
#pragma unroll
  for (int h = 0; h < kH; ++h) sd[h] = a.s_dst[static_cast<int64_t>(r) * a.s_dst_stride + h];
  for (int base = k0; base < k1; base += 32) {
    const int count = min(32, k1 - base);
    const int k = base + lane;
    const bool valid = lane < count;
    int32_t j = r;
    if (valid && k < deg) {
      j = __ldcs(a.src + e0 + k);
      assert(static_cast<uint32_t>(j) < static_cast<uint32_t>(a.n));
    }
    const uint64_t policy = j < a.hot ? evict_last_policy() : evict_first_policy();
    float w[kH], up[kH];
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      float e = -INFINITY;
      if (valid) {
        const float v = ld1(a.s_src + static_cast<int64_t>(j) * a.s_src_stride + h, policy) + sd[h];
        e = v > 0.0f ? v : v * a.slope;
      }
      const float top = fmaxf(p.m[h], warp_max(e));
      up[h] = rescale(p.m[h], top);
      w[h] = valid ? expf(e - top) : 0.0f;
      p.l[h] = p.l[h] * up[h] + warp_sum(w[h]);
      p.m[h] = top;
    }
    heads.scale(p.acc, up);
    for (int u = 0; u < count; u += kU) {
      float4 row[kU][kS];
#pragma unroll
      for (int q = 0; q < kU; ++q) {
        const int32_t jq = __shfl_sync(0xffffffffu, j, (u + q) & 31);
        if (u + q < count) load_row<kS>(a, lane, jq, row[q]);
      }
#pragma unroll
      for (int q = 0; q < kU; ++q) {
        float wq[kH];
#pragma unroll
        for (int h = 0; h < kH; ++h) wq[h] = __shfl_sync(0xffffffffu, w[h], (u + q) & 31);
        if (u + q < count) {
#pragma unroll
          for (int s = 0; s < kS; ++s)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              comp(p.acc[s], c) = fmaf(heads.pick(wq, s, c), comp(row[q][s], c), comp(p.acc[s], c));
        }
      }
    }
  }
}

// Row r's output from its whole partial: each float over its head's sum,
// the heads concatenated, or averaged through this warp's buffer.
template <int kH, int kS>
__device__ __forceinline__ void finish(const Args& a, const Heads<kH, kS>& heads, int lane,
                                       int32_t r, Partial<kH, kS>& p, float* buf) {
#pragma unroll
  for (int s = 0; s < kS; ++s)
#pragma unroll
    for (int c = 0; c < 4; ++c) comp(p.acc[s], c) = comp(p.acc[s], c) / heads.pick(p.l, s, c);
  if (!a.mean) {
    float* row = a.out + static_cast<int64_t>(r) * a.width;
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int f = 4 * (lane + 32 * s);
      if (f < a.width) *reinterpret_cast<float4*>(row + f) = p.acc[s];
    }
    return;
  }
#pragma unroll
  for (int s = 0; s < kS; ++s) reinterpret_cast<float4*>(buf)[lane + 32 * s] = p.acc[s];
  __syncwarp();
  float* row = a.out + static_cast<int64_t>(r) * a.channels;
  for (int c = lane; c < a.channels; c += 32) {
    float v = buf[c];
#pragma unroll
    for (int h = 1; h < kH; ++h) v += buf[h * a.channels + c];
    row[c] = v / kH;
  }
  __syncwarp();
}

template <int kH, int kS>
__device__ __forceinline__ void store(const Args& a, int64_t rec, int lane,
                                      const Partial<kH, kS>& p) {
#pragma unroll
  for (int s = 0; s < kS; ++s) a.acc_rec[(rec * kS + s) * 32 + lane] = p.acc[s];
  if (lane < kH) {
#pragma unroll
    for (int h = 0; h < kH; ++h)
      if (h == lane) {
        a.ml_rec[rec * 2 * kH + h] = p.m[h];
        a.ml_rec[rec * 2 * kH + kH + h] = p.l[h];
      }
  }
}

// p <- p merged with the partial in record rec.
template <int kH, int kS>
__device__ __forceinline__ void merge(const Args& a, const Heads<kH, kS>& heads, int64_t rec,
                                      int lane, Partial<kH, kS>& p) {
  float up[kH], in[kH];
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    const float m = a.ml_rec[rec * 2 * kH + h], l = a.ml_rec[rec * 2 * kH + kH + h];
    const float top = fmaxf(p.m[h], m);
    up[h] = rescale(p.m[h], top);
    in[h] = rescale(m, top);
    p.l[h] = p.l[h] * up[h] + l * in[h];
    p.m[h] = top;
  }
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const float4 v = a.acc_rec[(rec * kS + s) * 32 + lane];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      comp(p.acc[s], c) = comp(p.acc[s], c) * heads.pick(up, s, c) + comp(v, c) * heads.pick(in, s, c);
  }
}

// first_row[t] = the row of item t * kTile: the first row whose end (its
// self loop, at indptr[r + 1] + r) is at or past it.
__global__ void __launch_bounds__(kThreads) gat_attend_partition_kernel(Args a) {
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
template <int kH, int kS>
__global__ void __launch_bounds__(kThreads) gat_attend_kernel(Args a) {
  __shared__ __align__(16) float bufs[kWarps][128 * kS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (t >= a.tiles) return;
  const Heads<kH, kS> heads(lane, a.channels);
  const int64_t d0 = t * kTile, d1 = min(d0 + kTile, a.items);
  int32_t r = a.first_row[t], head = -1;
  // indptr[r0 + lane], 32 rows at a time
  int32_t r0 = r, ptr = a.indptr[min(r0 + lane, a.n)];
  Partial<kH, kS> p;
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
    walk<kH, kS>(a, heads, lane, r, e0, static_cast<int>(e1 - e0), static_cast<int>(lo - start),
                 static_cast<int>(hi - start), p);
    if (hi < end) {  // the row goes on past the tile: the tail partial
      store<kH, kS>(a, 2 * t + 1, lane, p);
      break;
    }
    if (lo > start) {  // the row began in an earlier tile: the head partial
      store<kH, kS>(a, 2 * t, lane, p);
      head = r;
    } else {
      finish<kH, kS>(a, heads, lane, r, p, bufs[warp]);
    }
    if (hi == d1) break;
    ++r;
  }
  if (lane == 0) a.head_row[t] = head;
}

// One warp a tile whose head partial is a row's last: folds the tail
// partials of the row's earlier tiles in order, then the head, and writes
// the row.
template <int kH, int kS>
__global__ void __launch_bounds__(kThreads) gat_attend_merge_kernel(Args a) {
  __shared__ __align__(16) float bufs[kWarps][128 * kS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (t >= a.tiles) return;
  const int32_t r = a.head_row[t];
  if (r < 0) return;
  const Heads<kH, kS> heads(lane, a.channels);
  const int64_t first = (static_cast<int64_t>(a.indptr[r]) + r) / kTile;
  Partial<kH, kS> p;
  p.clear();
  for (int64_t u = first; u < t; ++u) merge<kH, kS>(a, heads, 2 * u + 1, lane, p);
  merge<kH, kS>(a, heads, 2 * t, lane, p);
  finish<kH, kS>(a, heads, lane, r, p, bufs[warp]);
}

// 16-byte slices a lane of a row of `width` floats: 2 or 4, 0 for a width
// without an instance.
int slices_for(int width) {
  if (width % 4 != 0) return 0;
  return width > 128 && width <= 256 ? 2 : width > 256 && width <= 512 ? 4 : 0;
}

template <int kH, int kS>
void launch(const Args& a, cudaStream_t st) {
  const auto blocks = static_cast<unsigned>((a.tiles + kWarps - 1) / kWarps);
  gat_attend_kernel<kH, kS><<<blocks, kThreads, 0, st>>>(a);
  gat_attend_merge_kernel<kH, kS><<<blocks, kThreads, 0, st>>>(a);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

// Bytes of scratch a call needs, -1 for shapes the kernel does not take.
int64_t gat_attend_scratch_bytes(int64_t n, int64_t E, int32_t heads, int32_t width) {
  const int64_t slices = slices_for(width);
  if (n <= 0 || E < 0 || heads != kHeads || slices == 0 || width % heads != 0) return -1;
  const int64_t tiles = (n + E + kTile - 1) / kTile;
  return tiles * (2 * slices * 32 * 16 + 2 * 2 * heads * 4 + 8);
}

// indptr: (n + 1,) int32 from 0 to E; src: (E,) int32 in [0, n); z: (n,
// width) float32 at row stride z_stride; s_src, s_dst: (n, heads) float32
// at their row strides; out: (n, width), or (n, width / heads) when mean,
// contiguous and 16-byte aligned; rows [0, hot) load with evict_last;
// scratch: 16-byte aligned, gat_attend_scratch_bytes of it. Three launches
// on `stream`.
int gat_attend_f32(const void* indptr, const void* src, int64_t E, const void* z,
                   int64_t z_stride, const void* s_src, int64_t s_src_stride, const void* s_dst,
                   int64_t s_dst_stride, void* out, int64_t n, int32_t heads, int32_t width,
                   int32_t hot, float slope, int32_t mean, void* scratch, int64_t scratch_bytes,
                   void* stream) {
  const int64_t need = gat_attend_scratch_bytes(n, E, heads, width);
  if (need < 0 || scratch_bytes < need) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.indptr = static_cast<const int32_t*>(indptr);
  a.src = static_cast<const int32_t*>(src);
  a.z = static_cast<const float*>(z);
  a.s_src = static_cast<const float*>(s_src);
  a.s_dst = static_cast<const float*>(s_dst);
  a.out = static_cast<float*>(out);
  a.z_stride = z_stride;
  a.s_src_stride = s_src_stride;
  a.s_dst_stride = s_dst_stride;
  a.E = E;
  a.items = n + E;
  a.tiles = (a.items + kTile - 1) / kTile;
  a.n = static_cast<int32_t>(n);
  a.width = width;
  a.channels = width / heads;
  a.hot = hot;
  a.slope = slope;
  a.mean = mean != 0;
  a.vec = reinterpret_cast<uintptr_t>(z) % 16 == 0 && z_stride % 4 == 0 && width % 4 == 0;
  const int slices = slices_for(width);
  a.acc_rec = static_cast<float4*>(scratch);
  a.ml_rec = reinterpret_cast<float*>(a.acc_rec + a.tiles * 2 * slices * 32);
  a.first_row = reinterpret_cast<int32_t*>(a.ml_rec + a.tiles * 2 * 2 * heads);
  a.head_row = a.first_row + a.tiles;
  const auto st = static_cast<cudaStream_t>(stream);
  gat_attend_partition_kernel<<<static_cast<unsigned>((a.tiles + kThreads - 1) / kThreads),
                                kThreads, 0, st>>>(a);
  if (slices == 2)
    launch<kHeads, 2>(a, st);
  else
    launch<kHeads, 4>(a, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
