// The four statistics of PNA's aggregation over the rows of a CSR, for NVIDIA
// Hopper (sm_90a): for float32 messages m (E, d) sorted by row, with offsets
// (R + 1,), out (4, R, d) holds each row's sum of the messages, sum of their
// squares, maximum and minimum, column by column. A row with no message sums
// to 0; a maximum or minimum that is not finite (a row with no message, an
// infinity, a NaN) is 0. NaN propagates as the port's plain path gives it:
// into the sums, and into the extremes before they are zeroed.
//
// It replaces no Pallas kernel: the JAX package reduces PNA's messages with
// XLA's jax.ops.segment_sum, segment_max and segment_min. It was added
// because PNA's blocked inference layer (nn/gnn.py, _pna_blocked) read each
// block's messages four times, and once more to square them: two index_add_
// (a float atomic a message) and two torch.segment_reduce calls took 39% of
// a forward on the kron21.pna cell.
//
// What bounds it: the bytes. It reads the messages once (4·E·d bytes), the
// offsets once (4(R + 1)) and writes each row's four statistics once
// (16·R·d): at the kron21.pna cell's blocks (E 2^24, d 75, R ~524K) that is
// 5.66 GB, 1.69 ms at 3.35e12 B/s. It makes no atomic and reads no row id.
//
// What the design does about it:
//   - Merge-path partition (Merrill and Garland, SC'16), as csrc/segment_sum.cu:
//     the R row ends and the E messages are one merged list, and each block
//     owns a tile of the same number of items of it, whatever the rows'
//     lengths: a hub's 102,580 messages span hundreds of tiles and a run of
//     empty rows is a few items of one. A tile holds at most
//     min(kStage / d, kMaxItems) items (218 at d = 75), so that its messages
//     fit the kStage floats it stages. A small kernel finds each tile's
//     first (row, message) by a binary search of the offsets.
//   - Each block stages its tile's messages, one contiguous span of
//     (messages · d) floats, in shared memory with 16-byte cp.async copies,
//     whatever the rows' alignment (d = 75 makes 300-byte rows): the span is
//     copied in the aligned quads of global memory that cover it, and a
//     quad past an end of the array is read an element at a time. A float's
//     column is its position in the span modulo d. No thread loads a row.
//   - Each of the block's 8 warps walks an eighth of the tile's items in
//     order; lane l keeps the four statistics of columns l, l + 32, ... in
//     registers (at most 4 columns a lane: d <= 128) and reads them from
//     shared memory, consecutive lanes on consecutive floats. A row that
//     ends inside the warp's items is stored from registers. Each warp's
//     last partial row goes to shared memory, and a warp's first row, which
//     may begin in an earlier warp, takes the earlier warps' parts in order.
//   - Rows that span tiles: each tile leaves the 4·d partials of the row it
//     ends inside (its carry), and a carry pass of two small kernels folds
//     the carries of the tiles before a row's last tile into that row in a
//     fixed order, then zeroes its non-finite extremes: blocks of kGroup
//     tiles walk their tiles in order, a thread a column, and a segmented
//     scan over the groups, a block a column, joins the groups a row spans.
//     No atomic, so a launch repeats bit for bit. On the kron21.pna cell
//     (H100 80GB HBM3) a layer's four launches take 8.42 ms against the
//     6.44 ms bound, the carry pass 0.51 of it; a carry pass that waited on
//     each row's load in turn and walked the groups in one block took 1.56.
//   - Everything is float32, the messages' type. The square of a message
//     is exact inside the fma that adds it. The extremes take max.NaN and
//     min.NaN, which return NaN where either input is NaN (fmaxf/fminf drop
//     it).
// Error bound: the sums' order is a tree. A message passes through a warp's
// run of at most ceil(items / 8) in sequence, up to 8 warps' parts, the
// carries of the T tiles its row spans in sequence, and for a row that spans
// groups a warp's scan (5) and up to 8 warps' parts, then 2 more joins: so
// each sum lies within (ceil(items / 8) + 23 + T) float32 roundings of the
// row's sum of magnitudes (of squares, for the sum of squares) of its
// float64 value, where T <= (length + 1) / items + 2 and items =
// min(16384 / d, 2048). The extremes are exact.
//
// The partition asserts offsets[0] == 0 and offsets[R] == E (a device-side
// assert, raised at the next call that waits for the stream). Offsets that
// decrease give wrong rows but no access out of bounds.
//
// C interface for ctypes: the entry point returns a cudaError_t, the launches'
// (cudaGetLastError()) or cudaErrorInvalidValue for what it does not take.

#include <assert.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 16384;     // floats of messages a tile stages (64 KB)
constexpr int kMaxItems = 2048;   // items of the merged list a tile owns, at most
constexpr int kMaxCols = 4;       // columns a lane keeps: d <= 32 * kMaxCols
constexpr int kCarryThreads = 32 * kMaxCols;  // a thread a column in the carry pass
constexpr int kGroup = 64;        // tiles a block of the carry pass walks
constexpr int kBatch = 8;         // tiles the carry pass loads at once
constexpr int kScanThreads = 256; // groups' runs the second carry kernel scans
constexpr int kIntMax = 0x7fffffff;

int tile_items(int d) { return kStage / d < kMaxItems ? kStage / d : kMaxItems; }

int64_t tiles_for(int64_t R, int64_t E, int d) {
  return (R + E + tile_items(d) - 1) / tile_items(d);
}

int64_t groups_for(int64_t tiles) { return (tiles + kGroup - 1) / kGroup; }

size_t smem_bytes(int d) {  // the messages (and their lead), then the row ends
  return sizeof(int32_t) * (kStage + 4 + tile_items(d) + 4);
}

// src[first + k] for k < count into dst, 16-byte aligned shared memory:
// element first + k goes to dst[lead + k], where lead is the element's place
// in its aligned quad of global memory, so that each quad is one 16-byte
// cp.async copy (its elements outside the slice are copied too and never
// read). A quad that passes either end of the array is read an element at a
// time. Returns lead; the copies land at cp.async.wait_all.
__device__ __forceinline__ int stage(const int32_t* __restrict__ src, int64_t len,
                                     int64_t first, int count, int32_t* dst) {
  const int lead = static_cast<int>((reinterpret_cast<uintptr_t>(src + first) >> 2) & 3);
  const int quads = count > 0 ? (lead + count + 3) >> 2 : 0;
  for (int q = threadIdx.x; q < quads; q += kThreads) {
    const int64_t g = first - lead + 4 * q;  // the quad's first element
    if (g >= 0 && g + 4 <= len) {
      const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + 4 * q));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src + g)
                   : "memory");
    } else {
      for (int k = 0; k < 4; ++k)
        if (g + k >= 0 && g + k < len) dst[4 * q + k] = __ldcs(src + g + k);
    }
  }
  return lead;
}

// Where the merged list's diagonal d crosses: (row ends taken, messages
// taken). A row's end comes after its messages: message e is taken before
// row end r while e < ends(r).
template <typename Ends>
__device__ __forceinline__ int64_t merge_path(int64_t d, int64_t rows, int64_t msgs,
                                              Ends ends) {
  int64_t lo = d > msgs ? d - msgs : 0, hi = d < rows ? d : rows;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (ends(mid) <= d - mid - 1) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float finite_or_zero(float v) {
  return fabsf(v) <= 3.402823466e38f ? v : 0.0f;  // false for ±inf and NaN
}

// One column's statistics of a run of messages.
struct Stats {
  float sum, sq, hi, lo;
};

__device__ __forceinline__ Stats none() { return {0.0f, 0.0f, -CUDART_INF_F, CUDART_INF_F}; }

__device__ __forceinline__ void take(Stats& a, float x) {
  a.sum += x;
  a.sq = fmaf(x, x, a.sq);
  a.hi = max_nan(a.hi, x);
  a.lo = min_nan(a.lo, x);
}

// a's run, then b's
__device__ __forceinline__ Stats join(Stats a, Stats b) {
  return {a.sum + b.sum, a.sq + b.sq, max_nan(a.hi, b.hi), min_nan(a.lo, b.lo)};
}

// Plane p of the (4, R, d) statistics or of a (., 4, d) array of partials
// lies `plane` floats after plane p - 1.
__device__ __forceinline__ Stats load(const float* __restrict__ at, int64_t plane) {
  return {at[0], at[plane], at[2 * plane], at[3 * plane]};
}

__device__ __forceinline__ void store(float* __restrict__ at, int64_t plane, Stats v) {
  at[0] = v.sum;
  at[plane] = v.sq;
  at[2 * plane] = v.hi;
  at[3 * plane] = v.lo;
}

// A row's statistics as the caller sees them: the extremes zeroed where not finite.
__device__ __forceinline__ Stats finished(Stats v) {
  return {v.sum, v.sq, finite_or_zero(v.hi), finite_or_zero(v.lo)};
}

// coords[t] = where tile t's items start, for t in [0, tiles]:
// coords[tiles] = (R, E).
__global__ void __launch_bounds__(kThreads) segment_reduce_partition_kernel(
    const int32_t* __restrict__ offsets, int64_t R, int64_t E, int items, int64_t tiles,
    int2* __restrict__ coords) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t > tiles) return;
  if (t == 0) assert(offsets[0] == 0 && offsets[R] == E);
  const int64_t d = t * items < R + E ? t * items : R + E;
  const int64_t rows = merge_path(d, R, E, [&](int64_t r) { return offsets[r + 1]; });
  coords[t] = make_int2(static_cast<int>(rows), static_cast<int>(d - rows));
}

// One block a tile of the merged list: writes every row whose end lies in
// the tile, and leaves in carry[tile] the partials of the row the tile ends
// inside. The tile's first row, when the tile ends it and is not tile 0, is
// written as partials (extremes not zeroed), which the carry pass finishes:
// it may have begun in an earlier tile.
template <int kCols>
__global__ void __launch_bounds__(kThreads, 3) segment_reduce_kernel(
    const float* __restrict__ m, const int32_t* __restrict__ offsets, int64_t R, int64_t E,
    int d, const int2* __restrict__ coords, float* __restrict__ out,
    float* __restrict__ carry) {
  extern __shared__ __align__(16) int32_t staged[];  // messages, then row ends
  __shared__ int warp_head[kWarps];

  const int2 c0 = coords[blockIdx.x], c1 = coords[blockIdx.x + 1];
  const int row0 = c0.x, edge0 = c0.y;
  const int rows = c1.x - row0, msgs = c1.y - edge0, total = rows + msgs;
  const int msgs_at = stage(reinterpret_cast<const int32_t*>(m), E * d,
                            static_cast<int64_t>(edge0) * d, msgs * d, staged);
  int32_t* ends_region = staged + kStage + 4;
  const int ends_at = stage(offsets, R + 1, row0 + 1, rows, ends_region);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  const int32_t* ends = ends_region + ends_at;  // ends[i]: row row0 + i's end, a global offset
  const float* msg = reinterpret_cast<const float*>(staged + msgs_at);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t plane = R * d;
  // this warp's items [lo, hi) of the tile
  const int per = (total + kWarps - 1) / kWarps;
  const int lo = min(warp * per, total), hi = min(lo + per, total);
  int i = static_cast<int>(merge_path(lo, rows, msgs, [&](int64_t r) { return ends[r] - edge0; }));
  int j = lo - i;
  int next_end = i < rows ? ends[i] - edge0 : kIntMax;
  Stats run[kCols], first[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) run[k] = none();
  int first_row = -1;  // the first row the warp ends, tile-local
  for (int item = lo; item < hi; ++item) {
    if (next_end <= j) {  // row i ends
      if (first_row < 0) {
        first_row = i;
#pragma unroll
        for (int k = 0; k < kCols; ++k) first[k] = run[k];
      } else {
        float* at = out + static_cast<int64_t>(row0 + i) * d + lane;
#pragma unroll
        for (int k = 0; k < kCols; ++k)
          if (k < kCols - 1 || lane + 32 * k < d) store(at + 32 * k, plane, finished(run[k]));
      }
#pragma unroll
      for (int k = 0; k < kCols; ++k) run[k] = none();
      ++i;
      next_end = i < rows ? ends[i] - edge0 : kIntMax;
    } else {
      const float* x = msg + j * d + lane;
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (k < kCols - 1 || lane + 32 * k < d) take(run[k], x[32 * k]);
      ++j;
    }
  }

  // Each warp's last run goes to shared memory, over the staged messages:
  // part[w][p][c] holds warp w's plane p of column c.
  __syncthreads();
  float* part = reinterpret_cast<float*>(staged);
  if (lane == 0) warp_head[warp] = first_row >= 0;
#pragma unroll
  for (int k = 0; k < kCols; ++k)
    if (k < kCols - 1 || lane + 32 * k < d) store(part + warp * 4 * d + lane + 32 * k, d, run[k]);
  __syncthreads();

  // the warps' parts from the last warp before w that ends a row (its run
  // after that end) up to w - 1, in order
  const auto before = [&](int w, int c) {
    int h = w - 1;
    while (h > 0 && !warp_head[h]) --h;
    Stats v = none();
    for (int u = h < 0 ? 0 : h; u < w; ++u) v = join(v, load(part + u * 4 * d + c, d));
    return v;
  };
  if (first_row >= 0) {
    // the tile's first row (a warp's first row 0: no earlier warp ends a
    // row) may have begun in an earlier tile
    const bool partial = first_row == 0 && blockIdx.x > 0;
    float* at = out + static_cast<int64_t>(row0 + first_row) * d;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int c = lane + 32 * k;
      if (k < kCols - 1 || c < d) {
        const Stats v = join(before(warp, c), first[k]);
        store(at + c, plane, partial ? v : finished(v));
      }
    }
  }
  if (warp == kWarps - 1) {
    float* at = carry + static_cast<int64_t>(blockIdx.x) * 4 * d;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int c = lane + 32 * k;
      if (k < kCols - 1 || c < d) store(at + c, d, before(kWarps, c));
    }
  }
}

// The carry pass: into each row that spans tiles, the carries of the tiles
// before its last one, in tile order, then the row finished. Tile p's carry
// belongs to the row it ends inside, and a tile that ends a row starts that
// row's partials anew. Blocks of kGroup tiles walk their tiles in order (a
// thread a column, kBatch tiles' loads at once) and finish every row a tile
// of theirs ends, but for a group after the first the row of its first such
// tile, whose earlier part lies in earlier groups. A second kernel finishes
// those: a block a column takes a segmented scan of the groups' partials
// across its threads, each thread holding a run of consecutive groups.
struct Groups {
  float* sum;    // (count, 4, d): the group's partials after its last ending tile
  float* first;  // (count, 4, d): the group's part of the row its first ending tile ends
  int* head;     // (count,): whether a tile of the group ends a row
  int* row;      // (count,): that row, or -1 where the group finishes it itself
};

__global__ void __launch_bounds__(kCarryThreads) segment_reduce_carry_kernel(
    const int2* __restrict__ coords, const float* __restrict__ carry, int64_t tiles, int64_t R,
    int d, float* __restrict__ out, Groups groups) {
  const int c = threadIdx.x;
  if (c >= d) return;
  const int64_t g = blockIdx.x, p0 = g * kGroup, p1 = min(p0 + kGroup, tiles);
  const int64_t plane = R * d;
  Stats acc = none();
  bool head = false;
  int deferred = -1;
  for (int64_t pb = p0; pb < p1; pb += kBatch) {
    int row[kBatch + 1];
#pragma unroll
    for (int b = 0; b <= kBatch; ++b) row[b] = pb + b <= p1 ? coords[pb + b].x : 0;
    // the batch's carries, and the partials of each row one of its tiles ends
    Stats part[kBatch], own[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const bool valid = pb + b < p1, ends = valid && row[b + 1] != row[b] && pb + b > 0;
      part[b] = valid ? load(carry + (pb + b) * 4 * d + c, d) : none();
      own[b] = ends ? load(out + static_cast<int64_t>(row[b]) * d + c, plane) : none();
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int64_t p = pb + b;
      if (p < p1) {
        const bool ends = row[b + 1] != row[b];
        if (ends && p > 0) {
          if (head || g == 0) {  // every earlier tile of the row is in this group
            store(out + static_cast<int64_t>(row[b]) * d + c, plane, finished(join(acc, own[b])));
          } else {  // the group's first ending tile: earlier groups hold the rest
            deferred = row[b];
            store(groups.first + g * 4 * d + c, d, acc);
          }
        }
        acc = ends ? part[b] : join(acc, part[b]);
        head = head || ends;
      }
    }
  }
  store(groups.sum + g * 4 * d + c, d, acc);
  if (c == 0) {
    groups.head[g] = head;
    groups.row[g] = deferred;
  }
}

// Over a block's threads in order, each with its partials v and whether a
// row ends in its part (head): the partials of the threads before it, from
// the last one with a head (its v) on, of the row the thread starts in.
template <int kBlock>
__device__ __forceinline__ Stats exclusive_segmented_scan(bool head, Stats v) {
  __shared__ Stats warp_v[kBlock / 32];
  __shared__ int warp_head[kBlock / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const auto up = [](Stats x, int off) {
    return Stats{__shfl_up_sync(0xffffffffu, x.sum, off), __shfl_up_sync(0xffffffffu, x.sq, off),
                 __shfl_up_sync(0xffffffffu, x.hi, off), __shfl_up_sync(0xffffffffu, x.lo, off)};
  };
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Stats x = up(v, off);
    const int x_head = __shfl_up_sync(0xffffffffu, static_cast<int>(head), off);
    if (lane >= off) {
      if (!head) v = join(x, v);
      head = head || x_head;
    }
  }
  if (lane == 31) {
    warp_v[warp] = v;
    warp_head[warp] = head;
  }
  __syncthreads();
  Stats before = none();  // the warps before this one, in order
  for (int w = 0; w < warp; ++w) before = warp_head[w] ? warp_v[w] : join(before, warp_v[w]);
  const Stats prev = up(v, 1);
  const int prev_head = __shfl_up_sync(0xffffffffu, static_cast<int>(head), 1);
  return lane == 0 ? before : (prev_head ? prev : join(before, prev));
}

// A block a column: thread t holds a run of consecutive groups.
__global__ void __launch_bounds__(kScanThreads) segment_reduce_carry_groups_kernel(
    int64_t count, int64_t R, int d, float* __restrict__ out, Groups groups) {
  const int c = blockIdx.x;
  const int64_t plane = R * d;
  const int64_t per = (count + kScanThreads - 1) / kScanThreads;
  const int64_t lo = min(static_cast<int64_t>(threadIdx.x) * per, count);
  const int64_t hi = min(lo + per, count);
  Stats v = none();
  bool head = false;
  for (int64_t g = lo; g < hi; ++g) {
    const Stats sum = load(groups.sum + g * 4 * d + c, d);
    v = groups.head[g] ? sum : join(v, sum);
    head = head || groups.head[g];
  }
  Stats s = exclusive_segmented_scan<kScanThreads>(head, v);
  for (int64_t g = lo; g < hi; ++g) {
    const int row = groups.row[g];
    if (row >= 0) {
      float* at = out + static_cast<int64_t>(row) * d + c;
      const Stats fix = join(s, load(groups.first + g * 4 * d + c, d));
      store(at, plane, finished(join(fix, load(at, plane))));
    }
    const Stats sum = load(groups.sum + g * 4 * d + c, d);
    s = groups.head[g] ? sum : join(s, sum);
  }
}

template <int kCols>
void launch_tiles(const float* m, const int32_t* offsets, int64_t R, int64_t E, int d,
                  int64_t tiles, const int2* coords, float* out, float* carry,
                  cudaStream_t st) {
  auto* kernel = segment_reduce_kernel<kCols>;
  const size_t smem = smem_bytes(d);  // beyond 48 KB, dynamic shared memory must be asked for
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  kernel<<<static_cast<unsigned>(tiles), kThreads, smem, st>>>(m, offsets, R, E, d, coords, out,
                                                               carry);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

// Bytes of scratch segment_reduce_f32 needs: the tiles' coordinates and
// carries, and the carry pass's partials and two words a group of tiles.
int64_t segment_reduce_scratch_bytes(int64_t R, int64_t E, int32_t d) {
  if (R <= 0 || E <= 0 || d <= 0) return 0;
  const int64_t tiles = tiles_for(R, E, d), count = groups_for(tiles);
  return 8 * (tiles + 1) + 16 * d * tiles + count * (32 * d + 8);
}

// m: (E, d) float32, contiguous; offsets: (R + 1,) int32 with offsets[0] =
// 0, offsets[R] = E; out: (4, R, d) float32, every element written;
// scratch: 8-byte aligned, of segment_reduce_scratch_bytes(R, E, d) bytes.
// Up to four launches on `stream`. R and E are positive and d is at most 128.
int segment_reduce_f32(const void* m, const void* offsets, int64_t E, int64_t R, int32_t d,
                       void* out, void* scratch, int64_t scratch_bytes, void* stream) {
  if (R <= 0 || E <= 0 || d <= 0 || d > 32 * kMaxCols ||
      scratch_bytes < segment_reduce_scratch_bytes(R, E, d))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = tiles_for(R, E, d), count = groups_for(tiles);
  const auto* msgs = static_cast<const float*>(m);
  const auto* ptr = static_cast<const int32_t*>(offsets);
  auto* o = static_cast<float*>(out);
  auto* coords = static_cast<int2*>(scratch);
  auto* carry = reinterpret_cast<float*>(coords + tiles + 1);
  float* gsum = carry + tiles * 4 * d;
  float* gfirst = gsum + count * 4 * d;
  auto* ghead = reinterpret_cast<int*>(gfirst + count * 4 * d);
  const Groups groups{gsum, gfirst, ghead, ghead + count};
  const auto st = static_cast<cudaStream_t>(stream);
  const auto blocks = static_cast<unsigned>((tiles + kThreads) / kThreads);  // tiles + 1 threads
  segment_reduce_partition_kernel<<<blocks, kThreads, 0, st>>>(ptr, R, E, tile_items(d), tiles,
                                                               coords);
  switch ((d + 31) / 32) {
    case 1: launch_tiles<1>(msgs, ptr, R, E, d, tiles, coords, o, carry, st); break;
    case 2: launch_tiles<2>(msgs, ptr, R, E, d, tiles, coords, o, carry, st); break;
    case 3: launch_tiles<3>(msgs, ptr, R, E, d, tiles, coords, o, carry, st); break;
    default: launch_tiles<4>(msgs, ptr, R, E, d, tiles, coords, o, carry, st); break;
  }
  if (tiles > 1) {
    segment_reduce_carry_kernel<<<static_cast<unsigned>(count), kCarryThreads, 0, st>>>(
        coords, carry, tiles, R, d, o, groups);
    if (count > 1)
      segment_reduce_carry_groups_kernel<<<static_cast<unsigned>(d), kScanThreads, 0, st>>>(
          count, R, d, o, groups);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
