// Segment sum of float32 messages over the rows of a CSR, for NVIDIA Hopper
// (sm_90a).
//
// out[r] = data[indptr[r]] + ... + data[indptr[r + 1] - 1], and 0 for a row
// with no messages, as jax.ops.segment_sum gives. It is what the port's
// engine.sum_reduce (index_add_ over a zero base) computes for
// edge_map_pull, whose messages come in the in-CSR's order: g.dst is sorted
// and g.indptr holds its rows' offsets. It replaces no Pallas kernel: the
// JAX package's pull sums with XLA's jax.ops.segment_sum. It was added
// because index_add_ took two thirds of PageRank-Delta's device time on the
// kron cell: it reads the (E,) int32 ids besides the messages and makes one
// float atomic a message, and under a hub's run thousands of neighbouring
// threads add into one address, one at a time.
//
// What bounds it: the bytes. An exact sum a row reads each message once (4E
// bytes), the N + 1 offsets once (4(N + 1)) and writes each row once (4N):
// 4.46 GB, 1.33 ms at 3.35e12 B/s, at the kron cell's shape (E 1.05e9, N
// 3.4e7). It makes no atomic and reads no id.
//
// What the design does about it:
//   - Merge-path partition (Merrill and Garland, "Merge-based parallel
//     sparse matrix-vector multiplication", SC'16). The N row ends and the
//     E messages are one merged list of N + E items; each block owns a tile
//     of kTile consecutive items of it, so every block does the same work
//     whatever the rows' lengths: a hub's million messages span hundreds of
//     blocks, and a run of thousands of empty rows (DBG puts them together)
//     is one block's rows. A small kernel finds each block's first (row,
//     message) by a binary search of indptr on the block's diagonal, all
//     blocks at once, before the main kernel runs.
//   - Each block stages its slice of offsets and messages in shared memory
//     with coalesced 16-byte cp.async copies, whatever the arrays'
//     alignment: each slice is copied in the aligned quads of global memory
//     that cover it, and a quad that passes an end of its array is read an
//     element at a time (__ldcs). Rows are written back coalesced with
//     st.global.cs. On the kron cell (H100 80GB HBM3) the main kernel takes
//     1.80 ms a launch this way; one 4-byte __ldcs load an element took 2.33 ms,
//     and a 16-byte __ldcs load a quad through registers 2.09 ms. An L2
//     evict_first policy on the copies, meant to keep the stream from
//     displacing the rows K1 (hot_gather.cu) marks evict_last, changed
//     neither this kernel's time nor K1's over PageRank-Delta's iterations
//     (8.86-8.87 ms a launch either way), and was not kept.
//   - Inside the block each thread finds its own 15 items of the merged
//     list by a binary search in shared memory and walks them with a
//     sequential float32 sum, ending a row at each row end (15 is odd, so a
//     warp's loads in a tile of one row's messages hit 32 banks). A
//     segmented scan across the block (warp shuffles with head flags, then
//     the warps in order) gives each thread the part of its first row that
//     earlier threads hold. A row that lies in one block is stored once,
//     with no atomic. Three other designs took the same time to four digits
//     on one card (H100 80GB HBM3, 700 W): 16 message slots a thread read
//     with 16-byte loads, persistent blocks that staged the next tile while
//     summing this one, and a block that only staged and stored. The time
//     moved instead from card to card and with the offsets' density (one
//     row: 1.4-1.6 ms at the kron cell's E; the cells' rows: 1.76-2.34 ms),
//     where a plain read of the messages took 1.34-1.41 ms.
//   - Rows that span blocks: each block leaves the part of the row it ends
//     inside (its carry), and a carry pass of two small kernels adds the
//     carries of the blocks before a row's last block into that row, in a
//     fixed order (not an atomicAdd a block). It scans the carries in
//     groups of tiles, then the groups, so its cost does not grow with a
//     row's length: one thread walking back over a row's tiles took 30.5 ms
//     for a single row of 1.07e9 messages, where this takes 0.01 ms; one
//     block of 1,024 threads, each folding and then walking its run of
//     consecutive tiles, took 0.71-0.86 ms on the PRD cells against these
//     two kernels' 0.015-0.027 ms. So every launch on the same input gives
//     the same bits, which index_add_ does not.
// The sum's order is a tree (15 in sequence, then the scan, then the
// carries): it is not index_add_'s, so the bits differ from it; its error
// bound is (30 + the tiles a row spans) float32 roundings of the row's sum
// of magnitudes, against a row's length for index_add_.
//
// The first kernel asserts indptr[0] == 0 and indptr[N] == E (a device-side
// assert, raised at the next call that waits for the stream). Offsets that
// decrease give wrong sums but no access out of bounds.
//
// C interface for ctypes: the entry point returns a cudaError_t, the launches'
// (cudaGetLastError()) or cudaErrorInvalidValue for a scratch too small.

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 15;                // items of the merged list a thread walks
constexpr int kTile = kThreads * kPerThread;  // row ends + messages a block owns
constexpr int kGroup = 1024;                  // tiles a block of the carry pass scans
constexpr int kIntMax = 0x7fffffff;

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

// A segmented scan's values at a thread: including it and before it, and
// whether a head lies in those threads.
struct Scan {
  float incl, excl;
  bool incl_head, excl_head;
};

// Segmented scan of (head, v) over a block's threads in order, where a head
// starts a new sum. Two calls need a __syncthreads between them.
template <int kBlock>
__device__ __forceinline__ Scan block_segmented_scan(bool head, float v) {
  __shared__ float warp_sum[kBlock / 32];
  __shared__ int warp_head[kBlock / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, v, off);
    const int up_head = __shfl_up_sync(0xffffffffu, static_cast<int>(head), off);
    if (lane >= off) {
      if (!head) v = up + v;
      head = head || up_head;
    }
  }
  if (lane == 31) {
    warp_sum[warp] = v;
    warp_head[warp] = head;
  }
  __syncthreads();
  float before = 0.0f;  // the warps before this one, scanned in order
  bool before_head = false;
  for (int w = 0; w < warp; ++w) {
    before = warp_head[w] ? warp_sum[w] : before + warp_sum[w];
    before_head = before_head || warp_head[w];
  }
  const float prev = __shfl_up_sync(0xffffffffu, v, 1);
  const int prev_head = __shfl_up_sync(0xffffffffu, static_cast<int>(head), 1);
  Scan s;
  s.excl = lane == 0 ? before : (prev_head ? prev : before + prev);
  s.excl_head = lane == 0 ? before_head : (prev_head || before_head);
  s.incl = head ? v : before + v;
  s.incl_head = head || before_head;
  return s;
}

// coords[t] = where tile t's items start, for t in [0, tiles]:
// coords[tiles] = (n, E).
__global__ void __launch_bounds__(kThreads) segment_sum_partition_kernel(
    const int32_t* __restrict__ indptr, int64_t n, int64_t E, int64_t tiles,
    int2* __restrict__ coords) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t > tiles) return;
  if (t == 0) assert(indptr[0] == 0 && indptr[n] == E);
  const int64_t d = t * kTile < n + E ? t * kTile : n + E;
  const int64_t rows = merge_path(d, n, E, [&](int64_t r) { return indptr[r + 1]; });
  coords[t] = make_int2(static_cast<int>(rows), static_cast<int>(d - rows));
}

// One block a tile of the merged list: writes every row whose end lies in
// the tile (the row's part in earlier tiles comes from the carry pass) and
// leaves in carry[tile] the part of the row the tile ends inside.
__global__ void __launch_bounds__(kThreads) segment_sum_kernel(
    const float* __restrict__ data, const int32_t* __restrict__ indptr, int64_t n,
    int64_t E, const int2* __restrict__ coords, float* __restrict__ out,
    float* __restrict__ carry) {
  __shared__ __align__(16) int32_t staged[kTile + 16];  // row ends, then messages
  __shared__ float sums[kTile];

  const int2 c0 = coords[blockIdx.x], c1 = coords[blockIdx.x + 1];
  const int row0 = c0.x, edge0 = c0.y;
  const int rows = c1.x - row0, msgs = c1.y - edge0, total = rows + msgs;
  const int ends_at = stage(indptr, n + 1, row0 + 1, rows, staged);
  const int msgs_from = (ends_at + rows + 3) & ~3;
  const int msgs_at = stage(reinterpret_cast<const int32_t*>(data), E, edge0, msgs,
                            staged + msgs_from);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  const int32_t* ends = staged + ends_at;  // ends[i]: row row0 + i's end, a global offset
  const float* msg = reinterpret_cast<const float*>(staged + msgs_from + msgs_at);

  // this thread's items [d, d + kPerThread) of the tile
  const int d = min(static_cast<int>(threadIdx.x) * kPerThread, total);
  int i = static_cast<int>(merge_path(d, rows, msgs, [&](int64_t r) { return ends[r] - edge0; }));
  int j = d - i;
  int next_end = i < rows ? ends[i] - edge0 : kIntMax;
  float run = 0.0f, first = 0.0f;
  int first_row = -1;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (d + k < total) {
      if (next_end <= j) {  // row i ends
        if (first_row < 0) {
          first_row = i;
          first = run;
        } else {
          sums[i] = run;
        }
        run = 0.0f;
        ++i;
        next_end = i < rows ? ends[i] - edge0 : kIntMax;
      } else {
        run += msg[j++];
      }
    }
  }

  // what the threads before this one hold of its first row, and the part
  // of the row the tile ends inside
  const Scan scan = block_segmented_scan<kThreads>(first_row >= 0, run);
  if (first_row >= 0) sums[first_row] = scan.excl + first;
  if (threadIdx.x == kThreads - 1) carry[blockIdx.x] = scan.incl;
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += kThreads) __stcs(out + row0 + r, sums[r]);
}

// The carry pass adds into each row that spans tiles the carries of the
// tiles before its last one. Tile p's carry belongs to the row it ends
// inside, and a tile that ends a row starts that sum anew: so a segmented
// scan of the carries in tile order, restarted at each such tile, holds
// before tile p the earlier tiles' part of p's first row. It runs in two
// kernels, in a fixed order of additions: blocks of kGroup tiles scan their
// tiles and finish every row but the group's first, then one block scans
// the groups and finishes those.
struct Groups {
  float* sum;    // the group's scan at its last tile
  int* head;     // whether a tile of the group ends a row
  int* row;      // the first row of the group's first tile that ends one, or -1
  float* first;  // that tile's part of it from the group's earlier tiles
};

__global__ void __launch_bounds__(kGroup) segment_sum_carry_kernel(
    const int2* __restrict__ coords, const float* __restrict__ carry, int64_t tiles,
    float* __restrict__ out, Groups groups) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kGroup + threadIdx.x;
  const bool valid = p < tiles;
  const int row = valid ? coords[p].x : 0;
  const bool ends = valid && coords[p + 1].x != row;
  if (threadIdx.x == 0) groups.row[blockIdx.x] = -1;
  const Scan scan = block_segmented_scan<kGroup>(ends, valid ? carry[p] : 0.0f);
  if (ends && p > 0) {
    if (scan.excl_head || blockIdx.x == 0) {  // every earlier tile of the row is here
      if (scan.excl != 0.0f) out[row] += scan.excl;
    } else {  // the group's first such tile: earlier groups hold the rest
      groups.row[blockIdx.x] = row;
      groups.first[blockIdx.x] = scan.excl;
    }
  }
  if (threadIdx.x == kGroup - 1) {
    groups.sum[blockIdx.x] = scan.incl;
    groups.head[blockIdx.x] = scan.incl_head;
  }
}

// One block: each thread takes a run of groups in order.
__global__ void __launch_bounds__(kGroup) segment_sum_carry_groups_kernel(
    int64_t count, float* __restrict__ out, Groups groups) {
  const int64_t per = (count + kGroup - 1) / kGroup;
  const int64_t lo = min(static_cast<int64_t>(threadIdx.x) * per, count);
  const int64_t hi = min(lo + per, count);
  bool head = false;
  float v = 0.0f;
  for (int64_t g = lo; g < hi; ++g) {
    v = groups.head[g] ? groups.sum[g] : v + groups.sum[g];
    head = head || groups.head[g];
  }
  float s = block_segmented_scan<kGroup>(head, v).excl;
  for (int64_t g = lo; g < hi; ++g) {
    if (groups.row[g] >= 0) {
      const float fix = s + groups.first[g];
      if (fix != 0.0f) out[groups.row[g]] += fix;
    }
    s = groups.head[g] ? groups.sum[g] : s + groups.sum[g];
  }
}

int64_t tiles_for(int64_t n, int64_t E) { return (n + E + kTile - 1) / kTile; }

int64_t groups_for(int64_t tiles) { return (tiles + kGroup - 1) / kGroup; }

}  // namespace

extern "C" {

const char* cuda_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

// data: (E,) float32; indptr: (n + 1,) int32 with indptr[0] = 0, indptr[n] =
// E; out: (n,) float32, every row written; scratch: 8-byte aligned, of at
// least 12 * tiles + 8 + 16 * ceil(tiles / 1024) bytes for tiles =
// ceil((n + E) / 3840): the tiles' coordinates and carries, and the carry
// pass's four words a group. Up to four launches on `stream`; nothing when
// n or E is 0 (the caller fills out).
int segment_sum_f32(const void* data, const void* indptr, int64_t E, void* out, int64_t n,
                    void* scratch, int64_t scratch_bytes, void* stream) {
  if (n <= 0 || E <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t tiles = tiles_for(n, E), count = groups_for(tiles);
  if (scratch_bytes < 12 * tiles + 8 + 16 * count)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* d = static_cast<const float*>(data);
  const auto* ptr = static_cast<const int32_t*>(indptr);
  auto* o = static_cast<float*>(out);
  auto* coords = static_cast<int2*>(scratch);
  auto* carry = reinterpret_cast<float*>(coords + tiles + 1);
  const Groups groups{carry + tiles, reinterpret_cast<int*>(carry + tiles + count),
                      reinterpret_cast<int*>(carry + tiles + 2 * count),
                      carry + tiles + 3 * count};
  const auto st = static_cast<cudaStream_t>(stream);
  const auto blocks = static_cast<unsigned>((tiles + kThreads) / kThreads);  // tiles + 1 threads
  segment_sum_partition_kernel<<<blocks, kThreads, 0, st>>>(ptr, n, E, tiles, coords);
  segment_sum_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(d, ptr, n, E, coords,
                                                                        o, carry);
  if (tiles > 1) {
    segment_sum_carry_kernel<<<static_cast<unsigned>(count), kGroup, 0, st>>>(coords, carry,
                                                                             tiles, o, groups);
    if (count > 1) segment_sum_carry_groups_kernel<<<1, kGroup, 0, st>>>(count, o, groups);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
