// K5: the deterministic segment sum, written once in the output dtype, for
// Hopper.
//
// Replaces the Pallas TPU kernel localrf_tpu/ops/pallas/binned_scatter.py
// (`binned_segment_sum_merged`: `_kernel_v2`). It computes K2's function in
// one fixed order:
//
//   out[r, :] = (((0 + g[p1]) + g[p2]) + ...)   p1 < p2 < ... the points with
//                                               idx == r; f32 adds, cast once
//
// Rows no point hits are zeros; indices outside [0, n_rows) are skipped.
//
// What bounds it on the card: bytes. At the 640^3 plane shape P = 1,359,872
// payload rows of 128 bf16 (348 MB) sum into a [409,600, 128] table (105 MB
// in bf16): 0.46 GB with the indices, 0.14 ms at 3.35 TB/s. The payload is
// read once, in place, by point id (no permuted copy of it), and every
// output row is written once. The schedule adds ~40 bytes a point (the
// indices read twice, an 8-byte bin written once and read twice) and a
// count matrix (17 MB at 640^3) zeroed, written and scanned.
//
// The design: a stable counting sort of the point ids, in two levels, then
// a walk of each row's points in point order.
// - Level 1, by tile of 2^shift output rows (64 for rows of 128), over fixed
//   ranges of `range_len` points (set from P alone):
//   - count (`merged_count_kernel`, a block per range): each range's
//     in-range points per tile, int shared atomics (counts do not depend on
//     order), written into column r of the zeroed tile-major matrix
//     mat[t * n_ranges + r];
//   - scan (three kernels: block sums, one block over those, the scan in
//     place): mat becomes each (tile, range) pair's first slot, and
//     tile_start[t] = mat[t][0];
//   - scatter (`merged_scatter_kernel`, a warp per range, in rounds of 32
//     points in point order): each point's rank among its range's earlier
//     points of its tile (__match_any_sync and a running count per tile in
//     shared memory) gives its slot; it writes (id, row within the tile).
//   Each tile's segment then holds its points in increasing id.
// - Level 2 and the walk (`merged_reduce_kernel`, a block per tile, 16
//   warps): each warp takes an equal contiguous part of the tile's segment,
//   counts it per row (__match_any_sync), the block takes the prefix over
//   the warps and the rows, and each warp places its part again in order: a
//   stable counting sort by row, in shared memory (or, for a segment larger
//   than the shared buffer, in a global scratch at the tile's offsets).
//   Then each warp walks the rows that start in its part of the sorted
//   segment: its lanes split the channels (4 per lane: 8 bytes of bf16 or
//   16 of f32), kUnroll payload rows gathered by id in flight (the next
//   batch's ids loaded while they land), an f32 sum in registers, each row
//   written once. Rows without points are written as zeros, so every
//   output row is written exactly once.
// What is left between it and its bound: the payload rows are gathered at
// random (one 256-byte row per point), and a row hit by very many points
// is summed by one warp in order (its adds depend on each other) with
// only kUnroll of its payload rows in flight: a real 64^3 step puts 5,168
// points on one row. Staging a tile's payload rows in shared memory by
// cp.async (4 stages of 64 rows, the warps summing from there) was slower
// on every input, the sum switched off included.
// What limits its size: a count block keeps one counter per tile in shared
// memory, so a table has at most 58,112 tiles (3.7M rows in tiles of 64;
// lrf_segment_sum_merged_workspace says -1 past it), and the count matrix
// grows as tiles x ranges: near that limit at 4,096 ranges it holds 238M
// ints (0.95 GB) that every call zeroes and scans, and a scatter block has
// room for one warp's counters only.
// Every grid and buffer is sized from the shapes alone (no host sync), so
// the call is capturable in a CUDA graph. No atomics touch a sum, so two
// launches give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCountThreads = 256;
constexpr int kCountPoints = 8;  // points per thread of a count pass
constexpr int kScanThreads = 256;
constexpr int kScanItems = 16;  // matrix entries per thread of a scan block
constexpr int kScanChunk = kScanThreads * kScanItems;
constexpr int kScanBlocksThreads = 1024;
constexpr int kScatterWarps = 4;  // ranges per scatter block, at most
constexpr int kScatterRounds = 4;  // rounds of 32 points a warp loads ahead
constexpr int kReduceThreads = 512;  // also the most rows a tile may have: a thread a row
constexpr int kReduceWarps = kReduceThreads / 32;
constexpr int kSmemMax = 232448;  // a block's dynamic shared memory on sm_90

template <typename I>
__device__ __forceinline__ int tile_of(I row, int64_t n_rows, int shift) {
  const int64_t r = static_cast<int64_t>(row);
  return (r >= 0 && r < n_rows) ? static_cast<int>(r >> shift) : -1;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// ---- level 1: count, scan, scatter ------------------------------------------

// A block per range of points [r * range_len, (r + 1) * range_len): the
// counts per tile in shared memory, the nonzero ones written to the matrix.
template <typename I>
__global__ void __launch_bounds__(kCountThreads)
    merged_count_kernel(const I* __restrict__ idx, int64_t p_total, int64_t n_rows, int shift,
                        int n_tiles, int64_t range_len, int n_ranges, int* __restrict__ mat) {
  extern __shared__ int hist[];
  const int r = blockIdx.x, lane = lane_id();
  for (int i = threadIdx.x; i < n_tiles; i += kCountThreads) hist[i] = 0;
  __syncthreads();
  const int64_t lo = static_cast<int64_t>(r) * range_len;
  const int64_t hi = lo + range_len < p_total ? lo + range_len : p_total;
  for (int64_t p0 = lo; p0 < hi; p0 += kCountThreads * kCountPoints) {
    int t[kCountPoints];
#pragma unroll
    for (int k = 0; k < kCountPoints; ++k) {
      const int64_t p = p0 + k * kCountThreads + threadIdx.x;
      t[k] = p < hi ? tile_of(idx[p], n_rows, shift) : -1;
    }
#pragma unroll
    for (int k = 0; k < kCountPoints; ++k) {
      const unsigned peers = __match_any_sync(kFull, t[k]);
      if (t[k] >= 0 && lane == __ffs(peers) - 1) atomicAdd(hist + t[k], __popc(peers));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_tiles; i += kCountThreads) {
    if (hist[i]) mat[static_cast<int64_t>(i) * n_ranges + r] = hist[i];
  }
}

// Sum of `v` over the block (kScanThreads); every thread gets it.
__device__ __forceinline__ int block_sum(int v, int* warp_sums) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  if (lane_id() == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < kScanThreads / 32; ++w) s += warp_sums[w];
  return s;
}

// Exclusive prefix of `v` over the block's threads (kThreads of them).
template <int kThreads>
__device__ __forceinline__ int block_exclusive(int v, int* warp_sums, int* total) {
  const int lane = lane_id(), warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kThreads / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kThreads / 32 - 1];
  return before + incl - v;
}

// Scan, pass 1: the sum of each chunk of kScanChunk matrix entries (the
// matrix is padded to whole chunks with zeros).
__global__ void __launch_bounds__(kScanThreads)
    merged_scan_sum_kernel(const int* __restrict__ mat, int* __restrict__ block_sums) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int4* src = reinterpret_cast<const int4*>(mat + static_cast<int64_t>(blockIdx.x) * kScanChunk);
  int s = 0;
#pragma unroll
  for (int k = 0; k < kScanItems / 4; ++k) {
    const int4 v = src[k * kScanThreads + threadIdx.x];
    s += v.x + v.y + v.z + v.w;
  }
  s = block_sum(s, warp_sums);
  if (threadIdx.x == 0) block_sums[blockIdx.x] = s;
}

// Scan, pass 2 (one block): the chunk sums become exclusive prefixes, in
// place; *total = the number of binned points.
__global__ void __launch_bounds__(kScanBlocksThreads)
    merged_scan_blocks_kernel(int* __restrict__ block_sums, int n, int* __restrict__ total) {
  __shared__ int warp_sums[kScanBlocksThreads / 32];
  int carry = 0;
  for (int i0 = 0; i0 < n; i0 += kScanBlocksThreads) {
    const int i = i0 + threadIdx.x;
    const int v = i < n ? block_sums[i] : 0;
    int chunk_total;
    const int before = block_exclusive<kScanBlocksThreads>(v, warp_sums, &chunk_total);
    if (i < n) block_sums[i] = carry + before;
    carry += chunk_total;
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

// Scan, pass 3: each chunk's exclusive prefix, in place, plus its chunk's
// base; tile_start[t] = the first slot of tile t (entry t * n_ranges).
__global__ void __launch_bounds__(kScanThreads)
    merged_scan_kernel(int* __restrict__ mat, const int* __restrict__ block_sums, int n_ranges,
                       int n_tiles, int* __restrict__ tile_start) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int chunk[kScanChunk];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanChunk;
  int4* src = reinterpret_cast<int4*>(mat + base);
  int v[kScanItems];
#pragma unroll
  for (int k = 0; k < kScanItems / 4; ++k) {
    const int4 x = src[threadIdx.x * (kScanItems / 4) + k];
    v[4 * k] = x.x;
    v[4 * k + 1] = x.y;
    v[4 * k + 2] = x.z;
    v[4 * k + 3] = x.w;
  }
  int mine = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) mine += v[k];
  int total;
  int run = block_sums[blockIdx.x] + block_exclusive<kScanThreads>(mine, warp_sums, &total);
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const int c = v[k];
    v[k] = run;
    run += c;
  }
#pragma unroll
  for (int k = 0; k < kScanItems / 4; ++k) {
    const int4 x = make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    src[threadIdx.x * (kScanItems / 4) + k] = x;
    reinterpret_cast<int4*>(chunk)[threadIdx.x * (kScanItems / 4) + k] = x;
  }
  __syncthreads();
  const int64_t t_lo = (base + n_ranges - 1) / n_ranges;
  for (int64_t t = t_lo + threadIdx.x; t < n_tiles && t * n_ranges < base + kScanChunk;
       t += kScanThreads) {
    tile_start[t] = chunk[t * n_ranges - base];
  }
}

// A warp per range, in rounds of 32 points in point order. `cnt` (shared
// memory) holds the warp's running count per tile; only this warp touches
// it, and __syncwarp orders one round's update before the next round's read.
template <typename I>
__global__ void __launch_bounds__(kScatterWarps * 32)
    merged_scatter_kernel(const I* __restrict__ idx, int64_t p_total, int64_t n_rows, int shift,
                          int n_tiles, int64_t range_len, int n_ranges,
                          const int* __restrict__ mat, int2* __restrict__ bins) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = lane_id();
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= n_ranges) return;
  int* cnt = smem + warp * n_tiles;
  for (int i = lane; i < n_tiles; i += 32) cnt[i] = 0;
  __syncwarp();
  const int64_t lo = static_cast<int64_t>(r) * range_len;
  const int64_t hi = lo + range_len < p_total ? lo + range_len : p_total;
  const unsigned below = (1u << lane) - 1u;
  for (int64_t p0 = lo; p0 < hi; p0 += 32 * kScatterRounds) {
    int64_t row[kScatterRounds];
#pragma unroll
    for (int k = 0; k < kScatterRounds; ++k) {
      const int64_t p = p0 + k * 32 + lane;
      row[k] = p < hi ? static_cast<int64_t>(idx[p]) : -1;
    }
#pragma unroll
    for (int k = 0; k < kScatterRounds; ++k) {
      const int t = tile_of(row[k], n_rows, shift);
      const unsigned peers = __match_any_sync(kFull, t);
      const int leader = __ffs(peers) - 1;
      int first = t >= 0 ? mat[static_cast<int64_t>(t) * n_ranges + r] : 0;
      int before = 0;
      if (t >= 0 && lane == leader) {
        before = cnt[t];
        cnt[t] = before + __popc(peers);
      }
      before = __shfl_sync(kFull, before, leader);
      __syncwarp();
      if (t >= 0) {
        first += before + __popc(peers & below);
        bins[first] = make_int2(static_cast<int>(p0 + k * 32 + lane),
                                static_cast<int>(row[k] - (static_cast<int64_t>(t) << shift)));
      }
    }
  }
}

// ---- level 2 and the walk ----------------------------------------------------

// VEC payload elements per lane: 4 (8 bytes of bf16, 16 of f32), or 1 where a
// row is not a whole number of such pieces.
template <typename T, int VEC>
struct Raw {
  using type = T;
};
template <>
struct Raw<__nv_bfloat16, 4> {
  using type = uint2;
};
template <>
struct Raw<float, 4> {
  using type = uint4;
};

template <typename T, int VEC>
__device__ __forceinline__ typename Raw<T, VEC>::type load_raw(const T* p) {
  return __ldg(reinterpret_cast<const typename Raw<T, VEC>::type*>(p));
}

__device__ __forceinline__ float lo_bf16(unsigned x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float hi_bf16(unsigned x) { return __uint_as_float(x & 0xffff0000u); }

template <typename T, int VEC>
__device__ __forceinline__ void add_raw(float (&acc)[VEC], const typename Raw<T, VEC>::type& r) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 2) {
      acc[0] += __bfloat162float(r);
    } else {
      acc[0] += r;
    }
  } else if constexpr (sizeof(T) == 2) {
    acc[0] += lo_bf16(r.x);
    acc[1] += hi_bf16(r.x);
    acc[2] += lo_bf16(r.y);
    acc[3] += hi_bf16(r.y);
  } else {
    acc[0] += __uint_as_float(r.x);
    acc[1] += __uint_as_float(r.y);
    acc[2] += __uint_as_float(r.z);
    acc[3] += __uint_as_float(r.w);
  }
}

__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // .x = a (low half)
  return *reinterpret_cast<const unsigned*>(&v);
}

template <typename TOut, int VEC>
__device__ __forceinline__ void store_row(TOut* dst, const float (&acc)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(TOut) == 2) {
      *dst = __float2bfloat16(acc[0]);
    } else {
      *dst = acc[0];
    }
  } else if constexpr (sizeof(TOut) == 2) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]));
  } else {
    *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// The first row start at or after x: rs[k], k = #{j in [0, n_rows_tile] :
// rs[j] < x} (rs[n_rows_tile] is the segment's length, so k exists).
__device__ __forceinline__ int start_at_or_after(const int* rs, int tile_rows, int x) {
  int k = 0;
  for (int j0 = 0; j0 <= tile_rows; j0 += 32) {
    const int j = j0 + lane_id();
    k += __popc(__ballot_sync(kFull, j <= tile_rows && rs[j] < x));
  }
  return rs[k];
}

// The row that holds sorted slot q (q < the segment's length): the last j
// with rs[j] <= q.
__device__ __forceinline__ int row_of_slot(const int* rs, int tile_rows, int q) {
  int k = 0;
  for (int j0 = 0; j0 < tile_rows; j0 += 32) {
    const int j = j0 + lane_id();
    k += __popc(__ballot_sync(kFull, j < tile_rows && rs[j] <= q));
  }
  return k - 1;
}

// A block per tile of 2^shift output rows, two blocks an SM. Shared memory: cnt
// [kReduceWarps][tile_rows] (each warp's count, then its next slot, per
// row), rs [tile_rows + 1] (row starts in the sorted segment), and the
// sorted ids [seg_cap].
template <typename T, typename TOut, int VEC>
__global__ void __launch_bounds__(kReduceThreads, 2)
    merged_reduce_kernel(const int* __restrict__ tile_start, const int2* __restrict__ bins,
                         int* scratch, const T* __restrict__ g, TOut* __restrict__ out, int c,
                         int64_t n_rows, int shift, int seg_cap) {
  // payload rows a lane has in flight: as many as leave two blocks an SM
  // (64 registers a thread)
  constexpr int kUnroll = sizeof(T) == 2 ? 12 : 8;
  extern __shared__ int sm[];
  const int tile_rows = 1 << shift;
  int* cnt = sm;
  int* rs = cnt + kReduceWarps * tile_rows;
  int* sorted_sm = rs + tile_rows + 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = lane_id();
  const int tile = blockIdx.x;
  const int start = tile_start[tile], n = tile_start[tile + 1] - start;
  const int64_t row0 = static_cast<int64_t>(tile) << shift;
  const int rows = static_cast<int>(n_rows - row0 < tile_rows ? n_rows - row0 : tile_rows);
  const float zero[VEC] = {};
  if (n == 0) {
    for (int r = warp; r < rows; r += kReduceWarps) {
      for (int c0 = lane * VEC; c0 < c; c0 += 32 * VEC) store_row<TOut, VEC>(out + (row0 + r) * c + c0, zero);
    }
    return;
  }
  const int2* seg = bins + start;
  for (int i = tid; i < kReduceWarps * tile_rows; i += kReduceThreads) cnt[i] = 0;
  __syncthreads();

  // level 2: warp w's part [w_lo, w_hi) of the segment, counted per row
  const int w_lo = static_cast<int>(static_cast<int64_t>(n) * warp / kReduceWarps);
  const int w_hi = static_cast<int>(static_cast<int64_t>(n) * (warp + 1) / kReduceWarps);
  int* mine = cnt + warp * tile_rows;
  const unsigned below = (1u << lane) - 1u;
  for (int i0 = w_lo; i0 < w_hi; i0 += 32) {
    const int i = i0 + lane;
    const int row = i < w_hi ? seg[i].y : -1;
    const unsigned peers = __match_any_sync(kFull, row);
    if (row >= 0 && lane == __ffs(peers) - 1) mine[row] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // each row's total over the warps, then the row starts (one warp's scan)
  if (tid < tile_rows) {
    int run = 0;
    for (int w = 0; w < kReduceWarps; ++w) {
      const int x = cnt[w * tile_rows + tid];
      cnt[w * tile_rows + tid] = run;
      run += x;
    }
    rs[tid] = run;
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int j0 = 0; j0 < tile_rows; j0 += 32) {
      const int j = j0 + lane;
      const int x = j < tile_rows ? rs[j] : 0;
      int incl = x;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += y;
      }
      if (j < tile_rows) rs[j] = carry + incl - x;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) rs[tile_rows] = carry;
  }
  __syncthreads();
  if (tid < tile_rows) {
    for (int w = 0; w < kReduceWarps; ++w) cnt[w * tile_rows + tid] += rs[tid];
  }
  __syncthreads();
  // level 2: each warp places its part again, in order
  int* sorted = n <= seg_cap ? sorted_sm : scratch + start;
  for (int i0 = w_lo; i0 < w_hi; i0 += 32) {
    const int i = i0 + lane;
    const int2 b = i < w_hi ? seg[i] : make_int2(0, -1);
    const unsigned peers = __match_any_sync(kFull, b.y);
    const int leader = __ffs(peers) - 1;
    int slot = 0;
    if (b.y >= 0 && lane == leader) {
      slot = mine[b.y];
      mine[b.y] = slot + __popc(peers);
    }
    slot = __shfl_sync(kFull, slot, leader);
    __syncwarp();
    if (b.y >= 0) sorted[slot + __popc(peers & below)] = b.x;
  }
  __syncthreads();

  // rows without points: zeros
  for (int r = warp; r < rows; r += kReduceWarps) {
    if (rs[r] == rs[r + 1]) {
      for (int c0 = lane * VEC; c0 < c; c0 += 32 * VEC) store_row<TOut, VEC>(out + (row0 + r) * c + c0, zero);
    }
  }
  // the walk: the rows that start in [w_lo, w_hi), their points in order
  const int q_lo = start_at_or_after(rs, tile_rows, w_lo);
  const int q_hi = start_at_or_after(rs, tile_rows, w_hi);
  if (q_lo >= q_hi) return;
  const int r_first = row_of_slot(rs, tile_rows, q_lo);
  for (int c0 = lane * VEC; c0 < c; c0 += 32 * VEC) {
    int r = r_first, end = rs[r + 1];
    float acc[VEC] = {};
    int id[kUnroll];  // the ids of the batch to load next
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) id[u] = q_lo + u < q_hi ? sorted[q_lo + u] : 0;
    for (int q0 = q_lo; q0 < q_hi; q0 += kUnroll) {
      typename Raw<T, VEC>::type v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (q0 + u < q_hi) v[u] = load_raw<T, VEC>(g + static_cast<int64_t>(id[u]) * c + c0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + kUnroll + u;
        id[u] = q < q_hi ? sorted[q] : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + u;
        if (q < q_hi) {
          if (q == end) {
            store_row<TOut, VEC>(out + (row0 + r) * c + c0, acc);
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
            do {
              ++r;
              end = rs[r + 1];
            } while (end == q);
          }
          add_raw<T, VEC>(acc, v[u]);
        }
      }
    }
    store_row<TOut, VEC>(out + (row0 + r) * c + c0, acc);
  }
}

// Lets `kernel` take up to kSmemMax bytes of dynamic shared memory (the limit,
// not what a launch takes: a graph may hold launches of several sizes).
template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
}

template <typename T, typename TOut>
cudaError_t launch_reduce(const int* tile_start, const int2* bins, int* scratch, const T* g, TOut* out,
                          int c, int vec, int64_t n_rows, int shift, int n_tiles, int seg_cap,
                          cudaStream_t s) {
  const int tile_rows = 1 << shift;
  const int smem = (kReduceWarps * tile_rows + tile_rows + 1 + seg_cap) * static_cast<int>(sizeof(int));
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  const auto kernel = vec == 4 ? merged_reduce_kernel<T, TOut, 4> : merged_reduce_kernel<T, TOut, 1>;
  const cudaError_t err = allow_smem(kernel);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, kReduceThreads, smem, s>>>(tile_start, bins, scratch, g, out, c, n_rows, shift,
                                               seg_cap);
  return cudaGetLastError();
}

// The count matrix padded to whole scan chunks, in ints.
int64_t mat_len(int n_tiles, int n_ranges) {
  const int64_t n = static_cast<int64_t>(n_tiles) * n_ranges;
  return (n + kScanChunk - 1) / kScanChunk * kScanChunk;
}

template <typename I>
cudaError_t launch_bins(const I* idx, int64_t p, int64_t n_rows, int shift, int n_tiles,
                        int64_t range_len, int n_ranges, int* workspace, int* tile_start, int2* bins,
                        cudaStream_t s) {
  const int count_smem = n_tiles * static_cast<int>(sizeof(int));  // one warp's counters too
  const int64_t n_mat = mat_len(n_tiles, n_ranges);
  int* mat = workspace;
  int* block_sums = workspace + n_mat;
  cudaError_t err = cudaMemsetAsync(mat, 0, n_mat * sizeof(int), s);
  if (err == cudaSuccess) err = allow_smem(merged_count_kernel<I>);
  if (err == cudaSuccess) err = allow_smem(merged_scatter_kernel<I>);
  if (err != cudaSuccess) return err;
  merged_count_kernel<I><<<n_ranges, kCountThreads, count_smem, s>>>(
      idx, p, n_rows, shift, n_tiles, range_len, n_ranges, mat);
  const int n_chunks = static_cast<int>(n_mat / kScanChunk);
  merged_scan_sum_kernel<<<n_chunks, kScanThreads, 0, s>>>(mat, block_sums);
  merged_scan_blocks_kernel<<<1, kScanBlocksThreads, 0, s>>>(block_sums, n_chunks, tile_start + n_tiles);
  merged_scan_kernel<<<n_chunks, kScanThreads, 0, s>>>(mat, block_sums, n_ranges, n_tiles, tile_start);
  const int fit = kSmemMax / count_smem;
  const int warps = fit < kScatterWarps ? fit : kScatterWarps;
  merged_scatter_kernel<I><<<(n_ranges + warps - 1) / warps, warps * 32, warps * count_smem, s>>>(
      idx, p, n_rows, shift, n_tiles, range_len, n_ranges, mat, bins);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_reduce_out(const int* tile_start, const int2* bins, int* scratch, const T* g,
                              void* out, int out_is_bf16, int c, int vec, int64_t n_rows, int shift,
                              int n_tiles, int seg_cap, cudaStream_t s) {
  if (out_is_bf16) {
    return launch_reduce(tile_start, bins, scratch, g, static_cast<__nv_bfloat16*>(out), c, vec,
                         n_rows, shift, n_tiles, seg_cap, s);
  }
  return launch_reduce(tile_start, bins, scratch, g, static_cast<float*>(out), c, vec, n_rows,
                       shift, n_tiles, seg_cap, s);
}

}  // namespace

// Ints of the workspace a call needs for n_tiles tiles and n_ranges point
// ranges (the count matrix, padded to whole scan chunks, then one sum per
// chunk), or -1 where a block cannot count that many tiles in shared memory
// (more than kSmemMax / 4 = 58,112: 3.7M rows in tiles of 64).
extern "C" int64_t lrf_segment_sum_merged_workspace(int n_tiles, int n_ranges) {
  if (n_tiles < 1 || n_ranges < 1 || n_tiles > kSmemMax / static_cast<int>(sizeof(int))) return -1;
  const int64_t n_mat = mat_len(n_tiles, n_ranges);
  return n_mat + n_mat / kScanChunk;
}

// idx [P] (int64, or int32), g [P, C] (bf16 or f32; 8 or 16-byte aligned
// rows where vec == 4), out [n_rows, C]; the plan's shift (tile rows =
// 1 << shift, at most kReduceThreads), n_tiles, range_len and n_ranges;
// int32 buffers: workspace [workspace_len] (16-byte aligned; at least
// lrf_segment_sum_merged_workspace(n_tiles, n_ranges)), tile_start
// [n_tiles + 1], bins [P] int2 and scratch [P]. seg_cap: the longest tile
// segment the reduce sorts in shared memory (longer ones go through
// scratch).
extern "C" int lrf_segment_sum_merged(const void* idx, int idx_is_i64, const void* g, int g_is_bf16,
                                      int vec, void* out, int out_is_bf16, int64_t p, int c,
                                      int64_t n_rows, int shift, int n_tiles, int64_t range_len,
                                      int n_ranges, void* workspace, int64_t workspace_len,
                                      void* tile_start, void* bins, void* scratch, int seg_cap,
                                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t need = lrf_segment_sum_merged_workspace(n_tiles, n_ranges);
  if (shift < 0 || (1 << shift) > kReduceThreads || need < 0 || workspace_len < need ||
      range_len < 1 || static_cast<int64_t>(n_ranges) * range_len < p ||
      (vec != 1 && (vec != 4 || c % 4)) || seg_cap < 0 || p >= (int64_t{1} << 31) || c < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* ws = static_cast<int*>(workspace);
  auto* ts = static_cast<int*>(tile_start);
  auto* b = static_cast<int2*>(bins);
  cudaError_t err =
      idx_is_i64 ? launch_bins(static_cast<const int64_t*>(idx), p, n_rows, shift, n_tiles, range_len,
                               n_ranges, ws, ts, b, s)
                 : launch_bins(static_cast<const int32_t*>(idx), p, n_rows, shift, n_tiles, range_len,
                               n_ranges, ws, ts, b, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* sc = static_cast<int*>(scratch);
  err = g_is_bf16 ? launch_reduce_out(ts, b, sc, static_cast<const __nv_bfloat16*>(g), out, out_is_bf16,
                                      c, vec, n_rows, shift, n_tiles, seg_cap, s)
                  : launch_reduce_out(ts, b, sc, static_cast<const float*>(g), out, out_is_bf16, c,
                                      vec, n_rows, shift, n_tiles, seg_cap, s);
  return static_cast<int>(err);
}
