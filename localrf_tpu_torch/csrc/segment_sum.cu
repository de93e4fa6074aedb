// K2: segment sum, the backward of every plane-table row gather, for Hopper.
//
// Replaces the Pallas TPU kernel localrf_tpu/ops/pallas/binned_scatter.py
// (`binned_segment_sum`: `_kernel`), the VJP of `take_rows_binned`.
//
//   out[r, :] = sum_{p : idx_p == r} g_p    (f32 accumulation, written once
//                                            in the caller's dtype)
//
// What bounds it on the card: bytes. At the 640^3 stage each orientation
// sums P = 1,359,872 payload rows of 128 bf16 (348 MB) into a [409,600, 128]
// table (105 MB in bf16): 0.46 GB with the indices, 0.14 ms at 3.35 TB/s.
// An f32 atomic add per element into a full f32 staging table (210 MB, four
// times the 50 MB L2) moves each point's 512-byte f32 row through device
// memory and needs a zero pass and a cast pass: ~1.4 GB. At 64^3 the table
// fits in L2 but ~72 points land on each row and their atomics contend.
//
// The design bins the points by tile of `tile_rows` output rows and reduces
// each tile on chip, as the TPU kernel binned its points by output tile
// (it sorted them and ran one-hot MXU tiles; Hopper has shared memory):
// - bin (three small kernels): count the in-range points of each tile
//   (warp-aggregated int atomics into a per-block histogram in shared
//   memory, one global atomic per block and tile hit), exclusive-scan the
//   counts in one block into tile starts, a work list and the list of
//   empty tiles, and scatter each point's (id, row within its tile) into
//   bin order. A counting sort on tile ids, not a sort of the 64-bit
//   indices. Indices outside [0, n_rows) fall into no bin.
// - zero (`segment_sum_zero_kernel`): the rows of the empty tiles (most of
//   the plane at 640^3: the ball's points hit ~6% of its tiles) are written
//   as zeros by short blocks without shared memory.
// - reduce (`segment_sum_tile_kernel`): one block per work item of at most
//   kChunk points holds its tile as f32 rows in shared memory (32 KB for
//   rows of 128, 48 KB with the sort buffers). It first sorts its points by
//   row in shared memory (a second counting sort, with int shared atomics,
//   which are native: an f32 shared atomic add is a compare-and-swap loop on
//   this card), then its groups of lanes take equal consecutive segments of
//   the sorted points, read the payload rows with 16-byte loads (a 256-byte
//   bf16 row is 16 lanes of 16 B, kUnroll rows in flight), sum each row's
//   run in registers and store it once; only the rows that cross a
//   segment's end take f32 shared atomics. Then every row of the tile is
//   written once, in the out dtype. No staging table, no zero pass over it,
//   no cast pass.
// - skew: a tile with more than kChunk points (the ball of a 640^3 step
//   packs a few tiles with many times the mean; at 64^3 every tile holds
//   ~4,600) is split into several work items. Each writes its f32 partial
//   tile to a slot of its own (no zeroing needed) and the block that
//   finishes last (a per-tile counter after a fence) sums the partials in
//   slot order and writes the rows once.
// What is left between it and its bound: the payload rows are gathered at
// random (one 256-byte row per point), which the reduce reads at ~2 TB/s,
// and the bin kernels read the indices twice.
// Every grid and buffer is sized from the shapes alone, so the whole call
// is capturable in a CUDA graph: the reduce grid holds the most work items
// any index set can make (n_tiles + P / kChunk) and blocks past the scan's
// count exit at once. The order of the points within a tile depends on
// the atomics, so results match the plain `index_add_` to f32 rounding
// (and to one bf16 ulp after the cast).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;      // bin kernels and the reduce
constexpr int kScanThreads = 1024;
constexpr int kBinPoints = 8;      // points per thread of the bin kernels
constexpr int kSharedTiles = 12288;  // tile counters a bin block keeps in shared memory (48 KB)
constexpr int kUnroll = 8;         // payload rows a lane loads before it adds them
constexpr int kChunk = 2048;       // binned points one reduce block sums at most
constexpr int kPerThread = kChunk / kThreads;

__device__ __forceinline__ int tile_of(int64_t row, int64_t n_rows, int tile_rows) {
  return (row >= 0 && row < n_rows) ? static_cast<int>(row / tile_rows) : -1;
}

// Adds each lane's point to counters[t] (t < 0: no point), one atomic per
// distinct t in the warp; returns the lane's slot: the counter's value
// before the warp's add plus the lane's rank among its peers.
__device__ __forceinline__ int warp_add(int* counters, int t) {
  const unsigned peers = __match_any_sync(0xffffffffu, t);
  const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
  int base = 0;
  if (t >= 0 && lane == leader) base = atomicAdd(counters + t, __popc(peers));
  return __shfl_sync(0xffffffffu, base, leader) + __popc(peers & ((1u << lane) - 1u));
}

// A bin block takes kBinPoints points per thread. Where the tile counters
// fit in shared memory (n_tiles <= kSharedTiles: every plane of the
// schedule), it counts its points there and adds one global atomic per
// tile it hit, so the few tiles of a small table (64 at 64^3) or of a
// ball's centre do not take every point's atomic; else it adds to the
// global counters directly.
__global__ void __launch_bounds__(kThreads)
    segment_sum_bin_count_kernel(const int64_t* __restrict__ idx, int64_t p_total,
                                 int64_t n_rows, int tile_rows, int n_tiles,
                                 int* __restrict__ counts) {
  extern __shared__ int hist[];
  const bool local = n_tiles <= kSharedTiles;
  if (local) {
    for (int i = threadIdx.x; i < n_tiles; i += kThreads) hist[i] = 0;
    __syncthreads();
  }
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kThreads * kBinPoints + threadIdx.x;
  int t[kBinPoints];
#pragma unroll
  for (int k = 0; k < kBinPoints; ++k) {
    const int64_t p = p0 + k * kThreads;
    t[k] = p < p_total ? tile_of(idx[p], n_rows, tile_rows) : -1;
  }
#pragma unroll
  for (int k = 0; k < kBinPoints; ++k) warp_add(local ? hist : counts, t[k]);
  if (local) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_tiles; i += kThreads) {
      if (hist[i]) atomicAdd(counts + i, hist[i]);
    }
  }
}

// One block, in rounds of kScanThreads tiles: starts[t] = first bin slot of
// tile t (starts[n_tiles] = the binned total), cursor = starts, the work
// list of the tiles with points: tile t makes ceil(count / chunk) items
// (t, part), and a split tile's items own the partial slots
// slot_base[t] + part; and the list of empty tiles. totals = (items,
// empty tiles).
__global__ void __launch_bounds__(kScanThreads)
    segment_sum_bin_scan_kernel(const int* __restrict__ counts, int n_tiles, int chunk,
                                int* __restrict__ starts, int* __restrict__ cursor,
                                int* __restrict__ slot_base, int2* __restrict__ items,
                                int* __restrict__ empty, int2* __restrict__ totals) {
  __shared__ int4 warp_total[kScanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int4 carry = make_int4(0, 0, 0, 0);  // points, items, partial slots, empty tiles so far
  for (int t0 = 0; t0 < n_tiles; t0 += kScanThreads) {
    const int t = t0 + tid;
    const int c = t < n_tiles ? counts[t] : 0;
    const int k = (c + chunk - 1) / chunk;
    const int4 mine = make_int4(c, k, k > 1 ? k : 0, t < n_tiles && c == 0);
    int4 incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl.x, off);
      const int y = __shfl_up_sync(0xffffffffu, incl.y, off);
      const int z = __shfl_up_sync(0xffffffffu, incl.z, off);
      const int w = __shfl_up_sync(0xffffffffu, incl.w, off);
      if (lane >= off) incl = make_int4(incl.x + x, incl.y + y, incl.z + z, incl.w + w);
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int4 v = warp_total[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, v.x, off);
        const int y = __shfl_up_sync(0xffffffffu, v.y, off);
        const int z = __shfl_up_sync(0xffffffffu, v.z, off);
        const int w = __shfl_up_sync(0xffffffffu, v.w, off);
        if (lane >= off) v = make_int4(v.x + x, v.y + y, v.z + z, v.w + w);
      }
      warp_total[lane] = v;
    }
    __syncthreads();
    const int4 before = warp > 0 ? warp_total[warp - 1] : make_int4(0, 0, 0, 0);
    if (t < n_tiles) {
      const int pts = carry.x + before.x + incl.x - mine.x;
      const int item = carry.y + before.y + incl.y - mine.y;
      starts[t] = pts;
      cursor[t] = pts;
      slot_base[t] = carry.z + before.z + incl.z - mine.z;
      for (int j = 0; j < k; ++j) items[item + j] = make_int2(t, j);
      if (c == 0) empty[carry.w + before.w + incl.w - 1] = t;
    }
    const int4 total = warp_total[kScanThreads / 32 - 1];
    carry = make_int4(carry.x + total.x, carry.y + total.y, carry.z + total.z, carry.w + total.w);
    __syncthreads();
  }
  if (tid == 0) {
    starts[n_tiles] = carry.x;
    *totals = make_int2(carry.y, carry.w);
  }
}

// Each in-range point's (id, row within its tile), into its tile's bin:
// slots reserved per block and tile (shared counters, as the count
// kernel), or per warp and tile from the global cursors.
__global__ void __launch_bounds__(kThreads)
    segment_sum_bin_scatter_kernel(const int64_t* __restrict__ idx, int64_t p_total,
                                   int64_t n_rows, int tile_rows, int n_tiles,
                                   int* __restrict__ cursor, int2* __restrict__ bin) {
  extern __shared__ int hist[];
  const bool local = n_tiles <= kSharedTiles;
  if (local) {
    for (int i = threadIdx.x; i < n_tiles; i += kThreads) hist[i] = 0;
    __syncthreads();
  }
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kThreads * kBinPoints + threadIdx.x;
  int64_t row[kBinPoints];
  int t[kBinPoints], slot[kBinPoints];
#pragma unroll
  for (int k = 0; k < kBinPoints; ++k) {
    const int64_t p = p0 + k * kThreads;
    row[k] = p < p_total ? idx[p] : -1;
    t[k] = tile_of(row[k], n_rows, tile_rows);
  }
#pragma unroll
  for (int k = 0; k < kBinPoints; ++k) slot[k] = warp_add(local ? hist : cursor, t[k]);
  if (local) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_tiles; i += kThreads) {
      if (hist[i]) hist[i] = atomicAdd(cursor + i, hist[i]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kBinPoints; ++k) {
    if (t[k] >= 0) {
      const int pos = (local ? hist[t[k]] : 0) + slot[k];
      bin[pos] = make_int2(static_cast<int>(p0 + k * kThreads),
                           static_cast<int>(row[k] - static_cast<int64_t>(t[k]) * tile_rows));
    }
  }
}

// ---- the reduce -----------------------------------------------------------

// VEC payload elements per lane: 8 bf16 or 4 f32 (one 16-byte load), or 1
// where a row is not a whole number of 16-byte pieces.
template <typename T, int VEC>
struct Raw {
  using type = uint4;
};
template <typename T>
struct Raw<T, 1> {
  using type = T;
};

template <typename T, int VEC>
__device__ __forceinline__ typename Raw<T, VEC>::type load_raw(const T* p) {
  if constexpr (VEC == 1) {
    return *p;
  } else {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
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
  } else if constexpr (VEC == 8) {  // bf16
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[2 * k] += lo_bf16(w[k]);
      acc[2 * k + 1] += hi_bf16(w[k]);
    }
  } else {  // VEC == 4: f32
    acc[0] += __uint_as_float(r.x);
    acc[1] += __uint_as_float(r.y);
    acc[2] += __uint_as_float(r.z);
    acc[3] += __uint_as_float(r.w);
  }
}

// Puts a lane's run sum into its VEC elements of `row` in the shared tile:
// a plain (vector) store where this lane's group holds every point of the
// row, else f32 shared atomics (a CAS loop on this card), which only the
// rows at the ends of a group's segment need.
template <int VEC>
__device__ __forceinline__ void flush(float* tile, int row, int c, int j, bool owned,
                                      const float (&acc)[VEC]) {
  float* dst = tile + row * c + j * VEC;
  if (owned) {
    if constexpr (VEC == 1) {
      *dst = acc[0];
    } else {
#pragma unroll
      for (int k = 0; k < VEC / 4; ++k) {
        reinterpret_cast<float4*>(dst)[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
      }
    }
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) atomicAdd(dst + v, acc[v]);
  }
}

// In place: a[0:n] <- its exclusive prefix sums, a[n] <- the total (one
// block of kThreads; `warp_sums` holds kThreads / 32 ints).
__device__ void block_exclusive_scan(int* a, int n, int* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + kThreads - 1) / kThreads;
  const int i0 = min(tid * per, n), i1 = min(i0 + per, n);
  int mine = 0;
  for (int i = i0; i < i1; ++i) mine += a[i];
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  int run = before + incl - mine;
  __syncthreads();
  for (int i = i0; i < i1; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  if (tid == kThreads - 1) a[n] = run;
  __syncthreads();
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// dst[0:W] = v[0:W] in TOut; W in {1, 4, 8}; dst aligned to W elements.
template <typename TOut, int W>
__device__ __forceinline__ void store_vec(TOut* dst, const float (&v)[W]) {
  if constexpr (W == 1) {
    store1(dst, v[0]);
  } else if constexpr (sizeof(TOut) == 4) {
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      reinterpret_cast<float4*>(dst)[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    }
  } else {
    unsigned w[W / 2];
#pragma unroll
    for (int k = 0; k < W / 2; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      w[k] = *reinterpret_cast<const unsigned*>(&h);
    }
    if constexpr (W == 8) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    }
  }
}

// v[0:W] = src[0:W] (shared tile or partials; `cg`: bypass L1, for the
// partials other blocks wrote)
template <int W, bool CG>
__device__ __forceinline__ void load_f32(const float* src, float (&v)[W]) {
  if constexpr (W == 1) {
    if constexpr (CG) {
      v[0] = __ldcg(src);
    } else {
      v[0] = *src;
    }
  } else {
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      float4 x;
      if constexpr (CG) {
        x = __ldcg(reinterpret_cast<const float4*>(src) + k);
      } else {
        x = reinterpret_cast<const float4*>(src)[k];
      }
      v[4 * k] = x.x;
      v[4 * k + 1] = x.y;
      v[4 * k + 2] = x.z;
      v[4 * k + 3] = x.w;
    }
  }
}

// The rows of the tiles no point hit are zeros: one block per empty tile,
// no shared memory, so many of these short blocks run at once.
template <typename TOut, int VEC>
__global__ void __launch_bounds__(kThreads)
    segment_sum_zero_kernel(const int* __restrict__ empty, const int2* __restrict__ totals,
                            TOut* __restrict__ out, int c, int64_t n_rows, int tile_rows) {
  if (static_cast<int>(blockIdx.x) >= totals->y) return;
  const int64_t row_lo = static_cast<int64_t>(empty[blockIdx.x]) * tile_rows;
  const int n_el = static_cast<int>(min(static_cast<int64_t>(tile_rows), n_rows - row_lo)) * c;
  TOut* dst = out + row_lo * c;
  const float z[VEC] = {};
  for (int e = threadIdx.x * VEC; e < n_el; e += kThreads * VEC) store_vec<TOut, VEC>(dst + e, z);
}

template <typename TIn, int VEC, typename TOut>
__global__ void __launch_bounds__(kThreads, 3)
    segment_sum_tile_kernel(const TIn* __restrict__ g, const int2* __restrict__ bin,
                            const int* __restrict__ starts, const int* __restrict__ slot_base,
                            const int2* __restrict__ items, const int2* __restrict__ totals,
                            int* __restrict__ done, float* __restrict__ partials,
                            TOut* __restrict__ out, int c, int64_t n_rows, int tile_rows,
                            int chunk) {
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);
  __shared__ int last;
  if (static_cast<int>(blockIdx.x) >= totals->x) return;
  const int2 item = items[blockIdx.x];
  const int t = item.x, part = item.y;
  const int64_t row_lo = static_cast<int64_t>(t) * tile_rows;
  const int rows = static_cast<int>(min(static_cast<int64_t>(tile_rows), n_rows - row_lo));
  const int n_el = rows * c;  // this tile's elements of `out`, contiguous from row_lo
  TOut* dst = out + row_lo * c;
  const int p_begin = starts[t], p_end = starts[t + 1];
  const int count = p_end - p_begin;
  const int n_parts = count > chunk ? (count + chunk - 1) / chunk : 1;

  // shared: the f32 tile, then the chunk sorted by row: row starts
  // [tile_rows + 1], point ids and rows [kChunk]
  int* row_start = reinterpret_cast<int*>(tile + tile_rows * c);
  int* sorted_pt = row_start + tile_rows + 1;
  int* sorted_row = sorted_pt + kChunk;
  __shared__ int warp_sums[kThreads / 32];
  for (int e = threadIdx.x; e < n_el; e += kThreads) tile[e] = 0.0f;
  for (int r = threadIdx.x; r <= tile_rows; r += kThreads) row_start[r] = 0;
  __syncthreads();

  // sort this item's points by row within the block (a counting sort:
  // warp-aggregated int shared atomics, which are native, a scan, a scatter)
  const int lo = p_begin + part * chunk, n = min(chunk, p_end - lo);
  int rank[kPerThread], row_of[kPerThread], pt_of[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = k * kThreads + threadIdx.x;
    const int2 b = e < n ? __ldg(bin + lo + e) : make_int2(0, -1);
    pt_of[k] = b.x;
    row_of[k] = b.y;
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) rank[k] = warp_add(row_start, row_of[k]);
  __syncthreads();
  block_exclusive_scan(row_start, tile_rows, warp_sums);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (row_of[k] >= 0) {
      const int pos = row_start[row_of[k]] + rank[k];
      sorted_pt[pos] = pt_of[k];
      sorted_row[pos] = row_of[k];
    }
  }
  __syncthreads();

  // G lanes read one payload row (VEC elements each); the S groups of G
  // lanes take equal consecutive segments of the sorted points, so a group
  // sums whole runs of one row in registers, kUnroll loads in flight, and
  // stores each run once; only a row that crosses a segment's end is added
  // atomically
  const int G = c / VEC;
  const int S = G <= kThreads ? kThreads / G : 1;
  const int grp = G <= kThreads ? static_cast<int>(threadIdx.x) / G : 0;
  if (grp < S) {
    const int seg_lo = grp * n / S, seg_hi = (grp + 1) * n / S;
    const int tid = threadIdx.x;
    for (int j = G <= kThreads ? tid % G : tid; j < G; j += kThreads) {
      float acc[VEC] = {};
      int cur = -1;
      for (int q0 = seg_lo; q0 < seg_hi; q0 += kUnroll) {
        typename Raw<TIn, VEC>::type raw[kUnroll];
        int rr[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = q0 + u;
          rr[u] = -1;
          if (q < seg_hi) {
            rr[u] = sorted_row[q];
            raw[u] = load_raw<TIn, VEC>(g + static_cast<int64_t>(sorted_pt[q]) * c + j * VEC);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (rr[u] < 0) break;
          if (rr[u] != cur) {
            if (cur >= 0) {
              flush<VEC>(tile, cur, c, j, row_start[cur] >= seg_lo && row_start[cur + 1] <= seg_hi, acc);
            }
            cur = rr[u];
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
          }
          add_raw<TIn, VEC>(acc, raw[u]);
        }
      }
      if (cur >= 0) {
        flush<VEC>(tile, cur, c, j, row_start[cur] >= seg_lo && row_start[cur + 1] <= seg_hi, acc);
      }
    }
  }
  __syncthreads();

  if (n_parts == 1) {  // the whole tile: write its rows once
    for (int e = threadIdx.x * VEC; e < n_el; e += kThreads * VEC) {
      float v[VEC];
      load_f32<VEC, false>(tile + e, v);
      store_vec<TOut, VEC>(dst + e, v);
    }
    return;
  }

  // a split tile: park this part's f32 tile; the last part to finish sums
  // all parts in slot order and writes the rows once
  const int64_t stride = static_cast<int64_t>(tile_rows) * c;
  float* base = partials + static_cast<int64_t>(slot_base[t]) * stride;
  float* mine = base + part * stride;
  for (int e = threadIdx.x * VEC; e < n_el; e += kThreads * VEC) {
    float v[VEC];
    load_f32<VEC, false>(tile + e, v);
    store_vec<float, VEC>(mine + e, v);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done + t, 1) == n_parts - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = threadIdx.x * VEC; e < n_el; e += kThreads * VEC) {
    float sum[VEC] = {};
    for (int k = 0; k < n_parts; ++k) {
      float v[VEC];
      load_f32<VEC, true>(base + k * stride + e, v);
#pragma unroll
      for (int u = 0; u < VEC; ++u) sum[u] += v[u];
    }
    store_vec<TOut, VEC>(dst + e, sum);
  }
}

template <typename TIn, int VEC, typename TOut>
int launch_tiles(const TIn* g, const int2* bin, const int* starts, const int* slot_base,
                 const int2* items, const int* empty, const int2* totals, int* done,
                 float* partials, void* out, int c, int64_t n_rows, int tile_rows, int n_tiles,
                 int chunk, int64_t n_items_max, cudaStream_t s) {
  if (chunk != kChunk) return static_cast<int>(cudaErrorInvalidValue);
  segment_sum_zero_kernel<TOut, VEC><<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      empty, totals, static_cast<TOut*>(out), c, n_rows, tile_rows);
  const size_t smem = (static_cast<size_t>(tile_rows) * c + tile_rows + 1 + 2 * kChunk) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(segment_sum_tile_kernel<TIn, VEC, TOut>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  segment_sum_tile_kernel<TIn, VEC, TOut><<<static_cast<unsigned>(n_items_max), kThreads, smem, s>>>(
      g, bin, starts, slot_base, items, totals, done, partials, static_cast<TOut*>(out), c,
      n_rows, tile_rows, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn, int VEC>
int launch_tiles_out(int out_is_bf16, const TIn* g, const int2* bin, const int* starts,
                     const int* slot_base, const int2* items, const int* empty, const int2* totals,
                     int* done, float* partials, void* out, int c, int64_t n_rows, int tile_rows,
                     int n_tiles, int chunk, int64_t n_items_max, cudaStream_t s) {
  if (out_is_bf16) {
    return launch_tiles<TIn, VEC, __nv_bfloat16>(g, bin, starts, slot_base, items, empty, totals,
                                                 done, partials, out, c, n_rows, tile_rows,
                                                 n_tiles, chunk, n_items_max, s);
  }
  return launch_tiles<TIn, VEC, float>(g, bin, starts, slot_base, items, empty, totals, done,
                                       partials, out, c, n_rows, tile_rows, n_tiles, chunk,
                                       n_items_max, s);
}

}  // namespace

// The bin: counts (zeroed by the caller) -> starts, cursor, slot_base,
// items, empty, totals -> bin.
extern "C" int lrf_segment_sum_bin(const void* idx, int64_t p, int64_t n_rows, int tile_rows,
                                   int n_tiles, int chunk, void* counts, void* starts,
                                   void* cursor, void* slot_base, void* items, void* empty,
                                   void* totals, void* bin, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int64_t*>(idx);
  const unsigned blocks = static_cast<unsigned>((p + kThreads * kBinPoints - 1) / (kThreads * kBinPoints));
  const size_t smem = n_tiles <= kSharedTiles ? static_cast<size_t>(n_tiles) * sizeof(int) : 0;
  if (p) {
    segment_sum_bin_count_kernel<<<blocks, kThreads, smem, s>>>(ix, p, n_rows, tile_rows, n_tiles,
                                                                static_cast<int*>(counts));
  }
  segment_sum_bin_scan_kernel<<<1, kScanThreads, 0, s>>>(
      static_cast<const int*>(counts), n_tiles, chunk, static_cast<int*>(starts),
      static_cast<int*>(cursor), static_cast<int*>(slot_base), static_cast<int2*>(items),
      static_cast<int*>(empty), static_cast<int2*>(totals));
  if (p) {
    segment_sum_bin_scatter_kernel<<<blocks, kThreads, smem, s>>>(
        ix, p, n_rows, tile_rows, n_tiles, static_cast<int*>(cursor), static_cast<int2*>(bin));
  }
  return static_cast<int>(cudaGetLastError());
}

// The zero and reduce kernels over a bin from lrf_segment_sum_bin; `done`
// zeroed by the caller; vec = 8 (bf16) or 4 (f32) for 16-byte payload
// loads, else 1.
extern "C" int lrf_segment_sum_reduce(const void* g, int g_is_bf16, int vec, const void* bin,
                                      const void* starts, const void* slot_base,
                                      const void* items, const void* empty, const void* totals,
                                      void* done, void* partials, void* out, int out_is_bf16,
                                      int c, int64_t n_rows, int tile_rows, int n_tiles, int chunk,
                                      int64_t n_items_max, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const int2*>(bin);
  const auto* st = static_cast<const int*>(starts);
  const auto* sb = static_cast<const int*>(slot_base);
  const auto* it = static_cast<const int2*>(items);
  const auto* em = static_cast<const int*>(empty);
  const auto* to = static_cast<const int2*>(totals);
  auto* dn = static_cast<int*>(done);
  auto* pa = static_cast<float*>(partials);
  if (g_is_bf16) {
    const auto* gp = static_cast<const __nv_bfloat16*>(g);
    if (vec == 8) {
      return launch_tiles_out<__nv_bfloat16, 8>(out_is_bf16, gp, b, st, sb, it, em, to, dn, pa, out,
                                                c, n_rows, tile_rows, n_tiles, chunk, n_items_max, s);
    }
    return launch_tiles_out<__nv_bfloat16, 1>(out_is_bf16, gp, b, st, sb, it, em, to, dn, pa, out, c,
                                              n_rows, tile_rows, n_tiles, chunk, n_items_max, s);
  }
  const auto* gp = static_cast<const float*>(g);
  if (vec == 4) {
    return launch_tiles_out<float, 4>(out_is_bf16, gp, b, st, sb, it, em, to, dn, pa, out, c, n_rows,
                                      tile_rows, n_tiles, chunk, n_items_max, s);
  }
  return launch_tiles_out<float, 1>(out_is_bf16, gp, b, st, sb, it, em, to, dn, pa, out, c, n_rows,
                                    tile_rows, n_tiles, chunk, n_items_max, s);
}
