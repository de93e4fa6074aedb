// K5: merged segment sum, written once in the output dtype, for Hopper.
//
// Replaces the Pallas TPU kernel localrf_tpu/ops/pallas/binned_scatter.py
// (`binned_segment_sum_merged`: `_kernel_v2`). It computes K2's function
//
//   out[r, :] = sum_{p : idx_p == r} g_p    (f32 accumulation, stored once
//                                            in the caller's dtype)
//
// What bounds it on the card: the payload stream. At the 640^3 plane shape
// P ~ 1.36M rows of 128 bf16 (348 MB) reduce into a [409,600, 128] table;
// the sorted payload is read once and every output row is written once
// (105 MB in bf16), so ~450 MB of traffic against K2's payload read plus
// an f32 staging table zeroed, atomically updated and read back for the
// cast (~1 GB). The TPU kernel visited (tile, sorted chunk) pairs in
// order on one core and masked each chunk's rows with a one-hot matmul;
// here the wrapper sorts the indices (torch.sort, stable), puts the
// payload in sorted order (one index_select) and finds each tile's range
// of sorted points (torch.searchsorted), as the JAX wrapper does outside
// its Pallas body. Then one block per tile of `tile_rows` output rows walks
// its range in order: each thread owns a channel, keeps a running f32 sum
// of the current row, writes the row when the index changes, and writes
// zeros for rows no point hits. An empty tile just writes zeros (no dummy
// steps, no masks). No staging table, no atomics, no cast pass, and the
// summation order is fixed (sorted, stable), so the result is
// deterministic. Indices outside [0, n_rows) fall outside every tile's
// range and are skipped.
//
// The walk is latency bound per block: each thread loads kUnroll points
// (index and payload) before it adds them, so that many loads are in
// flight; the wrapper sizes tiles to ~256 points so enough blocks fill the
// card. A row hit by very many points is summed by one block in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // one channel per thread, rows of up to 128 values per pass
constexpr int kUnroll = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    segment_sum_merged_kernel(const int64_t* __restrict__ sidx, const TIn* __restrict__ g,
                              const int64_t* __restrict__ starts, TOut* __restrict__ out, int c,
                              int64_t n_rows, int tile_rows) {
  const int64_t tile = blockIdx.x;
  const int64_t row_lo = tile * tile_rows;
  const int64_t row_hi = row_lo + tile_rows < n_rows ? row_lo + tile_rows : n_rows;
  const int64_t p_lo = starts[tile];
  const int64_t p_hi = starts[tile + 1];
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    int64_t next = row_lo;  // first row not yet written
    int64_t row = -1;       // the row `acc` sums
    float acc = 0.0f;
    for (int64_t p0 = p_lo; p0 < p_hi; p0 += kUnroll) {
      int64_t r[kUnroll];
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t p = p0 + u;
        if (p < p_hi) {
          r[u] = sidx[p];
          v[u] = to_f32(g[p * c + ch]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p0 + u < p_hi) {
          if (r[u] != row) {  // uniform across the block: every thread sees the same index
            if (row >= 0) {
              store(out + row * c + ch, acc);
              next = row + 1;
            }
            for (; next < r[u]; ++next) store(out + next * c + ch, 0.0f);
            row = r[u];
            acc = 0.0f;
          }
          acc += v[u];
        }
      }
    }
    if (row >= 0) {
      store(out + row * c + ch, acc);
      next = row + 1;
    }
    for (; next < row_hi; ++next) store(out + next * c + ch, 0.0f);
  }
}

template <typename TIn>
void launch(const int64_t* sidx, const TIn* g, const int64_t* starts, void* out, int out_is_bf16,
            int c, int64_t n_rows, int tile_rows, int64_t n_tiles, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>(n_tiles);
  if (out_is_bf16) {
    segment_sum_merged_kernel<<<blocks, kThreads, 0, s>>>(
        sidx, g, starts, static_cast<__nv_bfloat16*>(out), c, n_rows, tile_rows);
  } else {
    segment_sum_merged_kernel<<<blocks, kThreads, 0, s>>>(
        sidx, g, starts, static_cast<float*>(out), c, n_rows, tile_rows);
  }
}

}  // namespace

extern "C" int lrf_segment_sum_merged(const void* sidx, const void* g, int g_is_bf16,
                                      const void* starts, void* out, int out_is_bf16, int c,
                                      int64_t n_rows, int tile_rows, int64_t n_tiles,
                                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* idx = static_cast<const int64_t*>(sidx);
  const auto* st = static_cast<const int64_t*>(starts);
  if (g_is_bf16) {
    launch(idx, static_cast<const __nv_bfloat16*>(g), st, out, out_is_bf16, c, n_rows, tile_rows,
           n_tiles, s);
  } else {
    launch(idx, static_cast<const float*>(g), st, out, out_is_bf16, c, n_rows, tile_rows, n_tiles,
           s);
  }
  return static_cast<int>(cudaGetLastError());
}
