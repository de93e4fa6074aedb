// K3: segment sum into small tables (the line-table backward of
// `--line_bwd segsum`), for Hopper.
//
// Replaces the Pallas TPU kernel localrf_tpu/ops/pallas/segsum.py
// (`segment_sum_matmul`: `_segsum_kernel`), the VJP of `take_rows`.
//
//   out[r, :] = sum_{p : idx_p == r} g_p    (f32 accumulation, f32 out)
//
// What bounds it on the card: contention, not bytes. At the 640^3 stage
// P = 1,359,872 rows of 64 bf16 (174 MB) land on only 640 line rows, about
// 2,100 points per row, so K2's design (one global f32 atomic per element)
// would serialise ~2,100 deep on each of 41k addresses in L2. The TPU
// kernel kept a [T_TILE, C] accumulator resident in VMEM across the point
// stream and fed it one-hot MXU matmuls; here the output tile lives in
// shared memory instead: a whole [640, 64] f32 line table is 160 KB, within
// the 227 KB a block can opt into. Each block (32 warps, about one block
// per SM) zeroes its tile, streams a stretch of the points (one warp per
// point, lanes over channels, so a warp's shared atomics never collide;
// each warp loads the indices and rows of 4 points before it adds any, so
// the global loads overlap: one point at a time, the kernel is latency
// bound and slower than the plain `index_add_` at 640^3), and flushes its tile once with
// global atomics into the zeroed f32 output: per block one add per element
// of the tile instead of one per point. Tables taller than one block's
// shared memory are cut into row tiles (grid.x), as the TPU kernel tiles T;
// every row-tile block scans its points and skips the rows of other tiles.
// Summation order is nondeterministic, so results match the plain
// `index_add_` to f32 rounding. Indices outside [0, n_rows) are skipped;
// the forward gather's index clamp (`_unnormalize`) keeps them in range.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 32;  // blockDim = (32, 32)
constexpr int kUnroll = 4;  // points in flight per warp
constexpr int kMaxC = 64;   // payload width: two channels per lane (a quad line row is 2C = 64)
constexpr int kMaxSmemBytes = 160 * 1024;  // one [640, 64] f32 line table

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(32 * kWarps) segsum_small_kernel(const int64_t* __restrict__ idx, const T* __restrict__ g,
                                    float* __restrict__ out, int64_t p_total, int c,
                                    int64_t n_rows, int tile_rows) {
  extern __shared__ float tile[];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int64_t rows_here = (n_rows - row0 < tile_rows) ? (n_rows - row0) : tile_rows;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int n_tile = static_cast<int>(rows_here) * c;
  for (int e = tid; e < n_tile; e += 32 * kWarps) tile[e] = 0.0f;
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(gridDim.y) * kWarps;
  const int64_t first = static_cast<int64_t>(blockIdx.y) * kWarps + threadIdx.y;
  // lanes carry channels lane and lane + 32 (c <= kMaxC); kUnroll points in flight
  const int j0 = threadIdx.x, j1 = threadIdx.x + 32;
  for (int64_t p = first; p < p_total; p += kUnroll * stride) {
    int64_t local[kUnroll];
    float v0[kUnroll], v1[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = p + u * stride;
      local[u] = q < p_total ? idx[q] - row0 : -1;
      const bool in = local[u] >= 0 && local[u] < rows_here;
      v0[u] = (in && j0 < c) ? to_f32(g[q * c + j0]) : 0.0f;
      v1[u] = (in && j1 < c) ? to_f32(g[q * c + j1]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (local[u] < 0 || local[u] >= rows_here) continue;
      float* dst = tile + local[u] * c;
      if (j0 < c) atomicAdd(dst + j0, v0[u]);
      if (j1 < c) atomicAdd(dst + j1, v1[u]);
    }
  }
  __syncthreads();

  float* o = out + row0 * c;
  for (int e = tid; e < n_tile; e += 32 * kWarps) {
    const float v = tile[e];
    if (v != 0.0f) atomicAdd(o + e, v);
  }
}

template <typename T>
cudaError_t launch(const int64_t* idx, const T* g, float* out, int64_t p, int c, int64_t n_rows,
                   cudaStream_t s) {
  if (c < 1 || c > kMaxC) return cudaErrorInvalidValue;
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const int row_bytes = c * static_cast<int>(sizeof(float));
  int tile_rows = kMaxSmemBytes / row_bytes;
  if (tile_rows > n_rows) tile_rows = static_cast<int>(n_rows);
  if (tile_rows < 1) return cudaErrorInvalidValue;
  const int64_t row_tiles = (n_rows + tile_rows - 1) / tile_rows;
  // about one block per SM in all, but no block with fewer than ~1024 points
  int64_t pt_blocks = (static_cast<int64_t>(n_sm) + row_tiles - 1) / row_tiles;
  const int64_t max_pt_blocks = (p + 1023) / 1024;
  if (pt_blocks > max_pt_blocks) pt_blocks = max_pt_blocks;
  if (pt_blocks < 1) pt_blocks = 1;
  const size_t smem = static_cast<size_t>(tile_rows) * row_bytes;
  cudaError_t err = cudaFuncSetAttribute(segsum_small_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(row_tiles), static_cast<unsigned>(pt_blocks));
  segsum_small_kernel<T><<<grid, dim3(32, kWarps), smem, s>>>(idx, g, out, p, c, n_rows,
                                                              tile_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lrf_segsum_small(const void* idx, const void* g, int g_is_bf16, void* out,
                                int64_t p, int c, int64_t n_rows, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int64_t*>(idx);
  auto* o = static_cast<float*>(out);
  cudaError_t err =
      g_is_bf16 ? launch(ix, static_cast<const __nv_bfloat16*>(g), o, p, c, n_rows, s)
                : launch(ix, static_cast<const float*>(g), o, p, c, n_rows, s);
  return static_cast<int>(err);
}
