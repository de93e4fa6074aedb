// K2: segment sum, the backward of every plane-table row gather, for Hopper.
//
// Replaces the Pallas TPU kernel localrf_tpu/ops/pallas/binned_scatter.py
// (`binned_segment_sum`: `_kernel`), the VJP of `take_rows_binned`.
//
//   out[r, :] = sum_{p : idx_p == r} g_p    (f32 accumulation, then the
//                                            caller's dtype: bf16 here)
//
// What bounds it on the card: the payload stream. At the 640^3 stage each
// orientation scatters P ~ 1.36M rows of 128 bf16 (348 MB) into a
// [409,600, 128] table; every element costs one f32 atomic add in L2, and
// the f32 staging table (210 MB) is zeroed, updated and read back once for
// the cast. The TPU kernel sorted the indices and ran one-hot MXU matmuls
// per output tile because the TPU has no scatter-add hardware; Hopper's L2
// does f32 reductions (RED) natively, so this design needs no sort: one
// warp per point reads its 128-wide row coalesced and issues fire-and-forget
// atomic adds into the zeroed f32 staging buffer; a second small kernel
// casts the staging buffer to bf16 (round to nearest even). Summation order
// across points is nondeterministic, so results match the plain
// `index_add_` to f32 rounding (and to one bf16 ulp after the cast).
// Indices outside [0, n_rows) are skipped; the forward gather's index
// clamp (`_unnormalize`) is what keeps them in range.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPointsPerBlock = 8;  // blockDim = (32, 8): one warp per point

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void segment_sum_kernel(const int64_t* __restrict__ idx, const T* __restrict__ g,
                                   float* __restrict__ out, int64_t p_total, int c,
                                   int64_t n_rows) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (p >= p_total) return;
  const int64_t row = idx[p];
  if (row < 0 || row >= n_rows) return;
  const T* src = g + p * c;
  float* dst = out + row * c;
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    atomicAdd(dst + j, to_f32(src[j]));
  }
}

__global__ void cast_f32_bf16_kernel(const float* __restrict__ src,
                                     __nv_bfloat16* __restrict__ dst, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    dst[i] = __float2bfloat16(src[i]);
  }
}

}  // namespace

extern "C" int lrf_segment_sum(const void* idx, const void* g, int g_is_bf16, void* out,
                               int64_t p, int c, int64_t n_rows, void* stream) {
  const dim3 block(32, kPointsPerBlock);
  const unsigned blocks = static_cast<unsigned>((p + kPointsPerBlock - 1) / kPointsPerBlock);
  auto s = static_cast<cudaStream_t>(stream);
  if (g_is_bf16) {
    segment_sum_kernel<<<blocks, block, 0, s>>>(static_cast<const int64_t*>(idx),
                                                static_cast<const __nv_bfloat16*>(g),
                                                static_cast<float*>(out), p, c, n_rows);
  } else {
    segment_sum_kernel<<<blocks, block, 0, s>>>(static_cast<const int64_t*>(idx),
                                                static_cast<const float*>(g),
                                                static_cast<float*>(out), p, c, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lrf_cast_f32_bf16(const void* src, void* dst, int64_t n, void* stream) {
  const int64_t want = (n + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(want < (1 << 20) ? want : (1 << 20));
  cast_f32_bf16_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<__nv_bfloat16*>(dst), n);
  return static_cast<int>(cudaGetLastError());
}
