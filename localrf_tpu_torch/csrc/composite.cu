// K1: volume-compositing weights and their analytic backward, for Hopper.
//
// Replaces the Pallas TPU kernel localrf_tpu/ops/pallas/composite.py
// (`fused_weights`: `_fwd_kernel` and `_bwd_kernel`).
//
//   a_i = 1 - exp(-sigma_i * dist_i * scale),  a_{S-1} = 1 (terminator)
//   b_i = max(1 - a_i, 1e-10),  T_i = prod_{j<i} b_j,  w_i = a_i T_i
//   dsigma_i = (g_i T_i - (sum_{k>i} g_k w_k) / b_i) * (1 - a_i) * dist_i * scale,
//   0 at the terminator; no gradient to dist.
//
// What bounds it on the card: the scan is sequential per ray, so with one
// thread per ray the kernel is latency bound (a chain of S dependent
// expf/multiply steps), not bandwidth bound — the main path's [4096, 332]
// moves 16 MB in and out, microseconds at HBM speed, but has only 4096
// threads. The design keeps every intermediate in registers: the forward
// reads sigma and dist once and writes w once; the backward needs no [R, S]
// scratch (the Pallas kernel keeps three in VMEM) — a forward pass parks
// T_i in the dsigma output buffer, and a reverse pass recomputes a_i and
// w_i = a_i T_i from it while carrying the suffix sum, so no `total -
// prefix` subtraction can cancel. The recomputed a_i is bit-identical to
// the forward's (same expression, no fast math). `max(1 - a, eps)` stays an
// fmaxf: (1 - a) + eps may be reassociated to 0 at the terminator.
// `dist_stride` is 0 for a [1, S] dist row shared by all rays and S for a
// per-ray [R, S] dist, so the broadcast is never materialised.

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-10f;
constexpr int kThreads = 64;  // 4096 rays -> 64 blocks over 132 SMs

__device__ __forceinline__ float alpha_at(const float* sg, const float* dd, int i, int s,
                                          float scale) {
  return (i == s - 1) ? 1.0f : 1.0f - expf(-sg[i] * dd[i] * scale);
}

__global__ void composite_fwd_kernel(const float* __restrict__ sigma,
                                     const float* __restrict__ dists, float* __restrict__ w,
                                     int r_total, int s, int dist_stride, float scale) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= r_total) return;
  const float* sg = sigma + static_cast<size_t>(r) * s;
  const float* dd = dists + static_cast<size_t>(r) * dist_stride;
  float* wr = w + static_cast<size_t>(r) * s;
  float t = 1.0f;
  for (int i = 0; i < s; ++i) {
    const float a = alpha_at(sg, dd, i, s, scale);
    wr[i] = a * t;
    t = t * fmaxf(1.0f - a, kEps);
  }
}

__global__ void composite_bwd_kernel(const float* __restrict__ sigma,
                                     const float* __restrict__ dists,
                                     const float* __restrict__ g, float* __restrict__ dsigma,
                                     int r_total, int s, int dist_stride, float scale) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= r_total) return;
  const float* sg = sigma + static_cast<size_t>(r) * s;
  const float* dd = dists + static_cast<size_t>(r) * dist_stride;
  const float* gr = g + static_cast<size_t>(r) * s;
  float* ds = dsigma + static_cast<size_t>(r) * s;

  // forward pass: T_i parked in the output row
  float t = 1.0f;
  for (int i = 0; i < s; ++i) {
    ds[i] = t;
    t = t * fmaxf(1.0f - alpha_at(sg, dd, i, s, scale), kEps);
  }
  // reverse pass: suffix = sum_{k>i} g_k w_k
  float suffix = 0.0f;
  for (int i = s - 1; i >= 0; --i) {
    const float a = alpha_at(sg, dd, i, s, scale);
    const float ti = ds[i];
    const float b = fmaxf(1.0f - a, kEps);
    const float gi = gr[i];
    const float dl_da = gi * ti - suffix / b;
    const float dsig = dl_da * (1.0f - a) * dd[i] * scale;
    ds[i] = (i == s - 1) ? 0.0f : dsig;
    suffix = suffix + gi * (a * ti);
  }
}

}  // namespace

extern "C" int lrf_composite_fwd(const void* sigma, const void* dists, void* w, int r, int s,
                                 int dist_stride, float scale, void* stream) {
  const int blocks = (r + kThreads - 1) / kThreads;
  composite_fwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sigma), static_cast<const float*>(dists),
      static_cast<float*>(w), r, s, dist_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lrf_composite_bwd(const void* sigma, const void* dists, const void* g,
                                 void* dsigma, int r, int s, int dist_stride, float scale,
                                 void* stream) {
  const int blocks = (r + kThreads - 1) / kThreads;
  composite_bwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sigma), static_cast<const float*>(dists),
      static_cast<const float*>(g), static_cast<float*>(dsigma), r, s, dist_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lrf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
