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
// What bounds it on the card: bytes, since the main path's [4096, 332]
// moves only 16 MB forward and 22 MB backward (microseconds at 3.35 TB/s),
// but the scan along a ray is sequential, so how the rays are spread over
// the threads decides the time. Both kernels run one warp per ray and walk
// it in windows of 32 consecutive samples, so every load and store is
// coalesced and 4,096 rays make 4,096 warps (~31 on each of 132 SMs). In
// each window a shuffle exclusive product scan of b_i = max(1 - a_i, eps)
// times the carry from earlier windows gives T_i (`window_fwd`), and the
// window's product carries on to the next.
// - forward: w_i = a_i T_i written from registers, window by window; sigma
//   and dist read once, w written once. The backward recomputes T with the
//   same `window_fwd`, so the two see the same bits.
// - backward: an (alpha, T) pair per lane stays in registers for the first
//   kCacheWin windows (S <= 384, the main path's 72 and 332), so T is never
//   parked in device memory. A reverse pass over the windows runs a
//   shuffle suffix-sum scan of g_k w_k plus the carry from later windows:
//   the suffix sum is summed, never taken as `total - prefix`, which
//   cancels. Windows past the cache keep only their starting T (shared
//   memory) and recompute a and T in the reverse pass from the inputs (the
//   same arithmetic, so the same bits).
// The products and sums run in another order than the plain cumprod: the
// result moves by a few f32 ulp, and the order is fixed, so both kernels
// are deterministic.
// a_i is the same expression in both kernels and the plain version (no
// fast math). `max(1 - a, eps)` stays an fmaxf: (1 - a) + eps may be
// reassociated to 0 at the terminator.
// `dist_stride` is 0 for a [1, S] dist row shared by all rays and S for a
// per-ray [R, S] dist, so the broadcast is never materialised.

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-10f;
constexpr int kFwdWarps = 4;  // forward: one warp per ray, 4 rays per block (1,024 blocks at R = 4096)
constexpr int kBwdWarps = 8;  // backward: one warp per ray, 8 rays per block
constexpr int kCacheWin = 12;  // backward: windows of 32 samples kept in registers

// One lane's sample of a window: alpha and transmittance T.
struct Sample {
  float a, t;
};

// Window w of a ray, lane i = 32 w + lane: a_i, T_i = carry * prod of the
// window's earlier b (shuffle product scan); advances carry past the window.
// Lanes past the end carry b = 1.
__device__ __forceinline__ Sample window_fwd(const float* sg, const float* dd, int i, int s,
                                             float scale, int lane, float& carry) {
  const bool valid = i < s;
  const float sv = valid ? sg[i] : 0.0f;
  const float dv = valid ? dd[i] : 0.0f;
  const float a = (i == s - 1) ? 1.0f : 1.0f - expf(-sv * dv * scale);
  float incl = valid ? fmaxf(1.0f - a, kEps) : 1.0f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl *= y;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 1.0f;
  const Sample out{a, carry * excl};
  carry *= __shfl_sync(0xffffffffu, incl, 31);
  return out;
}

__global__ void __launch_bounds__(kFwdWarps * 32)
    composite_fwd_kernel(const float* __restrict__ sigma, const float* __restrict__ dists,
                         float* __restrict__ w, int r_total, int s, int dist_stride, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kFwdWarps + warp;
  if (r >= r_total) return;  // the whole warp
  const float* sg = sigma + static_cast<size_t>(r) * s;
  const float* dd = dists + static_cast<size_t>(r) * dist_stride;
  float* wr = w + static_cast<size_t>(r) * s;
  float carry = 1.0f;
#pragma unroll 4
  for (int i0 = 0; i0 < s; i0 += 32) {
    const int i = i0 + lane;
    const Sample x = window_fwd(sg, dd, i, s, scale, lane, carry);
    if (i < s) wr[i] = x.a * x.t;
  }
}

// The reverse step of window w: suffix_i = (sum of g_k w_k over the later
// lanes of the window, a shuffle suffix scan) + suffix (the later windows);
// writes dsigma_i; adds the window's sum to suffix.
__device__ __forceinline__ void window_bwd(const Sample& x, const float* gr, const float* dd,
                                           float* ds, int i, int s, float scale, int lane,
                                           float& suffix) {
  const bool valid = i < s;
  const float gi = valid ? gr[i] : 0.0f;
  float incl = gi * (x.a * x.t);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += y;
  }
  float excl = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) excl = 0.0f;
  if (valid) {
    const float later = excl + suffix;
    const float b = fmaxf(1.0f - x.a, kEps);
    const float dl_da = gi * x.t - later / b;
    ds[i] = (i == s - 1) ? 0.0f : dl_da * (1.0f - x.a) * dd[i] * scale;
  }
  suffix += __shfl_sync(0xffffffffu, incl, 0);
}

__global__ void __launch_bounds__(kBwdWarps * 32)
    composite_bwd_kernel(const float* __restrict__ sigma, const float* __restrict__ dists,
                         const float* __restrict__ g, float* __restrict__ dsigma, int r_total,
                         int s, int dist_stride, float scale) {
  extern __shared__ float far_t[];  // [kBwdWarps][n_far]: T at the start of each uncached window
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kBwdWarps + warp;
  if (r >= r_total) return;  // the whole warp
  const float* sg = sigma + static_cast<size_t>(r) * s;
  const float* dd = dists + static_cast<size_t>(r) * dist_stride;
  const float* gr = g + static_cast<size_t>(r) * s;
  float* ds = dsigma + static_cast<size_t>(r) * s;
  const int n_win = (s + 31) >> 5;
  const int n_far = n_win > kCacheWin ? n_win - kCacheWin : 0;
  float* my_far = far_t + warp * n_far;

  Sample cache[kCacheWin];
  float carry = 1.0f;
#pragma unroll
  for (int w = 0; w < kCacheWin; ++w) {
    if (w < n_win) cache[w] = window_fwd(sg, dd, w * 32 + lane, s, scale, lane, carry);
  }
  for (int w = kCacheWin; w < n_win; ++w) {
    if (lane == 0) my_far[w - kCacheWin] = carry;
    window_fwd(sg, dd, w * 32 + lane, s, scale, lane, carry);
  }
  __syncwarp();

  float suffix = 0.0f;
  for (int w = n_win - 1; w >= kCacheWin; --w) {
    float start = my_far[w - kCacheWin];
    const Sample x = window_fwd(sg, dd, w * 32 + lane, s, scale, lane, start);
    window_bwd(x, gr, dd, ds, w * 32 + lane, s, scale, lane, suffix);
  }
#pragma unroll
  for (int w = kCacheWin - 1; w >= 0; --w) {
    if (w < n_win) window_bwd(cache[w], gr, dd, ds, w * 32 + lane, s, scale, lane, suffix);
  }
}

}  // namespace

extern "C" int lrf_composite_fwd(const void* sigma, const void* dists, void* w, int r, int s,
                                 int dist_stride, float scale, void* stream) {
  const int blocks = (r + kFwdWarps - 1) / kFwdWarps;
  composite_fwd_kernel<<<blocks, kFwdWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sigma), static_cast<const float*>(dists),
      static_cast<float*>(w), r, s, dist_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lrf_composite_bwd(const void* sigma, const void* dists, const void* g,
                                 void* dsigma, int r, int s, int dist_stride, float scale,
                                 void* stream) {
  const int n_win = (s + 31) / 32;
  const size_t smem = static_cast<size_t>(kBwdWarps) * (n_win > kCacheWin ? n_win - kCacheWin : 0) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (r + kBwdWarps - 1) / kBwdWarps;
  composite_bwd_kernel<<<blocks, kBwdWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sigma), static_cast<const float*>(dists),
      static_cast<const float*>(g), static_cast<float*>(dsigma), r, s, dist_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lrf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
