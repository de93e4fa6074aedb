// K4: the fused march core, forward and analytic backward, for Hopper.
//
// Replaces the Pallas TPU kernels localrf_tpu/ops/pallas/march.py
// (`_march_fwd_impl`: `_fwd_kernel`, and `_march_bwd`: `_bwd_kernel`).
// Per compacted sample p and orientation i (density 8 + appearance 24
// channels, app_dim 27, featureC 128, MLP_Fea_late_view without PE):
//
//   f_i   = bilerp(rows_i[p])                       (quad-packed, 128 wide)
//   l_i   = lerp(lines_i[x0_i], lines_i[x0_i] + 32) (quad-line row of 64)
//   prod  = f_i * l_i;  sigma += sum(prod[:8])
//   app   = concat_i(prod[8:]) @ basis              (72 -> 27)
//   rgb   = sigmoid(MLP(app, viewdir))              (27 -> 128 -> 128, +3 -> 3)
//
// and the backward: d_rows (fed to K2), d(wx, wy, w1) (the pose gradient),
// dlines (f32, cast by the caller), dbasis and the MLP gradients (f32).
//
// Rounding follows the Pallas kernel and `march_core_plain` op by op: the
// lerp weights, lerps and products in the table dtype T; sigma and app as
// f32 sums of T products; hidden dots f32, rounded to the MLP dtype M, bias
// added in M; the last layer two f32 dots plus b3; relu masks compare in
// f32; d_app rounded to T before the basis and factor backward. `rnd<B>`
// rounds an f32 value to bf16 (nearest even) where the dtype is bf16; the
// product or sum of two bf16 values is exact in f32, so one rounding after
// each op gives PyTorch's bf16 op bit for bit.
//
// What bounds it on the card: the MLP. At 640^3 the step shades
// P = 1,359,872 samples, ~20k multiply-adds each forward and ~3x that
// backward (recompute + VJP), on CUDA cores from shared memory; the row
// and line bytes (3 x 348 MB of bf16 rows) come second. The TPU kernel ran
// the MLP and the one-hot line lookup on the MXU with lines resident in
// VMEM. Here a line row is a direct indexed load (the [3, 640, 64] bf16
// lines sit in L2), and the design is the simple one:
// - forward: persistent blocks of 256 threads loop over tiles of 16
//   points; the weights, rounded as the Pallas kernel rounds them, stay in
//   shared memory (row strides padded to 129 so both the forward and the
//   transposed backward reads are free of bank conflicts); one warp per
//   point with a lane per channel computes the features, then the tile's
//   app and hidden activations pass through shared memory;
// - backward, kernel 1: one block per SM recomputes the tile's forward,
//   runs the MLP and basis VJP and writes d_app [P, 27] (f32); every
//   parameter gradient is a per-block partial in shared memory, each entry
//   owned by one thread per phase (no atomics), written out once per block
//   and summed over blocks in a fixed order by a small third kernel
//   (deterministic; the TPU kernel carried these sums in its revisited
//   output blocks over the sequential grid);
// - backward, kernel 2: one warp per run of 16 consecutive points, a lane
//   per channel, recomputes the lerps and produces d_rows, d(wx, wy, w1)
//   and dlines. dlines takes f32 global atomics, but consecutive samples of
//   a ray mostly share a line row, so each warp sums a run of equal rows
//   in registers and adds once per run (about 2,100 samples land on each
//   of the 640 rows at 640^3).
// Tensor cores (wgmma), TMA and warp specialisation are later work.
// x0 is never range-checked here: the texel clamp in the caller keeps
// x0 <= G - 1, and the quad line's last row duplicates the border.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int CD = 8, CA = 24, C = 32, APP = 27, FC = 128, NB = 3 * CA;
constexpr int TP = 16;         // points per tile
constexpr int kThreads = 256;  // 8 warps
constexpr int WS = FC + 1;     // padded row stride of w1 and w2 in shared memory
constexpr int kPtsPerWarp = 16;

// shared memory (floats): weights
constexpr int OFF_BASIS = 0;                    // [72][27], rounded to T
constexpr int OFF_W1 = OFF_BASIS + NB * APP;    // [27][WS], rounded to M
constexpr int OFF_B1 = OFF_W1 + APP * WS;       // [128], M
constexpr int OFF_W2 = OFF_B1 + FC;             // [128][WS], M
constexpr int OFF_B2 = OFF_W2 + FC * WS;        // [128], M
constexpr int OFF_W3 = OFF_B2 + FC;             // [131][3], M
constexpr int OFF_B3 = OFF_W3 + (FC + 3) * 3;   // [3], f32
constexpr int N_W = OFF_B3 + 4;
// activations of one tile
constexpr int OFF_FEAT = N_W;                   // [TP][72] appearance products (T)
constexpr int OFF_SIG = OFF_FEAT + TP * NB;     // [TP] sigma feature
constexpr int OFF_X0M = OFF_SIG + TP;           // [TP][27] app rounded to M
constexpr int OFF_H1 = OFF_X0M + TP * APP;      // [TP][128]
constexpr int OFF_H2 = OFF_H1 + TP * FC;        // [TP][128]
constexpr int OFF_RGB = OFF_H2 + TP * FC;       // [TP][4]
constexpr int N_FWD = OFF_RGB + TP * 4;
// backward: cotangents of one tile
constexpr int OFF_DP3 = N_FWD;                  // [TP][4] d_pre3 (f32)
constexpr int OFF_DP3M = OFF_DP3 + TP * 4;      // [TP][4] d_pre3 rounded to M
constexpr int OFF_DP2 = OFF_DP3M + TP * 4;      // [TP][128]
constexpr int OFF_DP1 = OFF_DP2 + TP * FC;      // [TP][128]
constexpr int OFF_DAPPT = OFF_DP1 + TP * FC;    // [TP][27] d_app rounded to T
constexpr int OFF_ACC = OFF_DAPPT + TP * APP;
// parameter-gradient partials, in the layout of the caller's dparams
constexpr int A_BASIS = 0;
constexpr int A_W1 = A_BASIS + NB * APP;
constexpr int A_B1 = A_W1 + APP * FC;
constexpr int A_W2 = A_B1 + FC;
constexpr int A_B2 = A_W2 + FC * FC;
constexpr int A_W3 = A_B2 + FC;
constexpr int A_B3 = A_W3 + (FC + 3) * 3;
constexpr int N_ACC = A_B3 + 3;
constexpr int N_BWD = OFF_ACC + N_ACC;
static_assert(N_BWD * 4 <= 232448, "backward shared memory exceeds one block's 227 KB");

template <bool B>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (B) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
struct Inputs {
  const T* rows[3];
  const float* wxy;  // [P, 6] wx0 wy0 wx1 wy1 wx2 wy2
  const float* w1l;  // [P, 3]
  const int* x0;     // [P, 3]
  const float* vd;   // [P, 3]
  const T* lines;    // [3, G, 64]
  const float* basis;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  const float* w3;
  const float* b3;
  int64_t p_total;
  int g;
};

template <bool TB, bool MB>
__device__ void stage_weights(float* sm, const float* basis, const float* w1, const float* b1,
                              const float* w2, const float* b2, const float* w3,
                              const float* b3) {
  const int tid = threadIdx.x;
  for (int e = tid; e < NB * APP; e += kThreads) sm[OFF_BASIS + e] = rnd<TB>(basis[e]);
  for (int e = tid; e < APP * FC; e += kThreads) {
    sm[OFF_W1 + (e >> 7) * WS + (e & 127)] = rnd<MB>(w1[e]);
  }
  for (int e = tid; e < FC * FC; e += kThreads) {
    sm[OFF_W2 + (e >> 7) * WS + (e & 127)] = rnd<MB>(w2[e]);
  }
  for (int e = tid; e < FC; e += kThreads) {
    sm[OFF_B1 + e] = rnd<MB>(b1[e]);
    sm[OFF_B2 + e] = rnd<MB>(b2[e]);
  }
  for (int e = tid; e < (FC + 3) * 3; e += kThreads) sm[OFF_W3 + e] = rnd<MB>(w3[e]);
  if (tid < 3) sm[OFF_B3 + tid] = b3[tid];
}

// The forward of one tile of TP points into shared memory: features, sigma,
// app (rounded to M), h1, h2, rgb. Points past p_total give zero features.
// Ends with a barrier.
template <typename T, bool MB>
__device__ void tile_forward(float* sm, const Inputs<T>& in, int64_t p0) {
  constexpr bool TB = std::is_same<T, __nv_bfloat16>::value;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // phase A: one warp per point, lane = channel
  for (int pl = warp; pl < TP; pl += kThreads / 32) {
    const int64_t p = p0 + pl;
    float sigma = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float prod = 0.0f;
      if (p < in.p_total) {
        const T* r = in.rows[i] + p * (4 * C);
        const float wx = rnd<TB>(in.wxy[p * 6 + 2 * i]);
        const float wy = rnd<TB>(in.wxy[p * 6 + 2 * i + 1]);
        const float wl = rnd<TB>(in.w1l[p * 3 + i]);
        const float omwx = rnd<TB>(1.0f - wx), omwy = rnd<TB>(1.0f - wy);
        const float omwl = rnd<TB>(1.0f - wl);
        const float v00 = ld(r + lane), v01 = ld(r + C + lane);
        const float v10 = ld(r + 2 * C + lane), v11 = ld(r + 3 * C + lane);
        const float top = rnd<TB>(rnd<TB>(v00 * omwx) + rnd<TB>(v01 * wx));
        const float bot = rnd<TB>(rnd<TB>(v10 * omwx) + rnd<TB>(v11 * wx));
        const float f = rnd<TB>(rnd<TB>(top * omwy) + rnd<TB>(bot * wy));
        const T* lr = in.lines + (static_cast<int64_t>(i) * in.g + in.x0[p * 3 + i]) * (2 * C);
        const float l = rnd<TB>(rnd<TB>(ld(lr + lane) * omwl) + rnd<TB>(ld(lr + C + lane) * wl));
        prod = rnd<TB>(f * l);
      }
      sigma += warp_sum(lane < CD ? prod : 0.0f);
      if (lane >= CD) sm[OFF_FEAT + pl * NB + i * CA + lane - CD] = prod;
    }
    if (lane == 0) sm[OFF_SIG + pl] = sigma;
  }
  __syncthreads();

  // phase B: app = sum_i feats_i @ basis_i (f32), rounded to M
  for (int e = tid; e < TP * APP; e += kThreads) {
    const int pl = e / APP, k = e % APP;
    const float* ft = sm + OFF_FEAT + pl * NB;
    float app = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float s = 0.0f;
      for (int j = 0; j < CA; ++j) s += ft[i * CA + j] * sm[OFF_BASIS + (i * CA + j) * APP + k];
      app += s;
    }
    sm[OFF_X0M + pl * APP + k] = rnd<MB>(app);
  }
  __syncthreads();

  const int n = tid & (FC - 1), half = tid >> 7;  // two halves of TP / 2 points
  // phase C: h1 = relu(M(x0m @ w1) + b1)
  {
    float acc[TP / 2];
#pragma unroll
    for (int q = 0; q < TP / 2; ++q) acc[q] = 0.0f;
    for (int k = 0; k < APP; ++k) {
      const float w = sm[OFF_W1 + k * WS + n];
#pragma unroll
      for (int q = 0; q < TP / 2; ++q) acc[q] += sm[OFF_X0M + (half * (TP / 2) + q) * APP + k] * w;
    }
#pragma unroll
    for (int q = 0; q < TP / 2; ++q) {
      const float pre = rnd<MB>(rnd<MB>(acc[q]) + sm[OFF_B1 + n]);
      sm[OFF_H1 + (half * (TP / 2) + q) * FC + n] = fmaxf(pre, 0.0f);
    }
  }
  __syncthreads();
  // phase D: h2 = relu(M(h1 @ w2) + b2)
  {
    float acc[TP / 2];
#pragma unroll
    for (int q = 0; q < TP / 2; ++q) acc[q] = 0.0f;
    for (int m = 0; m < FC; ++m) {
      const float w = sm[OFF_W2 + m * WS + n];
#pragma unroll
      for (int q = 0; q < TP / 2; ++q) acc[q] += sm[OFF_H1 + (half * (TP / 2) + q) * FC + m] * w;
    }
#pragma unroll
    for (int q = 0; q < TP / 2; ++q) {
      const float pre = rnd<MB>(rnd<MB>(acc[q]) + sm[OFF_B2 + n]);
      sm[OFF_H2 + (half * (TP / 2) + q) * FC + n] = fmaxf(pre, 0.0f);
    }
  }
  __syncthreads();
  // phase E: rgb = sigmoid(h2 @ w3[:128] + M(vd) @ w3[128:] + b3), f32
  if (tid < TP * 3) {
    const int pl = tid / 3, o = tid % 3;
    const int64_t p = p0 + pl;
    float a = 0.0f;
    for (int m = 0; m < FC; ++m) a += sm[OFF_H2 + pl * FC + m] * sm[OFF_W3 + m * 3 + o];
    float b = 0.0f;
    if (p < in.p_total) {
#pragma unroll
      for (int v = 0; v < 3; ++v) b += rnd<MB>(in.vd[p * 3 + v]) * sm[OFF_W3 + (FC + v) * 3 + o];
    }
    const float pre3 = (a + b) + sm[OFF_B3 + o];
    sm[OFF_RGB + pl * 4 + o] = 1.0f / (1.0f + expf(-pre3));
  }
  __syncthreads();
}

template <typename T, bool MB>
__global__ void __launch_bounds__(kThreads, 2)
    march_fwd_kernel(Inputs<T> in, float* __restrict__ out) {
  extern __shared__ float sm[];
  constexpr bool TB = std::is_same<T, __nv_bfloat16>::value;
  stage_weights<TB, MB>(sm, in.basis, in.w1, in.b1, in.w2, in.b2, in.w3, in.b3);
  __syncthreads();
  const int64_t n_tiles = (in.p_total + TP - 1) / TP;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t p0 = tile * TP;
    tile_forward<T, MB>(sm, in, p0);
    const int tid = threadIdx.x;
    if (tid < TP * 4) {
      const int pl = tid >> 2, c = tid & 3;
      const int64_t p = p0 + pl;
      if (p < in.p_total) out[p * 4 + c] = c == 0 ? sm[OFF_SIG + pl] : sm[OFF_RGB + pl * 4 + c - 1];
    }
    __syncthreads();
  }
}

// Backward kernel 1: recompute, MLP + basis VJP, d_app, parameter partials.
template <typename T, bool MB>
__global__ void __launch_bounds__(kThreads, 1)
    march_bwd_mlp_kernel(Inputs<T> in, const float* __restrict__ gout,
                         float* __restrict__ d_app, float* __restrict__ partials) {
  extern __shared__ float sm[];
  constexpr bool TB = std::is_same<T, __nv_bfloat16>::value;
  const int tid = threadIdx.x;
  stage_weights<TB, MB>(sm, in.basis, in.w1, in.b1, in.w2, in.b2, in.w3, in.b3);
  float* acc = sm + OFF_ACC;
  for (int e = tid; e < N_ACC; e += kThreads) acc[e] = 0.0f;
  __syncthreads();
  const int n = tid & (FC - 1), half = tid >> 7;
  const int64_t n_tiles = (in.p_total + TP - 1) / TP;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t p0 = tile * TP;
    tile_forward<T, MB>(sm, in, p0);

    // d_pre3 = g_rgb * rgb * (1 - rgb)
    if (tid < TP * 3) {
      const int pl = tid / 3, o = tid % 3;
      const int64_t p = p0 + pl;
      const float g = p < in.p_total ? gout[p * 4 + 1 + o] : 0.0f;
      const float rgb = sm[OFF_RGB + pl * 4 + o];
      const float d = g * rgb * (1.0f - rgb);
      sm[OFF_DP3 + pl * 4 + o] = d;
      sm[OFF_DP3M + pl * 4 + o] = rnd<MB>(d);
    }
    __syncthreads();

    // d_pre2 = (pre2 > 0) * M(d_pre3m @ w3h^T); dw3, db3
#pragma unroll
    for (int q = 0; q < TP / 2; ++q) {
      const int pl = half * (TP / 2) + q;
      float s = 0.0f;
#pragma unroll
      for (int o = 0; o < 3; ++o) s += sm[OFF_DP3M + pl * 4 + o] * sm[OFF_W3 + n * 3 + o];
      sm[OFF_DP2 + pl * FC + n] = sm[OFF_H2 + pl * FC + n] > 0.0f ? rnd<MB>(s) : 0.0f;
    }
    for (int e = tid; e < FC * 3; e += kThreads) {
      const int m = e / 3, o = e % 3;
      float s = 0.0f;
      for (int pl = 0; pl < TP; ++pl) s += sm[OFF_H2 + pl * FC + m] * sm[OFF_DP3M + pl * 4 + o];
      acc[A_W3 + e] += s;
    }
    if (tid < 9) {
      const int v = tid / 3, o = tid % 3;
      float s = 0.0f;
      for (int pl = 0; pl < TP; ++pl) {
        const int64_t p = p0 + pl;
        const float vdm = p < in.p_total ? rnd<MB>(in.vd[p * 3 + v]) : 0.0f;
        s += vdm * sm[OFF_DP3M + pl * 4 + o];
      }
      acc[A_W3 + FC * 3 + tid] += s;
    } else if (tid < 12) {
      const int o = tid - 9;
      float s = 0.0f;
      for (int pl = 0; pl < TP; ++pl) s += sm[OFF_DP3 + pl * 4 + o];
      acc[A_B3 + o] += s;
    }
    __syncthreads();

    // d_pre1 = (pre1 > 0) * M(d_pre2 @ w2^T); dw2, db2
    {
      float a[TP / 2];
#pragma unroll
      for (int q = 0; q < TP / 2; ++q) a[q] = 0.0f;
      for (int k = 0; k < FC; ++k) {
        const float w = sm[OFF_W2 + n * WS + k];
#pragma unroll
        for (int q = 0; q < TP / 2; ++q) a[q] += sm[OFF_DP2 + (half * (TP / 2) + q) * FC + k] * w;
      }
#pragma unroll
      for (int q = 0; q < TP / 2; ++q) {
        const int pl = half * (TP / 2) + q;
        sm[OFF_DP1 + pl * FC + n] = sm[OFF_H1 + pl * FC + n] > 0.0f ? rnd<MB>(a[q]) : 0.0f;
      }
    }
    for (int e = tid; e < FC * FC; e += kThreads) {
      const int m = e >> 7, k = e & 127;
      float s = 0.0f;
      for (int pl = 0; pl < TP; ++pl) s += sm[OFF_H1 + pl * FC + m] * sm[OFF_DP2 + pl * FC + k];
      acc[A_W2 + e] += s;
    }
    if (tid < FC) {
      float s = 0.0f;
      for (int pl = 0; pl < TP; ++pl) s += sm[OFF_DP2 + pl * FC + tid];
      acc[A_B2 + tid] += s;
    }
    __syncthreads();

    // d_app = d_pre1 @ w1^T (f32, written out; rounded to T here); dw1, db1
    for (int e = tid; e < TP * APP; e += kThreads) {
      const int pl = e / APP, k = e % APP;
      float s = 0.0f;
      for (int m = 0; m < FC; ++m) s += sm[OFF_DP1 + pl * FC + m] * sm[OFF_W1 + k * WS + m];
      const int64_t p = p0 + pl;
      if (p < in.p_total) d_app[p * APP + k] = s;
      sm[OFF_DAPPT + pl * APP + k] = rnd<TB>(s);
    }
    for (int e = tid; e < APP * FC; e += kThreads) {
      const int k = e >> 7, m = e & 127;
      float s = 0.0f;
      for (int pl = 0; pl < TP; ++pl) s += sm[OFF_X0M + pl * APP + k] * sm[OFF_DP1 + pl * FC + m];
      acc[A_W1 + e] += s;
    }
    if (tid < FC) {
      float s = 0.0f;
      for (int pl = 0; pl < TP; ++pl) s += sm[OFF_DP1 + pl * FC + tid];
      acc[A_B1 + tid] += s;
    }
    __syncthreads();

    // dbasis += feats^T @ T(d_app)
    for (int e = tid; e < NB * APP; e += kThreads) {
      const int j = e / APP, k = e % APP;
      float s = 0.0f;
      for (int pl = 0; pl < TP; ++pl) s += sm[OFF_FEAT + pl * NB + j] * sm[OFF_DAPPT + pl * APP + k];
      acc[A_BASIS + e] += s;
    }
    __syncthreads();
  }
  float* part = partials + static_cast<int64_t>(blockIdx.x) * N_ACC;
  for (int e = tid; e < N_ACC; e += kThreads) part[e] = acc[e];
}

// Backward kernel 2: per point and orientation, the factor backward.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    march_bwd_factor_kernel(Inputs<T> in, const float* __restrict__ gout,
                            const float* __restrict__ d_app, T* __restrict__ drows0,
                            T* __restrict__ drows1, T* __restrict__ drows2,
                            float* __restrict__ d_wxy, float* __restrict__ d_w1l,
                            float* __restrict__ dlines) {
  constexpr bool TB = std::is_same<T, __nv_bfloat16>::value;
  __shared__ float basis_s[NB * APP];
  const int tid = threadIdx.x, lane = tid & 31;
  for (int e = tid; e < NB * APP; e += kThreads) basis_s[e] = rnd<TB>(in.basis[e]);
  __syncthreads();
  T* drows[3] = {drows0, drows1, drows2};
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (tid >> 5);
  const int64_t p_begin = gw * kPtsPerWarp;
  const int64_t p_end =
      (p_begin + kPtsPerWarp < in.p_total) ? p_begin + kPtsPerWarp : in.p_total;
  // a run of equal line rows per orientation, summed in registers
  int run_x[3] = {-1, -1, -1};
  float run0[3] = {0.0f, 0.0f, 0.0f}, run1[3] = {0.0f, 0.0f, 0.0f};
  const int jj = lane >= CD ? lane - CD : 0;
  for (int64_t p = p_begin; p < p_end; ++p) {
    const float dk = lane < APP ? rnd<TB>(d_app[p * APP + lane]) : 0.0f;
    const float gs = rnd<TB>(gout[p * 4]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const T* r = in.rows[i] + p * (4 * C);
      const float wx = rnd<TB>(in.wxy[p * 6 + 2 * i]);
      const float wy = rnd<TB>(in.wxy[p * 6 + 2 * i + 1]);
      const float wl = rnd<TB>(in.w1l[p * 3 + i]);
      const float omwx = rnd<TB>(1.0f - wx), omwy = rnd<TB>(1.0f - wy);
      const float omwl = rnd<TB>(1.0f - wl);
      const float v00 = ld(r + lane), v01 = ld(r + C + lane);
      const float v10 = ld(r + 2 * C + lane), v11 = ld(r + 3 * C + lane);
      const float top = rnd<TB>(rnd<TB>(v00 * omwx) + rnd<TB>(v01 * wx));
      const float bot = rnd<TB>(rnd<TB>(v10 * omwx) + rnd<TB>(v11 * wx));
      const float f = rnd<TB>(rnd<TB>(top * omwy) + rnd<TB>(bot * wy));
      const int xi = in.x0[p * 3 + i];
      const T* lrow = in.lines + (static_cast<int64_t>(i) * in.g + xi) * (2 * C);
      const float lr0 = ld(lrow + lane), lr1 = ld(lrow + C + lane);
      const float l = rnd<TB>(rnd<TB>(lr0 * omwl) + rnd<TB>(lr1 * wl));

      // d_feat = T(T(d_app) @ basis_i^T); lanes < 8 carry T(d_sigma)
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < APP; ++k) {
        s += __shfl_sync(0xffffffffu, dk, k) * basis_s[(i * CA + jj) * APP + k];
      }
      const float dprod = lane < CD ? gs : rnd<TB>(s);
      const float d_f = rnd<TB>(dprod * l), d_l = rnd<TB>(dprod * f);

      // line lerp backward
      const float dlr0 = rnd<TB>(d_l * omwl), dlr1 = rnd<TB>(d_l * wl);
      if (xi != run_x[i]) {
        if (run_x[i] >= 0) {
          float* dst = dlines + (static_cast<int64_t>(i) * in.g + run_x[i]) * (2 * C);
          atomicAdd(dst + lane, run0[i]);
          atomicAdd(dst + C + lane, run1[i]);
        }
        run_x[i] = xi;
        run0[i] = 0.0f;
        run1[i] = 0.0f;
      }
      run0[i] += dlr0;
      run1[i] += dlr1;
      const float dw1l = warp_sum(rnd<TB>(d_l * rnd<TB>(lr1 - lr0)));

      // plane bilerp backward
      const float d_top = rnd<TB>(d_f * omwy), d_bot = rnd<TB>(d_f * wy);
      T* dr = drows[i] + p * (4 * C);
      st(dr + lane, d_top * omwx);
      st(dr + C + lane, d_top * wx);
      st(dr + 2 * C + lane, d_bot * omwx);
      st(dr + 3 * C + lane, d_bot * wx);
      const float dwx = warp_sum(
          rnd<TB>(rnd<TB>(d_top * rnd<TB>(v01 - v00)) + rnd<TB>(d_bot * rnd<TB>(v11 - v10))));
      const float dwy = warp_sum(rnd<TB>(d_f * rnd<TB>(bot - top)));
      if (lane == 0) {
        d_wxy[p * 6 + 2 * i] = rnd<TB>(dwx);
        d_wxy[p * 6 + 2 * i + 1] = rnd<TB>(dwy);
        d_w1l[p * 3 + i] = rnd<TB>(dw1l);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (run_x[i] >= 0) {
      float* dst = dlines + (static_cast<int64_t>(i) * in.g + run_x[i]) * (2 * C);
      atomicAdd(dst + lane, run0[i]);
      atomicAdd(dst + C + lane, run1[i]);
    }
  }
}

// dparams[e] = sum over blocks of partials[b][e], in block order.
__global__ void march_reduce_kernel(const float* __restrict__ partials, int n_blocks,
                                    float* __restrict__ dparams) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N_ACC) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += partials[static_cast<int64_t>(b) * N_ACC + e];
  dparams[e] = s;
}

template <typename T>
Inputs<T> make_inputs(const void* rows0, const void* rows1, const void* rows2, const void* wxy,
                      const void* w1l, const void* x0, const void* vd, const void* lines,
                      const void* basis, const void* w1, const void* b1, const void* w2,
                      const void* b2, const void* w3, const void* b3, int64_t p, int g) {
  Inputs<T> in;
  in.rows[0] = static_cast<const T*>(rows0);
  in.rows[1] = static_cast<const T*>(rows1);
  in.rows[2] = static_cast<const T*>(rows2);
  in.wxy = static_cast<const float*>(wxy);
  in.w1l = static_cast<const float*>(w1l);
  in.x0 = static_cast<const int*>(x0);
  in.vd = static_cast<const float*>(vd);
  in.lines = static_cast<const T*>(lines);
  in.basis = static_cast<const float*>(basis);
  in.w1 = static_cast<const float*>(w1);
  in.b1 = static_cast<const float*>(b1);
  in.w2 = static_cast<const float*>(w2);
  in.b2 = static_cast<const float*>(b2);
  in.w3 = static_cast<const float*>(w3);
  in.b3 = static_cast<const float*>(b3);
  in.p_total = p;
  in.g = g;
  return in;
}

int grid_for(int64_t p, int n_blocks) {
  const int64_t n_tiles = (p + TP - 1) / TP;
  return static_cast<int>(n_tiles < n_blocks ? n_tiles : n_blocks);
}

template <typename T, bool MB>
cudaError_t fwd(const Inputs<T>& in, float* out, int n_blocks, cudaStream_t s) {
  const size_t smem = N_FWD * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(march_fwd_kernel<T, MB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  march_fwd_kernel<T, MB><<<grid_for(in.p_total, n_blocks), kThreads, smem, s>>>(in, out);
  return cudaGetLastError();
}

template <typename T, bool MB>
cudaError_t bwd(const Inputs<T>& in, const float* gout, void* drows0, void* drows1,
                void* drows2, float* d_wxy, float* d_w1l, float* dlines, float* d_app,
                float* partials, float* dparams, int n_blocks, cudaStream_t s) {
  const size_t smem = N_BWD * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(march_bwd_mlp_kernel<T, MB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = grid_for(in.p_total, n_blocks);
  march_bwd_mlp_kernel<T, MB><<<grid, kThreads, smem, s>>>(in, gout, d_app, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t pts_per_block = static_cast<int64_t>(kPtsPerWarp) * (kThreads / 32);
  const unsigned fblocks = static_cast<unsigned>((in.p_total + pts_per_block - 1) / pts_per_block);
  march_bwd_factor_kernel<T><<<fblocks, kThreads, 0, s>>>(
      in, gout, d_app, static_cast<T*>(drows0), static_cast<T*>(drows1),
      static_cast<T*>(drows2), d_wxy, d_w1l, dlines);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  march_reduce_kernel<<<(N_ACC + 255) / 256, 256, 0, s>>>(partials, grid, dparams);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lrf_march_n_params() { return N_ACC; }

extern "C" int lrf_march_fwd(const void* rows0, const void* rows1, const void* rows2,
                             const void* wxy, const void* w1l, const void* x0, const void* vd,
                             const void* lines, const void* basis, const void* w1,
                             const void* b1, const void* w2, const void* b2, const void* w3,
                             const void* b3, void* out, int64_t p, int g, int t_bf16,
                             int m_bf16, int n_blocks, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  cudaError_t err;
  if (t_bf16) {
    const auto in = make_inputs<__nv_bfloat16>(rows0, rows1, rows2, wxy, w1l, x0, vd, lines,
                                               basis, w1, b1, w2, b2, w3, b3, p, g);
    err = m_bf16 ? fwd<__nv_bfloat16, true>(in, o, n_blocks, s)
                 : fwd<__nv_bfloat16, false>(in, o, n_blocks, s);
  } else {
    const auto in = make_inputs<float>(rows0, rows1, rows2, wxy, w1l, x0, vd, lines, basis, w1,
                                       b1, w2, b2, w3, b3, p, g);
    err = m_bf16 ? fwd<float, true>(in, o, n_blocks, s) : fwd<float, false>(in, o, n_blocks, s);
  }
  return static_cast<int>(err);
}

extern "C" int lrf_march_bwd(const void* rows0, const void* rows1, const void* rows2,
                             const void* wxy, const void* w1l, const void* x0, const void* vd,
                             const void* lines, const void* basis, const void* w1,
                             const void* b1, const void* w2, const void* b2, const void* w3,
                             const void* b3, const void* gout, void* drows0, void* drows1,
                             void* drows2, void* d_wxy, void* d_w1l, void* dlines, void* d_app,
                             void* partials, void* dparams, int64_t p, int g, int t_bf16,
                             int m_bf16, int n_blocks, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* go = static_cast<const float*>(gout);
  auto* dwxy = static_cast<float*>(d_wxy);
  auto* dw1l = static_cast<float*>(d_w1l);
  auto* dl = static_cast<float*>(dlines);
  auto* da = static_cast<float*>(d_app);
  auto* pa = static_cast<float*>(partials);
  auto* dp = static_cast<float*>(dparams);
  cudaError_t err;
  if (t_bf16) {
    const auto in = make_inputs<__nv_bfloat16>(rows0, rows1, rows2, wxy, w1l, x0, vd, lines,
                                               basis, w1, b1, w2, b2, w3, b3, p, g);
    err = m_bf16 ? bwd<__nv_bfloat16, true>(in, go, drows0, drows1, drows2, dwxy, dw1l, dl, da,
                                            pa, dp, n_blocks, s)
                 : bwd<__nv_bfloat16, false>(in, go, drows0, drows1, drows2, dwxy, dw1l, dl,
                                             da, pa, dp, n_blocks, s);
  } else {
    const auto in = make_inputs<float>(rows0, rows1, rows2, wxy, w1l, x0, vd, lines, basis, w1,
                                       b1, w2, b2, w3, b3, p, g);
    err = m_bf16 ? bwd<float, true>(in, go, drows0, drows1, drows2, dwxy, dw1l, dl, da, pa, dp,
                                    n_blocks, s)
                 : bwd<float, false>(in, go, drows0, drows1, drows2, dwxy, dw1l, dl, da, pa, dp,
                                     n_blocks, s);
  }
  return static_cast<int>(err);
}
