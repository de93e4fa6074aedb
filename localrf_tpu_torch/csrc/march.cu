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
// backward (recompute + VJP); the row and line bytes (3 x 348 MB of bf16
// rows) come second. The TPU kernel ran the MLP and the one-hot line
// lookup on the MXU with lines resident in VMEM. Here a line row is a
// direct indexed load (the [3, 640, 64] bf16 lines sit in L2).
//
// Two instantiations, chosen by dtype in the C entry points (no fallback
// between them):
// - bf16 tables and bf16 MLP (the training CLI's dtypes): the tensor-core
//   kernels `march_fwd_mma_kernel` and `march_bwd_mlp_mma_kernel`. Every
//   operand of the basis and MLP products is a bf16 value there (the
//   products, the rounded activations and cotangents, the weights rounded
//   as staged), and the product of two bf16 values is exact in f32, so
//   `mma.sync.m16n8k16` bf16 with f32 accumulation gives the CUDA-core sums
//   up to their order. Persistent blocks of 256 threads (one per SM) loop
//   over tiles of 64 points. The weights sit in shared memory as bf16 in
//   their natural row-major layout, rows padded so that `ldmatrix` is free
//   of bank conflicts (basis [96][40], w1 [32][136], w2 [128][136], the
//   padding zero); `ldmatrix.trans` reads the transposed operands (w2^T,
//   w1^T, and the activations of the weight gradients) from the same
//   copies. Eight warps split each product: a warp owns 16 rows by N/2
//   columns (the accumulator layout of a warpgroup's m64 `wgmma`, which
//   is not used here; PERF.md "PR 5" gives the phase spans of a tile).
//   While a tile's MLP runs, the next tile's rows and per-point inputs
//   arrive in shared memory by `cp.async` (zero-filled past P, so a ragged
//   tile needs no branch), then its line rows (the gather needs its x0),
//   so the features read only shared memory. The backward keeps dw2, dw1
//   and dbasis in registers across its tiles (dw2 as 16 rows of 128 per
//   warp) and dw3's hidden rows in shared memory, and writes them once.
// - any f32 table or MLP: the CUDA-core kernels `march_fwd_kernel` and
//   `march_bwd_mlp_kernel`: tiles of 16 points, the weights as f32 in
//   shared memory (row strides padded to 129), one warp per point for the
//   features and a thread per output column for the products.
// Both backward MLP kernels write d_feat = T(T(d_app) @ basis^T) [P, 72] in
// the table dtype (the appearance products' cotangent) and per-block
// parameter-gradient partials, each entry owned by one thread (no
// atomics), summed over blocks in a fixed order by `march_reduce_kernel`
// (deterministic; the TPU kernel carried these sums in its revisited
// output blocks over the sequential grid).
// Backward, factor kernel (both dtypes): a half warp per run of 16
// consecutive points, a lane per pair of channels, recomputes the lerps
// and produces d_rows, d(wx, wy, w1) and dlines from d_feat. dlines takes
// f32 global atomics (float2, Hopper's vector atomic add); consecutive
// samples of a ray often share a line row, so each half warp sums a run of
// equal rows in registers and adds once per run (about 2,100 samples land
// on each of the 640 rows at 640^3).
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
constexpr int kPtsPerHalf = 16;  // points a half warp walks in the factor kernel

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

// Backward kernel 1: recompute, MLP + basis VJP, d_feat, parameter partials.
template <typename T, bool MB>
__global__ void __launch_bounds__(kThreads, 1)
    march_bwd_mlp_kernel(Inputs<T> in, const float* __restrict__ gout,
                         T* __restrict__ d_feat, float* __restrict__ partials) {
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

    // d_app = d_pre1 @ w1^T (f32), rounded to T; dw1, db1
    for (int e = tid; e < TP * APP; e += kThreads) {
      const int pl = e / APP, k = e % APP;
      float s = 0.0f;
      for (int m = 0; m < FC; ++m) s += sm[OFF_DP1 + pl * FC + m] * sm[OFF_W1 + k * WS + m];
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
    // d_feat = T(T(d_app) @ basis^T), written out for the factor kernel
    for (int e = tid; e < TP * NB; e += kThreads) {
      const int pl = e / NB, j = e % NB;
      const int64_t p = p0 + pl;
      float s = 0.0f;
      for (int k = 0; k < APP; ++k) s += sm[OFF_DAPPT + pl * APP + k] * sm[OFF_BASIS + j * APP + k];
      if (p < in.p_total) st(d_feat + p * NB + j, s);
    }
    __syncthreads();
  }
  float* part = partials + static_cast<int64_t>(blockIdx.x) * N_ACC;
  for (int e = tid; e < N_ACC; e += kThreads) part[e] = acc[e];
}

// Two channels of T in packed arithmetic: bf16 pairs round once per op, which
// is the f32 op rounded to bf16 (see tile_features); f32 pairs are plain f32.
template <typename T>
struct Pair;

template <>
struct Pair<float> {
  using V = float2;
  __device__ static V splat(float x) { return make_float2(x, x); }
  __device__ static V mul(V a, V b) { return make_float2(a.x * b.x, a.y * b.y); }
  __device__ static V add(V a, V b) { return make_float2(a.x + b.x, a.y + b.y); }
  __device__ static V sub(V a, V b) { return make_float2(a.x - b.x, a.y - b.y); }
  __device__ static float2 f32(V a) { return a; }
};

template <>
struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  __device__ static V splat(float x) { return __float2bfloat162_rn(x); }
  __device__ static V mul(V a, V b) { return __hmul2_rn(a, b); }
  __device__ static V add(V a, V b) { return __hadd2_rn(a, b); }
  __device__ static V sub(V a, V b) { return __hsub2_rn(a, b); }
  __device__ static float2 f32(V a) { return __bfloat1622float2(a); }
};

// sum over the 16 lanes of a half warp (every lane of the warp calls it)
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Backward kernel 2: per point and orientation, the factor backward. A half
// warp walks a run of kPtsPerHalf consecutive points, a lane per pair of
// channels (4-byte loads and stores of bf16 rows; the line gradient's run
// sums added as float2, Hopper's vector atomic).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    march_bwd_factor_kernel(Inputs<T> in, const float* __restrict__ gout,
                            const T* __restrict__ d_feat, T* __restrict__ drows0,
                            T* __restrict__ drows1, T* __restrict__ drows2,
                            float* __restrict__ d_wxy, float* __restrict__ d_w1l,
                            float* __restrict__ dlines) {
  using P2 = Pair<T>;
  using V = typename P2::V;
  constexpr bool TB = std::is_same<T, __nv_bfloat16>::value;
  const int cp = threadIdx.x & 15;  // channels 2 cp, 2 cp + 1
  T* drows[3] = {drows0, drows1, drows2};
  const int64_t p_begin =
      ((static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 4) * kPtsPerHalf;
  auto ld2 = [](const T* q) { return *reinterpret_cast<const V*>(q); };
  auto st2v = [](T* q, V v) { *reinterpret_cast<V*>(q) = v; };
  // a run of equal line rows per orientation, summed in registers
  int run_x[3] = {-1, -1, -1};
  float2 run0[3], run1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) run0[i] = run1[i] = make_float2(0.0f, 0.0f);
  auto flush = [&](int i) {
    float* dst = dlines + (static_cast<int64_t>(i) * in.g + run_x[i]) * (2 * C) + 2 * cp;
    atomicAdd(reinterpret_cast<float2*>(dst), run0[i]);
    atomicAdd(reinterpret_cast<float2*>(dst + C), run1[i]);
  };
  const V one = P2::splat(1.0f);
  // a fixed trip count, so both halves of a warp reach every shuffle
  for (int k = 0; k < kPtsPerHalf; ++k) {
    const int64_t p = p_begin + k;
    const bool valid = p < in.p_total;
    const int64_t pc = valid ? p : 0;
    const V gs = P2::splat(gout[pc * 4]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const T* r = in.rows[i] + pc * (4 * C) + 2 * cp;
      const V wx = P2::splat(in.wxy[pc * 6 + 2 * i]);
      const V wy = P2::splat(in.wxy[pc * 6 + 2 * i + 1]);
      const V wl = P2::splat(in.w1l[pc * 3 + i]);
      const V omwx = P2::sub(one, wx), omwy = P2::sub(one, wy), omwl = P2::sub(one, wl);
      const V v00 = ld2(r), v01 = ld2(r + C), v10 = ld2(r + 2 * C), v11 = ld2(r + 3 * C);
      const V top = P2::add(P2::mul(v00, omwx), P2::mul(v01, wx));
      const V bot = P2::add(P2::mul(v10, omwx), P2::mul(v11, wx));
      const V f = P2::add(P2::mul(top, omwy), P2::mul(bot, wy));
      const int xi = in.x0[pc * 3 + i];
      const T* lrow = in.lines + (static_cast<int64_t>(i) * in.g + xi) * (2 * C) + 2 * cp;
      const V lr0 = ld2(lrow), lr1 = ld2(lrow + C);
      const V l = P2::add(P2::mul(lr0, omwl), P2::mul(lr1, wl));

      // channels < 8 carry T(d_sigma), the others d_feat
      const V dprod = cp < CD / 2 ? gs : ld2(d_feat + pc * NB + i * CA + 2 * cp - CD);
      const V d_f = P2::mul(dprod, l), d_l = P2::mul(dprod, f);

      // line lerp backward
      const float2 dlr0 = P2::f32(P2::mul(d_l, omwl)), dlr1 = P2::f32(P2::mul(d_l, wl));
      if (valid) {
        if (xi != run_x[i]) {
          if (run_x[i] >= 0) flush(i);
          run_x[i] = xi;
          run0[i] = run1[i] = make_float2(0.0f, 0.0f);
        }
        run0[i].x += dlr0.x;
        run0[i].y += dlr0.y;
        run1[i].x += dlr1.x;
        run1[i].y += dlr1.y;
      }
      const float2 t1 = P2::f32(P2::mul(d_l, P2::sub(lr1, lr0)));
      const float dw1l = half_sum(t1.x + t1.y);

      // plane bilerp backward
      const V d_top = P2::mul(d_f, omwy), d_bot = P2::mul(d_f, wy);
      if (valid) {
        T* dr = drows[i] + p * (4 * C) + 2 * cp;
        st2v(dr, P2::mul(d_top, omwx));
        st2v(dr + C, P2::mul(d_top, wx));
        st2v(dr + 2 * C, P2::mul(d_bot, omwx));
        st2v(dr + 3 * C, P2::mul(d_bot, wx));
      }
      const float2 tx = P2::f32(P2::add(P2::mul(d_top, P2::sub(v01, v00)),
                                        P2::mul(d_bot, P2::sub(v11, v10))));
      const float2 ty = P2::f32(P2::mul(d_f, P2::sub(bot, top)));
      const float dwx = half_sum(tx.x + tx.y), dwy = half_sum(ty.x + ty.y);
      if (cp == 0 && valid) {
        d_wxy[p * 6 + 2 * i] = rnd<TB>(dwx);
        d_wxy[p * 6 + 2 * i + 1] = rnd<TB>(dwy);
        d_w1l[p * 3 + i] = rnd<TB>(dw1l);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (run_x[i] >= 0) flush(i);
  }
}

// ---------------------------------------------------------------------------
// The tensor-core instantiation: bf16 tables and bf16 MLP.

using bf16 = __nv_bfloat16;
constexpr int TPM = 64;   // points per tile
constexpr int NBP = 80;   // basis rows (72) padded to the k16 step of feats @ basis
constexpr int NBN = 96;   // and to 12 n8 chunks of d_app @ basis^T
// bf16 row strides: a multiple of 16 bytes whose count of 16-byte pieces is
// odd, so the 8 rows an ldmatrix phase reads fall in 8 distinct bank groups
constexpr int LDB = 40;   // [.][32] arrays
constexpr int LDF = 88;   // [.][80]
constexpr int LDH = 136;  // [.][128]

constexpr int align128(int b) { return (b + 127) / 128 * 128; }
// shared memory, in bytes; everything not written below stays zero
constexpr int S_BASIS = 0;                                   // bf16 [96][LDB] basis (T)
constexpr int S_W1 = align128(S_BASIS + NBN * LDB * 2);      // bf16 [32][LDH] w1 (M)
constexpr int S_W2 = align128(S_W1 + 32 * LDH * 2);          // bf16 [128][LDH] w2 (M)
constexpr int S_VEC = align128(S_W2 + FC * LDH * 2);         // f32, V_* below
constexpr int V_B1 = 0, V_B2 = FC, V_W3 = 2 * FC, V_B3 = V_W3 + (FC + 3) * 3;
constexpr int N_VEC = V_B3 + 3;
constexpr int S_FEAT = align128(S_VEC + N_VEC * 4);          // bf16 [64][LDF] products (T)
constexpr int S_X0M = align128(S_FEAT + TPM * LDF * 2);      // bf16 [64][LDB] app rounded to M
constexpr int S_H1 = align128(S_X0M + TPM * LDB * 2);        // bf16 [64][LDH] h1
constexpr int S_H2 = align128(S_H1 + TPM * LDH * 2);         // bf16 [64][LDH] h2, then d_pre1
constexpr int S_PT = align128(S_H2 + TPM * LDH * 2);         // f32 per point, P_* below
constexpr int P_SIG = 0, P_RGB = TPM, P_VDM = P_RGB + TPM * 4, P_GR = P_VDM + TPM * 3;
constexpr int P_DP3 = P_GR + TPM * 3, P_DP3M = P_DP3 + TPM * 4, P_PRE3 = P_DP3M + TPM * 4;
constexpr int N_PT = P_PRE3 + 2 * TPM * 3;                   // pre3 partials [2 halves][64][3]
constexpr int S_ROWS = align128(S_PT + N_PT * 4);            // bf16 [3][64][128] (cp.async)
constexpr int S_IN = align128(S_ROWS + 3 * TPM * 4 * C * 2); // 32-bit inputs, I_* (cp.async)
constexpr int I_WXY = 0, I_W1L = TPM * 6, I_X0 = I_W1L + TPM * 3, I_VD = I_X0 + TPM * 3;
constexpr int I_GO = I_VD + TPM * 3, N_IN = I_GO + TPM * 4;
constexpr int S_LINES = align128(S_IN + N_IN * 4);          // bf16 [3][64][64] (cp.async)
constexpr int SMEM_FWD = align128(S_LINES + 3 * TPM * 2 * C * 2);
constexpr int S_DP2 = SMEM_FWD;                              // bf16 [64][LDH] d_pre2
constexpr int S_DAPP = align128(S_DP2 + TPM * LDH * 2);      // bf16 [64][LDB] d_app (T)
constexpr int S_DP3M = align128(S_DAPP + TPM * LDB * 2);     // bf16 [64][LDB] d_pre3m, columns 3.. zero
constexpr int S_DW3 = align128(S_DP3M + TPM * LDB * 2);      // f32 [128][3] the block's dw3[:128]
constexpr int SMEM_BWD = align128(S_DW3 + FC * 3 * 4);
static_assert(SMEM_BWD <= 232448, "tensor-core backward exceeds one block's 227 KB");
// the 12 partials after dw3[:128]: w3's view-direction rows, then b3
static_assert(A_B3 == A_W3 + (FC + 3) * 3, "w3 | b3 layout");

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p)));
}

// d += a @ b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 (4) bytes global -> shared, zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float bf(const bf16* p) { return __bfloat162float(*p); }

// Phases of a tensor-core tile, for the spans of a build with
// -DLRF_MARCH_PHASES (scripts/march_phases.py): thread 0 of each block adds
// the clock64() ticks since the last mark to g_phase_cycles[block][phase].
// A mark that follows a block barrier closes the block's span since the
// barrier before; SETUP, TAIL, FETCH and END are thread 0's own time
// (TAIL: its warp's share of the previous tile's last, barrier-free part;
// FETCH: its share of issuing the next tile's copies). Without the macro a
// mark is nothing.
enum Phase {
  PH_SETUP, PH_TAIL, PH_WAIT, PH_FEAT, PH_FETCH, PH_APP, PH_H1, PH_H2, PH_RGB,
  PH_DP3, PH_DP2, PH_DP1, PH_DAPP, PH_END, N_PHASES
};
#ifdef LRF_MARCH_PHASES
constexpr int kPhaseBlocks = 1024;
__device__ long long g_phase_cycles[kPhaseBlocks][N_PHASES];
__shared__ long long s_phase_t;
__device__ __forceinline__ void mark(int phase) {
  if (threadIdx.x == 0 && blockIdx.x < kPhaseBlocks) {
    const long long t = clock64();
    if (phase >= 0) g_phase_cycles[blockIdx.x][phase] += t - s_phase_t;
    s_phase_t = t;
  }
}
#else
__device__ __forceinline__ void mark(int) {}
#endif

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[NC][4]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[c][j] = 0.0f;
  }
}

// One warp: acc[c] += A[m0 : m0 + 16, :16 KS] @ B[:16 KS, n0 + 8c : n0 + 8c + 8], c < NC.
// A is a[m * lda + k], or with AT a[k * lda + m] (stored transposed);
// B is b[n * ldb + k], or with BN b[k * ldb + n] (stored [K][N]).
// acc[c] holds rows m0 + lane / 4 (entries 0, 1) and m0 + 8 + lane / 4
// (2, 3) at columns n0 + 8c + 2 (lane % 4) + {0, 1}.
template <int NC, int KS, bool AT, bool BN>
__device__ __forceinline__ void warp_mma(float (&acc)[NC][4], const bf16* a, int lda, int m0,
                                         const bf16* b, int ldb, int n0) {
  static_assert(NC % 2 == 0, "B fragments come in pairs of n8 chunks");
  const int lane = threadIdx.x & 31, i8 = lane & 7, mat = lane >> 3;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int k = ks * 16;
    uint32_t af[4];
    if constexpr (AT) {
      ldsm4t(af, a + (k + i8 + (mat >> 1) * 8) * lda + m0 + (mat & 1) * 8);
    } else {
      ldsm4(af, a + (m0 + (lane & 15)) * lda + k + (lane >> 4) * 8);
    }
#pragma unroll
    for (int c = 0; c < NC; c += 2) {
      const int n = n0 + c * 8;
      uint32_t bfr[4];
      if constexpr (BN) {
        ldsm4t(bfr, b + (k + i8 + (mat & 1) * 8) * ldb + n + (mat >> 1) * 8);
      } else {
        ldsm4(bfr, b + (n + i8 + (mat >> 1) * 8) * ldb + k + (mat & 1) * 8);
      }
      mma16816(acc[c], af, bfr[0], bfr[1]);
      mma16816(acc[c + 1], af, bfr[2], bfr[3]);
    }
  }
}

struct Smem {
  unsigned char* base;
  __device__ bf16* h(int off) const { return reinterpret_cast<bf16*>(base + off); }
  __device__ float* f(int off) const { return reinterpret_cast<float*>(base + off); }
};

// Start the copies of tile `tile`'s rows and per-point inputs into S_ROWS
// and S_IN (gout only when given), zero-filled past P, as one group.
__device__ void fetch_tile(const Smem& s, const Inputs<bf16>& in, const float* gout, int64_t tile) {
  const int tid = threadIdx.x;
  const int64_t p0 = tile * TPM;
  bf16* rows = s.h(S_ROWS);
  for (int c = tid; c < 3 * TPM * 16; c += kThreads) {  // 16 pieces of 16 bytes a row
    const int i = c / (TPM * 16), pl = (c >> 4) % TPM, part = c & 15;
    const bool ok = p0 + pl < in.p_total;
    const bf16* src = ok ? in.rows[i] + (p0 + pl) * (4 * C) + part * 8 : in.rows[i];
    cp16(rows + (i * TPM + pl) * (4 * C) + part * 8, src, ok);
  }
  float* w = s.f(S_IN);
  auto copy = [&](int off, const void* base, int width) {
    const int64_t first = p0 * width, total = in.p_total * width;
    for (int e = tid; e < TPM * width; e += kThreads) {
      const bool ok = first + e < total;
      cp4(w + off + e, static_cast<const float*>(base) + (ok ? first + e : 0), ok);
    }
  };
  copy(I_WXY, in.wxy, 6);
  copy(I_W1L, in.w1l, 3);
  copy(I_X0, in.x0, 3);
  copy(I_VD, in.vd, 3);
  if (gout != nullptr) copy(I_GO, gout, 4);
  asm volatile("cp.async.commit_group;\n" ::);
}

// Start the copies of the line rows of the tile whose x0 is in S_IN into
// S_LINES, as one group (S_IN's zeros past P pick row 0).
__device__ void fetch_lines(const Smem& s, const Inputs<bf16>& in) {
  const int* x0 = reinterpret_cast<const int*>(s.f(S_IN) + I_X0);
  bf16* lines = s.h(S_LINES);
  for (int c = threadIdx.x; c < 3 * TPM * 8; c += kThreads) {  // 8 pieces of 16 bytes a row
    const int i = c / (TPM * 8), pl = (c >> 3) % TPM, part = c & 7;
    const bf16* src = in.lines + (static_cast<int64_t>(i) * in.g + x0[pl * 3 + i]) * (2 * C);
    cp16(lines + (i * TPM + pl) * (2 * C) + part * 8, src + part * 8, true);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Zero the block's shared memory, fetch its first tile (rows and inputs,
// then its line rows), stage the weights (rounded as the CUDA-core kernels
// round them; padding stays zero).
__device__ void mma_setup(const Smem& s, int n_bytes, const Inputs<bf16>& in, const float* gout) {
  const int tid = threadIdx.x;
  for (int e = tid; e < n_bytes / 16; e += kThreads) {
    reinterpret_cast<uint4*>(s.base)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  fetch_tile(s, in, gout, blockIdx.x);
  bf16 *basis = s.h(S_BASIS), *w1 = s.h(S_W1), *w2 = s.h(S_W2);
  float* vec = s.f(S_VEC);
  for (int e = tid; e < NB * APP; e += kThreads) {
    basis[(e / APP) * LDB + e % APP] = __float2bfloat16(in.basis[e]);
  }
  for (int e = tid; e < APP * FC; e += kThreads) w1[(e >> 7) * LDH + (e & 127)] = __float2bfloat16(in.w1[e]);
  for (int e = tid; e < FC * FC; e += kThreads) w2[(e >> 7) * LDH + (e & 127)] = __float2bfloat16(in.w2[e]);
  for (int e = tid; e < FC; e += kThreads) {
    vec[V_B1 + e] = rnd<true>(in.b1[e]);
    vec[V_B2 + e] = rnd<true>(in.b2[e]);
  }
  for (int e = tid; e < (FC + 3) * 3; e += kThreads) vec[V_W3 + e] = rnd<true>(in.w3[e]);
  if (tid < 3) vec[V_B3 + tid] = in.b3[tid];
  cp_wait_all();
  __syncthreads();
  fetch_lines(s, in);
}

// Phase A of one tile from the fetched inputs: the products into S_FEAT,
// sigma, M(vd) and (backward) the rgb cotangent into S_PT. A half warp per
// point, a lane per pair of channels in packed bf16 arithmetic: the sum,
// difference or product of two bf16 values rounded once to bf16 equals the
// f32 op rounded to bf16 (a product is exact in f32; a sum is exact unless
// the smaller term lies below the larger's half ulp, where both give the
// larger), so these are the CUDA-core kernels' rnd<T> chains bit for bit.
// The _rn intrinsics keep each op rounded: the plain ones may be
// contracted into an fma, which rounds a product and a sum once.
// Points past P read zeros and give zeros.
__device__ void tile_features(const Smem& s) {
  using bf2 = __nv_bfloat162;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cp = lane & 15;  // channels 2 cp, 2 cp + 1
  const bf2* rows = reinterpret_cast<const bf2*>(s.h(S_ROWS));
  const bf2* lines = reinterpret_cast<const bf2*>(s.h(S_LINES));
  const float* w = s.f(S_IN);
  bf16* feat = s.h(S_FEAT);
  float* pt = s.f(S_PT);
  const bf2 one = __float2bfloat162_rn(1.0f);
  for (int pl = 2 * warp + (lane >> 4); pl < TPM; pl += kThreads / 16) {
    float sigma = 0.0f;  // lanes cp < 4: their density products over the orientations
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const bf2* r = rows + (i * TPM + pl) * (2 * C);  // corners at 0, 16, 32, 48
      const bf2* lr = lines + (i * TPM + pl) * C;      // the pair at 0, 16
      const bf2 wx = __float2bfloat162_rn(w[I_WXY + pl * 6 + 2 * i]);
      const bf2 wy = __float2bfloat162_rn(w[I_WXY + pl * 6 + 2 * i + 1]);
      const bf2 wl = __float2bfloat162_rn(w[I_W1L + pl * 3 + i]);
      const bf2 omwx = __hsub2_rn(one, wx), omwy = __hsub2_rn(one, wy), omwl = __hsub2_rn(one, wl);
      const bf2 top = __hadd2_rn(__hmul2_rn(r[cp], omwx), __hmul2_rn(r[C / 2 + cp], wx));
      const bf2 bot = __hadd2_rn(__hmul2_rn(r[C + cp], omwx), __hmul2_rn(r[3 * C / 2 + cp], wx));
      const bf2 f = __hadd2_rn(__hmul2_rn(top, omwy), __hmul2_rn(bot, wy));
      const bf2 l = __hadd2_rn(__hmul2_rn(lr[cp], omwl), __hmul2_rn(lr[C / 2 + cp], wl));
      const bf2 prod = __hmul2_rn(f, l);
      if (cp < CD / 2) {
        sigma += __low2float(prod) + __high2float(prod);
      } else {
        *reinterpret_cast<bf2*>(feat + pl * LDF + i * CA + 2 * cp - CD) = prod;
      }
    }
    sigma += __shfl_xor_sync(0xffffffffu, sigma, 1);
    sigma += __shfl_xor_sync(0xffffffffu, sigma, 2);
    if (cp == 0) pt[P_SIG + pl] = sigma;
  }
  if (tid < TPM * 3) {
    pt[P_VDM + tid] = rnd<true>(w[I_VD + tid]);
    pt[P_GR + tid] = w[I_GO + (tid / 3) * 4 + 1 + tid % 3];
  }
}

// h = relu(M(M(acc) + bias)) into a [64][LDH] tile, as bf16. With w3, also
// this warp's part of h @ w3[:128] (its 64 columns; f32) into pre3 [64][3].
__device__ __forceinline__ void hidden_epilogue(const float (&acc)[8][4], const float* bias, bf16* h,
                                                int m0, int n0, const float* w3 = nullptr,
                                                float* pre3 = nullptr) {
  const int lane = threadIdx.x & 31, r = m0 + (lane >> 2);
  float part[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int n = n0 + c * 8 + 2 * (lane & 3);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float v0 = fmaxf(rnd<true>(rnd<true>(acc[c][2 * hr]) + bias[n]), 0.0f);
      const float v1 = fmaxf(rnd<true>(rnd<true>(acc[c][2 * hr + 1]) + bias[n + 1]), 0.0f);
      st2(h + (r + 8 * hr) * LDH + n, v0, v1);
      if (w3 != nullptr) {
#pragma unroll
        for (int o = 0; o < 3; ++o) part[hr][o] += v0 * w3[n * 3 + o] + v1 * w3[(n + 1) * 3 + o];
      }
    }
  }
  if (w3 != nullptr) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        float v = part[hr][o];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if ((lane & 3) == 0) pre3[(r + 8 * hr) * 3 + o] = v;
      }
    }
  }
}

// The MLP forward of the tile in S_FEAT: app (rounded to M), h1, h2, rgb.
// Each product on tensor cores, a warp owning rows 16 (warp % 4) and half
// the columns. With `next`, waits there for the next tile's rows and
// inputs and starts the copy of its line rows. Ends with a barrier.
__device__ void tile_mlp_forward(const Smem& s, const Inputs<bf16>& in, bool next) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mb = (warp & 3) * 16, nh = warp >> 2, r = mb + (lane >> 2);
  const float* vec = s.f(S_VEC);
  bf16 *x0m = s.h(S_X0M), *h1 = s.h(S_H1), *h2 = s.h(S_H2);
  float* pt = s.f(S_PT);
  {  // app = feats @ basis (f32 sums of T products), rounded to M
    float acc[2][4];
    zero(acc);
    warp_mma<2, NBP / 16, false, true>(acc, s.h(S_FEAT), LDF, mb, s.h(S_BASIS), LDB, nh * 16);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = nh * 16 + c * 8 + 2 * (lane & 3);
      st2(x0m + r * LDB + n, rnd<true>(acc[c][0]), rnd<true>(acc[c][1]));
      st2(x0m + (r + 8) * LDB + n, rnd<true>(acc[c][2]), rnd<true>(acc[c][3]));
    }
  }
  __syncthreads();
  mark(PH_APP);
  {  // h1 = relu(M(x0m @ w1) + b1)
    float acc[8][4];
    zero(acc);
    warp_mma<8, 2, false, true>(acc, x0m, LDB, mb, s.h(S_W1), LDH, nh * 64);
    hidden_epilogue(acc, vec + V_B1, h1, mb, nh * 64);
  }
  __syncthreads();
  mark(PH_H1);
  {  // h2 = relu(M(h1 @ w2) + b2), and the halves of h2 @ w3[:128]
    float acc[8][4];
    zero(acc);
    warp_mma<8, FC / 16, false, true>(acc, h1, LDH, mb, s.h(S_W2), LDH, nh * 64);
    hidden_epilogue(acc, vec + V_B2, h2, mb, nh * 64, vec + V_W3, pt + P_PRE3 + nh * TPM * 3);
  }
  if (next) cp_wait_all();
  __syncthreads();
  mark(PH_H2);
  if (next) fetch_lines(s, in);
  // rgb = sigmoid(h2 @ w3[:128] + M(vd) @ w3[128:] + b3), f32
  if (tid < TPM * 3) {
    const int pl = tid / 3, o = tid % 3;
    const float a = pt[P_PRE3 + tid] + pt[P_PRE3 + TPM * 3 + tid];
    float b = 0.0f;
#pragma unroll
    for (int v = 0; v < 3; ++v) b += pt[P_VDM + pl * 3 + v] * vec[V_W3 + (FC + v) * 3 + o];
    const float pre3 = (a + b) + vec[V_B3 + o];
    pt[P_RGB + pl * 4 + o] = 1.0f / (1.0f + expf(-pre3));
  }
  __syncthreads();
  mark(PH_RGB);
}

__global__ void __launch_bounds__(kThreads, 1)
    march_fwd_mma_kernel(Inputs<bf16> in, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem s{smem_raw};
  const int tid = threadIdx.x;
  mark(-1);
  mma_setup(s, SMEM_FWD, in, nullptr);
  mark(PH_SETUP);
  const float* pt = s.f(S_PT);
  const int64_t n_tiles = (in.p_total + TPM - 1) / TPM;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    mark(PH_TAIL);
    cp_wait_all();
    __syncthreads();
    mark(PH_WAIT);
    tile_features(s);
    __syncthreads();
    mark(PH_FEAT);
    const bool next = tile + gridDim.x < n_tiles;
    if (next) fetch_tile(s, in, nullptr, tile + gridDim.x);
    mark(PH_FETCH);
    tile_mlp_forward(s, in, next);
    const int pl = tid >> 2, c = tid & 3;
    const int64_t p = tile * TPM + pl;
    if (p < in.p_total) out[p * 4 + c] = c == 0 ? pt[P_SIG + pl] : pt[P_RGB + pl * 4 + c - 1];
  }
  mark(PH_END);
}

// Backward kernel 1, tensor cores: recompute, MLP + basis VJP, d_feat (T),
// parameter partials.
__global__ void __launch_bounds__(kThreads, 1)
    march_bwd_mlp_mma_kernel(Inputs<bf16> in, const float* __restrict__ gout,
                             bf16* __restrict__ d_feat, float* __restrict__ partials) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem s{smem_raw};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mb = (warp & 3) * 16, nh = warp >> 2, r = mb + (lane >> 2);
  mark(-1);
  mma_setup(s, SMEM_BWD, in, gout);
  mark(PH_SETUP);
  const float* vec = s.f(S_VEC);
  const bf16 *feat = s.h(S_FEAT), *x0m = s.h(S_X0M), *h1 = s.h(S_H1);
  bf16 *h2 = s.h(S_H2), *dp1 = s.h(S_H2), *dp2 = s.h(S_DP2), *dapp = s.h(S_DAPP);
  bf16* dp3m = s.h(S_DP3M);
  float *pt = s.f(S_PT), *dw3h = s.f(S_DW3);
  // parameter partials kept across tiles: dw2 rows 16 warp.., dw1 rows
  // 16 (warp % 2).. by columns 32 (warp / 2)..; dbasis rows 16 warp.. (warps
  // 0-4); db2 (threads < 128) or db1; entry tid / 16 of w3[128:] | b3
  // (threads tid % 16 == 0 below 192); dw3[:128] in shared memory
  float dw2[16][4], dw1[4][4], dbasis[4][4], dbias = 0.0f, d3 = 0.0f;
  zero(dw2);
  zero(dw1);
  zero(dbasis);
  const int64_t n_tiles = (in.p_total + TPM - 1) / TPM;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    mark(PH_TAIL);
    cp_wait_all();
    __syncthreads();
    mark(PH_WAIT);
    tile_features(s);
    __syncthreads();
    mark(PH_FEAT);
    const bool next = tile + gridDim.x < n_tiles;
    if (next) fetch_tile(s, in, gout, tile + gridDim.x);
    mark(PH_FETCH);
    tile_mlp_forward(s, in, next);

    // d_pre3 = g_rgb * rgb * (1 - rgb); points past P have g_rgb = 0
    if (tid < TPM * 3) {
      const int pl = tid / 3, o = tid % 3;
      const float rgb = pt[P_RGB + pl * 4 + o];
      const float d = pt[P_GR + tid] * rgb * (1.0f - rgb);
      pt[P_DP3 + pl * 4 + o] = d;
      pt[P_DP3M + pl * 4 + o] = rnd<true>(d);
      dp3m[pl * LDB + o] = __float2bfloat16(d);
    }
    __syncthreads();
    mark(PH_DP3);

    // d_pre2 = (pre2 > 0) * M(d_pre3m @ w3h^T) (K = 3: CUDA cores)
    for (int e = tid; e < TPM * FC; e += kThreads) {
      const int pl = e >> 7, n = e & 127;
      float sum = 0.0f;
#pragma unroll
      for (int o = 0; o < 3; ++o) sum += pt[P_DP3M + pl * 4 + o] * vec[V_W3 + n * 3 + o];
      dp2[pl * LDH + n] = __float2bfloat16(bf(h2 + pl * LDH + n) > 0.0f ? rnd<true>(sum) : 0.0f);
    }
    {  // dw3[:128] += h2^T @ d_pre3m; the lanes holding columns 0-2 add them up
      float acc[2][4];
      zero(acc);
      warp_mma<2, TPM / 16, true, true>(acc, h2, LDH, warp * 16, dp3m, LDB, 0);
      const int q2 = 2 * (lane & 3);
      if (q2 < 3) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float* d = dw3h + (warp * 16 + (lane >> 2) + 8 * hr) * 3 + q2;
          d[0] += acc[0][2 * hr];
          if (q2 == 0) d[1] += acc[0][2 * hr + 1];
        }
      }
    }
    // w3[128:] += M(vd)^T @ d_pre3m and db3 += d_pre3 (f32): 16 lanes an
    // entry, 4 points a lane
    if (tid < 12 * 16) {
      const int k = tid >> 4, part = tid & 15;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < TPM / 16; ++j) {
        const int pl = part + 16 * j;
        sum += k < 9 ? pt[P_VDM + pl * 3 + k / 3] * pt[P_DP3M + pl * 4 + k % 3] : pt[P_DP3 + pl * 4 + k - 9];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      d3 += sum;
    }
    __syncthreads();
    mark(PH_DP2);

    // d_pre1 = (pre1 > 0) * M(d_pre2 @ w2^T), over h2; dw2 += h1^T @ d_pre2; db2
    {
      float acc[8][4];
      zero(acc);
      warp_mma<8, FC / 16, false, false>(acc, dp2, LDH, mb, s.h(S_W2), LDH, nh * 64);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int n = nh * 64 + c * 8 + 2 * (lane & 3);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = r + 8 * hr;
          const bf16* hv = h1 + row * LDH + n;
          st2(dp1 + row * LDH + n, bf(hv) > 0.0f ? rnd<true>(acc[c][2 * hr]) : 0.0f,
              bf(hv + 1) > 0.0f ? rnd<true>(acc[c][2 * hr + 1]) : 0.0f);
        }
      }
    }
    warp_mma<16, TPM / 16, true, true>(dw2, h1, LDH, warp * 16, dp2, LDH, 0);
    if (tid < FC) {
      float sum = 0.0f;
      for (int pl = 0; pl < TPM; ++pl) sum += bf(dp2 + pl * LDH + tid);
      dbias += sum;
    }
    __syncthreads();
    mark(PH_DP1);

    // d_app = d_pre1 @ w1^T (f32), rounded to T; dw1 += x0m^T @ d_pre1; db1
    {
      float acc[2][4];
      zero(acc);
      warp_mma<2, FC / 16, false, false>(acc, dp1, LDH, mb, s.h(S_W1), LDH, nh * 16);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int k = nh * 16 + c * 8 + 2 * (lane & 3);
        st2(dapp + r * LDB + k, rnd<true>(acc[c][0]), rnd<true>(acc[c][1]));
        st2(dapp + (r + 8) * LDB + k, rnd<true>(acc[c][2]), rnd<true>(acc[c][3]));
      }
    }
    warp_mma<4, TPM / 16, true, true>(dw1, x0m, LDB, (warp & 1) * 16, dp1, LDH, (warp >> 1) * 32);
    if (tid >= FC) {
      float sum = 0.0f;
      for (int pl = 0; pl < TPM; ++pl) sum += bf(dp1 + pl * LDH + tid - FC);
      dbias += sum;
    }
    __syncthreads();
    mark(PH_DAPP);

    // dbasis += feats^T @ T(d_app); d_feat = T(T(d_app) @ basis^T), written out
    if (warp < NBP / 16) warp_mma<4, TPM / 16, true, true>(dbasis, feat, LDF, warp * 16, dapp, LDB, 0);
    {
      float acc[6][4];
      zero(acc);
      warp_mma<6, 2, false, false>(acc, dapp, LDB, mb, s.h(S_BASIS), LDB, nh * 48);
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const int n = nh * 48 + c * 8 + 2 * (lane & 3);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int64_t p = tile * TPM + r + 8 * hr;
          if (n < NB && p < in.p_total) {
            st2(d_feat + p * NB + n, rnd<true>(acc[c][2 * hr]), rnd<true>(acc[c][2 * hr + 1]));
          }
        }
      }
    }
  }

  float* part = partials + static_cast<int64_t>(blockIdx.x) * N_ACC;
  const int g = lane >> 2, q2 = 2 * (lane & 3);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int m2 = warp * 16 + g + 8 * hr, m1 = (warp & 1) * 16 + g + 8 * hr;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      part[A_W2 + m2 * FC + c * 8 + q2] = dw2[c][2 * hr];
      part[A_W2 + m2 * FC + c * 8 + q2 + 1] = dw2[c][2 * hr + 1];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = (warp >> 1) * 32 + c * 8 + q2;
      if (m1 < APP) {
        part[A_W1 + m1 * FC + n] = dw1[c][2 * hr];
        part[A_W1 + m1 * FC + n + 1] = dw1[c][2 * hr + 1];
      }
      if (warp < NBP / 16 && m2 < NB) {
        if (c * 8 + q2 < APP) part[A_BASIS + m2 * APP + c * 8 + q2] = dbasis[c][2 * hr];
        if (c * 8 + q2 + 1 < APP) part[A_BASIS + m2 * APP + c * 8 + q2 + 1] = dbasis[c][2 * hr + 1];
      }
    }
  }
  part[(tid < FC ? A_B2 + tid : A_B1 + tid - FC)] = dbias;
  for (int e = tid; e < FC * 3; e += kThreads) part[A_W3 + e] = dw3h[e];
  if (tid < 12 * 16 && (tid & 15) == 0) part[A_W3 + FC * 3 + (tid >> 4)] = d3;
  mark(PH_END);
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

// the persistent grid: a block per tile of `tile` points, at most n_blocks
int grid_for(int64_t p, int tile, int n_blocks) {
  const int64_t n_tiles = (p + tile - 1) / tile;
  return static_cast<int>(n_tiles < n_blocks ? n_tiles : n_blocks);
}

// bf16 tables and MLP take the tensor-core kernels, every other pair the
// CUDA-core ones
template <typename T, bool MB>
constexpr bool kMma = std::is_same<T, bf16>::value && MB;

template <typename T, bool MB>
cudaError_t fwd(const Inputs<T>& in, float* out, int n_sms, cudaStream_t s) {
  cudaError_t err;
  if constexpr (kMma<T, MB>) {
    err = cudaFuncSetAttribute(march_fwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_FWD);
    if (err != cudaSuccess) return err;
    march_fwd_mma_kernel<<<grid_for(in.p_total, TPM, n_sms), kThreads, SMEM_FWD, s>>>(in, out);
  } else {
    const size_t smem = N_FWD * sizeof(float);
    err = cudaFuncSetAttribute(march_fwd_kernel<T, MB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    // two blocks per SM (__launch_bounds__)
    march_fwd_kernel<T, MB><<<grid_for(in.p_total, TP, 2 * n_sms), kThreads, smem, s>>>(in, out);
  }
  return cudaGetLastError();
}

template <typename T, bool MB>
cudaError_t bwd(const Inputs<T>& in, const float* gout, void* drows0, void* drows1,
                void* drows2, float* d_wxy, float* d_w1l, float* dlines, T* d_feat,
                float* partials, float* dparams, int n_blocks, cudaStream_t s) {
  cudaError_t err;
  int grid;
  if constexpr (kMma<T, MB>) {
    err = cudaFuncSetAttribute(march_bwd_mlp_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BWD);
    if (err != cudaSuccess) return err;
    grid = grid_for(in.p_total, TPM, n_blocks);
    march_bwd_mlp_mma_kernel<<<grid, kThreads, SMEM_BWD, s>>>(in, gout, d_feat, partials);
  } else {
    const size_t smem = N_BWD * sizeof(float);
    err = cudaFuncSetAttribute(march_bwd_mlp_kernel<T, MB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    grid = grid_for(in.p_total, TP, n_blocks);
    march_bwd_mlp_kernel<T, MB><<<grid, kThreads, smem, s>>>(in, gout, d_feat, partials);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t pts_per_block = static_cast<int64_t>(kPtsPerHalf) * (kThreads / 16);
  const unsigned fblocks = static_cast<unsigned>((in.p_total + pts_per_block - 1) / pts_per_block);
  march_bwd_factor_kernel<T><<<fblocks, kThreads, 0, s>>>(
      in, gout, d_feat, static_cast<T*>(drows0), static_cast<T*>(drows1),
      static_cast<T*>(drows2), d_wxy, d_w1l, dlines);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  march_reduce_kernel<<<(N_ACC + 255) / 256, 256, 0, s>>>(partials, grid, dparams);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lrf_march_n_params() { return N_ACC; }

#ifdef LRF_MARCH_PHASES
// Copy the phase spans (int64 [1024][N_PHASES], clock64 ticks) to `host`
// and zero them; synchronous.
extern "C" int lrf_march_phase_cycles(void* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_phase_cycles, sizeof(g_phase_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const long long zeros[kPhaseBlocks][N_PHASES] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_cycles, zeros, sizeof(zeros)));
}
#endif

extern "C" int lrf_march_fwd(const void* rows0, const void* rows1, const void* rows2,
                             const void* wxy, const void* w1l, const void* x0, const void* vd,
                             const void* lines, const void* basis, const void* w1,
                             const void* b1, const void* w2, const void* b2, const void* w3,
                             const void* b3, void* out, int64_t p, int g, int t_bf16,
                             int m_bf16, int n_sms, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  cudaError_t err;
  if (t_bf16) {
    const auto in = make_inputs<__nv_bfloat16>(rows0, rows1, rows2, wxy, w1l, x0, vd, lines,
                                               basis, w1, b1, w2, b2, w3, b3, p, g);
    err = m_bf16 ? fwd<__nv_bfloat16, true>(in, o, n_sms, s)
                 : fwd<__nv_bfloat16, false>(in, o, n_sms, s);
  } else {
    const auto in = make_inputs<float>(rows0, rows1, rows2, wxy, w1l, x0, vd, lines, basis, w1,
                                       b1, w2, b2, w3, b3, p, g);
    err = m_bf16 ? fwd<float, true>(in, o, n_sms, s) : fwd<float, false>(in, o, n_sms, s);
  }
  return static_cast<int>(err);
}

extern "C" int lrf_march_bwd(const void* rows0, const void* rows1, const void* rows2,
                             const void* wxy, const void* w1l, const void* x0, const void* vd,
                             const void* lines, const void* basis, const void* w1,
                             const void* b1, const void* w2, const void* b2, const void* w3,
                             const void* b3, const void* gout, void* drows0, void* drows1,
                             void* drows2, void* d_wxy, void* d_w1l, void* dlines, void* d_feat,
                             void* partials, void* dparams, int64_t p, int g, int t_bf16,
                             int m_bf16, int n_blocks, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* go = static_cast<const float*>(gout);
  auto* dwxy = static_cast<float*>(d_wxy);
  auto* dw1l = static_cast<float*>(d_w1l);
  auto* dl = static_cast<float*>(dlines);
  auto* pa = static_cast<float*>(partials);
  auto* dp = static_cast<float*>(dparams);
  cudaError_t err;
  if (t_bf16) {
    auto* da = static_cast<__nv_bfloat16*>(d_feat);
    const auto in = make_inputs<__nv_bfloat16>(rows0, rows1, rows2, wxy, w1l, x0, vd, lines,
                                               basis, w1, b1, w2, b2, w3, b3, p, g);
    err = m_bf16 ? bwd<__nv_bfloat16, true>(in, go, drows0, drows1, drows2, dwxy, dw1l, dl, da,
                                            pa, dp, n_blocks, s)
                 : bwd<__nv_bfloat16, false>(in, go, drows0, drows1, drows2, dwxy, dw1l, dl,
                                             da, pa, dp, n_blocks, s);
  } else {
    auto* da = static_cast<float*>(d_feat);
    const auto in = make_inputs<float>(rows0, rows1, rows2, wxy, w1l, x0, vd, lines, basis, w1,
                                       b1, w2, b2, w3, b3, p, g);
    err = m_bf16 ? bwd<float, true>(in, go, drows0, drows1, drows2, dwxy, dw1l, dl, da, pa, dp,
                                    n_blocks, s)
                 : bwd<float, false>(in, go, drows0, drows1, drows2, dwxy, dw1l, dl, da, pa, dp,
                                     n_blocks, s);
  }
  return static_cast<int>(err);
}
