// density_l1: LocalRF's density L1 term and its gradients in one pass, for
// Hopper, on a cubic grid, in IEEE f32 with every sum in an order the shapes
// fix.
//
// Replaces no kernel of localrf_tpu/ops/pallas/: the JAX package computes
// this term in `jnp` (localrf_tpu/models/tensorf.py `density_l1`, einsum
// blocks under `jax.checkpoint`), and the port ran the same blocks through
// autograd, where every voxel went through device memory in the forward
// pass, again in the recomputed forward and again in the backward.
//
// On a cubic grid every density plane flattens to [C_i, G^2] and every line
// is [C_i, G], so voxel v = p G + d has the same (p, d) in all three
// orientations (the reference's layout quirk). With A the stacked planes
// [K, G^2], B the stacked lines [K, G] and K = C_0 + C_1 + C_2:
//
//   f[p, d] = sum_k A[k, p] B[k, d]
//   sigma   = softplus(f + shift)  (threshold 20: x past it is its own value)
//             or relu(f)
//   value   = sum_{p,d} sqrt(max(sigma, 1e-5)) / G^3
//   g[p, d] = d value / d f, unscaled: [sigma >= 1e-5] / (2 sqrt(.)) * dsigma
//   dA      = g B^T / G^3   [K, G^2],   dB = A^T g / G^3   [K, G]
//
// What bounds it on the card: f32 operations, not bytes. Each voxel costs
// 3 K fused multiply-adds (f, and one for each gradient) and about four
// special-function operations (exp, log1p, sqrt, a division); at 640^3 and
// K = 24 that is 37.7 GFLOP, 0.56 ms at 67 TFLOP/s of non-tensor f32, and
// ~1.05G special-function operations, ~0.25 ms on the SFUs, which issue
// beside the FMA pipe: the bound is the larger, 0.56 ms. The bytes are
// the planes read once and their gradient written once, 2 x 39.3 MB. Tensor
// cores would round the f32 parameters to TF32 or bf16, so the products run
// as FFMA on the CUDA cores, and the design keeps everything else off the
// critical path:
// - No voxel is written to device memory. A block holds all of B in shared
//   memory ([K, G] f32, 61 KB at K = 24, G = 640), per row tile the tile's
//   [K, 64] slice of A, and per visit (64 rows x 128 columns) the visit's g
//   (34 KB); with ~103 KB a block, two blocks share an SM at both cells'
//   shapes, and the register tiles fit 128 registers a thread. Where B
//   whole does not fit (a CP field's K = 96 at G = 500 would take 250 KB),
//   a block holds only the visit's [K, 128] columns of B, loaded at each
//   visit from L2 (`stream_b`: 109 KB at K = 96); the sums are the same,
//   in the same order. Past K = 64 the register tiles need more than 128
//   registers a thread, so one block takes an SM.
// - A visit runs three phases between block barriers (see the kernel): f,
//   the square roots and g from 4 x 8 register tiles; the plane gradient
//   g B^T, kept in registers across the tile's visits and written once; the
//   line gradient A g, added to the block's partial [K, G] in device memory
//   (L2) by the one thread that owns each entry. Every sum runs in an order
//   the shapes fix: in-thread chains, then the block's partials.
// - Persistent blocks, `n_blocks` of them (the wrapper fixes 264: 2 per SM
//   of an H100), each walking a fixed range of row tiles; a second kernel
//   sums the blocks' partials in block order, in f64, and the value from
//   each block's f64 sum of its lanes' f32 partial sums. No atomics: two
//   launches give the same bits, whatever the card.
// - Rows past G^2 and columns past G (G = 300 is not a multiple of the
//   tile) are masked: A and B read 0 there, g and the value are 0, and a
//   warp whose whole 32 x 32 part of the visit is outside writes zeros.
// - softplus is PyTorch's (`log1pf(expf(x))`, x itself past 20; no fast
//   math in the build), the clamp's gradient mask is `sigma >= 1e-5`, as
//   torch.clamp's backward has it.
// Every grid and buffer is sized from the shapes and the kernel launches on
// the stream it is given, so the call is capturable in a CUDA graph.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kTileRows = 64;   // plane pixels a row tile
constexpr int kTileCols = 128;  // line entries a column tile
constexpr int kRows = 4;        // forward: a lane's rows, 4 (lane >> 2) + 0..3 of its warp's 32
constexpr int kCols = 8;        // forward: a lane's columns, 8 (lane & 3) + 0..7 of its warp's 32
constexpr int kGStride = kTileRows + 4;  // floats a column of the g tile: 17 float4, odd, so
                                         // that float4 reads of 32 columns spread over the banks
constexpr int kMaxK = 96;
// dynamic shared memory a block may opt into on sm_90 (227 KB), less the
// kernel's static bytes
constexpr int64_t kSmemOptin = 232448 - 64;
constexpr float kClampMin = 1e-5f;
constexpr float kSoftplusThreshold = 20.0f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* a[3];  // density planes [C_i, G^2]
  const float* b[3];  // density lines [C_i, G]
  float* da[3];       // their gradients [C_i, G^2]
  int c0, c01;        // C_0, C_0 + C_1
  int k;              // C_0 + C_1 + C_2
  int g, gp;          // G; G rounded up to 32, a line row in shared memory and in the partials
  int64_t n_pix;      // G^2
  int64_t n_tiles;    // row tiles of kTileRows
  float shift;
  int relu;
  float n_vox;        // G^3 (exact in f32 for the grids in use)
  float* partials;    // [n_blocks, K, gp]: each block's line gradient
  double* sums;       // [n_blocks]: each block's sum of square roots
  int stream_b;       // B in shared memory one visit's columns at a time (else whole)
};

__device__ __forceinline__ float plane_at(const Args& s, int k, int64_t p) {
  if (k < s.c0) return s.a[0][k * s.n_pix + p];
  if (k < s.c01) return s.a[1][(k - s.c0) * s.n_pix + p];
  return s.a[2][(k - s.c01) * s.n_pix + p];
}

__device__ __forceinline__ float line_at(const Args& s, int k, int d) {
  if (k < s.c0) return s.b[0][k * s.g + d];
  if (k < s.c01) return s.b[1][(k - s.c0) * s.g + d];
  return s.b[2][(k - s.c01) * s.g + d];
}

__device__ __forceinline__ float* dplane_at(const Args& s, int k, int64_t p) {
  if (k < s.c0) return s.da[0] + k * s.n_pix + p;
  if (k < s.c01) return s.da[1] + (k - s.c0) * s.n_pix + p;
  return s.da[2] + (k - s.c01) * s.n_pix + p;
}

// sqrt(max(sigma, 1e-5)) of feature f, and g, its derivative w.r.t. f:
// torch's backward of sqrt (1 / (2 result)), of the clamp (0 where sigma <
// 1e-5) and of softplus (z / (z + 1), z = exp(x); 1 past the threshold) or
// relu (1 where f > 0), as one division
__device__ __forceinline__ float root_and_grad(float f, float shift, bool relu, float& g) {
  float sigma, num, den;
  if (relu) {
    sigma = fmaxf(f, 0.0f);
    num = f > 0.0f ? 1.0f : 0.0f;
    den = 1.0f;
  } else {
    const float x = f + shift;
    const float z = expf(x);
    const bool linear = x > kSoftplusThreshold;
    sigma = linear ? x : log1pf(z);
    num = linear ? 1.0f : z;
    den = linear ? 1.0f : z + 1.0f;
  }
  const float root = sqrtf(fmaxf(sigma, kClampMin));
  g = sigma >= kClampMin ? num / (den * (2.0f * root)) : 0.0f;
  return root;
}

// One block walks row tiles [t0, t1) of 64 plane pixels; for each it walks
// the line in column tiles of 128 (a visit), in three phases split by block
// barriers:
// - forward (warp 4 h + q: rows 32 h.., columns 32 q.. of the tile; a lane
//   4 rows x 8 columns in registers): f over the K loop from shared A and B,
//   then the square root (summed) and g, written transposed into the g tile
//   gs [128 columns, 64 rows];
// - plane gradient (thread: rows 2 lane, 2 lane + 1; KM = KP / 8 channels
//   KM warp..): g B^T over the visit's columns, into registers that live
//   across the row tile's visits, written once at its end;
// - line gradient (thread: channels KM warp..; columns lane + 32 j, j < 4):
//   A g over the tile's 64 rows, added to this thread's entries of the
//   block's partial in device memory.
template <int KP>
__global__ void __launch_bounds__(kThreads, KP > 64 ? 1 : 2) density_l1_kernel(const __grid_constant__ Args s) {
  constexpr int KM = KP / 8;  // channels a thread of the gradient phases
  extern __shared__ __align__(16) float smem[];
  // B, 0 past K and G: whole [KP, gp], or the visit's columns [KP, kTileCols]
  const int BS = s.stream_b ? kTileCols : s.gp;  // a channel's stride in b_s
  float* b_s = smem;
  float* a_s = b_s + KP * BS;            // [KP, kTileRows]: the row tile of A, 0 past K and G^2
  float* gs = a_s + KP * kTileRows;      // [kTileCols, kGStride]: g of the visit, column-major
  __shared__ double warp_sums[kThreads / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = warp >> 2, q = warp & 3;
  const int lr = lane >> 2, lc = lane & 3;
  const int row_base = h * 32 + lr * kRows;  // forward: the lane's first row in the tile
  const int k_base = warp * KM;              // gradient phases: the thread's first channel
  const int K = s.k, G = s.g, GP = s.gp;

  if (!s.stream_b) {
    for (int i = tid; i < KP * GP; i += kThreads) {
      const int k = i / GP, d = i - k * GP;
      b_s[i] = (k < K && d < G) ? line_at(s, k, d) : 0.0f;
    }
  }
  // the block's partial line gradient: this thread adds to (and so zeroes)
  // channels k_base.. at columns d = lane (mod 32)
  float* part = s.partials + static_cast<int64_t>(blockIdx.x) * K * GP;
  for (int d = lane; d < G; d += 32) {
#pragma unroll
    for (int m = 0; m < KM; ++m) {
      if (k_base + m < K) part[(k_base + m) * GP + d] = 0.0f;
    }
  }

  const int64_t t0 = blockIdx.x * s.n_tiles / gridDim.x, t1 = (blockIdx.x + 1) * s.n_tiles / gridDim.x;
  double root_sum = 0.0;
  for (int64_t tile = t0; tile < t1; ++tile) {
    const int64_t p0 = tile * kTileRows;
    for (int i = tid; i < KP * kTileRows; i += kThreads) {
      const int k = i / kTileRows, r = i % kTileRows;
      a_s[i] = (k < K && p0 + r < s.n_pix) ? plane_at(s, k, p0 + r) : 0.0f;
    }
    __syncthreads();

    float da[2][KM];
#pragma unroll
    for (int m = 0; m < KM; ++m) da[0][m] = da[1][m] = 0.0f;
    const bool rows_on = p0 + h * 32 < s.n_pix;

    for (int col0 = 0; col0 < G; col0 += kTileCols) {
      const int n_cols = min(kTileCols, G - col0);
      // the visit's columns of B: b_v[k * BS + c] is B[k][col0 + c]
      const float* b_v = s.stream_b ? b_s : b_s + col0;
      if (s.stream_b) {
        for (int i = tid; i < KP * kTileCols; i += kThreads) {
          const int k = i / kTileCols, d = col0 + i % kTileCols;
          b_s[i] = (k < K && d < G) ? line_at(s, k, d) : 0.0f;
        }
        __syncthreads();
      }
      // forward
      float4* my_gs = reinterpret_cast<float4*>(gs + (q * 32 + lc * kCols) * kGStride + row_base);
      if (rows_on && q * 32 < n_cols) {
        const int cbase = col0 + q * 32 + lc * kCols;  // the lane's first column
        float f[kRows][kCols];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int c = 0; c < kCols; ++c) f[r][c] = 0.0f;
#pragma unroll
        for (int k = 0; k < KP; ++k) {
          const float4 a4 = *reinterpret_cast<const float4*>(a_s + k * kTileRows + row_base);
          const float4 b4 = *reinterpret_cast<const float4*>(b_v + k * BS + cbase - col0);
          const float4 b8 = *reinterpret_cast<const float4*>(b_v + k * BS + cbase - col0 + 4);
          const float av[kRows] = {a4.x, a4.y, a4.z, a4.w};
          const float bv[kCols] = {b4.x, b4.y, b4.z, b4.w, b8.x, b8.y, b8.z, b8.w};
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int c = 0; c < kCols; ++c) f[r][c] = fmaf(av[r], bv[c], f[r][c]);
        }
        float roots = 0.0f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const bool row_ok = p0 + row_base + r < s.n_pix;
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            float g;
            const float root = root_and_grad(f[r][c], s.shift, s.relu != 0, g);
            const bool ok = row_ok && cbase + c < G;
            roots += ok ? root : 0.0f;
            f[r][c] = ok ? g : 0.0f;
          }
        }
        root_sum += static_cast<double>(roots);
#pragma unroll
        for (int c = 0; c < kCols; ++c) my_gs[c * (kGStride / 4)] = make_float4(f[0][c], f[1][c], f[2][c], f[3][c]);
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) my_gs[c * (kGStride / 4)] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      __syncthreads();

      // plane gradient: da[r][m] += sum_c g[c][2 lane + r] B[k_base + m][col0 + c],
      // over the visit's columns rounded up to 8 (g and B are 0 past G; gp
      // and kTileCols >= that round-up), two steps of 4 at a time
      const int n_cols8 = (n_cols + 7) & ~7;
#pragma unroll 2
      for (int c = 0; c < n_cols8; c += 4) {
        float2 gv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) gv[j] = *reinterpret_cast<const float2*>(gs + (c + j) * kGStride + 2 * lane);
#pragma unroll
        for (int m = 0; m < KM; ++m) {
          const float4 bv = *reinterpret_cast<const float4*>(b_v + (k_base + m) * BS + c);
          const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            da[0][m] = fmaf(gv[j].x, bj[j], da[0][m]);
            da[1][m] = fmaf(gv[j].y, bj[j], da[1][m]);
          }
        }
      }

      // line gradient: db[m][j] = sum_r A[k_base + m][r] g[lane + 32 j][r]
      float prev[KM][4];
#pragma unroll
      for (int m = 0; m < KM; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = col0 + lane + 32 * j;
          prev[m][j] = (k_base + m < K && d < G) ? part[(k_base + m) * GP + d] : 0.0f;
        }
      float db[KM][4];
#pragma unroll
      for (int m = 0; m < KM; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) db[m][j] = 0.0f;
#pragma unroll 2
      for (int r = 0; r < kTileRows; r += 4) {
        float4 gv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) gv[j] = *reinterpret_cast<const float4*>(gs + (lane + 32 * j) * kGStride + r);
#pragma unroll
        for (int m = 0; m < KM; ++m) {
          const float4 av = *reinterpret_cast<const float4*>(a_s + (k_base + m) * kTileRows + r);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            db[m][j] = fmaf(av.x, gv[j].x, db[m][j]);
            db[m][j] = fmaf(av.y, gv[j].y, db[m][j]);
            db[m][j] = fmaf(av.z, gv[j].z, db[m][j]);
            db[m][j] = fmaf(av.w, gv[j].w, db[m][j]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < KM; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = col0 + lane + 32 * j;
          if (k_base + m < K && d < G) part[(k_base + m) * GP + d] = prev[m][j] + db[m][j];
        }
      __syncthreads();  // the next visit's forward overwrites gs, the next tile's loads a_s
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t p = p0 + 2 * lane + r;
#pragma unroll
      for (int m = 0; m < KM; ++m) {
        if (p < s.n_pix && k_base + m < K) *dplane_at(s, k_base + m, p) = da[r][m] / s.n_vox;
      }
    }
  }

  // the block's sum of square roots, in a fixed tree
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) root_sum += __shfl_xor_sync(kFull, root_sum, off);
  if (lane == 0) warp_sums[warp] = root_sum;
  __syncthreads();
  if (tid == 0) {
    double total = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    s.sums[blockIdx.x] = total;
  }
}

// dB = (sum over blocks of their partials) / G^3 and the value, each summed
// in block order in f64
__global__ void density_l1_final_kernel(const float* __restrict__ partials, const double* __restrict__ sums,
                                        float* __restrict__ dlines, float* __restrict__ value, int k, int g,
                                        int gp, int n_blocks, double n_vox) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < k * g) {
    const int64_t at = static_cast<int64_t>(i / g) * gp + i % g;
    double acc = 0.0;
    for (int b = 0; b < n_blocks; ++b) acc += partials[static_cast<int64_t>(b) * k * gp + at];
    dlines[i] = static_cast<float>(acc / n_vox);
  }
  if (i == 0) {
    double acc = 0.0;
    for (int b = 0; b < n_blocks; ++b) acc += sums[b];
    value[0] = static_cast<float>(acc / n_vox);
  }
}

template <int KP>
cudaError_t launch_main(const Args& s, int n_blocks, size_t smem, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(density_l1_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  density_l1_kernel<KP><<<n_blocks, kThreads, smem, stream>>>(s);
  return cudaGetLastError();
}

}  // namespace

// Shared memory a block holding B whole (stream_b = 0) or one visit's
// columns of it (stream_b = 1) needs for K channels and lines of length G.
static int64_t smem_bytes(int k, int g, int stream_b) {
  const int kp = (k + 7) / 8 * 8, gp = (g + 31) / 32 * 32;
  return static_cast<int64_t>(sizeof(float)) * (kp * ((stream_b ? kTileCols : gp) + kTileRows) +
                                                kTileCols * kGStride);
}

// B is held whole where that fits the card's shared memory
static int stream_b(int k, int g) { return smem_bytes(k, g, 0) > kSmemOptin ? 1 : 0; }

// Shared memory a block needs for K channels and lines of length G (the
// wrapper checks it against the card's limit before launching).
extern "C" int64_t lrf_density_l1_smem(int k, int g) { return smem_bytes(k, g, stream_b(k, g)); }

// planes a0..a2 [C_i, G^2], lines b0..b2 [C_i, G] (f32, contiguous); writes
// the planes' gradients da0..da2, the lines' gradient dlines [K, G] and the
// value [1], each already divided by G^3; partials [n_blocks, K, G rounded up
// to 32] f32 and sums [n_blocks] f64 are scratch.
extern "C" int lrf_density_l1(const void* a0, const void* a1, const void* a2, const void* b0, const void* b1,
                              const void* b2, void* da0, void* da1, void* da2, int c0, int c1, int c2, int g,
                              float shift, int relu, void* partials, void* sums, void* dlines, void* value,
                              int n_blocks, void* stream) {
  Args s;
  s.a[0] = static_cast<const float*>(a0);
  s.a[1] = static_cast<const float*>(a1);
  s.a[2] = static_cast<const float*>(a2);
  s.b[0] = static_cast<const float*>(b0);
  s.b[1] = static_cast<const float*>(b1);
  s.b[2] = static_cast<const float*>(b2);
  s.da[0] = static_cast<float*>(da0);
  s.da[1] = static_cast<float*>(da1);
  s.da[2] = static_cast<float*>(da2);
  s.c0 = c0;
  s.c01 = c0 + c1;
  s.k = c0 + c1 + c2;
  s.g = g;
  s.gp = (g + 31) / 32 * 32;
  s.n_pix = static_cast<int64_t>(g) * g;
  s.n_tiles = (s.n_pix + kTileRows - 1) / kTileRows;
  s.shift = shift;
  s.relu = relu;
  s.n_vox = static_cast<float>(s.n_pix * g);
  s.partials = static_cast<float*>(partials);
  s.sums = static_cast<double*>(sums);
  s.stream_b = stream_b(s.k, g);
  if (s.k < 1 || s.k > kMaxK || g < 1 || n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(smem_bytes(s.k, g, s.stream_b));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((s.k + 7) / 8 * 8) {
    case 8: err = launch_main<8>(s, n_blocks, smem, st); break;
    case 16: err = launch_main<16>(s, n_blocks, smem, st); break;
    case 24: err = launch_main<24>(s, n_blocks, smem, st); break;
    case 32: err = launch_main<32>(s, n_blocks, smem, st); break;
    case 40: err = launch_main<40>(s, n_blocks, smem, st); break;
    case 48: err = launch_main<48>(s, n_blocks, smem, st); break;
    case 56: err = launch_main<56>(s, n_blocks, smem, st); break;
    case 64: err = launch_main<64>(s, n_blocks, smem, st); break;
    case 72: err = launch_main<72>(s, n_blocks, smem, st); break;
    case 80: err = launch_main<80>(s, n_blocks, smem, st); break;
    case 88: err = launch_main<88>(s, n_blocks, smem, st); break;
    default: err = launch_main<96>(s, n_blocks, smem, st); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kg = s.k * g;
  constexpr int kFinalThreads = 256;
  density_l1_final_kernel<<<(kg + kFinalThreads - 1) / kFinalThreads, kFinalThreads, 0, st>>>(
      s.partials, s.sums, static_cast<float*>(dlines), static_cast<float*>(value), s.k, g, s.gp, n_blocks,
      static_cast<double>(s.n_pix) * g);
  return static_cast<int>(cudaGetLastError());
}
