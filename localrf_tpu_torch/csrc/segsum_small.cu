// K3: segment sum into small tables (the line-table backward of
// `--line_bwd segsum`), for Hopper, in an order fixed by the shapes alone.
//
// Replaces the Pallas TPU kernel localrf_tpu/ops/pallas/segsum.py
// (`segment_sum_matmul`: `_segsum_kernel`), the VJP of `take_rows`.
//
//   out[r, :] = sum_{p : idx_p == r} g_p    (f32 accumulation, f32 out)
//
// What bounds it on the card: bytes. At the 640^3 stage P = 1,359,872 rows
// of 64 bf16 (174 MB) with their int64 indices land on only 640 line rows,
// about 2,100 points per row: 185 MB, 0.055 ms at 3.35 TB/s. The TPU kernel
// kept a [T_TILE, C] accumulator resident in VMEM across the point stream
// and fed it one-hot MXU matmuls; here a block keeps its [tile_rows, C] f32
// accumulator in shared memory (a whole [640, 64] line table is 160 KB of
// the 227 KB a block can opt into) and sums its points into it with plain
// adds: no atomics (a shared f32 atomicAdd is a compare-and-swap loop on
// this card), and every row's sum runs in an order the shapes fix, so the
// result does not depend on timing or on the SM count, and a plain version
// (ops/kernels/segsum.py `segment_sum_small_ordered`) reproduces it bit
// for bit.
// - Blocks: grid (row tiles, point ranges) from `segsum_plan` (P, n_rows
//   and C alone): range k holds the points [k L, (k + 1) L). A table taller
//   than one block's accumulator is cut into row tiles, as the TPU kernel
//   tiles T; every row-tile block of a range reads the range's points and
//   skips the rows of other tiles, and indices outside [0, n_rows) too.
// - Stream: the range passes through shared memory in stages of up to 256
//   points (indices and payload rows), kStages buffers deep, so two stages
//   are in flight while the block sums the third. One thread copies a
//   stage with two TMA bulk copies (`cp.async.bulk`, completing on the
//   buffer's mbarrier): a `cp.async` of 16 bytes from each of the 1,024
//   threads kept the load/store queue full, and the block then spent
//   longer issuing copies than summing.
// - Rows are owned by warps: row r of the tile belongs to warp r % 32, so
//   rows spread over warps however the points cluster (the ball of a 640^3
//   step hits the middle ~350 rows). Each warp ballots over a stage's
//   indices, 32 at a time, and takes its points in point order; its lanes
//   add a payload row into the accumulator row (two channels a lane). No
//   two warps touch one row, so a row's sum runs in point order, from 0,
//   as a chain of f32 adds (adds, never fused multiply-adds; there is no
//   fast math).
// - Runs: a real step's line indices come in runs (a ray's samples stay
//   on one x or y line row for many samples, and neighbouring rays share
//   it), so a warp keeps the row it is adding into in registers and writes
//   it back only when its next point is on another row; it reads the rows
//   and payload of 2 points (8 in a round that is mostly its own) before
//   adding them, so the reads overlap. A shared load, add and store per
//   point would chain every point of a run through shared memory in one
//   warp while the others wait at the stage's barrier.
// - Ranges: each block writes its tile of the range's f32 partial table
//   [n_ranges, n_rows, C] (scratch from the wrapper, 21.6 MB at 640^3,
//   which stays in the 50 MB L2), and a second kernel sums the partials in
//   range order, from 0, and writes every output row once: no zero fill,
//   no atomic flush. With one range the block writes the output itself.
// Every grid and buffer is sized from the shapes, so the call is
// capturable in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 32;  // blockDim: row r of a tile belongs to warp r % kWarps
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxC = 64;   // payload width: two channels a lane (a quad line row is 2C = 64)
constexpr int kStages = 3;  // stage buffers: two in flight while one is summed
constexpr int kMaxStage = 256;                    // points in a stage at most
constexpr int kSmemBytes = 226 * 1024;  // dynamic shared memory: of the 227 KB a block can opt into,
                                        // 1 KB left for the stage barriers
constexpr int kMaxAccBytes = 160 * 1024;          // one [640, 64] f32 line table
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)), "r"(count));
}
// one arrival that also expects `bytes` of bulk copies to complete on bar
__device__ __forceinline__ void bar_arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n" ::"r"(saddr(bar)),
      "r"(parity)
      : "memory");
}
// orders this thread's earlier shared-memory accesses (and, after a
// barrier, the block's) before later bulk copies into the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// TMA: `bytes` (a multiple of 16; both ends 16-byte aligned) global ->
// shared, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

// A lane's two channels of a row: 2 lane and 2 lane + 1 when C is even
// (PAIR: one 4- or 8-byte access), else lane and lane + 32; channels past
// C read as 0 and are not written.
template <bool PAIR, typename T>
__device__ __forceinline__ float2 load_g(const T* row, int lane, int c) {
  if (PAIR) return 2 * lane < c ? load2(row + 2 * lane) : make_float2(0.0f, 0.0f);
  return make_float2(lane < c ? to_f32(row[lane]) : 0.0f, lane + 32 < c ? to_f32(row[lane + 32]) : 0.0f);
}
template <bool PAIR>
__device__ __forceinline__ float2 load_acc(const float* row, int lane, int c) {
  return load_g<PAIR>(row, lane, c);
}
template <bool PAIR>
__device__ __forceinline__ void store_acc(float* row, float2 a, int lane, int c) {
  if (PAIR) {
    if (2 * lane < c) *reinterpret_cast<float2*>(row + 2 * lane) = a;
  } else {
    if (lane < c) row[lane] = a.x;
    if (lane + 32 < c) row[lane + 32] = a.y;
  }
}

// A warp's running sum: the accumulator row it adds into (`cur`, -1 for
// none) kept in registers (`a`), so a run of points on one row costs adds
// only; a point on another row writes the row back and loads the next.
// Only this warp touches its rows, and a lane reads back what it wrote.
struct Run {
  int cur = -1;
  float2 a = make_float2(0.0f, 0.0f);
};

template <bool PAIR>
__device__ __forceinline__ void add_point(Run& s, float* acc, int row, float2 v, int lane, int c) {
  if (row != s.cur) {
    if (s.cur >= 0) store_acc<PAIR>(acc + s.cur * c, s.a, lane, c);
    s.cur = row;
    s.a = load_acc<PAIR>(acc + row * c, lane, c);
  }
  s.a.x += v.x;
  s.a.y += v.y;
}

// This warp's points among the 32 of a round (mask m; rr the lanes' rows),
// in point order. B of them at a time: their rows and payload rows are
// read before the first add, so the reads overlap.
template <int B, bool PAIR, typename T>
__device__ __forceinline__ void take(unsigned& m, Run& s, float* acc, const T* bp, int base, int rr,
                                     int lane, int c) {
  int row[B];
  float2 v[B];
  bool ok[B];
#pragma unroll
  for (int u = 0; u < B; ++u) {
    ok[u] = m != 0;
    const int j = (__ffs(m) - 1) & 31;
    m &= m - 1;
    row[u] = __shfl_sync(0xffffffffu, rr, j);
    v[u] = load_g<PAIR>(bp + (base + j) * c, lane, c);
  }
#pragma unroll
  for (int u = 0; u < B; ++u) {
    if (ok[u]) add_point<PAIR>(s, acc, row[u], v[u], lane, c);
  }
}

// The round's points in chunks of 8 lanes, every lane's payload row read
// (the round is mostly this warp's: a run of points on its rows)
template <bool PAIR, typename T>
__device__ __forceinline__ void take_dense(unsigned m, Run& s, float* acc, const T* bp, int base,
                                           int rr, int lane, int c) {
#pragma unroll
  for (int u0 = 0; u0 < 32; u0 += 8) {
    if (((m >> u0) & 0xffu) == 0) continue;
    int row[8];
    float2 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      row[u] = __shfl_sync(0xffffffffu, rr, u0 + u);
      v[u] = load_g<PAIR>(bp + (base + u0 + u) * c, lane, c);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if ((m >> (u0 + u)) & 1u) add_point<PAIR>(s, acc, row[u], v[u], lane, c);
    }
  }
}

// Phases of a stage, for the spans of a build with -DLRF_SEGSUM_PHASES
// (scripts/segsum_phases.py): each warp sums the clock64() ticks between
// its marks by phase in registers, and lane 0 of each warp of the blocks
// of row tile 0 adds them to g_segsum_cycles[range][warp][phase] at the
// end, and the stages to the last column.
// WAIT: until the stage has landed; BARRIER: until every warp is done with
// the stage before; ISSUE: thread 0's copies of a later stage (the other
// warps pass at once); SUM: the warp's scan and adds. Without the macro a
// mark is nothing.
enum Phase { PH_WAIT, PH_BARRIER, PH_ISSUE, PH_SUM, N_PHASES };
#ifdef LRF_SEGSUM_PHASES
constexpr int kPhaseRanges = 256;
__device__ long long g_segsum_cycles[kPhaseRanges][kWarps][N_PHASES + 1];
// ph[0, N_PHASES): a warp's ticks so far in each phase (registers);
// ph[N_PHASES]: the clock at its last mark
__device__ __forceinline__ void mark(long long (&ph)[N_PHASES + 1], int phase) {
  const long long now = clock64();
  if (phase >= 0) ph[phase] += now - ph[N_PHASES];
  ph[N_PHASES] = now;
}
__device__ __forceinline__ void mark_flush(const long long (&ph)[N_PHASES + 1], int stages) {
  if ((threadIdx.x & 31) == 0 && blockIdx.x == 0 && blockIdx.y < kPhaseRanges) {
    long long* dst = g_segsum_cycles[blockIdx.y][threadIdx.x >> 5];
    for (int k = 0; k < N_PHASES; ++k) dst[k] += ph[k];
    dst[N_PHASES] += stages;
  }
}
#else
__device__ __forceinline__ void mark(long long (&)[N_PHASES + 1], int) {}
__device__ __forceinline__ void mark_flush(const long long (&)[N_PHASES + 1], int) {}
#endif

// One block: the points [p_lo, p_hi) of range blockIdx.y into the rows of
// tile blockIdx.x, then that tile of the range's partial table. Shared
// memory: the f32 accumulator [tile_rows, c] (acc_bytes), then kStages
// index buffers [stage] int64, then kStages payload buffers [stage, c].
template <typename T, bool PAIR>
__global__ void __launch_bounds__(kThreads, 1)
    segsum_small_kernel(const int64_t* __restrict__ idx, const T* __restrict__ g,
                        float* __restrict__ partials, int64_t p_total, int c, int64_t n_rows,
                        int tile_rows, int64_t range_len, int stage, int acc_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[kStages];  // stage buffer b holds its stage
  float* acc = reinterpret_cast<float*>(smem);
  int64_t* sidx = reinterpret_cast<int64_t*>(smem + acc_bytes);
  T* spay = reinterpret_cast<T*>(smem + acc_bytes + kStages * stage * 8);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int rows_here = static_cast<int>(n_rows - row0 < tile_rows ? n_rows - row0 : tile_rows);
  const int64_t p_lo = static_cast<int64_t>(blockIdx.y) * range_len;
  const int64_t p_hi = p_lo + range_len < p_total ? p_lo + range_len : p_total;
  const int n_st = p_hi > p_lo ? static_cast<int>((p_hi - p_lo + stage - 1) / stage) : 0;

  for (int e = tid; e < rows_here * c; e += kThreads) acc[e] = 0.0f;
  if (tid == 0) {
    for (int b = 0; b < kStages; ++b) bar_init(&full[b], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0: stage s -> buffer b, its indices and payload rows as two
  // bulk copies of whole 16-byte pieces, the bytes past the last piece (at
  // the very end of P only) by plain copies before its arrival.
  auto issue = [&](int s, int b) {
    const int64_t q0 = p_lo + static_cast<int64_t>(s) * stage;
    const int n = static_cast<int>(p_hi - q0 < stage ? p_hi - q0 : stage);
    const int pay = n * c * static_cast<int>(sizeof(T));
    const unsigned ib = (n * 8) & ~15, pb = pay & ~15;
    int64_t* si = sidx + b * stage;
    T* sp = spay + static_cast<int64_t>(b) * stage * c;
    if (ib < static_cast<unsigned>(n * 8)) si[n - 1] = idx[q0 + n - 1];
    for (int e = static_cast<int>(pb / sizeof(T)); e < n * c; ++e) sp[e] = g[q0 * c + e];
    fence_proxy_async();  // the buffer's last readers and these writes, before the copies
    bar_arrive_expect(&full[b], ib + pb);
    if (ib) bulk_copy(si, idx + q0, ib, &full[b]);
    if (pb) bulk_copy(sp, g + q0 * c, pb, &full[b]);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages - 1 && s < n_st; ++s) issue(s, s);
  }
  Run run;
  long long ph[N_PHASES + 1] = {};
  mark(ph, -1);
  for (int s = 0; s < n_st; ++s) {
    bar_wait(&full[s % kStages], (s / kStages) & 1);  // stage s has landed
    mark(ph, PH_WAIT);
    __syncthreads();  // and every warp is done with stage s - 1, whose buffer is refilled next
    mark(ph, PH_BARRIER);
    if (tid == 0 && s + kStages - 1 < n_st) issue(s + kStages - 1, (s + kStages - 1) % kStages);
    mark(ph, PH_ISSUE);
    const int b = s % kStages;
    const int64_t q0 = p_lo + static_cast<int64_t>(s) * stage;
    const int n = static_cast<int>(p_hi - q0 < stage ? p_hi - q0 : stage);
    const int64_t* bi = sidx + b * stage;
    const T* bp = spay + static_cast<int64_t>(b) * stage * c;
    for (int base = 0; base < n; base += 32) {
      const int q = base + lane;
      int rr = -1;  // the lane's point's row in the tile, or -1
      if (q < n) {
        const int64_t r = bi[q] - row0;
        if (r >= 0 && r < rows_here) rr = static_cast<int>(r);
      }
      unsigned m = __ballot_sync(0xffffffffu, rr >= 0 && (rr & (kWarps - 1)) == warp);
      if (__popc(m) >= 8) {
        take_dense<PAIR>(m, run, acc, bp, base, rr, lane, c);
      } else {
        while (m) {
          if (m & (m - 1)) {
            take<2, PAIR>(m, run, acc, bp, base, rr, lane, c);
          } else {
            take<1, PAIR>(m, run, acc, bp, base, rr, lane, c);
          }
        }
      }
    }
    mark(ph, PH_SUM);
  }
  mark_flush(ph, n_st);
  if (run.cur >= 0) store_acc<PAIR>(acc + run.cur * c, run.a, lane, c);
  __syncthreads();

  float* dst = partials + (static_cast<int64_t>(blockIdx.y) * n_rows + row0) * c;
  for (int e = tid; e < rows_here * c; e += kThreads) dst[e] = acc[e];
}

// out[e] = sum over ranges k, in order from 0, of partials[k][e]
__global__ void __launch_bounds__(kReduceThreads)
    segsum_small_reduce_kernel(const float* __restrict__ partials, float* __restrict__ out,
                               int64_t n_el, int n_ranges) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (e >= n_el) return;
  float s = 0.0f;
#pragma unroll 8
  for (int k = 0; k < n_ranges; ++k) s += __ldcg(partials + k * n_el + e);
  out[e] = s;
}

template <typename T>
cudaError_t launch(const int64_t* idx, const T* g, float* partials, float* out, int64_t p, int c,
                   int64_t n_rows, int tile_rows, int n_ranges, int64_t range_len,
                   cudaStream_t s) {
  if (c < 1 || c > kMaxC || tile_rows < 1 || n_ranges < 1 || range_len < 32 || range_len % 32 ||
      static_cast<int64_t>(n_ranges) * range_len < p || n_ranges > 65535 ||
      static_cast<int64_t>(tile_rows) * c * 4 > kMaxAccBytes) {
    return cudaErrorInvalidValue;
  }
  if (n_ranges == 1 && partials != out) return cudaErrorInvalidValue;
  const int acc_bytes = (tile_rows * c * 4 + 15) / 16 * 16;
  const int per_point = 8 + c * static_cast<int>(sizeof(T));
  int stage = (kSmemBytes - acc_bytes) / (kStages * per_point);
  stage = (stage < kMaxStage ? stage : kMaxStage) / 32 * 32;
  if (stage < 32) return cudaErrorInvalidValue;
  const int smem = acc_bytes + kStages * stage * per_point;
  const auto kernel = c % 2 == 0 ? segsum_small_kernel<T, true> : segsum_small_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t row_tiles = (n_rows + tile_rows - 1) / tile_rows;
  const dim3 grid(static_cast<unsigned>(row_tiles), static_cast<unsigned>(n_ranges));
  kernel<<<grid, kThreads, smem, s>>>(idx, g, partials, p, c, n_rows, tile_rows, range_len, stage,
                                      acc_bytes);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_ranges == 1) return err;
  const int64_t n_el = n_rows * c;
  segsum_small_reduce_kernel<<<static_cast<unsigned>((n_el + kReduceThreads - 1) / kReduceThreads),
                               kReduceThreads, 0, s>>>(partials, out, n_el, n_ranges);
  return cudaGetLastError();
}

}  // namespace

#ifdef LRF_SEGSUM_PHASES
// Copy the phase spans (int64 [256][32][N_PHASES + 1]: clock64 ticks, then
// stages) to `host` and zero them; synchronous.
extern "C" int lrf_segsum_phase_cycles(void* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_segsum_cycles, sizeof(g_segsum_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const long long zeros[kPhaseRanges][kWarps][N_PHASES + 1] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_segsum_cycles, zeros, sizeof(zeros)));
}
#endif

// idx int64 [P] and g [P, C] (f32 or bf16) on 16-byte boundaries; partials
// f32 [n_ranges, n_rows, C] (the output itself when n_ranges == 1); out f32
// [n_rows, C]; the plan's tile_rows, n_ranges and range_len.
extern "C" int lrf_segsum_small(const void* idx, const void* g, int g_is_bf16, void* partials,
                                void* out, int64_t p, int c, int64_t n_rows, int tile_rows,
                                int n_ranges, int64_t range_len, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int64_t*>(idx);
  auto* pa = static_cast<float*>(partials);
  auto* o = static_cast<float*>(out);
  cudaError_t err =
      g_is_bf16 ? launch(ix, static_cast<const __nv_bfloat16*>(g), pa, o, p, c, n_rows, tile_rows,
                         n_ranges, range_len, s)
                : launch(ix, static_cast<const float*>(g), pa, o, p, c, n_rows, tile_rows, n_ranges,
                         range_len, s);
  return static_cast<int>(err);
}
