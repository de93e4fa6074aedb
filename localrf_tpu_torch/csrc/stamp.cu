// A device timestamp: one thread writes the card's %globaltimer (ns) into
// ring[row + *step, slot] of an int64 [rows, n_slots] ring.
//
// Replaces no kernel of localrf_tpu/ops/pallas/ (the JAX package times its
// steps from the host): it is the port tracer's probe (utils/profiling.py).
// A captured training step (models/graph.py) replays as one CUDA graph, so
// no host clock and no launch counter sees where its time goes; these
// stamps, captured at module boundaries of the step, are written by the
// card itself at every replay. The row comes from device memory (`step`,
// one of the step's static inputs), so one captured graph writes row k at
// the k-th step of a chunk; eager callers pass step = nullptr and the row.
//
// What bounds it: nothing but the launch. One thread stores 8 bytes, so a
// stamp costs the gap between two kernels of a stream (~1-2 us); it runs
// after the previous kernel of the stream has finished, which is the
// instant it records.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void stamp_kernel(int64_t* ring, const int64_t* step, int64_t row, int n_slots,
                             int slot) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const int64_t r = row + (step != nullptr ? *step : 0);
  ring[r * n_slots + slot] = static_cast<int64_t>(t);
}

}  // namespace

extern "C" int lrf_stamp(void* ring, const void* step, long long row, int n_slots, int slot,
                         void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(ring), static_cast<const int64_t*>(step), static_cast<int64_t>(row),
      n_slots, slot);
  return static_cast<int>(cudaGetLastError());
}
