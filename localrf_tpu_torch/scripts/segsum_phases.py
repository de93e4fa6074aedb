"""Where a stage of K3 (the line-table segment sum) spends its time, by phase.

    python3 localrf_tpu_torch/scripts/segsum_phases.py

Builds the kernels twice (into build/kernels/): as they ship, and with
-DLRF_SEGSUM_PHASES, where lane 0 of each warp of segsum_small_kernel (the
blocks of row tile 0) adds the clock64() ticks between the phase marks of
csrc/segsum_small.cu to a device array. On random bf16 payloads of 64
channels it runs K3 at 640 rows on uniform indices and on the three line
sums of one real 640^3 segsum step (chip_smoke.record_sums on
chip_smoke.model_640), and at 64 rows on uniform indices, and prints for
each case:

- the call's ms in both builds (chip_smoke._time_ms: a replayed CUDA graph
  of 20 calls) and its bound (the function's bytes at 3.35 TB/s);
- the points of a stage, the stages of a block, and the mean run of
  consecutive points on one row;
- the ticks of one stage in each phase (wait for its copy, the block
  barrier, issuing a later stage's copies, the warp's scan and adds): the
  mean over all warps of all blocks, and for the adds also the busiest
  warp of each block (the mean over blocks);
- the SM clock by nvidia-smi while the kernel loops.

The instrumented build must give the same sums, bit for bit, as the
shipped one. One JSON line per case at the end. Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
PHASES = ("wait", "barrier", "issue", "sum")  # csrc/segsum_small.cu's enum Phase, in order
PHASE_RANGES, WARPS = 256, 32  # the device array's first two dimensions


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("segsum_phases: no CUDA device")
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from localrf_tpu_torch.ops.kernels import _build
    from localrf_tpu_torch.ops.kernels import segsum as k3
    from localrf_tpu_torch.scripts.march_phases import sm_clock_mhz

    print(cs._gpu_line())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    ds = cs.make_dataset(cs.W, cs.H, cs.N_FRAMES)
    model = cs.model_640(dev, "segsum")
    real = cs.record_sums(model, ds, k3, "segment_sum_small")
    del model
    torch.cuda.empty_cache()
    cases = [("640 rows uniform", torch.randint(0, 640, (4096 * 332,), generator=gen, device=dev), 640)]
    cases += [(f"640 rows real step, line sum {i}", idx, n) for i, (idx, n) in enumerate(real)]
    cases.append(("64 rows uniform", torch.randint(0, 64, (4096 * 72,), generator=gen, device=dev), 64))
    cases = [(label, idx, n, torch.randn(idx.shape[0], 64, generator=gen, device=dev).to(torch.bfloat16))
             for label, idx, n in cases]

    shipped = {}
    for label, idx, n, g in cases:
        shipped[label] = (k3.segment_sum_small(idx, g, n), cs._time_ms(lambda: k3.segment_sum_small(idx, g, n)))

    _build._lib = None
    _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, "-DLRF_SEGSUM_PHASES")
    lib = _build.library()
    lib.lrf_segsum_phase_cycles.argtypes = [ctypes.c_void_p]
    lib.lrf_segsum_phase_cycles.restype = ctypes.c_int
    host = torch.zeros((PHASE_RANGES, WARPS, len(PHASES) + 1), dtype=torch.int64)

    def read_ticks() -> torch.Tensor:
        torch.cuda.synchronize()
        rc = lib.lrf_segsum_phase_cycles(host.data_ptr())
        if rc:
            raise RuntimeError(f"lrf_segsum_phase_cycles: CUDA error {rc}")
        return host.clone()

    rows = []
    for label, idx, n, g in cases:
        out, ms_shipped = shipped[label]
        if not torch.equal(k3.segment_sum_small(idx, g, n), out):
            raise AssertionError(f"{label}: the instrumented build computes another sum")
        ms = cs._time_ms(lambda: k3.segment_sum_small(idx, g, n))
        read_ticks()
        k3.segment_sum_small(idx, g, n)
        plan = k3.segsum_plan(idx.shape[0], n, 64)
        ticks = read_ticks()[: min(plan.n_ranges, PHASE_RANGES)].double()
        stages = ticks[:, :, len(PHASES)]
        per_stage = ticks[:, :, : len(PHASES)] / stages[:, :, None]
        row = {
            "case": label, "P": idx.shape[0], "n_rows": n, "ms": ms, "ms_shipped": ms_shipped,
            "bound_ms": cs._bound(cs._nbytes(idx, g, out))["bound_ms"], "n_ranges": plan.n_ranges,
            "stages_per_block": float(stages[:, 0].mean()),
            "mean_run": idx.shape[0] / (int((idx[1:] != idx[:-1]).sum()) + 1),
            "points_per_stage": idx.shape[0] / plan.n_ranges / float(stages[:, 0].mean()),
            "ticks_per_stage": {p: float(per_stage[:, :, j].mean()) for j, p in enumerate(PHASES)},
            "busiest_warp_sum_ticks_per_stage": float(per_stage[:, :, PHASES.index("sum")].max(dim=1).values.mean()),
        }
        row["ticks_per_stage"]["whole"] = float(per_stage.sum(dim=2).mean())
        rows.append(row)
        t = row["ticks_per_stage"]
        print(f"{label}: {ms:.4f} ms (shipped build {ms_shipped:.4f}, bound {row['bound_ms']:.4f});"
              f" {row['points_per_stage']:.0f} points a stage, {row['stages_per_block']:.0f} stages a block,"
              f" runs of {row['mean_run']:.2f} points on one row;"
              f" ticks a stage: " + ", ".join(f"{p} {t[p]:.0f}" for p in (*PHASES, "whole"))
              + f"; the busiest warp's sum {row['busiest_warp_sum_ticks_per_stage']:.0f}")
    label, idx, n, g = cases[0]
    clocks = sm_clock_mhz(lambda: k3.segment_sum_small(idx, g, n))
    print(f"SM clock by nvidia-smi while K3 loops: {statistics.median(clocks) if clocks else None} MHz")
    for row in rows:
        print(json.dumps(row))


if __name__ == "__main__":
    main()
