"""Where a tile of K4's tensor-core kernels spends its time, by phase.

    python3 localrf_tpu_torch/scripts/march_phases.py

Builds the kernels twice (into build/kernels/): as they ship, and with
-DLRF_MARCH_PHASES, where thread 0 of each block of march_fwd_mma_kernel
and march_bwd_mlp_mma_kernel adds the clock64() ticks between the phase
marks of csrc/march.cu to a device array. On chip_smoke.march_inputs at
G 64, P 4096 x 72 and G 640, P 4096 x 332 (bf16 tables and MLP, line rows
x0 uniform) it prints, for each kernel:

- its device us per launch in both builds (torch.profiler, the mean over
  5 calls after a warm-up; the difference is what the marks cost);
- the SM clock: the slowest block's ticks per call over the instrumented
  kernel's us, and nvidia-smi's clocks.sm sampled while the kernels loop;
- per phase, the ticks of one tile (a block's ticks over its tiles, the
  mean over blocks) and their share of all blocks' ticks; for the phases
  that run tensor-core products, their m16n8k16 MMAs per tile and that
  count per tick. One such MMA per SM per tick is the card's dense bf16
  rate (4,096 FLOP a tick; 989 TFLOP/s over 132 SMs at 1.83 GHz).

The instrumented build must give the same forward out and parameter
gradients, bit for bit, as the shipped one. One JSON line per kernel and
shape at the end. Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[2]
# csrc/march.cu's enum Phase, in order
PHASES = ("setup", "tail", "wait", "features", "fetch", "app", "h1", "h2", "rgb",
          "d_pre3", "d_pre2", "d_pre1", "d_app", "end")
PER_BLOCK = ("setup", "end")  # once per block, not per tile
FWD, BWD = "march_fwd_mma_kernel", "march_bwd_mlp_mma_kernel"
# m16n8k16 MMAs a block (8 warps) runs per tile in the phases bounded by
# barriers; the backward's tail adds dbasis (5 warps x 16) and d_feat (8 x 12)
MMAS = {
    FWD: {"app": 8 * 10, "h1": 8 * 16, "h2": 8 * 64},
    BWD: {"app": 8 * 10, "h1": 8 * 16, "h2": 8 * 64,
          "d_pre2": 8 * 8,             # dw3[:128] += h2^T @ d_pre3m (N padded to 16)
          "d_pre1": 8 * 64 + 8 * 64,   # d_pre2 @ w2^T; dw2 += h1^T @ d_pre2
          "d_app": 8 * 16 + 8 * 16},   # d_pre1 @ w1^T; dw1 += x0m^T @ d_pre1
}
MMAS_PER_TILE = {FWD: 720, BWD: 2240}
PHASE_BLOCKS = 1024  # rows of the device array (kPhaseBlocks)
REPS = 5


def launch_us(fn, name: str) -> float:
    """Device us of one launch of kernel `name`: the mean over the launches
    a torch.profiler trace of REPS calls of fn (after a warm-up call) holds
    (a trace may miss its first kernel)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA and name in e.name()]
    return sum(ns) / len(ns) / 1e3


def sm_clock_mhz(fn, seconds: float = 1.5) -> list[float]:
    """nvidia-smi's clocks.sm, sampled every 100 ms while fn loops."""
    import torch

    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=10)[0]
    return [float(v) for v in out.split()[1:]]  # the first sample may predate the loop


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("march_phases: no CUDA device")
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from localrf_tpu_torch.ops.kernels import _build
    from localrf_tpu_torch.ops.kernels import march as k4

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    cases = []
    for g_rows, s in ((64, 72), (640, 332)):
        args, gout = cs.march_inputs(g_rows, 4096 * s, torch.bfloat16,
                                     torch.Generator(device=dev).manual_seed(1), dev)
        plain = [a.detach() for a in args]
        cases.append((f"G {g_rows}, P {4096 * s}", {
            FWD: lambda plain=plain: k4._launch_fwd(plain, "bfloat16"),
            BWD: lambda plain=plain, gout=gout: k4._launch_bwd(plain, gout, "bfloat16"),
        }))

    def results(calls):  # forward out and the parameter gradients
        return [calls[FWD](), *calls[BWD]()[6:]]

    shipped_us, shipped = {}, {}
    for shape, calls in cases:
        for name, fn in calls.items():
            shipped_us[shape, name] = launch_us(fn, name)
        shipped[shape] = results(calls)

    _build._lib = None
    _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, "-DLRF_MARCH_PHASES")
    lib = _build.library()
    lib.lrf_march_phase_cycles.argtypes = [ctypes.c_void_p]
    lib.lrf_march_phase_cycles.restype = ctypes.c_int
    host = torch.zeros((PHASE_BLOCKS, len(PHASES)), dtype=torch.int64)

    def read_ticks() -> torch.Tensor:
        torch.cuda.synchronize()
        rc = lib.lrf_march_phase_cycles(host.data_ptr())
        if rc:
            raise RuntimeError(f"lrf_march_phase_cycles: CUDA error {rc}")
        return host.clone()

    rows = []
    for shape, calls in cases:
        if not all(torch.equal(a, b) for a, b in zip(results(calls), shipped[shape])):
            raise AssertionError(f"{shape}: the instrumented build computes another result")
        p = int(shape.rsplit(" ", 1)[1])
        n_tiles = (p + 63) // 64
        grid = min(n_tiles, k4._n_blocks(dev))
        tiles = torch.tensor([(n_tiles - b + grid - 1) // grid for b in range(grid)], dtype=torch.float64)
        clocks = sm_clock_mhz(lambda: [fn() for fn in calls.values()])
        for name, fn in calls.items():
            read_ticks()
            us = launch_us(fn, name)
            per_call = read_ticks()[:grid].double() / (REPS + 1)
            block = per_call.sum(dim=1)
            row = {
                "kernel": name, "shape": shape, "us": us, "us_shipped": shipped_us[shape, name],
                "tiles_per_block": float(tiles.mean()),
                "ticks_per_tile": float((block / tiles).mean()),
                "clock_mhz_from_ticks": float(block.max()) / us,
                "clock_mhz_nvidia_smi": statistics.median(clocks) if clocks else None,
                "phases": {},
            }
            row["mmas_per_tick"] = MMAS_PER_TILE[name] / row["ticks_per_tile"]
            for j, phase in enumerate(PHASES):
                col = per_call[:, j]
                if not col.any():
                    continue
                e = {"share": float(col.sum() / block.sum())}
                if phase in PER_BLOCK:
                    e["ticks_per_block"] = float(col.mean())
                else:
                    e["ticks_per_tile"] = float((col / tiles).mean())
                if phase in MMAS[name]:
                    e["mmas_per_tile"] = MMAS[name][phase]
                    e["mmas_per_tick"] = e["mmas_per_tile"] / e["ticks_per_tile"]
                row["phases"][phase] = e
            rows.append(row)
            print(f"{name} {shape}: {us:.1f} us (shipped build {row['us_shipped']:.1f});"
                  f" {row['ticks_per_tile']:.0f} ticks a tile, {row['tiles_per_block']:.2f} tiles a"
                  f" block, {row['mmas_per_tick']:.3f} MMAs a tick; SM clock"
                  f" {row['clock_mhz_from_ticks']:.0f} MHz from ticks, {row['clock_mhz_nvidia_smi']} MHz"
                  " by nvidia-smi")
            for phase, e in row["phases"].items():
                per = "tile" if "ticks_per_tile" in e else "block"
                mma = f"  {e['mmas_per_tile']} MMAs, {e['mmas_per_tick']:.3f} a tick" if "mmas_per_tile" in e else ""
                print(f"  {phase:9s} {e['ticks_per_' + per]:10.1f} ticks a {per:5s}"
                      f" {100 * e['share']:5.1f}%{mma}")
    for row in rows:
        print(json.dumps(row))


if __name__ == "__main__":
    main()
