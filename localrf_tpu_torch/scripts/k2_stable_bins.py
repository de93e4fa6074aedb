"""Could K2 take K5's binning? K2's reduce on K5's stable level-1 bins.

    python3 localrf_tpu_torch/scripts/k2_stable_bins.py

K2 (csrc/segment_sum.cu) and K5 (csrc/segment_sum_merged.cu) both bin the
points by tile of 64 output rows into (id, row within the tile) pairs: K2
with atomics (any order within a tile), K5 stably (each tile's points in
increasing id). For the main path's two plane shapes (64^3: 4,096 rows,
P 4096 x 72; 640^3: 409,600 rows, P 4096 x 332; bf16 payload of 128,
bf16 out), on uniform indices and on the three plane sums of one real
step (chip_smoke.real_plane_indices), the script prints K2's whole time,
the device us of K2's bin kernels and of K5's level-1 kernels (memset,
count, scan, scatter), and K2's zero and reduce kernels timed on its own
bins and on K5's (a CUDA graph of 20 calls replayed, per call). K2's work
list, empty tiles and partial slots come from its own bin kernels in both
runs: they depend on the tile counts alone, which the two binnings share.
The sum over K5's bins is checked against segment_sum_plain (chip_smoke's
K2 tolerance). Prints the card, one line and one JSON line per case. Needs
a CUDA card.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]


def _reduce(sched: dict, g, out, partials, plan, n_rows: int) -> None:
    """K2's zero and reduce kernels over the bin in `sched` (its done
    counters zeroed first, as K2's call does)."""
    import torch

    from localrf_tpu_torch.ops.kernels import _build

    sched["done"].zero_()
    _build.launch(
        "lrf_segment_sum_reduce", g.data_ptr(), 1, 8,
        *(sched[k].data_ptr() for k in ("bin", "starts", "slot_base", "items", "empty", "totals", "done")),
        partials.data_ptr(), out.data_ptr(), int(out.dtype == torch.bfloat16), g.shape[1], n_rows,
        plan.tile_rows, plan.n_tiles, plan.chunk, plan.n_items, _build.stream_ptr(g.device),
    )


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("k2_stable_bins: no CUDA device")
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from localrf_tpu_torch.ops.kernels import binned_scatter as k2
    from localrf_tpu_torch.scripts.kernel_ab import graph_ms, kernel_us

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    ds = cs.make_dataset(cs.W, cs.H, cs.N_FRAMES)
    real = cs.real_plane_indices(dev, ds)
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, n_rows, p in (("64^3", 4096, 4096 * 72), ("640^3", 409_600, 4096 * 332)):
        g = torch.randn(p, 128, generator=gen, device=dev).to(torch.bfloat16)
        cases = [("uniform", torch.randint(0, n_rows, (p,), generator=gen, device=dev))]
        cases += [(f"real step sum {k}", idx) for k, (idx, _) in enumerate(real[label])]
        for kind, idx in cases:
            plan = k2.tile_plan(p, 128, n_rows)
            if k2.merged_plan(p, 128, n_rows).tile_rows != plan.tile_rows:
                raise AssertionError(f"{label}: K2 and K5 tile the rows differently")
            with torch.cuda.device(dev):
                own = k2._bin_cuda(idx, n_rows, plan)
            _, merged = k2._merged_cuda(idx, g, n_rows, torch.bfloat16)
            if not torch.equal(own["starts"], merged["tile_start"]):
                raise AssertionError(f"{label} {kind}: K2's and K5's tile starts differ")
            n = int(own["starts"][-1])
            stable = dict(own, bin=own["bin"].clone())
            stable["bin"][:n] = merged["bins"][:n]
            partials = torch.empty(max(plan.n_slots, 1) * plan.tile_rows * 128, dtype=torch.float32,
                                   device=dev)
            out32 = torch.empty((n_rows, 128), dtype=torch.float32, device=dev)
            _reduce(stable, g, out32, partials, plan, n_rows)
            err = cs._close(out32, k2.segment_sum_plain(idx, g, n_rows), *cs.K2_TOL_F32)
            out = torch.empty((n_rows, 128), dtype=torch.bfloat16, device=dev)
            k2_us = kernel_us(lambda: k2.segment_sum(idx, g, n_rows, torch.bfloat16))
            k5_us = kernel_us(lambda: k2.binned_segment_sum_merged(idx, g, n_rows, torch.bfloat16))
            row = {
                "case": f"{label} {kind}",
                "k2_ms": graph_ms(lambda: k2.segment_sum(idx, g, n_rows, torch.bfloat16)),
                "k2_bin_us": sum(v for k, v in k2_us.items() if "segment_sum_bin" in k),
                "k5_level1_us": sum(v for k, v in k5_us.items() if "merged_reduce" not in k),
                "reduce_own_bins_ms": graph_ms(lambda: _reduce(own, g, out, partials, plan, n_rows)),
                "reduce_k5_bins_ms": graph_ms(lambda: _reduce(stable, g, out, partials, plan, n_rows)),
                "max_err_k5_bins": err, "k2_kernel_us": k2_us, "k5_kernel_us": k5_us,
            }
            print(f"{row['case']:26s} K2 {row['k2_ms']:.4f} ms: bin {row['k2_bin_us']:.1f} us;"
                  f" K5 level 1 {row['k5_level1_us']:.1f} us; K2 zero + reduce on its own bins"
                  f" {row['reduce_own_bins_ms']:.4f} ms, on K5's {row['reduce_k5_bins_ms']:.4f} ms"
                  f" (err {err:.3e})")
            print(json.dumps(row))


if __name__ == "__main__":
    main()
