"""Readings a cell's correctness limits are set from, on the chip at the
cell's own size (no measured window):

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --controls 3 [--first-seed N]

For each of --seeds seeds, the program's numbers against the reference
(the lower readings); for the first --controls of them also the control's
(the reference in float8 where the configuration states bf16: the factor
grids and the shading MLP, e4m3 forward and e5m2 gradients) and, on a training cell, the fault's
(the reference with each step's losses over half of its views). A step
that returns its state unchanged reads 1 on grad_gap and update_gap by
their definition and needs no run. Prints one JSON line per reading and a
summary: each number's largest program reading and least control or fault
reading.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from harness import check, manifest, scene  # noqa: E402
from run import Run  # noqa: E402


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def train_readings(spec: dict, entry, run, control: bool) -> dict:
    state = entry.setup(spec, run)
    n = spec["traffic"]["frames"]
    prog = entry.program_side(state["prog"], state["weights"], n)
    keep = {k: state[k] for k in ("sd", "frames", "weights", "plans")}
    state.clear()
    _free(run.device)
    args = (spec, keep["sd"], keep["frames"], keep["weights"], run.device)
    ref = entry.reference_side(*args, keep["plans"])
    sides = {"program": prog}
    if control:
        sides["control"] = entry.reference_side(*args, precision="fp8")
        sides["half_batch"] = entry.reference_side(*args, fault="half_batch")
    for side, got in sides.items():
        print(json.dumps({"seed": run.seed, "side": side, "detail": check.train_detail(got, ref)}),
              file=sys.stderr)
    return {side: check.train_numbers(got, ref) for side, got in sides.items()}


def eval_readings(spec: dict, entry, run, control: bool) -> dict:
    ks = list(range(1, spec["traffic"]["check_frames"] + 1))
    frames, weights, traj = entry.program_frames(spec, run, ks)
    _free(run.device)
    ref = entry.reference_frames(spec, weights, traj, ks, run.device)
    out = {"program": check.eval_numbers(frames, ref)}
    if control:
        out["control"] = check.eval_numbers(entry.reference_frames(spec, weights, traj, ks, run.device, "fp8"), ref)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    args = ap.parse_args()
    spec = manifest.cell_spec(args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    entry = manifest.entry_module(spec["traffic"]["entry"])
    readings = entry.__name__.endswith("train") and train_readings or eval_readings
    lower, upper = {}, {}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        out = readings(spec, entry, Run(device, seed, 0.0, False), i < args.controls)
        _free(device)
        for side, numbers in out.items():
            print(json.dumps({"seed": seed, "side": side, **{k: v for k, (v, _) in numbers.items()},
                              "where": {k: w for k, (_, w) in numbers.items()}}), flush=True)
            for k, (v, _) in numbers.items():
                if side == "program":
                    lower[k] = max(lower.get(k, 0.0), v)
                else:
                    upper.setdefault(side, {})[k] = min(upper.get(side, {}).get(k, float("inf")), v)
    print(json.dumps({"summary": args.workload, "lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
