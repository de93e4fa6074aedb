"""A tiny copy of the benchmark for CPU tests: the repository's benchmark
folder and BENCHMARK.json copied under a temporary directory, with one
configuration (`tiny`: LocalRF's widths, or another configuration file's,
at 32^3, 256 rays over 4 views)
and two cells (`tiny.tiny-train`, `tiny.tiny-eval`: 40x30 frames, 16 kept
samples a ray) added as new files and entries, as a later change adds
them. Their limits are set as the real cells' are (PERF.md), from the
program, the fp8 control and the half-batch fault on the CPU at this size
(deterministic there; program the largest of 4 seeds, control and fault
the least of 3): `loss_gap` 8.9e-6, control 4.9e-5; `grad_gap` 2.5e-3,
fault 0.62; `update_gap` 4.0e-3, fault 0.052; `grad_elem_gap` 1.5e-2,
control 9.1e-2; eval (3 seeds, control 2) `rgb_max_gap` 1.7e-4, control
1.6e-3; `rgb_mean_gap` 4.1e-5, control 2.9e-4."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_LIMITS = {
    "tiny-train": {"loss_gap": 2.5e-5, "grad_gap": 0.04, "update_gap": 0.02, "grad_elem_gap": 4e-2},
    "tiny-eval": {"rgb_max_gap": 5e-4, "rgb_mean_gap": 1e-4},
}


def make_tiny(root: Path, config_overrides: dict | None = None,
              config: Path = BENCH / "configs" / "localrf-default.json") -> Path:
    """The tiny copy under `root`, its configuration `tiny` cut from the
    file `config`, then `config_overrides`; returns its benchmark folder."""
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads(config.read_text())
    cfg.update(N_voxel_final=32**3, batch_size=256, n_views=4, n_max_frames=4, n_overlap=2,
               **(config_overrides or {}))
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    small = dict(wh=[40, 30], frames=6, grid=32, occ_min=8, occ_m=16)
    train = json.loads((BENCH / "traffic" / "refine-640.json").read_text())
    train.update(small, pool_slots=22, chunk=4, trace_units=2)
    evals = json.loads((BENCH / "traffic" / "eval-640.json").read_text())
    evals.update(small, trace_units=1)
    man["configs"].append({"name": "tiny", "source": "https://github.com/facebookresearch/localrf",
                           "file": "benchmark/configs/tiny.json", "reduced": ["N_voxel_final"], "why": "CPU tests"})
    for traffic, body in (("tiny-train", train), ("tiny-eval", evals)):
        (bench / "traffic" / f"{traffic}.json").write_text(json.dumps(body))
        cell = {"config": "tiny", "traffic": traffic, "chips": 1, "limits": TINY_LIMITS[traffic]}
        (bench / "workloads" / f"tiny.{traffic}.json").write_text(json.dumps(cell))
        man["workloads"].append({"name": f"tiny.{traffic}", "config": "tiny", "traffic": traffic, "chips": 1,
                                 "why": "CPU tests"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            kind = "eval" if any(w.endswith("eval-640") for w in m["workloads"]) else "train"
            m["workloads"].append(f"tiny.tiny-{kind}")
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return bench


@pytest.fixture
def tiny(tmp_path) -> Path:
    return make_tiny(tmp_path)


def run_tiny(bench: Path, cell: str, seed: int = 1234567, seconds: float = 0.3, trace: bool = False) -> dict:
    """One run of a tiny cell on the CPU (run.run_cell: everything but the
    look for a card)."""
    import torch

    import run as runner
    from harness import manifest

    return runner.run_cell(manifest.cell_spec(cell, bench), seed, seconds, trace, torch.device("cpu"))
