"""Every cell of BENCHMARK.json through the one command on a card, briefly:
exit 0, one result line, correct, the cell's end-to-end metrics. Skips
without a CUDA card (decided inside the test)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import ROOT

from harness import manifest

CELLS = [w["name"] for w in manifest.manifest()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    import torch

    spec = manifest.cell_spec(cell)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["entry"]["chips"]:
        pytest.skip("needs CUDA cards")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "4000000007",
                          "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {m["name"] for m in spec["end_to_end"]}
