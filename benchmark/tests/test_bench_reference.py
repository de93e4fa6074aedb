"""The plain f32 reference against localrf_tpu_torch on the CPU, at a tiny
grid with f32 factor tables and MLP, where the two compute the same
function: a training step's losses, gradients and Adam updates (three
steps through plan_chunk -> run_chunk), and eval frames through
forward_eval. They agree to f32 round-off (sums in other orders: seen
1e-7 to 8e-7); the tolerances below are 1e-5."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from conftest import make_tiny, run_tiny

from harness import manifest, scene
from reference.step import noise_draws, sampled_batches

F32 = {"gather_dtype": "float32", "mlp_dtype": "float32"}
TOL = 1e-5


@pytest.fixture
def tiny32(tmp_path):
    bench = make_tiny(tmp_path, F32)
    for cell in ("tiny.tiny-train", "tiny.tiny-eval"):
        path = bench / "workloads" / f"{cell}.json"
        body = json.loads(path.read_text())
        body["limits"] = {k: TOL for k in body["limits"]}
        path.write_text(json.dumps(body))
    return bench


@pytest.mark.parametrize("seed", [7, 2**31 + 11])
def test_training_steps_match_the_port_in_f32(tiny32, seed):
    res = run_tiny(tiny32, "tiny.tiny-train", seed=seed)
    assert res["correct"], res["checks"]
    assert all(row["value"] <= TOL for row in res["checks"].values())


@pytest.mark.parametrize("seed", [8, 2**31 + 12])
def test_eval_frames_match_the_port_in_f32(tiny32, seed):
    res = run_tiny(tiny32, "tiny.tiny-eval", seed=seed)
    assert res["correct"], res["checks"]


def test_sampler_and_jitter_are_the_ports_draws():
    from localrf_tpu_torch.data.dataset import SyntheticDataset
    from localrf_tpu_torch.models.render import draw_noise

    frames = scene.make_frames(5, 12, 8, 3, torch.device("cpu"))
    ds = SyntheticDataset(frames["rgbs"], "train", invdepths=frames["invdepths"], n_init_frames=5,
                          test_frame_every=0)
    ds._rng = np.random.default_rng(99)
    ours = sampled_batches(99, 3, 5, 96, 4, 32)
    for views, px in ours:
        b = ds.sample(32, True, True, n_views=4, values=False)
        assert not b["train_test_poses"]
        assert np.array_equal(b["view_ids"], views)
        assert np.array_equal(b["idx"], (px + views[:, None] * 96).reshape(-1))
    gen = torch.Generator().manual_seed(5)
    for mine in noise_draws(5, 3, 738, torch.device("cpu")):
        theirs = draw_noise(738, gen, torch.device("cpu"))
        assert all(torch.equal(mine[k], theirs[k]) for k in mine)


def test_specs_of_the_real_cells_match_what_the_reference_derives():
    from reference.render import compacted_samples, n_samples

    for name, grid, samples, kept in (("localrf-default.refine-640", 640, 2214, 332),
                                      ("tensorf-vm192.refine-300", 300, 1036, 256),
                                      ("localrf-default.eval-640", 640, 2214, 332)):
        spec = manifest.cell_spec(name)
        assert spec["traffic"]["grid"] == grid and spec["traffic"]["occ_m"] == kept
        assert n_samples(grid) == samples and compacted_samples(grid) == kept
        assert spec["config"]["N_voxel_final"] == grid**3
