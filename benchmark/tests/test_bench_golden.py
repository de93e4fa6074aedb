"""Golden values of the benchmark's two configurations on the CPU: the
weights drawn from a seed, the operation and byte counts behind
step_mfu.train, frame_mfu.eval and k2_roofline.train at the cells' shapes,
the TensorfConfig and LocalConfig the program is built with, and the
reference's first three steps and two eval frames at 32^3. Each equals a
literal recorded from the harness (tensors by the sha256 of their bytes,
counts as exact integers), so a change to the harness or to a field
module that moves what a cell reads shows here."""
from __future__ import annotations

import dataclasses
import hashlib
import json

import pytest
import torch
from conftest import BENCH, make_tiny

from harness import flops, manifest, program, scene

CPU = torch.device("cpu")
CONFIGS = ("localrf-default", "tensorf-vm192")


def _hash(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()).hexdigest()[:16]


def _text_hash(x) -> str:
    return hashlib.sha256(repr(x).encode()).hexdigest()[:16]


def _config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


# make_weights(field, widths, 16, 1234567, cpu): {name: (shape, hash)}
WEIGHTS = {
    "localrf-default": {
        "density_plane_0": ((8, 16, 16), "ecb52a9d69e2dd45"),
        "density_line_0": ((8, 16), "17b5a13d0fc46549"),
        "density_plane_1": ((8, 16, 16), "6283c76bffebd92c"),
        "density_line_1": ((8, 16), "9786181c6b6c7e27"),
        "density_plane_2": ((8, 16, 16), "879d5a20c4e4a4c5"),
        "density_line_2": ((8, 16), "7985e46152c52957"),
        "app_plane_0": ((24, 16, 16), "31b4b01d946d917d"),
        "app_line_0": ((24, 16), "85a083ab1f6d7936"),
        "app_plane_1": ((24, 16, 16), "5b2c94fe19025a82"),
        "app_line_1": ((24, 16), "00441dfbbbabb44f"),
        "app_plane_2": ((24, 16, 16), "823a7ee078259d5d"),
        "app_line_2": ((24, 16), "1f28eba90250e762"),
        "basis_mat": ((72, 27), "813c3543506aff4f"),
        "mlp.w1": ((27, 128), "05cc9a60fea3b720"),
        "mlp.b1": ((128,), "f6243bc103db12ef"),
        "mlp.w2": ((128, 128), "802bc37062739415"),
        "mlp.b2": ((128,), "523ac9c3bd27b2e7"),
        "mlp.w3": ((131, 3), "ac534a5bf9d98817"),
        "mlp.b3": ((3,), "15ec7bf0b50732b4"),
    },
    "tensorf-vm192": {
        "density_plane_0": ((16, 16, 16), "6b0f594f8c633c56"),
        "density_line_0": ((16, 16), "f54ca9de8d3464bd"),
        "density_plane_1": ((16, 16, 16), "9b72f369da5108a9"),
        "density_line_1": ((16, 16), "1d90b3429e8afdad"),
        "density_plane_2": ((16, 16, 16), "a865feded7778a93"),
        "density_line_2": ((16, 16), "b832e4463e87c36d"),
        "app_plane_0": ((48, 16, 16), "1981ae09c4d18364"),
        "app_line_0": ((48, 16), "ff86f05c38e34031"),
        "app_plane_1": ((48, 16, 16), "34b50d8717151faa"),
        "app_line_1": ((48, 16), "d2acaaa5524b48fa"),
        "app_plane_2": ((48, 16, 16), "119ce3025b0a8e71"),
        "app_line_2": ((48, 16), "09c2b158a726fdc8"),
        "basis_mat": ((144, 27), "cb9eb8caa0dd8d10"),
        "mlp.w1": ((150, 128), "e53641ae7fb9b5a4"),
        "mlp.b1": ((128,), "e1bcde242628be30"),
        "mlp.w2": ((128, 128), "c490834e42c79a82"),
        "mlp.b2": ((128,), "aca4b5a367f967b4"),
        "mlp.w3": ((128, 3), "9dfb6dfc1517b6bc"),
        "mlp.b3": ((3,), "15ec7bf0b50732b4"),
    },
}

# at the cell's grid, its batch and kept samples
COUNTS = {
    "localrf-default.refine-640": {"point_forward": 46154, "l1_voxel": 54, "n_params": 39405476,
                                   "train_step": 231230790576, "eval_frame": 15323128, "k2_bytes": 1391591424},
    "tensorf-vm192.refine-300": {"point_forward": 83024, "l1_voxel": 102, "n_params": 17377715,
                                 "train_step": 269641454052, "eval_frame": 21254144, "k2_bytes": 1774018560},
}
COUNTS["localrf-default.eval-640"] = COUNTS["localrf-default.refine-640"]

# dataclasses.asdict of program.local_config for localrf-default at 640^3
LOCAL_640 = {
    "fov": 85.6, "n_init_frames": 100, "n_overlap": 30, "WH": (960, 540), "n_iters_per_frame": 600,
    "n_iters_reg": 100, "lr_R_init": 0.005, "lr_t_init": 0.0005, "lr_i_init": 0.0, "lr_exposure_init": 0.001,
    "rf_lr_init": 0.02, "rf_lr_basis": 0.001, "lr_decay_target_ratio": 0.1, "N_voxel_list": {},
    "update_AlphaMask_list": [], "lr_upsample_reset": True, "loss_flow_weight": 1.0, "loss_depth_weight": 0.1,
    "tv_weight_density": 0.0, "tv_weight_app": 0.0, "l1_weight": 0.01, "n_views": 16, "batch_size": 4096,
    "occ_ratio": 0.45, "occ_min": 256, "moment_dtype": "float32", "seed": 20211202,
    "tensorf": {
        "grid_size": (640, 640, 640), "density_n_comp": (8, 8, 8), "app_n_comp": (24, 24, 24), "app_dim": 27,
        "feature_c": 128, "density_shift": -5.0, "distance_scale": 25.0, "ray_march_weight_thres": 0.0001,
        "alpha_mask_thres": 0.0001, "app_top_k": 0, "fast_gather": True, "gather_dtype": "bfloat16",
        "mlp_dtype": "bfloat16", "pallas_composite": True, "line_bwd": "onehot", "matmul_segsum": False,
        "binned_scatter": True, "binned_min_rows": 2000, "fused_plane_gather": False, "fused_fwd_gather": 0,
        "fused_line_gather": False, "occ_m": 0, "occ_probe_ds": 4, "occ_refine": True, "fused_march": False,
        "step_ratio": 0.5, "n_samples_cap": 1000000, "fea2dense_act": "softplus",
        "shading_mode": "MLP_Fea_late_view", "pos_pe": 0, "view_pe": 0, "fea_pe": 0,
        "aabb_lo": (-2.0, -2.0, -2.0), "aabb_hi": (2.0, 2.0, 2.0), "l1_stream_min_vox": 4194304,
    },
}
LOCAL = {
    "localrf-default.refine-640": LOCAL_640,
    "localrf-default.eval-640": LOCAL_640,
    "tensorf-vm192.refine-300": {**LOCAL_640, "tensorf": {
        **LOCAL_640["tensorf"], "grid_size": (300, 300, 300), "density_n_comp": (16, 16, 16),
        "app_n_comp": (48, 48, 48), "shading_mode": "MLP_Fea", "view_pe": 2, "fea_pe": 2}},
}

# the reference's three steps at 32^3 (conftest's tiny train cell, seed
# 2**31 + 77): each step's (rgb, flow, depth, L1, total) losses; hashes of
# the first gradient's tensors, of its norms and of the change's norms
REFERENCE = {
    "localrf-default": {
        "losses": [(0.06282980740070343, 0.13163051009178162, 0.11764100939035416, 0.000819766370113939,
                    0.31292110681533813),
                   (0.06469827145338058, 0.14809495210647583, 0.11717512458562851, 0.0008181597804650664,
                    0.3307865262031555),
                   (0.06378483027219772, 0.09168687462806702, 0.11995553225278854, 0.0008153831586241722,
                    0.2762426435947418)],
        "grad1": "70c328036ea093f9", "grad1_norms": "19ca05084ef330ee", "update": "11202280fae4e24c",
        "frames": ["59951fef867587b5", "3476cf1bd7bf1e0d"],
    },
    "tensorf-vm192": {
        "losses": [(0.0628499761223793, 0.13163051009178162, 0.11772024631500244, 0.0008200645097531378,
                    0.313020795583725),
                   (0.06445131450891495, 0.14809495210647583, 0.11739018559455872, 0.0008174923132173717,
                    0.3307539224624634),
                   (0.06388439983129501, 0.09168587625026703, 0.12069222331047058, 0.0008131293579936028,
                    0.2770756185054779)],
        "grad1": "a48c4e244af890a1", "grad1_norms": "96b0df398b1a5689", "update": "d4086ac74538c7cc",
        "frames": ["e58a7513920d197f", "f427c281de9e96c9"],
    },
}


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_are_the_recorded_draws(name):
    cfg = _config(name)
    w = scene.make_weights(manifest.field_module(cfg), scene.widths(cfg), 16, 1234567, CPU)
    assert list(w) == list(WEIGHTS[name])
    assert {k: (tuple(v.shape), _hash(v)) for k, v in w.items()} == WEIGHTS[name]


@pytest.mark.parametrize("cell", list(COUNTS))
def test_counts_are_the_recorded_integers(cell):
    spec = manifest.cell_spec(cell)
    field, wd, traffic = spec["field"], scene.widths(spec["config"]), spec["traffic"]
    g, m, b = traffic["grid"], traffic["occ_m"], spec["config"]["batch_size"]
    got = {"point_forward": flops.point_forward(field, wd), "l1_voxel": flops.l1_voxel(field, wd),
           "n_params": flops.n_params(field, wd, g), "train_step": flops.train_step(field, wd, g, b, m),
           "eval_frame": flops.eval_frame(field, wd, 1, m), "k2_bytes": flops.k2_bytes(field, wd, g, b, m)}
    assert got == COUNTS[cell]


@pytest.mark.parametrize("cell", list(LOCAL))
def test_program_configs_are_the_recorded_fields(cell):
    """Every recorded field equals; a field the port adds later holds its default."""
    from localrf_tpu_torch.models.local import LocalConfig
    from localrf_tpu_torch.models.tensorf import TensorfConfig

    spec = manifest.cell_spec(cell)
    cfg = program.local_config(spec["config"], spec["traffic"], spec["traffic"]["frames"])
    got = dataclasses.asdict(cfg)
    want = LOCAL[cell]
    defaults = {f.name: f.default for f in dataclasses.fields(LocalConfig)}
    tf_defaults = {f.name: f.default for f in dataclasses.fields(TensorfConfig)}
    assert {k: got[k] for k in want if k != "tensorf"} == {k: v for k, v in want.items() if k != "tensorf"}
    assert {k: got["tensorf"][k] for k in want["tensorf"]} == want["tensorf"]
    assert all(v == defaults[k] for k, v in got.items() if k not in want)
    assert all(v == tf_defaults[k] for k, v in got["tensorf"].items() if k not in want["tensorf"])


def _tiny(tmp_path, name):
    return make_tiny(tmp_path, config=BENCH / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_steps_are_the_recorded_ones(tmp_path, name):
    bench = _tiny(tmp_path, name)
    spec = manifest.cell_spec("tiny.tiny-train", bench)
    entry = manifest.entry_module("train", bench)
    sd = scene.seeds(2**31 + 77)
    traffic = spec["traffic"]
    frames = scene.make_frames(traffic["frames"], *traffic["wh"], sd["frames"], CPU)
    weights = scene.make_weights(spec["field"], scene.widths(spec["config"]), traffic["grid"], sd["weights"], CPU)
    ref = entry.reference_side(spec, sd, frames, weights, CPU)
    want = REFERENCE[name]
    assert [tuple(s.values()) for s in ref["losses"]] == want["losses"]
    assert list(ref["losses"][0]) == ["rgb_loss", "flow_loss", "depth_loss", "l1_loss", "total_loss"]
    grad = hashlib.sha256()
    for k in sorted(ref["grad1_tensors"]):
        grad.update(ref["grad1_tensors"][k].numpy().tobytes())
    assert grad.hexdigest()[:16] == want["grad1"]
    assert _text_hash(sorted(ref["grad1"].items())) == want["grad1_norms"]
    assert _text_hash(sorted(ref["update"].items())) == want["update"]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_frames_are_the_recorded_ones(tmp_path, name):
    bench = _tiny(tmp_path, name)
    spec = manifest.cell_spec("tiny.tiny-eval", bench)
    entry = manifest.entry_module("eval", bench)
    sd = scene.seeds(2**31 + 78)
    weights = scene.make_weights(spec["field"], scene.widths(spec["config"]), spec["traffic"]["grid"],
                                 sd["weights"], CPU)
    traj = scene.trajectory(entry.TRAJECTORY, entry.PATH_SEED)
    frames = entry.reference_frames(spec, weights, traj, [1, 2], CPU)
    assert [_hash(f) for f in frames] == REFERENCE[name]["frames"]
