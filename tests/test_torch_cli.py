"""The port's CLI layer against the JAX package's, on the CPU: the flags
(config.py), the model the CLI builds (train._make_model), the training
loop end to end (train.reconstruction with --device cpu, a resume, the
render-only entry as `python -m localrf_tpu_torch.train`), its frame and
field schedule against JAX's, the renderer (renderer.render: its panels,
metrics, annotate overlay and videos), and the helpers it draws on
(utils/spline.py, utils/vis.py, utils/lpips.py).

Scenes: tests/test_e2e_driver.py::make_scene_dir (40x30, 8 frames, depth
and flow) with that test's flags. Tolerances: the schedule (frame appends,
spawns, blending weights, rf_iter) exactly; the final poses of a JAX and
a port run that share field inits and noise to 1e-5 (measured 3.5e-7), in
f32 tables and MLP: with bf16 ones, jitted JAX on the CPU rounds some lerp
weights to the neighbouring bf16 value (tests/test_torch_eval.py) and ~40
steps carry that to 1.7e-3 in the poses; renderer frames and panels as tests/test_torch_eval.py
(rgb 1e-4; flow and depth panels, which divide by quantiles and MADs of
those renders, 1e-3); smoothed poses and depth colormaps equal; LPIPS rtol
1e-4 against JAX's on the same weights (f32 convolutions in another order).
"""
import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localrf_tpu import config as jconfig
from localrf_tpu import renderer as jrenderer
from localrf_tpu import train as jtrain
from localrf_tpu.data.dataset import SyntheticDataset as JSyntheticDataset
from localrf_tpu.models import local as jlocal
from localrf_tpu.utils import lpips as jlpips
from localrf_tpu.utils import spline as jspline
from localrf_tpu.utils import vis as jvis
from localrf_tpu_torch import config as tconfig
from localrf_tpu_torch import renderer as trenderer
from localrf_tpu_torch import train as ttrain
from localrf_tpu_torch.convert import field_from_jax, lpips_params_from_jax
from localrf_tpu_torch.data.dataset import SyntheticDataset
from localrf_tpu_torch.models import local as tlocal
from localrf_tpu_torch.utils import lpips as tlpips
from localrf_tpu_torch.utils import metrics as tmetrics
from localrf_tpu_torch.utils import spline as tspline
from localrf_tpu_torch.utils import vis as tvis
from test_e2e_driver import H, N_FRAMES, W, make_scene_dir
from test_lpips import _random_state_dicts
from test_torch_eval import two_field_models
from test_torch_local import jax_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_e2e_driver.py's flags
E2E_FLAGS = [
    "--batch_size", "64", "--n_views", "4", "--n_init_frames", "3", "--n_iters_per_frame", "6",
    "--n_iters_reg", "3", "--N_voxel_init", str(14**3), "--N_voxel_final", str(20**3), "--upsamp_list", "4",
    "--update_AlphaMask_list", "5", "--add_frames_every", "3", "--n_overlap", "2", "--n_max_frames", "6",
    "--max_drift", "100", "--test_frame_every", "4", "--fov", "60", "--skip_saving_video",
]


# ------------------------------ flags ------------------------------


def test_flags_and_defaults_match_jax():
    """The same flags with the same defaults as JAX's parser, apart from
    --device (cuda here); JAX's XLA-only flags parse with their defaults."""
    t, j = vars(tconfig.config_parser([])), vars(jconfig.config_parser([]))
    assert t.pop("device") == "cuda" and j.pop("device") == "tpu"
    assert t == j
    assert tconfig.config_parser(["--device", "cpu"]).device == "cpu"
    for flag in ("matmul_precision", "fused_plane_gather", "fused_line_gather", "fused_fwd_gather", "app_top_k"):
        assert flag in tconfig.INERT_FLAGS and flag in t


@pytest.mark.parametrize("cli", [[], ["--batch_size", "1024", "--fov", "70"]])
def test_config_files_parse_the_same(tmp_path, cli):
    """A --config file (comments, `key = value`, lists in brackets, bare
    flags) gives the same arguments in both packages; the CLI wins."""
    cfgfile = tmp_path / "scene.txt"
    cfgfile.write_text("# a comment\ndatadir = /data/forest1\nfov = 59\nbatch_size = 2048\n"
                       "upsamp_list = [100, 150, 200]\nn_lamb_sigma = [4, 4, 4]\nline_bwd = segsum\n"
                       "skip_saving_video\nlr_init = 0.01  # trailing comment\n")
    argv = ["--config", str(cfgfile), *cli]
    t, j = vars(tconfig.config_parser(argv)), vars(jconfig.config_parser(argv))
    t.pop("device"), j.pop("device")
    assert t == j
    assert t["upsamp_list"] == [100, 150, 200] and t["skip_saving_video"] is True
    assert t["batch_size"] == (1024 if cli else 2048)


def test_every_flag_consumed_or_documented_inert():
    """Every parsed flag is read somewhere in the port or listed in
    config.INERT_FLAGS with a reason (tests/test_config.py's check, on the
    port's sources)."""
    src = ""
    for root, _, files in os.walk(os.path.join(REPO, "localrf_tpu_torch")):
        for f in files:
            if f.endswith(".py") and not (root.endswith("localrf_tpu_torch") and f == "config.py"):
                src += open(os.path.join(root, f)).read()
    missing = [flag for flag in vars(tconfig.config_parser([]))
               if not re.search(rf"args\.{flag}\b|getattr\(args, \"{flag}\"", src) and flag not in tconfig.INERT_FLAGS]
    assert not missing, f"flags parsed but never consumed nor documented: {missing}"
    assert all(isinstance(v, str) and v for v in tconfig.INERT_FLAGS.values())


class _FakeDS:
    scene_bbox = np.array([[-2.0, -2.0, -2.0], [2.0, 2.0, 2.0]])
    num_images = 5
    img_wh = (8, 6)
    rel_poses = None
    transforms = None


MAKE_MODEL_CASES = {
    "defaults": [],
    "flags": ["--nSamples", "17", "--use_pallas", "0", "--line_bwd", "segsum", "--fused_march", "1",
              "--moment_dtype", "bfloat16", "--gather_dtype", "float32", "--upsamp_list", "3", "7",
              "--N_voxel_final", str(40**3), "--n_init_frames", "9", "--binned_scatter", "0", "--occ_probe_ds", "0",
              "--refinement_speedup_factor", "2", "--app_top_k", "0", "--seed", "5", "--lr_upsample_reset", "0"],
}


@pytest.mark.parametrize("case", list(MAKE_MODEL_CASES))
def test_make_model_builds_jax_config(case, capsys):
    """_make_model builds the LocalConfig JAX's builds from the same
    arguments (dataclasses.asdict; the port's TensorfConfig adds
    l1_stream_min_vox), on --device; an XLA gather flag changes nothing and
    says so."""
    argv = ["--N_voxel_init", str(16**3), *MAKE_MODEL_CASES[case], "--device", "cpu"]
    jm = jtrain._make_model(jconfig.config_parser(argv), _FakeDS())
    tm = ttrain._make_model(tconfig.config_parser(argv + ["--fused_plane_gather", "1"]), _FakeDS())
    got, want = dataclasses.asdict(tm.cfg), dataclasses.asdict(jm.cfg)
    got["tensorf"].pop("l1_stream_min_vox")
    assert got == want
    assert tm.device == torch.device("cpu") and tm.fields[-1]["params"]["basis_mat"].device.type == "cpu"
    assert "--fused_plane_gather=1 has no effect" in capsys.readouterr().out


def test_data_parallel_trains_on_one_card_or_raises():
    """--data_parallel 0 resolves to the launch's world size (a plain launch:
    one rank, no mesh); above it the run raises, naming the
    torch.distributed.run command, instead of training on fewer ranks."""
    assert ttrain._data_parallel(tconfig.config_parser(["--device", "cpu", "--data_parallel", "0"])) is None
    assert ttrain._data_parallel(tconfig.config_parser(["--device", "cpu", "--data_parallel", "1"])) is None
    with pytest.raises(ValueError, match="torch.distributed.run --nproc_per_node 2"):
        ttrain._data_parallel(tconfig.config_parser(["--device", "cpu", "--data_parallel", "2"]))


# ------------------------------ reconstruction ------------------------------


def _pngs(folder: str) -> dict:
    return {p: open(os.path.join(folder, p), "rb").read() for p in sorted(os.listdir(folder)) if p.endswith(".png")}


def test_reconstruction_resume_and_render_only(tmp_path, monkeypatch):
    """reconstruction on the CPU writes the JAX CLI's outputs (checkpoints,
    the tmp checkpoint of a mid-run eval, transforms.json with every frame
    and the frame size, transforms_rf.json, test renders, the smoothed
    path); --resume 1 continues from checkpoints_tmp.th with the dataset
    window it saved and trains to the end; `python -m
    localrf_tpu_torch.train --render_only 1` renders the final checkpoint's
    test frames into the same PNG bytes as the run's own."""
    scene, log = str(tmp_path / "scene"), str(tmp_path / "log")
    make_scene_dir(scene)
    argv = ["--datadir", scene, "--logdir", log, *E2E_FLAGS, "--vis_every", "10", "--scan_chunk", "4",
            "--pixel_pool", "1", "--device", "cpu"]
    model, metrics = ttrain.reconstruction(tconfig.config_parser(argv))
    for name in ("checkpoints.th", "checkpoints_tmp.th", "transforms.json", "transforms_rf.json"):
        assert os.path.isfile(f"{log}/{name}"), name
    with open(f"{log}/transforms.json") as f:
        tr = json.load(f)
    assert len(tr["frames"]) == model.n_frames == N_FRAMES and (tr["w"], tr["h"]) == (W, H)
    assert len(model.fields) >= 2  # the run spawned a field
    pngs = _pngs(f"{log}/test/rgb_maps")
    assert any(not p.endswith("_pose.png") for p in pngs)
    assert os.path.isfile(f"{log}/smooth_spline/transforms.json") and os.listdir(f"{log}/smooth_spline/rgb_maps")
    assert metrics and all(np.isfinite(m["mse"]) and m["lpips_backbone"] == "random-init" for m in metrics.values())

    seen = {}
    load = ttrain.load_checkpoint

    def load_and_note(path, **kw):
        m, extra = load(path, **kw)
        seen.update(path=path, extra=extra)
        return m, extra

    class NotingPool(ttrain.DevicePixelPool):
        def __init__(self, ds, capacity, device):
            seen["bounds"] = tuple(ds.active_frames_bounds)
            super().__init__(ds, capacity, device=device)

    monkeypatch.setattr(ttrain, "load_checkpoint", load_and_note)
    monkeypatch.setattr(ttrain, "DevicePixelPool", NotingPool)
    resumed, _ = ttrain.reconstruction(tconfig.config_parser(argv + ["--resume", "1"]))
    assert seen["path"].endswith("checkpoints_tmp.th") and seen["extra"]["iteration"] > 0
    assert seen["bounds"] == tuple(seen["extra"]["active_bounds"])
    assert resumed.n_frames == N_FRAMES

    pngs = _pngs(f"{log}/test/rgb_maps")
    for p in pngs:
        os.remove(f"{log}/test/rgb_maps/{p}")
    run = subprocess.run([sys.executable, "-m", "localrf_tpu_torch.train", *argv, "--render_only", "1",
                          "--render_path", "0"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert _pngs(f"{log}/test/rgb_maps") == pngs


def _record_jax(monkeypatch, events: list, inits: list, keys: list):
    """JAX's run: field inits, step keys, and frame / field events by step."""
    next_key, init = jlocal.LocalTensorfs._next_key, jlocal.init_tensorf

    def key(self):
        k = next_key(self)
        keys.append(k)
        return k

    def init_tensorf(k, cfg):
        keys.pop()  # that key made the field, not a step's noise
        params = init(k, cfg)
        inits.append(jax.device_get(params))
        return params

    monkeypatch.setattr(jlocal.LocalTensorfs, "_next_key", key)
    monkeypatch.setattr(jlocal, "init_tensorf", init_tensorf)
    _count_events(monkeypatch, jlocal.LocalTensorfs, events)


def _count_events(monkeypatch, cls, events: list):
    steps = [0]
    for name in ("optimizer_step", "optimizer_step_poses_only"):
        def counted(self, *a, _f=getattr(cls, name), **kw):
            steps[0] += 1
            return _f(self, *a, **kw)
        monkeypatch.setattr(cls, name, counted)
    for name in ("append_frame", "append_rf"):
        def noted(self, *a, _f=getattr(cls, name), _n=name, **kw):
            events.append((_n, steps[0]))
            return _f(self, *a, **kw)
        monkeypatch.setattr(cls, name, noted)


def test_schedule_matches_jax(tmp_path, monkeypatch):
    """A JAX and a port reconstruction of the same scene step by step
    (--scan_chunk 1), the port's fields initialized with JAX's draws and its
    steps fed JAX's noise, one device each, f32 tables and MLP: frames are
    appended and fields spawned after the same steps, the blending weights,
    rf_iter and pose links are equal, and the final poses agree."""
    scene = str(tmp_path / "scene")
    make_scene_dir(scene)
    flags = ["--datadir", scene, *E2E_FLAGS, "--vis_every", "1000", "--scan_chunk", "1", "--render_test", "0",
             "--render_path", "0", "--data_parallel", "1", "--gather_dtype", "float32", "--mlp_dtype", "float32"]
    j_events, inits, keys = [], [], []
    with monkeypatch.context() as mp:
        _record_jax(mp, j_events, inits, keys)
        jm, _ = jtrain.reconstruction(jconfig.config_parser(flags + ["--logdir", str(tmp_path / "jax")]))
    t_events = []

    def noise(self, cfg):
        return jax_noise(keys.pop(0), cfg.n_samples)

    monkeypatch.setattr(tlocal.LocalTensorfs, "_next_noise", noise)
    monkeypatch.setattr(tlocal, "init_tensorf", lambda cfg, gen, device: field_from_jax(inits.pop(0), device))
    _count_events(monkeypatch, tlocal.LocalTensorfs, t_events)
    tm, _ = ttrain.reconstruction(tconfig.config_parser(flags + ["--logdir", str(tmp_path / "port"),
                                                               "--device", "cpu"]))
    assert not keys and not inits  # the port drew exactly JAX's
    assert t_events == j_events
    assert [n for n, _ in t_events].count("append_rf") >= 2  # the first field and at least one spawn
    np.testing.assert_array_equal(tm.blending_weights, jm.blending_weights)
    assert tm.rf_iter == jm.rf_iter and tm.pose_linked_rf == jm.pose_linked_rf
    np.testing.assert_allclose(tm.get_cam2world(), jm.get_cam2world(), rtol=0, atol=1e-5)


# ------------------------------ the renderer ------------------------------


def _test_split(n=7):
    """Train and test SyntheticDatasets (both packages' classes) with depth
    and flow, every 4th frame a test frame."""
    rng = np.random.default_rng(4)
    shape = (n, H, W)
    kw = dict(invdepths=0.1 + 0.9 * rng.random(shape, dtype=np.float32),
              fwd_flow=rng.normal(0, 1, (*shape, 2)).astype(np.float32), fwd_mask=np.ones(shape, np.float32),
              bwd_flow=rng.normal(0, 1, (*shape, 2)).astype(np.float32), bwd_mask=np.ones(shape, np.float32),
              n_init_frames=n, test_frame_every=4)
    rgbs = rng.random((*shape, 3), dtype=np.float32)
    return [(cls(rgbs, "train", **kw), cls(rgbs, "test", **kw)) for cls in (JSyntheticDataset, SyntheticDataset)]


class _Args:
    batch_size = 512


def test_render_test_frames_and_panels_match_jax(tmp_path):
    """render(test=True) over two fields: the frames, ground truths, flow
    and depth comparison panels and the MSE / SSIM metrics equal JAX's
    render on the same model; both write the same files."""
    jm, tm = two_field_models()
    (j_train, j_test), (t_train, t_test) = _test_split()
    kw = dict(w=W, h=H, save_frames=True, test=True, img_format="png")
    out_j = jrenderer.render(j_test, jm.get_cam2world(), jm, _Args(), train_dataset=j_train,
                             save_path=str(tmp_path / "j"), **kw)
    out_t = trenderer.render(t_test, tm.get_cam2world(), tm, _Args(), train_dataset=t_train,
                             save_path=str(tmp_path / "t"), **kw)
    names = ("rgb", "depth", "gt", "fwd", "bwd", "depth_cmp")
    for name, a, b in zip(names, out_t[:6], out_j[:6]):
        assert len(a) == len(b) == 2, name
        for x, y in zip(a, b):
            assert x.shape == np.asarray(y).shape, name
            if name == "rgb" or name == "gt":
                np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-4, err_msg=name)
            elif name != "depth":
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-3, err_msg=name)
    assert sorted(out_t[6]) == sorted(out_j[6])
    for fb, m in out_j[6].items():
        np.testing.assert_allclose(out_t[6][fb]["mse"], m["mse"], rtol=1e-4)
        np.testing.assert_allclose(out_t[6][fb]["ssim"], m["ssim"], atol=1e-4)
        assert out_t[6][fb]["lpips_backbone"] == m["lpips_backbone"] == "random-init"
        assert np.isfinite(out_t[6][fb]["lpips_randinit"])
    for sub in ("rgb_maps", "depth_maps"):
        assert sorted(os.listdir(tmp_path / "t" / sub)) == sorted(os.listdir(tmp_path / "j" / sub))
    assert "_dev_cache" not in tm.fields[0]  # render clears the eval cache


def test_renderer_annotate(tmp_path):
    """The annotate overlay path runs and writes frames, and eval logs the
    metric triple: LPIPS finite, labelled with its backbone, under a
    distinct key for the random one (the port of tests/test_e2e_driver.py's
    test)."""
    rng = np.random.default_rng(2)
    rgbs = rng.uniform(0, 1, (6, H, W, 3)).astype(np.float32)
    train_ds = SyntheticDataset(rgbs, "train", n_init_frames=6, test_frame_every=4)
    test_ds = SyntheticDataset(rgbs, "test", n_init_frames=6, test_frame_every=4)
    cfg = tlocal.LocalConfig(fov=60.0, n_init_frames=6, WH=(W, H), n_views=4, batch_size=64,
                             tensorf=ttrain.TensorfConfig(grid_size=(12, 12, 12)),
                             loss_flow_weight=0.0, loss_depth_weight=0.0)
    model = tlocal.LocalTensorfs(cfg, device="cpu")

    class A:
        batch_size = W * H

    out = trenderer.render(test_ds, model.get_cam2world(), model, A(), w=W, h=H, save_path=str(tmp_path),
                           save_frames=True, test=True, train_dataset=train_ds, img_format="png", annotate=True)
    metrics = out[-1]
    assert len(metrics) >= 1
    for m in metrics.values():
        assert np.isfinite(m["mse"]) and np.isfinite(m["ssim"])
        assert m["lpips_backbone"] in ("pretrained", "random-init")
        assert np.isfinite(m["lpips" if m["lpips_backbone"] == "pretrained" else "lpips_randinit"])
    assert os.path.isdir(f"{tmp_path}/rgb_maps")


def test_path_render_writes_videos_or_says_why(tmp_path, monkeypatch, capsys):
    """A path render (test=False) writes mp4 videos through cv2's writer;
    where no writer opens, it prints JAX's "mp4 export skipped" line and
    still writes every frame."""
    _, tm = two_field_models()
    (_, _), (t_train, t_test) = _test_split()
    poses = tspline.smooth_poses_spline(tm.get_cam2world())
    kw = dict(w=W, h=H, train_dataset=t_train, save_frames=True, save_video=True, add_frame_to_list=False)
    trenderer.render(t_test, poses, tm, _Args(), save_path=str(tmp_path / "a"), **kw)
    for name in ("video", "posevideo", "depthvideo"):
        assert os.path.getsize(tmp_path / "a" / f"{name}.mp4") > 0
    import cv2

    class Closed:
        def __init__(self, *a):
            pass

        def isOpened(self):
            return False

    monkeypatch.setattr(cv2, "VideoWriter", Closed)
    trenderer.render(t_test, poses, tm, _Args(), save_path=str(tmp_path / "b"), **kw)
    said = capsys.readouterr().out
    assert said.count("mp4 export skipped") == 3
    assert len(os.listdir(tmp_path / "b" / "rgb_maps")) == 2 * len(poses)


# ------------------------------ helpers ------------------------------


@pytest.mark.parametrize("n", [12, 40])
def test_smooth_poses_spline_matches_jax(n):
    """The port's copy of the spline smoother equals JAX's (with and
    without the median prefilter, which starts at 30 frames)."""
    rng = np.random.default_rng(n)
    poses = np.concatenate([np.eye(3, dtype=np.float32)[None].repeat(n, 0),
                            np.cumsum(rng.normal(0, 0.05, (n, 3, 1)), 0).astype(np.float32)], -1)
    poses[:, :3, :3] += 0.02 * rng.normal(size=(n, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(tspline.smooth_poses_spline(poses), jspline.smooth_poses_spline(poses))


def test_vis_matches_jax():
    """visualize_depth (tensor or array, given or computed range), to_uint8
    and get_camera_mesh equal JAX's; draw_poses (cv2 here, matplotlib there)
    draws the wireframes in their colours."""
    rng = np.random.default_rng(0)
    depth = rng.uniform(0, 6, (H, W)).astype(np.float32)
    depth[0, 0] = 0
    for minmax in ([0, 5], None):
        got, mm = tvis.visualize_depth(torch.from_numpy(depth), minmax)
        want, mm_j = jvis.visualize_depth(depth, minmax)
        np.testing.assert_array_equal(got, want)
        assert mm == mm_j
    img = rng.uniform(-0.1, 1.1, (H, W, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvis.to_uint8(torch.from_numpy(img)), jvis.to_uint8(img))
    poses = np.concatenate([np.eye(3, dtype=np.float32)[None].repeat(5, 0),
                            rng.normal(0, 0.3, (5, 3, 1)).astype(np.float32)], -1)
    for a, b in zip(tvis.get_camera_mesh(poses, 0.05), jvis.get_camera_mesh(poses, 0.05)):
        np.testing.assert_array_equal(a, b)
    drawn = tvis.draw_poses(poses, ["C1"] * 4 + ["C2"])
    assert drawn.shape == (480, 640, 3) and drawn.dtype == np.uint8
    colours = {tuple(c) for c in drawn.reshape(-1, 3)}
    assert (255, 127, 14) in colours and (44, 160, 44) in colours  # C1 and C2


def test_flow_codec_matches_jax():
    """The port's encode_flow (which chip_smoke writes its scene with)
    equals JAX's, out-of-range flows masked, and decodes back."""
    from localrf_tpu.data import flow_io as jflow
    from localrf_tpu_torch.data import flow_io as tflow

    rng = np.random.default_rng(2)
    flow = rng.normal(0, 40, (H, W, 2)).astype(np.float32)
    flow[0, 0] = 200.0  # beyond the codec's range
    mask = rng.random((H, W)) > 0.2
    enc = tflow.encode_flow(flow, mask)
    np.testing.assert_array_equal(enc, jflow.encode_flow(flow, mask))
    dec, dec_mask = tflow.decode_flow(enc)
    assert dec_mask[0, 0] == 0 and dec_mask.sum() < mask.sum()
    keep = dec_mask > 0
    np.testing.assert_allclose(dec[keep], flow[keep], atol=2**-8)


def test_cam2cams_match_jax():
    rng = np.random.default_rng(1)
    c2w = np.concatenate([np.linalg.qr(rng.normal(size=(6, 3, 3)))[0],
                          rng.normal(size=(6, 3, 1))], -1).astype(np.float32)
    idx = np.array([0, 2, 5])
    from localrf_tpu.ops import math as jmath
    from localrf_tpu_torch.ops import math as tmath

    for got, want in zip(tmath.get_fwd_bwd_cam2cams(torch.from_numpy(c2w), torch.from_numpy(idx)),
                         jmath.get_fwd_bwd_cam2cams(jnp.asarray(c2w), jnp.asarray(idx))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


LPIPS_SHAPES = {"64x80": (64, 80), "under 32 px": (20, 28)}


@pytest.mark.parametrize("shape", list(LPIPS_SHAPES))
@pytest.mark.parametrize("weights", ["init_params", "load_torch_state"])
def test_lpips_matches_jax(shape, weights):
    """LPIPS of the port on JAX's weights (JAX's init_params(0) converted
    with lpips_params_from_jax, or one synthesized official state dict fed
    to both packages' load_torch_state) equals JAX's, also on images under
    32 px (bilinear upscale as jax.image.resize)."""
    if weights == "init_params":
        jp = jlpips.init_params(0)
        tp = lpips_params_from_jax(jax.device_get(jp), device="cpu")
    else:
        alex, lin = _random_state_dicts(seed=5)
        jp, tp = jlpips.load_torch_state(alex, lin), tlpips.load_torch_state(alex, lin, device="cpu")
    rng = np.random.default_rng(7)
    a = rng.uniform(0, 1, (*LPIPS_SHAPES[shape], 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    want = jlpips.lpips(jp, a, b)
    got = tlpips.lpips(tp, torch.from_numpy(a), b)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got > 0 and tlpips.lpips(tp, a, a) < 1e-6


def test_lpips_upscale_is_jax_resize():
    """The under-32 px upscale equals jax.image.resize(..., "bilinear")."""
    import torch.nn.functional as F

    img = np.random.default_rng(3).uniform(0, 1, (20, 28, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (32, 45, 3), "bilinear"))
    got = F.interpolate(torch.from_numpy(img).permute(2, 0, 1)[None], size=(32, 45), mode="bilinear",
                        align_corners=False, antialias=False)[0].permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_lpips_backbone_and_weights_file(tmp_path, monkeypatch):
    """Without a weights file: the seeded random backbone, reported as
    "random-init"; with one (the combined .npz JAX reads): "pretrained",
    and LPIPS on those weights equals JAX's."""
    monkeypatch.setattr(tlpips, "_CACHED", {})
    monkeypatch.delenv(tlpips.WEIGHTS_ENV, raising=False)
    assert tmetrics.lpips_backbone() == "random-init" and not tlpips.has_pretrained()
    rng = np.random.default_rng(8)
    a, b = (rng.uniform(0, 1, (40, 48, 3)).astype(np.float32) for _ in range(2))
    assert np.isfinite(tmetrics.rgb_lpips(a, b))
    alex, lin = _random_state_dicts(seed=9)
    jp = jlpips.load_torch_state(alex, lin)
    path = tmp_path / "lpips_alex.npz"
    np.savez(path, **{f"conv{i}_{k}": np.asarray(jp["convs"][i][k]) for i in range(5) for k in ("w", "b")},
             **{f"lin{i}": np.asarray(jp["lins"][i]) for i in range(5)})
    monkeypatch.setattr(tlpips, "_CACHED", {})
    monkeypatch.setenv(tlpips.WEIGHTS_ENV, str(path))
    assert tmetrics.lpips_backbone() == "pretrained"
    np.testing.assert_allclose(tmetrics.rgb_lpips(a, b), jlpips.lpips(jp, a, b), rtol=1e-4)
