"""The TensoRF-CP field of the port (`TensorfConfig(decomposition="cp")`)
against the benchmark's plain reference of it, `benchmark/reference/cp.py`
(loaded by path: the one CP reference of the benchmark and of these
tests), on the CPU at 24^3-32^3 with ranks [6] / [18] and seeded weights.

Tolerances: with f32 tables the port's quad-line lerps and products are
the reference's F.grid_sample lookups and products in another order, so
the features agree to 1e-5 relative (of the largest magnitude). With bf16
tables each line value, lerp weight, lerp and product is rounded to bf16
(8 bits: a relative 2^-9 each), about eight roundings on the path of one
component's product, so each feature agrees to 8 * 2^-9 of the sum of its
terms' bounds (sum_c of the product of the three lines' magnitudes read at
the point, and |basis| times that for the appearance: a lerp's rounding
scales with its inputs), the bound of a sum of terms each off by that
share.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from localrf_tpu_torch import config as tconfig
from localrf_tpu_torch import train as ttrain
from localrf_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from localrf_tpu_torch.models import tensorf as ttf
from localrf_tpu_torch.models.local import LocalConfig, LocalTensorfs
from localrf_tpu_torch.ops.kernels import segsum as k3
from localrf_tpu_torch.ops.kernels.march import fused_march_supported
from localrf_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
BENCH = REPO / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference import cp as ref_cp  # noqa: E402
from reference.field import rounder  # noqa: E402

SEEDS = (0, 1, 2)
RANKS = {"density_n_comp": (6,), "app_n_comp": (18,)}


def _cfg(g: int = 24, **kw) -> ttf.TensorfConfig:
    return ttf.TensorfConfig(grid_size=(g, g, g), decomposition="cp", shading_mode="MLP_Fea", fea_pe=2,
                             view_pe=2, **RANKS, **kw)


def _field(cfg: ttf.TensorfConfig, seed: int) -> ttf.TensorfField:
    return ttf.init_tensorf(cfg, torch.Generator().manual_seed(seed), "cpu")


def _points(seed: int, n: int = 3000) -> torch.Tensor:
    """Normalized points in [-1, 1]^3, a few on and past the border."""
    pts = 2.2 * torch.rand((n, 3), generator=torch.Generator().manual_seed(100 + seed)) - 1.1
    return pts


def _bench_conftest():
    """benchmark/tests/conftest.py (its tiny benchmark copy), by path."""
    spec = importlib.util.spec_from_file_location("bench_conftest", BENCH / "tests" / "conftest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _terms(field, pts, kind: str) -> torch.Tensor:
    """[P, R] bounds of the kind's per-component products: the products of
    the lines' magnitudes read at the points (a lerp's rounding error
    scales with its two inputs, not with its value)."""
    out = 1.0
    for i, axis in enumerate(ref_cp.LINE_AXIS):
        out = out * ref_cp.line_lookup(field[f"{kind}_line_{i}"].detach().abs(), pts[:, axis])
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype,line_bwd", [("float32", "onehot"), ("float32", "segsum"), ("bfloat16", "segsum")])
def test_features_match_the_reference(seed, dtype, line_bwd):
    cfg = _cfg(gather_dtype=dtype, line_bwd=line_bwd)
    field = _field(cfg, seed)
    pts = _points(seed)
    params = {k: v.detach() for k, v in field.named_parameters()}
    want_sigma, want_app = ref_cp.features(params, pts, rounder("f32"))
    sigma, app = ttf.compute_density_app_features(field, pts, cfg, ttf.build_combined_quad_views(field, cfg))
    assert sigma.dtype == app.dtype == torch.float32 and app.shape == (pts.shape[0], 27)
    if dtype == "float32":
        for got, want in ((sigma, want_sigma), (app, want_app)):
            torch.testing.assert_close(got.detach(), want, rtol=0.0, atol=1e-5 * float(want.abs().max()))
        # the density-only quad views (the alpha volume's) and the grid-sample route
        dens = ttf.compute_density_feature(field, pts, cfg, ttf.build_quad_views(field, cfg, kinds=("density",)))
        grid = ttf.compute_density_feature(field, pts, cfg)
        for got in (dens, grid):
            torch.testing.assert_close(got.detach(), want_sigma, rtol=0.0, atol=1e-5 * float(want_sigma.abs().max()))
        app_grid = ttf.compute_app_feature(field, pts, cfg)
        torch.testing.assert_close(app_grid.detach(), want_app, rtol=0.0, atol=1e-5 * float(want_app.abs().max()))
    else:
        bound = 8 * 2.0**-9
        sig_scale = _terms(field, pts, "density").sum(-1)
        assert ((sigma.detach() - want_sigma).abs() <= bound * sig_scale + 1e-7).all()
        app_scale = _terms(field, pts, "app") @ params["basis_mat"].abs()
        assert ((app.detach() - want_app).abs() <= bound * app_scale + 1e-7).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_density_l1_matches_the_reference(seed):
    """The port's L1 term of a CP field (the virtual plane line_1 (x) line_2
    and line_0 through the blocked path on the CPU) against the reference's
    density_l1_grads: value 1e-5 relative, each line's gradient 1e-5 of its
    largest entry; also streamed in blocks."""
    cfg = _cfg(g=28)
    field = _field(cfg, seed)
    want, want_grads = ref_cp.density_l1_grads({k: v.detach() for k, v in field.named_parameters()}, "softplus",
                                               voxels_per_block=5000)
    lines = [field[f"density_line_{i}"] for i in range(3)]
    for streamed in (False, True):
        c = cfg if not streamed else ttf.TensorfConfig(**{**cfg.__dict__, "l1_stream_min_vox": 1})
        profiling.RECORDER.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            val = ttf.density_l1(field, c)
            counts = profiling.counters()
        assert counts.get("l1.cp") == 1 and counts.get("l1.blocked") == 1
        assert abs(float(val.detach()) - float(want)) <= 1e-5 * abs(float(want))
        for i, g in enumerate(torch.autograd.grad(val, lines)):
            w = want_grads[f"density_line_{i}"]
            torch.testing.assert_close(g, w, rtol=0.0, atol=1e-5 * float(w.abs().max()))


@pytest.fixture(scope="module")
def tiny_cp(tmp_path_factory):
    """The benchmark's tiny copy cut from the CP-384 configuration (32^3,
    ranks [6] / [18])."""
    bc = _bench_conftest()
    root = tmp_path_factory.mktemp("cp_bench")
    over = {"n_lamb_sigma": [6], "n_lamb_sh": [18], "gather_dtype": "float32", "mlp_dtype": "float32"}
    return bc, bc.make_tiny(root, over, config=BENCH / "configs" / "tensorf-cp384.json")


def test_three_chunk_steps_match_the_reference_under_the_harness_check(tiny_cp):
    """Three steps through plan_chunk -> run_chunk of the CP program (f32
    tables and MLP) against the reference's steps: within the tiny cells'
    limits; the fp8 control fails them."""
    bc, bench = tiny_cp
    from harness import check, manifest
    from run import Run

    spec = manifest.cell_spec("tiny.tiny-train", bench)
    assert spec["field"].__name__ == "reference.cp" and spec["config"]["program"]["decomposition"] == "cp"
    entry = manifest.entry_module("train", bench)
    state = entry.setup(spec, Run(torch.device("cpu"), 2**31 + 4099, 0.0, False))
    assert state["model"].fields[-1]["cfg"].is_cp
    prog = entry.program_side(state["prog"], state["weights"], spec["traffic"]["frames"])
    args = (spec, state["sd"], state["frames"], state["weights"], torch.device("cpu"))
    ref = entry.reference_side(*args, state["plans"])
    ok, table = check.judge(check.train_numbers(prog, ref), bc.TINY_LIMITS["tiny-train"])
    assert ok, table
    assert table["loss_gap"]["value"] < 1e-6, table
    control = check.train_numbers(entry.reference_side(*args, precision="fp8"), ref)
    assert not check.judge(control, bc.TINY_LIMITS["tiny-train"])[0]


@pytest.mark.parametrize("seed", [2**31 + 77, 3_000_007_921])
def test_eval_frames_match_the_reference_render(tiny_cp, seed):
    """Two frames through LocalTensorfs.forward_eval of the CP program (f32
    tables and MLP) against the reference's render of the same weights and
    cameras: within the tiny eval cell's limits; the reference in fp8 fails
    them."""
    bc, bench = tiny_cp
    from harness import check, manifest
    from run import Run

    spec = manifest.cell_spec("tiny.tiny-eval", bench)
    entry = manifest.entry_module("eval", bench)
    assert spec["field"].__name__ == "reference.cp"
    frames, weights, traj = entry.program_frames(spec, Run(torch.device("cpu"), seed, 0.0, False), [1, 2])
    assert not any("plane" in k for k in weights)
    ref = entry.reference_frames(spec, weights, traj, [1, 2], torch.device("cpu"))
    ok, table = check.judge(check.eval_numbers(frames, ref), bc.TINY_LIMITS["tiny-eval"])
    assert ok, table
    fp8 = entry.reference_frames(spec, weights, traj, [1, 2], torch.device("cpu"), "fp8")
    assert not check.judge(check.eval_numbers(fp8, ref), bc.TINY_LIMITS["tiny-eval"])[0]


def test_upsampling_resizes_the_lines_as_interpolate():
    cfg = _cfg()
    field = _field(cfg, 0)
    new, new_cfg = ttf.upsample_tensorf(field, cfg, (32, 30, 28))
    assert new_cfg.grid_size == (32, 30, 28) and new_cfg.is_cp
    assert sorted(k for k, _ in new.named_parameters()) == sorted(k for k, _ in field.named_parameters())
    for i in range(3):
        n = new_cfg.grid_size[ttf.VEC_MODE[i]]
        for kind in ("density", "app"):
            want = F.interpolate(field[f"{kind}_line_{i}"].detach()[None], size=n, mode="linear",
                                 align_corners=True)[0]
            torch.testing.assert_close(new[f"{kind}_line_{i}"], want, rtol=1e-6, atol=1e-6)
    assert torch.equal(new["basis_mat"], field["basis_mat"])


def test_checkpoint_round_trips(tmp_path):
    tf = _cfg()
    model = LocalTensorfs(LocalConfig(WH=(40, 30), n_init_frames=3, tensorf=tf), device="cpu")
    while model.n_frames < 3:
        model.append_frame()
    path = str(tmp_path / "cp.th")
    save_checkpoint(model, path)
    back = load_checkpoint(path, device="cpu")
    assert back.cfg.tensorf == tf and back.fields[-1]["cfg"].is_cp
    a = dict(model.fields[-1]["params"].named_parameters())
    b = dict(back.fields[-1]["params"].named_parameters())
    assert sorted(a) == sorted(b) and not any("plane" in k for k in a)
    assert all(torch.equal(a[k], b[k]) for k in a)


class _FakeDS:
    scene_bbox = np.array([[-2.0, -2.0, -2.0], [2.0, 2.0, 2.0]])
    num_images = 5
    img_wh = (8, 6)
    rel_poses = None
    transforms = None


@pytest.mark.parametrize("name,ranks", [("TensorCP", ["6", "18"]), ("TensorVMSplit", None)])
def test_model_name_selects_the_field(name, ranks):
    argv = ["--N_voxel_init", str(16**3), "--model_name", name, "--device", "cpu"]
    if ranks:
        argv += ["--n_lamb_sigma", ranks[0], "--n_lamb_sh", ranks[1]]
    model = ttrain._make_model(tconfig.config_parser(argv), _FakeDS())
    tf = model.cfg.tensorf
    names = dict(model.fields[-1]["params"].named_parameters())
    if name == "TensorCP":
        assert tf.decomposition == "cp" and tf.density_n_comp == (6,) and tf.app_n_comp == (18,)
        assert names["density_line_0"].shape == (6, 16) and names["basis_mat"].shape == (18, 27)
        assert not any("plane" in k for k in names)
    else:
        assert tf.decomposition == "vm" and "density_plane_0" in names


def test_cp_config_checks():
    """A CP field takes one rank a kind, runs no fused march and no TV."""
    with pytest.raises(ValueError, match="one rank a kind"):
        ttf.TensorfConfig(grid_size=(16,) * 3, decomposition="cp")
    with pytest.raises(ValueError, match="decomposition"):
        ttf.TensorfConfig(grid_size=(16,) * 3, decomposition="cp2")
    cfg = ttf.TensorfConfig(grid_size=(16,) * 3, density_n_comp=(8,), app_n_comp=(24,), decomposition="cp",
                            fused_march=True)
    assert not fused_march_supported(cfg)
    assert fused_march_supported(ttf.TensorfConfig(grid_size=(16,) * 3))
    with pytest.raises(ValueError, match="TV"):
        LocalTensorfs(LocalConfig(WH=(40, 30), n_init_frames=3, tensorf=_cfg(), tv_weight_density=0.1),
                      device="cpu")


def test_k3_ordered_sum_at_768_columns_against_index_add():
    """K3's plain ordered version at a CP-384 line row (768 columns, 12
    column tiles) against the f32 index_add_: rtol 1e-4 / atol 1e-4; its
    plan at the 500^3 step tiles columns, and up to 64 columns it tiles none."""
    rng = np.random.default_rng(5)
    p, rows, c = 20_000, 500, 768
    idx = torch.from_numpy(np.clip(rows / 2 + 0.27 * rows * rng.uniform(-1, 1, p), 0, rows - 1).astype(np.int64))
    g = torch.from_numpy((10 * rng.standard_normal((p, c))).astype(np.float32)).to(torch.bfloat16)
    got = k3.segment_sum_small_ordered(idx, g, rows)
    want = k3.segment_sum_small_plain(idx, g, rows)
    assert got.shape == (rows, c) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert k3.segsum_plan(4096 * 259, 500, 768) == k3.SegsumPlan(500, 1, 11, 96_448, 12)
    assert k3.segsum_plan(4096 * 332, 640, 64).n_col_tiles == 1


def test_captured_counts_are_recorded_at_each_replay():
    """profiling.tallied (a graph capture) keeps the counts it sees out of
    the record and returns them; count_all records them, while recording."""
    profiling.RECORDER.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.tallied() as tally:
            profiling.count("k3.launches")
            profiling.count("k3.column_tiles", 12)
        assert profiling.counters() == {}
        profiling.count_all(tally)
        profiling.count_all(tally)
        assert profiling.counters() == {"k3.launches": 2, "k3.column_tiles": 24}
    profiling.count_all(tally)  # not recording: nothing
    assert profiling.counters() == {"k3.launches": 2, "k3.column_tiles": 24}


def test_line_sum_roofline_reads_k3_time_and_bytes(tiny_cp):
    """line_sum_roofline.train: the field's line_sum_bytes a step times the
    steps over the trace's K3 time and 3.35 TB/s; None with no K3 time in
    the trace."""
    _, bench = tiny_cp
    from harness import flops, manifest, scene

    spec = manifest.cell_spec("tiny.tiny-train", bench)
    read = manifest.metric_reader("line_sum_roofline.train", bench)
    ops = {"void (anonymous namespace)::segsum_small_kernel<__nv_bfloat16, true>(long const*)": 0.003,
           "void (anonymous namespace)::segsum_small_reduce_kernel(float const*)": 0.001, "other": 1.0}
    ctx = {"spec": spec, "traced": {"steps": 4}, "trace": {"window_s": 1.0, "ops": ops}}
    wd = scene.widths(spec["config"])
    need = ref_cp.line_sum_bytes(wd, 32, 256, 16)
    assert need == 3 * (256 * 16 * 48 * 2 + 256 * 16 * 8 + 32 * 48 * 4)
    assert read(ctx) == pytest.approx(100.0 * need * 4 / flops.HBM_BYTES_S / 0.004)
    assert read({**ctx, "trace": {"window_s": 1.0, "ops": {"other": 1.0}}}) is None
