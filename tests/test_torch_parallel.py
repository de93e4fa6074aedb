"""Port parity of ray-batch data parallelism (parallel/sharding.py, the
reduction in models/step.py, LocalTensorfs.set_mesh), the sample-split
render (parallel/sp.py) and utils/profiling.py.

Ranks are processes spawned on a gloo group (tests/test_torch_parallel_ranks.py
holds what they run; they import no JAX). One group of 2 ranks runs every
2-rank case and one group of 4 the 4-rank ones; the JAX package's oracles
run here, on the 8 virtual CPU devices of tests/conftest.py, and reach the
ranks through an .npz file (JAX's field init and noise).

Scene: 6 frames of 32x24 (every third a held-out test frame, so the third
of the K = 4 steps is pose-only), 4 views of 32 rays, a 24^3 field with f32
tables and MLP, an alpha refresh after the chunk (tests/test_torch_chunk.py's
set-up on a 2-way mesh).

Tolerances:
- the DP chunk against JAX's DP chunk (make_mesh(2)): per-step losses rtol
  1e-4 on step 0 and 1e-3 after, the pose window rtol / atol 1e-5 (JAX's own
  dry run holds its DP chunk to its single-device twin at rtol 1e-4 / atol
  1e-5, __graft_entry__.py:222-231); the field parameters to 2e-3 absolute
  with a median of 1e-6 (tests/test_torch_chunk.py: Adam's first steps are
  ~lr * sign(g), so a near-zero gradient whose sign differs by summation
  order moves that entry by up to 2 lr); the alpha volume bit for bit;
- the DP chunk against the port's single-process chunk: the same, with the
  losses at rtol 1e-5 (one summation order apart);
- both ranks, and world size 1 against no mesh: bit for bit;
- the rgb_loss denominator: the DP step's loss and gradients against the
  single-process step's at rtol 1e-5 / atol 1e-5 of the largest entry; the
  per-rank ratio of means off by more than 10% in rgb_loss and in the basis
  gradient (of its largest entry);
- an indivisible batch (every rank the whole batch): bit for bit with the
  single-process chunk ((g + g) / 2 = g);
- eval split over 2 ranks against one rank: 1e-6 absolute (a chunk's rays
  render in halves: another matmul size);
- render_rays_sp against render_rays (eval, no compaction) and against
  JAX's render_rays_sp on the same mesh shape: rtol 1e-5, atol 2e-5
  (tests/test_topk_and_sharding.py:196-254);
- the CLI under `torch.distributed.run` (2 gloo ranks) against a one-process
  run of the same flags: the final poses to 1e-6 (f32 tables and MLP).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as ranks
from localrf_tpu.data import pool as jpool
from localrf_tpu.data.dataset import SyntheticDataset as JSyntheticDataset
from localrf_tpu.models import local as jlocal
from localrf_tpu.models import tensorf as jtf
from localrf_tpu.parallel import sharding as jsharding
from localrf_tpu.parallel import sp as jsp
from localrf_tpu_torch.convert import params_from_jax
from localrf_tpu_torch.models import render as trender
from localrf_tpu_torch.models import tensorf as ttf
from localrf_tpu_torch.parallel import sharding
from localrf_tpu_torch.utils import profiling


def jax_noise(key, n_samples_total: int) -> dict:
    """JAX's render randomness, split as render.py:74 and rays.py:85-87 do."""
    key_strat, key_bg = jax.random.split(key)
    k1, k2 = jax.random.split(key_strat)
    n = n_samples_total // 6
    return {"u1": np.asarray(jax.random.uniform(k1, (1, n))), "u2": np.asarray(jax.random.uniform(k2, (1, n))),
            "bg": np.asarray(jax.random.uniform(key_bg, ()))}


def _jax_model():
    return jlocal.LocalTensorfs(ranks.config(jlocal, jtf, **ranks.CHUNK_KW))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """JAX's field init and the K noise draws its run_chunk makes, as the
    ranks read them ({"p/<param>", "n/u1", "n/u2", "n/bg"}), and the path."""
    jm = _jax_model()
    key, noise = jm._key, []
    for _ in range(ranks.K):
        key, sub = jax.random.split(key)
        noise.append(jax_noise(sub, jm.fields[-1]["cfg"].n_samples))
    arrays = {f"p/{k}": v.numpy() for k, v in params_from_jax(jax.device_get(jm.fields[-1]["params"]),
                                                                device="cpu").items()}
    arrays.update({f"n/{k}": np.stack([n[k] for n in noise]) for k in ("u1", "u2", "bg")})
    path = str(tmp_path_factory.mktemp("parallel") / "inputs.npz")
    np.savez(path, **arrays)
    return path, arrays


@pytest.fixture(scope="module")
def two_ranks(inputs, tmp_path_factory):
    """One gloo group of 2 ranks running every 2-rank job."""
    return ranks.spawn(2, str(tmp_path_factory.mktemp("g2")), inputs[0],
                       ["chunk", "world1", "trap", "odd", "eval", "sp"])


@pytest.fixture(scope="module")
def four_ranks(inputs, tmp_path_factory):
    return ranks.spawn(4, str(tmp_path_factory.mktemp("g4")), inputs[0], ["sp"])


@pytest.fixture(scope="module")
def single(inputs):
    """The port's single-process chunk on the same inputs."""
    return ranks.model_state(ranks.chunk_model(inputs[1]))


@pytest.fixture(scope="module")
def jax_dp():
    """JAX's pooled chunk on a 2-device mesh from the same init and noise."""
    jm = _jax_model()
    ds = ranks.dataset(JSyntheticDataset)
    jm.set_mesh(jsharding.make_mesh(2))
    jm.attach_pool(jpool.DevicePixelPool(ds, capacity=8))
    ranks.schedule(jm)
    jm.run_chunk(ranks.batches(ds), optimize_poses=True)
    jm.sync_window_to_host()
    return jm


def _window(state: dict, name: str) -> np.ndarray:
    return state[f"pose/{name}/0"][: ranks.N_FRAMES]


def _assert_chunk_close(got: dict, want_metrics: dict, want_pose: dict, want_params: dict, rtol0: float,
                        rtol: float) -> None:
    for k, v in want_metrics.items():
        for i in range(ranks.K):
            np.testing.assert_allclose(got[f"metric/{k}"][i], v[i], rtol=rtol0 if i == 0 else rtol, atol=1e-7,
                                       err_msg=f"{k} step {i}")
    for name, v in want_pose.items():
        np.testing.assert_allclose(_window(got, name), v, rtol=1e-5, atol=1e-5, err_msg=name)
    for k, v in want_params.items():
        err = np.abs(got[f"param/{k}"] - v)
        assert err.max() <= 2e-3 and np.median(err) <= 1e-6, (k, err.max(), np.median(err))


def test_dp_chunk_matches_jax_dp_chunk(two_ranks, jax_dp):
    """A pooled chunk under a 2-rank mesh against JAX's run_chunk with
    set_mesh(make_mesh(2)), from the same field init and noise."""
    got = ranks.result(two_ranks, "chunk", 0)
    pose = {"r": jax_dp.r_all, "t": jax_dp.t_all, "exposure": jax_dp.exp_all}
    params = {k: v.numpy() for k, v in params_from_jax(jax.device_get(jax_dp.fields[-1]["params"]),
                                                         device="cpu").items()}
    _assert_chunk_close(got, jax_dp.chunk_metrics, pose, params, 1e-4, 1e-3)
    np.testing.assert_array_equal(got["alpha"], np.asarray(jax_dp.fields[-1]["alpha_volume"]))
    assert int(got["opt_step"]) == int(jax_dp.fields[-1]["opt"].step) == 3


def test_dp_chunk_matches_single_process(two_ranks, single):
    """The same chunk under the mesh and in one process."""
    got = ranks.result(two_ranks, "chunk", 0)
    metrics = {k[7:]: v for k, v in single.items() if k.startswith("metric/")}
    pose = {n: _window(single, n) for n in ("r", "t", "exposure")}
    params = {k[6:]: v for k, v in single.items() if k.startswith("param/")}
    _assert_chunk_close(got, metrics, pose, params, 1e-5, 1e-5)
    np.testing.assert_array_equal(got["alpha"], single["alpha"])


def test_dp_ranks_stay_bit_equal(two_ranks):
    """After the chunk (its reduced steps and the alpha refresh) both ranks
    hold the same state bit for bit (padded window rows are NaN on both)."""
    a, b = ranks.result(two_ranks, "chunk", 0), ranks.result(two_ranks, "chunk", 1)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


def _assert_mesh_is_none(got: dict) -> None:
    mesh = {k[5:]: v for k, v in got.items() if k.startswith("mesh/")}
    none = {k[5:]: v for k, v in got.items() if k.startswith("none/")}
    assert mesh.keys() == none.keys() and mesh
    for k in mesh:
        assert mesh[k].tobytes() == none[k].tobytes(), k


def test_world_size_1_is_no_mesh(two_ranks):
    """A mesh of one rank trains the chunk bit for bit as no mesh does."""
    for rank in range(2):
        _assert_mesh_is_none(ranks.result(two_ranks, "world1", rank))


def test_rgb_loss_divides_by_the_global_mean_weight(two_ranks, inputs):
    """With the two shards' loss weights different (1 and 0.25), the DP
    step's loss and gradients equal the single-process step's; a per-rank
    ratio of means, averaged over the ranks, does not (its rgb_loss and the
    basis gradient are off by more than 10%), which this test would catch."""
    m = ranks.field_model(inputs[1])
    want = ranks.step_grads(m, ranks.joint_batch(ranks.dataset()), inputs[1])
    for rank in range(2):
        got = ranks.result(two_ranks, "trap", rank)
        for k, v in want.items():
            scale = float(np.nanmax(np.abs(v))) + 1e-30  # the padded window rows are NaN
            np.testing.assert_allclose(got[f"right/{k}"], v, rtol=1e-5, atol=1e-5 * scale, err_msg=k)
        wrong = float(got["wrong/metric/rgb_loss"])
        assert abs(wrong - want["metric/rgb_loss"]) > 0.1 * abs(want["metric/rgb_loss"]), wrong
        err = np.abs(got["wrong/grad/basis_mat"] - want["grad/basis_mat"]).max()
        assert err > 0.1 * np.abs(want["grad/basis_mat"]).max(), err


def test_indivisible_batch_is_replicated(two_ranks):
    """3 views over 2 ranks: every rank takes the whole batch, and the chunk
    equals the single-process chunk bit for bit."""
    for rank in range(2):
        _assert_mesh_is_none(ranks.result(two_ranks, "odd", rank))


@pytest.fixture(scope="module")
def eval_single():
    m = ranks.eval_model()
    out = ranks.eval_frames(m, ranks.EVAL_ONE)
    ranks.spawn_field(m)
    assert len(m.fields) == 2 and (m.blending_weights[ranks.EVAL_INIT] > 0).all()
    out.update(ranks.eval_frames(m, ranks.EVAL_TWO))
    return out


@pytest.mark.parametrize("call", [*ranks.EVAL_ONE, *ranks.EVAL_TWO])
def test_sharded_eval_matches_one_rank(two_ranks, eval_single, call):
    """forward_eval with each chunk's rays split over 2 ranks (one view
    through render_frame, several through render_chunk, two fields after a
    spawn and a slide; a chunk of 255 rays is not split) against one rank;
    both ranks hold the gathered frame."""
    for rank in range(2):
        got = ranks.result(two_ranks, "eval", rank)
        for part in ("rgb", "depth"):
            np.testing.assert_allclose(got[f"{call}/{part}"], eval_single[f"{call}/{part}"], rtol=0, atol=1e-6,
                                       err_msg=f"rank {rank} {part}")


def _jax_sp(arrays: dict, shape: tuple, alpha, **tf_kw) -> tuple[np.ndarray, np.ndarray]:
    mesh = jsp.make_sp_mesh(shape[0]) if len(shape) == 1 else jsp.make_dp_sp_mesh(*shape)
    params = {}
    for k, v in arrays.items():
        if k.startswith("p/"):
            *parents, leaf = k[2:].split(".")
            d = params
            for p in parents:
                d = d.setdefault(p, {})
            d[leaf] = v
    rays_o, rays_d = ranks.sp_rays()
    cfg = jtf.TensorfConfig(**ranks.TF_KW, **tf_kw)
    # jitted: JAX's own tests run it eagerly, ~30 s a call here
    fn = jax.jit(lambda p, o, d, a: jsp.render_rays_sp(p, cfg, o, d, mesh, alpha_volume=a))
    rgb, depth = fn(params, rays_o, rays_d, alpha)
    return np.asarray(rgb), np.asarray(depth)


@pytest.mark.parametrize("occ", ["", "-occ"], ids=["no-alpha", "alpha"])
@pytest.mark.parametrize("case", list(ranks.SP_CASES))
def test_render_rays_sp(case, occ, inputs, two_ranks, four_ranks):
    """render_rays_sp over a sample group of 2, of 4 (26 samples: 2 padded)
    and a (2, 2) ("data", "sample") mesh, with and without an alpha volume,
    against the port's render_rays (eval, no compaction) and JAX's
    render_rays_sp on the same mesh shape; every rank returns every ray."""
    world, shape = ranks.SP_CASES[case]
    cfg = ttf.TensorfConfig(**ranks.TF_KW)
    assert cfg.n_samples // 6 * 2 == 26
    alpha = ranks.ball() if occ else None
    rays_o, rays_d = (torch.from_numpy(a) for a in ranks.sp_rays())
    with torch.no_grad():
        rgb, depth = trender.render_rays(ranks.jax_field(inputs[1]), cfg, rays_o, rays_d, is_train=False,
                                         white_bg=True,
                                         alpha_volume=None if alpha is None else torch.from_numpy(alpha))
    j_rgb, j_depth = _jax_sp(inputs[1], shape, alpha)
    out = two_ranks if world == 2 else four_ranks
    for rank in range(world):
        got = ranks.result(out, "sp", rank)
        for ref in ((rgb.numpy(), depth.numpy()), (j_rgb, j_depth)):
            np.testing.assert_allclose(got[f"{case}/rgb{occ}"], ref[0], rtol=1e-5, atol=2e-5)
            np.testing.assert_allclose(got[f"{case}/depth{occ}"], ref[1], rtol=1e-5, atol=2e-5)
    if occ:  # the ball culls: the result differs from the field without it
        assert not np.allclose(ranks.result(out, "sp", 0)[f"{case}/depth"], depth.numpy(), atol=1e-3)


@pytest.mark.parametrize("occ", ["", "-occ"], ids=["no-alpha", "alpha"])
def test_render_rays_sp_on_the_grid_route(occ, inputs, four_ranks):
    """render_rays_sp on the grid-sample route (fast_gather=False: bilinear
    lookups in the f32 grids, the alpha volume through sample_alpha) over a
    sample group of 4, against the port's render_rays on that route (eval,
    no compaction), JAX's render_rays_sp on it, and the quad route's
    render_rays_sp (the same math): rtol 1e-5, atol 2e-5 as above."""
    world, shape = ranks.SP_CASES[ranks.GRID_SP_CASE]
    cfg = ttf.TensorfConfig(**ranks.TF_KW, fast_gather=False)
    alpha = ranks.ball() if occ else None
    rays_o, rays_d = (torch.from_numpy(a) for a in ranks.sp_rays())
    with torch.no_grad():
        rgb, depth = trender.render_rays(ranks.jax_field(inputs[1]), cfg, rays_o, rays_d, is_train=False,
                                         white_bg=True,
                                         alpha_volume=None if alpha is None else torch.from_numpy(alpha))
    j_rgb, j_depth = _jax_sp(inputs[1], shape, alpha, fast_gather=False)
    for rank in range(world):
        got = ranks.result(four_ranks, "sp", rank)
        case = ranks.GRID_SP_CASE
        for ref in ((rgb.numpy(), depth.numpy()), (j_rgb, j_depth),
                    (got[f"{case}/rgb{occ}"], got[f"{case}/depth{occ}"])):
            np.testing.assert_allclose(got[f"{case}/grid/rgb{occ}"], ref[0], rtol=1e-5, atol=2e-5)
            np.testing.assert_allclose(got[f"{case}/grid/depth{occ}"], ref[1], rtol=1e-5, atol=2e-5)


def test_shard_batch_splits_views_with_their_rays():
    """shard_batch on a stand-in mesh: a contiguous slice of every ray/view
    key per rank; the whole batch when a key does not divide."""

    class Mesh:
        mesh_dim_names = ("data",)

        def __init__(self, rank):
            self.rank = rank

        def get_local_rank(self, name):
            return self.rank

        def size(self, dim=None):
            return 2

    batch = {"view_ids": np.arange(4), "rgbs": np.arange(8 * 3).reshape(8, 3), "gate": np.ones(5)}
    for rank in range(2):
        got = sharding.shard_batch(batch, Mesh(rank))
        np.testing.assert_array_equal(got["view_ids"], np.arange(4)[rank * 2 : rank * 2 + 2])
        np.testing.assert_array_equal(got["rgbs"], batch["rgbs"][rank * 4 : rank * 4 + 4])
        assert got["gate"] is batch["gate"]
        stacked = sharding.shard_batch({"px": np.zeros((3, 8)), "slots": np.zeros((3, 4))}, Mesh(rank),
                                       sharding.POOL_SHARDED_KEYS, axis=1)
        assert stacked["px"].shape == (3, 4) and stacked["slots"].shape == (3, 2)
    odd = {"view_ids": np.arange(3), "rgbs": np.zeros((6, 3))}
    assert sharding.shard_batch(odd, Mesh(1))["view_ids"] is odd["view_ids"]


def test_profiling_trace_writes_on_the_cpu(tmp_path):
    """trace(dir) writes a Chrome trace of the enclosed CPU work; trace(None)
    is a no-op yielding None."""
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64).cumsum(0)
    assert prof is not None
    traces = [p for p in os.listdir(tmp_path) if p.endswith(".pt.trace.json")]
    assert len(traces) == 1 and os.path.getsize(tmp_path / traces[0]) > 0
    with profiling.trace(None) as prof:
        torch.ones(2).sum()
    assert prof is None


CLI_FLAGS = [
    "--batch_size", "64", "--n_views", "4", "--n_init_frames", "3", "--n_iters_per_frame", "6",
    "--n_iters_reg", "3", "--N_voxel_init", str(14**3), "--N_voxel_final", str(20**3), "--upsamp_list", "4",
    "--update_AlphaMask_list", "5", "--add_frames_every", "3", "--n_overlap", "2", "--n_max_frames", "6",
    "--max_drift", "100", "--test_frame_every", "4", "--fov", "60", "--skip_saving_video", "--vis_every", "10",
    "--scan_chunk", "4", "--pixel_pool", "1", "--device", "cpu", "--gather_dtype", "float32",
    "--mlp_dtype", "float32",
]


def _files(root: str) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_torchrun_cli_trains_on_two_ranks(tmp_path):
    """`python -m torch.distributed.run --nproc_per_node 2 -m
    localrf_tpu_torch.train ... --data_parallel 2` (gloo on the CPU) trains
    an 8-frame 32x24 scene through appends, upsamples, alpha refreshes, a
    spawn, mid-run evals and checkpoints, and renders; rank 0 alone writes
    (the same files as a one-process run, one TensorBoard event file), and
    its final poses match the one-process run's to 1e-6 (f32 tables and
    MLP: bf16 lerp weights would round apart)."""
    import subprocess
    import sys

    import chip_smoke
    from localrf_tpu_torch import config as tconfig
    from localrf_tpu_torch import train as ttrain

    scene = str(tmp_path / "scene")
    chip_smoke.write_scene(scene, ranks.W, ranks.H, 8)
    flags = ["--datadir", scene, *CLI_FLAGS]
    env = dict(os.environ, OMP_NUM_THREADS=str(ranks.THREADS))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
           "-m", "localrf_tpu_torch.train", *flags, "--logdir", str(tmp_path / "dp"), "--data_parallel", "2"]
    run = subprocess.run(cmd, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))), env=env,
                         capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "ray-batch data parallelism over 2 ranks" in run.stdout
    model, _ = ttrain.reconstruction(tconfig.config_parser(flags + ["--logdir", str(tmp_path / "one"),
                                                                    "--data_parallel", "1"]))
    assert len(model.fields) >= 2
    dp, one = _files(str(tmp_path / "dp")), _files(str(tmp_path / "one"))
    events = [f for f in dp if f.startswith("events.out.tfevents")]
    assert len(events) == 1 and [f for f in dp if f not in events] == [f for f in one if "tfevents" not in f]
    assert "checkpoints.th" in dp and any(f.startswith("test/rgb_maps/") for f in dp)

    def poses(run: str) -> np.ndarray:
        with open(tmp_path / run / "transforms.json") as f:
            return np.array([fr["transform_matrix"] for fr in json.load(f)["frames"]])

    np.testing.assert_allclose(poses("dp"), poses("one"), rtol=0, atol=1e-6)
