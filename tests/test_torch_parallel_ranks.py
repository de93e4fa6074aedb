"""The ranks' side of tests/test_torch_parallel.py: the set-up both sides
share, and what each process of a spawned torch.distributed group (gloo, on
the CPU) runs. Holds no test.

This module imports no JAX, and neither does a rank: JAX's field inits and
noise reach the ranks through an .npz file, and each rank writes what it
computed to `<out>/<job>_<rank>.npz`, which the test compares. The ranks
meet through a FileStore (tests run in parallel, so no fixed port), with a
timeout on every collective; `spawn` joins them with a time limit.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from localrf_tpu_torch.data.dataset import SyntheticDataset
from localrf_tpu_torch.data.pool import DevicePixelPool
from localrf_tpu_torch.models import local as tlocal
from localrf_tpu_torch.models import step as tstep
from localrf_tpu_torch.models import tensorf as ttf
from localrf_tpu_torch.optim import pytree_adam_init
from localrf_tpu_torch.parallel import sharding, sp

# a tiny scene of 32x24 frames, every third a held-out test frame (so the
# chunk's third step is a pose-only one); f32 tables and MLP (the defaults)
W, H, N_FRAMES, N_VIEWS, BATCH, K = 32, 24, 6, 4, 128, 4
TF_KW = dict(grid_size=(24, 24, 24), pallas_composite=True, binned_min_rows=100)
# the chunk starts at rf_iter 2 with the L1 on for two steps (n_iters_reg 4)
# and ends in an alpha refresh (an event: the state is broadcast again)
CHUNK_KW = dict(update_AlphaMask_list=[K], occ_min=4)
# the indivisible batch: 3 views over 2 ranks
ODD_VIEWS, ODD_BATCH = 3, 96
# eval: 5 frames, then 2 appended and a field spawned over them
EVAL_INIT = 5
# render_rays_sp: rays and the ball alpha volume's half-size
SP_RAYS = 64
SP_CASES = {
    # case: (ranks, mesh shape)
    "sample2": (2, (2,)),
    "sample4": (4, (4,)),
    "data2xsample2": (4, (2, 2)),
}
TIMEOUT_S = 60
# torch threads per rank (the suite runs several test files at once)
THREADS = 2


def config(mod, tf_mod, n_views: int = N_VIEWS, batch: int = BATCH, **kw):
    """LocalConfig of the JAX package (mod=localrf_tpu.models.local) or the port."""
    return mod.LocalConfig(WH=(W, H), n_init_frames=N_FRAMES, n_views=n_views, batch_size=batch,
                           tensorf=tf_mod.TensorfConfig(**TF_KW), **kw)


def dataset(cls=SyntheticDataset):
    """The seeded scene (cls: the JAX package's SyntheticDataset or the port's)."""
    rng = np.random.default_rng(0)
    shape = (N_FRAMES, H, W)
    return cls(
        rng.random((*shape, 3), dtype=np.float32), "train",
        invdepths=0.1 + 0.9 * rng.random(shape, dtype=np.float32),
        fwd_flow=rng.normal(0, 1, (*shape, 2)).astype(np.float32), fwd_mask=np.ones(shape, np.float32),
        bwd_flow=rng.normal(0, 1, (*shape, 2)).astype(np.float32), bwd_mask=np.ones(shape, np.float32),
        n_init_frames=N_FRAMES, test_frame_every=3,
    )


def schedule(m) -> None:
    m.is_refining = True
    m.rf_iter[-1] = 2
    m.n_iters_reg = 4


def batches(ds, n_views: int = N_VIEWS, batch: int = BATCH) -> list[dict]:
    out = [ds.sample(batch, True, True, n_views=n_views) for _ in range(K)]
    if n_views == N_VIEWS:
        assert [b["train_test_poses"] for b in out] == [False, False, True, False]
    return out


def joint_batch(ds) -> dict:
    """One joint-step batch whose two halves (the ranks' shards) differ:
    loss weights 1 on the first half of the views and 0.25 on the second,
    whose ground truth is black (so that the halves' errors differ too: a
    per-rank ratio of means is only off where they do)."""
    while True:
        b = ds.sample(BATCH, True, True, n_views=N_VIEWS)
        if not b["train_test_poses"]:
            break
    b["loss_weights"] = np.repeat(np.float32([1.0, 1.0, 0.25, 0.25]), BATCH // N_VIEWS)
    b["rgbs"] = np.concatenate([b["rgbs"][: BATCH // 2], np.zeros_like(b["rgbs"][BATCH // 2 :])])
    return b


def jax_field(inputs: dict) -> ttf.TensorfField:
    """JAX's field init, as the test wrote it ("p/<name>")."""
    return ttf.TensorfField({k[2:]: torch.from_numpy(v.copy()) for k, v in inputs.items() if k[:2] == "p/"})


def field_model(inputs: dict, n_views: int = N_VIEWS, batch: int = BATCH):
    """The port's model with JAX's field init, at the chunk's schedule."""
    m = tlocal.LocalTensorfs(config(tlocal, ttf, n_views, batch, **CHUNK_KW), device="cpu")
    field = jax_field(inputs)
    m.fields[-1]["params"] = field
    m.fields[-1]["opt"] = pytree_adam_init(field)
    schedule(m)
    return m


def chunk_model(inputs: dict, mesh=None, n_views: int = N_VIEWS, batch: int = BATCH):
    """The port's model from JAX's field init (`inputs`), its pool attached,
    JAX's noise injected, after one pooled chunk of K steps under `mesh`."""
    m = field_model(inputs, n_views, batch)
    ds = dataset()
    m.attach_pool(DevicePixelPool(ds, capacity=8, device="cpu"))
    noise = step_noise(inputs)
    m._next_noise = lambda cfg: noise.pop(0)
    if mesh is not None:
        m.set_mesh(mesh)
    m.run_chunk(batches(ds, n_views, batch), optimize_poses=True)
    return m


def step_noise(inputs: dict) -> list[dict]:
    return [{k: torch.from_numpy(np.array(inputs[f"n/{k}"][i])) for k in ("u1", "u2", "bg")} for i in range(K)]


def model_state(m) -> dict[str, np.ndarray]:
    """Everything a chunk trains, by name: the field and its Adam state, the
    pose window with its Adam state, the intrinsics, the chunk's metrics and
    the alpha volume."""
    f = m.fields[-1]
    out = {f"param/{k}": p.detach().numpy().copy() for k, p in f["params"].named_parameters()}
    out.update({f"m/{k}": v.numpy().copy() for k, v in f["opt"].m.items()})
    out.update({f"v/{k}": v.numpy().copy() for k, v in f["opt"].v.items()})
    out["opt_step"], out["lr_scale"] = f["opt"].step.numpy().copy(), f["opt"].lr_scale.numpy().copy()
    for name, val in m._pose_dev._asdict().items():
        for i, x in enumerate(val if isinstance(val, tuple) else (val,)):
            out[f"pose/{name}/{i}"] = x.detach().numpy().copy()
    out.update({f"intr/{k}": v.detach().numpy().copy() for k, v in m.intr.params.items()})
    out.update({f"metric/{k}": np.asarray(v) for k, v in m.chunk_metrics.items()})
    if f["alpha_volume"] is not None:
        out["alpha"] = f["alpha_volume"].numpy().copy()
    return out


def grads_state(g_field, g_pose, metrics) -> dict[str, np.ndarray]:
    out = {f"grad/{k}": v.numpy().copy() for k, v in g_field.items()}
    out.update({f"grad/pose{i}": v.numpy().copy() for i, v in enumerate(g_pose)})
    out.update({f"metric/{k}": v.numpy().copy() for k, v in metrics.items()})
    return out


def step_grads(m, batch: dict, inputs: dict, mesh=None) -> dict[str, np.ndarray]:
    """loss_grads of one joint step of `m` on `batch` (this rank's share
    under `mesh`), with JAX's first noise draw."""
    f = m.fields[-1]
    dev = m._device_batch(batch)
    g_field, g_pose, _, metrics = tstep.loss_grads(
        f["params"], m._pose_dev, m.intr.params, m._statics(True, dev["view_ids"].shape[0]), dev,
        m._scalars_py(), step_noise(inputs)[0], f["alpha_volume"], mesh=mesh)
    return grads_state(g_field, g_pose, metrics)


def eval_model(mesh=None):
    """The port's seeded model (its own init): one field over EVAL_INIT frames."""
    m = tlocal.LocalTensorfs(tlocal.LocalConfig(WH=(W, H), n_init_frames=EVAL_INIT,
                                                tensorf=ttf.TensorfConfig(**TF_KW)), device="cpu")
    if mesh is not None:
        m.set_mesh(mesh)
    return m


def spawn_field(m) -> None:
    """Two frames appended, a field spawned cross-fading over them, the
    window slid to its first frame."""
    for _ in range(2):
        m.append_frame()
    m.append_rf(2)
    m.set_window_start(int(np.argmax(m.blending_weights[:, -1] > 0)))


# eval calls: name -> (view ids, chunk), on the one-field model, then after
# spawn_field on the two-field one ("fade": the cross-fade frame)
EVAL_ONE = {"one-view": ([1], 256), "several-views": ([0, 2, 3], 256), "indivisible-chunk": ([1], 255)}
EVAL_TWO = {"two-fields": ([EVAL_INIT], 256), "two-fields-several-views": ([EVAL_INIT - 1, EVAL_INIT + 1], 256)}


def eval_frames(m, calls: dict) -> dict[str, np.ndarray]:
    out = {}
    for name, (views, chunk) in calls.items():
        ids = np.concatenate([np.arange(W * H)] * len(views))
        rgb, depth, _, _ = m.forward_eval(ids, np.asarray(views), W, H, chunk=chunk)
        out[f"{name}/rgb"], out[f"{name}/depth"] = rgb.numpy().copy(), depth.numpy().copy()
    return out


def sp_rays(n: int = SP_RAYS) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(3)
    return (rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32),
            rng.normal(0, 1, (n, 3)).astype(np.float32))


def ball(grid: int = 12) -> np.ndarray:
    ax = np.linspace(-1, 1, grid, dtype=np.float32)
    zz, yy, xx = np.meshgrid(ax, ax, ax, indexing="ij")
    return ((xx**2 + yy**2 + zz**2) < 0.6**2).astype(np.float32)


def sp_render(inputs: dict, mesh) -> dict[str, np.ndarray]:
    """render_rays_sp of JAX's field init over the rays of sp_rays, with no
    alpha volume and with the ball."""
    params = jax_field(inputs)
    cfg = ttf.TensorfConfig(**TF_KW)
    rays_o, rays_d = (torch.from_numpy(a) for a in sp_rays())
    out = {}
    for occ, av in (("", None), ("-occ", torch.from_numpy(ball()))):
        rgb, depth = sp.render_rays_sp(params, cfg, rays_o, rays_d, mesh, alpha_volume=av)
        out[f"rgb{occ}"], out[f"depth{occ}"] = rgb.numpy(), depth.numpy()
    return out


# ------------------------------ the ranks' jobs ------------------------------


def job_chunk(rank: int, world: int, inputs: dict) -> dict:
    """A pooled chunk under a "data" mesh over every rank."""
    return model_state(chunk_model(inputs, sharding.make_mesh(world, "cpu")))


def job_world1(rank: int, world: int, inputs: dict) -> dict:
    """The same chunk under a mesh of this rank alone, and with no mesh."""
    groups = [dist.new_group([r]) for r in range(world)]
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh.from_group(groups[rank], "cpu", mesh_dim_names=(sharding.DATA_AXIS,))
    out = {f"mesh/{k}": v for k, v in model_state(chunk_model(inputs, mesh)).items()}
    out.update({f"none/{k}": v for k, v in model_state(chunk_model(inputs)).items()})
    return out


def job_trap(rank: int, world: int, inputs: dict) -> dict:
    """One step's gradients on shards weighed differently: through
    loss_grads under the mesh (the global mean(loss_weights)), and as a
    per-rank ratio of means (loss_grads of the shard alone, then the same
    reduction of its gradients and metrics)."""
    mesh = sharding.make_mesh(world, "cpu")
    m = field_model(inputs)
    m.set_mesh(mesh)
    batch = joint_batch(dataset())
    out = {f"right/{k}": v for k, v in step_grads(m, batch, inputs, mesh).items()}
    wrong = step_grads(m, batch, inputs)  # the shard's own ratio, not reduced yet
    names = list(wrong)
    reduced = sharding.all_mean([torch.from_numpy(wrong[k]) for k in names], mesh)
    out.update({f"wrong/{k}": v.numpy() for k, v in zip(names, reduced)})
    return out


def job_odd(rank: int, world: int, inputs: dict) -> dict:
    """A chunk of ODD_VIEWS views, which do not split over the ranks, and
    the same chunk with no mesh (in this process: CPU reductions may add
    in another order with another thread count)."""
    out = {f"mesh/{k}": v for k, v in
           model_state(chunk_model(inputs, sharding.make_mesh(world, "cpu"), ODD_VIEWS, ODD_BATCH)).items()}
    out.update({f"none/{k}": v for k, v in model_state(chunk_model(inputs, None, ODD_VIEWS, ODD_BATCH)).items()})
    return out


def job_eval(rank: int, world: int, inputs: dict) -> dict:
    """forward_eval split over the ranks: one field, then two."""
    m = eval_model(sharding.make_mesh(world, "cpu"))
    out = eval_frames(m, EVAL_ONE)
    spawn_field(m)
    out.update(eval_frames(m, EVAL_TWO))
    return out


def job_sp(rank: int, world: int, inputs: dict) -> dict:
    """render_rays_sp on each mesh of SP_CASES over this many ranks."""
    out = {}
    for case, (ranks, shape) in SP_CASES.items():
        if ranks != world:
            continue
        mesh = (sp.make_sp_mesh(shape[0], "cpu") if len(shape) == 1
                else sp.make_dp_sp_mesh(*shape, device_type="cpu"))
        out.update({f"{case}/{k}": v for k, v in sp_render(inputs, mesh).items()})
    return out


JOBS = {name[4:]: fn for name, fn in list(globals().items()) if name.startswith("job_")}


def _rank_main(rank: int, world: int, store: str, inputs_path: str, out_dir: str, jobs: list[str]) -> None:
    try:
        torch.set_num_threads(THREADS)
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        inputs = dict(np.load(inputs_path)) if inputs_path else {}
        for job in jobs:
            np.savez(os.path.join(out_dir, f"{job}_{rank}.npz"), **JOBS[job](rank, world, inputs))
        if any(m.split(".")[0] in ("jax", "jaxlib", "localrf_tpu") for m in sys.modules):
            raise AssertionError("a rank imported jax or the JAX package")
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def spawn(world: int, tmp_dir: str, inputs_path: str | None, jobs: list[str], timeout_s: float = 150.0) -> str:
    """Run `jobs` on a gloo group of `world` spawned processes; returns the
    directory of their .npz results. Raises if a rank fails or the group
    does not finish within timeout_s (the processes are then killed)."""
    out_dir = os.path.join(tmp_dir, f"ranks{world}")
    os.makedirs(out_dir)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, os.path.join(out_dir, "store"), inputs_path,
                                                  out_dir, jobs))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join(10)
    if hung:
        raise TimeoutError(f"ranks {hung} of {world} did not finish {jobs} within {timeout_s} s")
    failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if failed:
        raise RuntimeError(f"ranks failed (exit codes {failed}) running {jobs}")
    return out_dir


def result(out_dir: str, job: str, rank: int) -> dict[str, np.ndarray]:
    return dict(np.load(os.path.join(out_dir, f"{job}_{rank}.npz")))
