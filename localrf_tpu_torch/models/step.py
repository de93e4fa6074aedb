"""Training step for joint pose + field optimization (PyTorch port of
localrf_tpu/models/step.py).

Loss construction, backward, per-frame-gated Adam steps and lr decay for
one batch, and the chunk executors `train_chunk` / `train_chunk_pooled`
(JAX runs K steps in one `lax.scan`). The per-step scalars JAX traces (lr
factor, refine/regularize flags, loss weights, the window length,
world2rf) are device tensors here and the gates on them are tensor
operations, so a step reads no value back to the host and can be captured
as a CUDA graph (models/graph.py). Four host branches key the graphs
(`StepBranches`): the regularizers JAX runs as `lax.cond` on tv_wd, tv_wa
and l1_w > 0, and the pose-only switch (JAX gates on a traced 0/1).

The eval render `render_frame` runs one field over a frame's fixed-size
chunks of rays under `torch.no_grad()`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ..ops.math import compute_depth_loss, get_pred_flow, inverse_pose, sixD_to_mtx
from ..ops.rays import get_ray_directions_360, get_ray_directions_lean, get_rays_lean, ids2pixel
from ..optim import (
    AdamState,
    PyTreeAdamState,
    adam_update,
    field_base_lrs,
    pytree_adam_update,
    scale_lr,
)
from ..parallel.sharding import all_mean, captures_collectives
from ..utils import profiling
from .render import render_rays
from .tensorf import (
    TensorfConfig,
    density_l1,
    factor_names,
    tv_loss_app,
    tv_loss_density,
)


class FieldState(NamedTuple):
    params: Any  # TensorfField
    opt: PyTreeAdamState


class PoseState(NamedTuple):
    """Sliding-window pose/exposure parameters, stacked over frames [Wc]."""

    r: torch.Tensor  # [Wc, 3, 2]
    t: torch.Tensor  # [Wc, 3]
    exposure: torch.Tensor  # [Wc, 3, 3]
    r_opt: AdamState
    t_opt: AdamState
    e_opt: AdamState


class IntrState(NamedTuple):
    params: dict  # {"focal_offset": [], "center_rel": [2]}
    opt: PyTreeAdamState


@dataclasses.dataclass(frozen=True)
class StepStatics:
    """Static step configuration (the JAX compile-bucket key)."""

    cfg: TensorfConfig
    w: int
    h: int
    n_views: int
    px_per_view: int
    wc: int  # window capacity
    fov360: bool = False
    white_bg: bool = True
    optimize_poses: bool = True
    exposure_on: bool = True
    intrinsics_on: bool = False
    flow_on: bool = True
    depth_on: bool = True
    has_alpha: bool = False
    flow_weight: float = 1.0
    depth_weight: float = 0.1
    lr_spatial: float = 0.02
    lr_net: float = 1e-3


@dataclasses.dataclass(frozen=True)
class StepBranches:
    """The host-side switches of one step: whether each of JAX's three
    regularizer `lax.cond`s (tv_wd, tv_wa, l1_w > 0) takes its loss branch,
    and whether the step is a pose-only one (a test-pose batch).
    The graph executor captures one graph per (StepStatics, StepBranches)."""

    tv_density: bool = False
    tv_app: bool = False
    l1: bool = False
    pose_only: bool = False

    @classmethod
    def of(cls, scalars: dict) -> "StepBranches":
        """From one step's host scalars (a tensor is read back: a sync on a card)."""
        return cls(
            float(scalars["tv_wd"]) > 0, float(scalars["tv_wa"]) > 0, float(scalars["l1_w"]) > 0,
            float(scalars.get("pose_only", 0.0)) > 0,
        )


def metric_names(statics: StepStatics) -> tuple[str, ...]:
    """The metrics a step of `statics` returns, in order."""
    return (
        ("rgb_loss",) + (("flow_loss",) if statics.flow_on else ())
        + (("depth_loss",) if statics.depth_on else ()) + ("tv_loss", "l1_loss", "total_loss")
    )


def _scalar_dtype(key: str) -> torch.dtype:
    return torch.int64 if key == "n_valid" else torch.float32


def scalar_tensors(scalars: dict, device) -> dict:
    """One step's scalars as tensors on `device`: numbers become 0-d float32
    (n_valid int64; world2rf [3]); tensors pass through."""
    return {
        k: v if isinstance(v, torch.Tensor)
        else torch.as_tensor(np.asarray(v), dtype=_scalar_dtype(k), device=device)
        for k, v in scalars.items()
    }


def stack_scalars(seq: list[dict], device) -> dict:
    """K steps' host scalars -> {key: [K, ...] tensor} on `device`, in three
    copies: the float32 scalars packed into one [K, n] array (each key a
    column view), world2rf [K, 3] and n_valid [K] int64."""
    keys = [k for k in seq[0] if k not in ("world2rf", "n_valid")]
    host = (np.asarray([[sc[k] for k in keys] for sc in seq], np.float32),
            np.stack([np.asarray(sc["world2rf"], np.float32) for sc in seq]),
            np.asarray([sc["n_valid"] for sc in seq], np.int64))
    profiling.count("h2d.copies", len(host))
    profiling.count("h2d.bytes", sum(a.nbytes for a in host))
    packed, world2rf, n_valid = (torch.from_numpy(a).to(device) for a in host)
    out = {k: packed[:, i] for i, k in enumerate(keys)}
    out["world2rf"] = world2rf
    out["n_valid"] = n_valid
    return out


def stack_noise(seq: list[dict]) -> dict:
    """K steps' noise dicts (render.draw_noise) -> {key: [K, ...]}."""
    return {k: torch.stack([n[k] for n in seq]) for k in seq[0]}


def row(seq: dict, k: int) -> dict:
    """Step k of [K, ...]-stacked inputs."""
    return {key: v[k] for key, v in seq.items()}


def cam2world_from_params(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[N,3,2]+[N,3] -> [N,3,4]."""
    return torch.cat([sixD_to_mtx(r), t[..., None]], dim=-1)


def _repeat_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """Each row of x repeated n times (repeat_interleave along dim 0)."""
    return x[:, None].expand(x.shape[0], n, *x.shape[1:]).reshape(x.shape[0] * n, *x.shape[1:])


def _cam2cams_clamped(c2w: torch.Tensor, indices: torch.Tensor, offset: int, n_valid: torch.Tensor):
    """Relative pose from camera i to camera i+offset, the neighbour index
    clamped to the valid window prefix."""
    idx = torch.minimum(torch.clamp(indices + offset, min=0), n_valid - 1)
    world2cam = inverse_pose(c2w[idx])
    rot = torch.matmul(world2cam[:, :3, :3], c2w[indices, :3, :3])
    t = torch.matmul(world2cam[:, :3, :3], c2w[indices, :3, 3:])[..., 0]
    t = t + world2cam[:, :3, 3]
    return torch.cat([rot, t[..., None]], dim=-1)


def _focal(intr_params, init_focal, w_scale):
    return init_focal * intr_params["focal_offset"] * w_scale


def _center(intr_params, w, h):
    c = intr_params["center_rel"]
    return torch.stack([c[0] * w, c[1] * h])


def _apply_exposure(rgb, exposure, view_ids, px_per_view, n_valid: torch.Tensor, test_id):
    """Per-frame 3x3 exposure. In test-pose mode (test_id 1) use the detached
    average of the two neighbours' exposures."""
    v_m = torch.clamp(view_ids - 1, min=0)
    v_m = torch.where(v_m == view_ids, 1, v_m)
    v_p = torch.minimum(view_ids + 1, n_valid - 1)
    e_avg = ((exposure[v_m] + exposure[v_p]) / 2.0).detach()
    e_own = exposure[view_ids]
    e = e_avg * test_id + e_own * (1.0 - test_id)
    return torch.einsum("bij,bj->bi", _repeat_rows(e, px_per_view), rgb)


def forward_rays(
    field_params,
    pose: PoseState,
    intr_params,
    statics: StepStatics,
    ray_idx: torch.Tensor,
    view_ids: torch.Tensor,
    scalars: dict[str, Any],
    noise: dict | None,
    *,
    is_train: bool,
    test_id=0.0,
    alpha_volume=None,
):
    """Rays from (pose, intrinsics), one-field render, exposure.
    `scalars` holds tensors (scalar_tensors). Returns (rgb [B,3], depth [B],
    directions [B,3], ij [B,2], focal, center)."""
    s = statics
    dev = ray_idx.device
    i, j = ids2pixel(s.w, s.h, ray_idx)
    if s.fov360:
        directions = get_ray_directions_360(i, j, s.w, s.h)
        focal = torch.ones((), device=dev)
        center = torch.stack([torch.full((), s.w / 2, device=dev), torch.full((), s.h / 2, device=dev)])
    else:
        focal = _focal(intr_params, scalars["init_focal"], scalars["w_scale"])
        center = _center(intr_params, s.w, s.h)
        directions = get_ray_directions_lean(i, j, focal, center)

    c2w = cam2world_from_params(pose.r[view_ids], pose.t[view_ids])  # [V,3,4]
    cam2rf = torch.cat([c2w[..., :3], (c2w[..., 3] + scalars["world2rf"])[..., None]], dim=-1)
    cam2rf = _repeat_rows(cam2rf, s.px_per_view)  # [B,3,4]

    rays_o, rays_d = get_rays_lean(directions, cam2rf)
    rgb, depth = render_rays(
        field_params, s.cfg, rays_o, rays_d,
        is_train=is_train, white_bg=s.white_bg, refine=scalars["refine"],
        alpha_volume=alpha_volume, noise=noise,
    )
    if s.exposure_on:
        rgb = _apply_exposure(
            rgb, pose.exposure, view_ids, s.px_per_view, scalars["n_valid"], test_id
        )
    rgb = torch.clamp(rgb, 0.0, 1.0)
    ij = torch.stack([i, j], dim=-1)
    return rgb, depth, directions, ij, focal, center


def _losses(field_params, pose, intr_params, statics, batch, scalars, noise, branches: StepBranches,
            *, alpha_volume=None, lw_mean=None):
    """The step's losses on `batch`. `lw_mean` is the rgb loss's denominator,
    mean(loss_weights) over the global batch when `batch` is one rank's
    share of it (default: over `batch`)."""
    s = statics
    rgb, depth, directions, ij, focal, center = forward_rays(
        field_params, pose, intr_params, s, batch["ray_idx"], batch["view_ids"], scalars, noise,
        is_train=True, test_id=scalars["pose_only"], alpha_volume=alpha_volume,
    )
    lw = batch["loss_weights"]
    rgb_loss = 0.25 * torch.mean(torch.abs(rgb - batch["rgbs"]) * lw) / (
        torch.mean(lw) if lw_mean is None else lw_mean)
    total = rgb_loss
    metrics = {"rgb_loss": rgb_loss}

    v, p = s.n_views, s.px_per_view
    reg_flag = scalars["reg_flag"]  # 0/1: rf_iter < n_iters_reg
    reg_w = scalars["reg_w"]  # lr_factor ** rf_iter
    depth_v = depth.reshape(v, p)

    if s.flow_on:
        # optical-flow reprojection loss
        c2w_win = cam2world_from_params(pose.r, pose.t)  # [Wc,3,4] world space
        n_valid = scalars["n_valid"]
        fwd_c2c = _cam2cams_clamped(c2w_win, batch["view_ids"], 1, n_valid)
        bwd_c2c = _cam2cams_clamped(c2w_win, batch["view_ids"], -1, n_valid)
        pts = directions.reshape(v, p, 3) * depth_v[..., None]
        ij_v = ij.reshape(v, p, 2)
        pred_fwd = get_pred_flow(pts, ij_v, fwd_c2c, focal, center)
        pred_bwd = get_pred_flow(pts, ij_v, bwd_c2c, focal, center)
        fwd_mask = batch["fwd_mask"].reshape(v, p)
        fwd_mask = torch.where((batch["view_ids"] == n_valid - 1)[:, None], 0.0, fwd_mask)
        bwd_mask = batch["bwd_mask"].reshape(v, p)
        arr = torch.sum(torch.abs(pred_bwd - batch["bwd_flow"].reshape(v, p, 2)), -1) * bwd_mask
        arr = arr + torch.sum(torch.abs(pred_fwd - batch["fwd_flow"].reshape(v, p, 2)), -1) * fwd_mask
        q = torch.quantile(arr, 0.9, dim=1, keepdim=True)
        arr = torch.where(arr > q, 0.0, arr)
        flow_loss = (torch.mean(arr) * s.flow_weight * reg_w / ((s.w + s.h) / 2)) * reg_flag
        total = total + flow_loss
        metrics["flow_loss"] = flow_loss

    if s.depth_on:
        # scale/shift-invariant monodepth loss
        inv_gt = batch["invdepths"].reshape(v, p)
        _, _, arr = compute_depth_loss(1.0 / torch.clamp(depth_v, min=1e-6), inv_gt)
        q = torch.quantile(arr, 0.8, dim=1, keepdim=True)
        arr = torch.where(arr > q, 0.0, arr)
        depth_loss = (torch.mean(arr) * s.depth_weight * reg_w) * reg_flag
        total = total + depth_loss
        metrics["depth_loss"] = depth_loss

    # TV / density-L1 regularizers with host-computed weights; the branches
    # are JAX's lax.conds on tv_wd, tv_wa, l1_w > 0, decided on the host.
    # The tracer's marks bracket them (their backward runs first, as they
    # are made last); with no branch on, the same stamps mark an empty span
    zero = torch.zeros((), device=rgb.device)
    kinds = (("density",) if branches.tv_density or branches.l1 else ()) + (("app",) if branches.tv_app else ())
    names = [n for kind in kinds for n in factor_names(s.cfg, kind)]
    if names:
        reg_params = dict(zip(names, profiling.mark(
            "regularizer", "regularizer.bwd_end", *(field_params[n] for n in names))))
        tv = tv_loss_density(reg_params) * scalars["tv_wd"] if branches.tv_density else zero
        if branches.tv_app:
            tv = tv + tv_loss_app(reg_params) * scalars["tv_wa"]
        l1 = density_l1(reg_params, s.cfg) * scalars["l1_w"] if branches.l1 else zero
        tv, l1 = profiling.mark("regularizer.end", "regularizer.bwd", tv, l1)
    else:
        tv = l1 = zero
        for name in ("regularizer", "regularizer.end", "regularizer.bwd", "regularizer.bwd_end"):
            profiling.stamp(name)
    total = total + tv + l1
    metrics["tv_loss"] = tv
    metrics["l1_loss"] = l1
    metrics["total_loss"] = total
    return total, metrics


def _step_scalars(scalars: dict, device) -> dict:
    return scalar_tensors({"pose_only": 0.0, **scalars}, device)


def loss_grads(field_params, pose, intr_params, statics, batch, scalars, noise, alpha_volume=None,
               branches: StepBranches | None = None, mesh=None):
    """Losses and their gradients w.r.t. the field parameters (by name), the
    pose window (r, t, exposure) and, when optimized, the intrinsics.
    `scalars` holds numbers or tensors; `branches` defaults to the
    regularizer switches read from them. Returns (g_field, (g_r, g_t, g_e),
    g_intr, metrics).

    With a `mesh` (parallel/sharding.py), `batch` is this rank's share of
    the global batch and the results are those of the global batch, equal
    on every rank: the loss is the mean over ranks of the ranks' losses.
    That holds term by term once the rgb loss, a ratio of means, divides by
    the global mean(loss_weights) (one scalar reduction before the forward
    pass; it does not depend on the parameters): the flow and depth losses
    are means over equal view shards (each view's quantile is local), the
    regularizers are the same on every rank. So the gradients and metrics
    are each rank's, reduced once by their mean (sharding.all_mean)."""
    if branches is None:
        branches = StepBranches.of(scalars)
    scalars = _step_scalars(scalars, pose.r.device)
    named = dict(field_params.named_parameters())
    r, t, e = (x.detach().requires_grad_(True) for x in (pose.r, pose.t, pose.exposure))
    intr_p = {k: v.detach().requires_grad_(statics.intrinsics_on) for k, v in intr_params.items()}
    lw_mean = None
    if mesh is not None:
        (lw_mean,) = all_mean([torch.mean(batch["loss_weights"])], mesh)
    total, metrics = _losses(
        field_params, pose._replace(r=r, t=t, exposure=e), intr_p, statics, batch, scalars, noise,
        branches, alpha_volume=alpha_volume, lw_mean=lw_mean,
    )
    leaves = list(named.values()) + [r, t, e]
    if statics.intrinsics_on:
        leaves += list(intr_p.values())
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    if mesh is not None:
        reduced = all_mean(grads + list(metrics.values()), mesh)
        grads, metrics = reduced[: len(grads)], dict(zip(metrics, reduced[len(grads) :]))
    n = len(named)
    g_field = dict(zip(named, grads[:n]))
    g_intr = dict(zip(intr_p, grads[n + 3 :]))
    return g_field, tuple(grads[n : n + 3]), g_intr, metrics


def train_core(
    field: FieldState,
    pose: PoseState,
    intr: IntrState,
    batch: dict,
    scalars: dict,
    statics: StepStatics,
    noise: dict,
    alpha_volume=None,
    branches: StepBranches | None = None,
    mesh=None,
):
    """One optimization step (with a `mesh`, on this rank's share of the
    batch and the gradients of the global one: loss_grads). `branches.pose_only` switches between the full
    joint step and photometric test-pose refinement: a pose-only step moves
    the poses only (no field, exposure or intrinsics update, no lr decay)
    and averages the exposure of the neighbours. That switch is a host
    branch, as it keys the captured graphs; JAX gates on a traced
    `pose_only` with the same results. The other gates (the per-frame pose
    gate, refining, first field) are tensor operations. The field and
    intrinsics (parameters and Adam state) are updated in place; returns
    (field, pose, intr, metrics)."""
    s = statics
    if branches is None:
        branches = StepBranches.of(scalars)
    scalars = _step_scalars(scalars, pose.r.device)
    g_field, (g_r, g_t, g_e), g_intr, metrics = loss_grads(
        field.params, pose, intr.params, s, batch, scalars, noise, alpha_volume, branches, mesh
    )
    profiling.stamp("adam")

    lr_factor = scalars["lr_factor"]
    is_refining = scalars["is_refining"] > 0
    gate = batch["gate"]  # [Wc] bool: linked to the current RF, rf_iter < n_iters

    # --- poses (on joint steps the lr decays first), then the gated step ---
    new_pose = pose
    if s.optimize_poses:
        r_opt, t_opt = pose.r_opt, pose.t_opt
        if not branches.pose_only:
            r_opt = scale_lr(r_opt, lr_factor, gate)
            t_opt = scale_lr(t_opt, lr_factor, gate)
        new_r, r_opt = adam_update(pose.r, g_r, r_opt, gate)
        new_t, t_opt = adam_update(pose.t, g_t, t_opt, gate)
        new_pose = pose._replace(r=new_r, t=new_t, r_opt=r_opt, t_opt=t_opt)
    if branches.pose_only:
        return field, new_pose, intr, metrics

    # --- field (lr decays after the step while refining) ---
    base_lrs = field_base_lrs(field.params, s.lr_spatial, s.lr_net)
    params, f_opt = pytree_adam_update(field.params, g_field, field.opt, base_lrs)
    with torch.no_grad():
        f_opt.lr_scale.mul_(torch.where(is_refining, lr_factor, 1.0))
    new_field = FieldState(params, f_opt)

    if s.exposure_on:
        e_opt = scale_lr(pose.e_opt, lr_factor, gate)
        new_e, e_opt = adam_update(pose.exposure, g_e, e_opt, gate)
        new_pose = new_pose._replace(exposure=new_e, e_opt=e_opt)

    # --- intrinsics: only while optimizing the first RF and refining ---
    new_intr = intr
    if s.intrinsics_on:
        gate_i = (scalars["is_first_rf"] > 0) & is_refining
        with torch.no_grad():
            intr.opt.lr_scale.mul_(torch.where(gate_i, lr_factor, 1.0))
        i_lrs = {k: scalars["lr_i_base"] for k in intr.params}
        i_params, i_opt = pytree_adam_update(intr.params, g_intr, intr.opt, i_lrs, gate=gate_i)
        new_intr = IntrState(i_params, i_opt)

    return new_field, new_pose, new_intr, metrics


# ------------------------------ chunks ------------------------------


def pooled_batch(pool: dict, idx: dict, px_per_view: int, n_px: int) -> dict:
    """One step's batch gathered from the pixel pool's flat [capacity *
    n_px, ...] arrays: rows slot(view) * n_px + px (JAX train_chunk_pooled)."""
    slots = idx["slots"]
    rows = _repeat_rows(slots * n_px, px_per_view) + idx["px"]
    batch = {
        "ray_idx": idx["px"],
        "view_ids": idx["view_ids"],
        "gate": idx["gate"],
        "rgbs": pool["rgbs"].index_select(0, rows),
        "loss_weights": pool["loss_weights"].index_select(0, rows)[:, None],
    }
    for k in ("invdepths", "fwd_flow", "bwd_flow", "fwd_mask", "bwd_mask"):
        if k in pool:
            batch[k] = pool[k].index_select(0, rows)
    return batch


def _run_chunk(field, pose, intr, batch_of, inputs_seq, scalars_seq, statics, noise_seq, n_steps,
               alpha_volume, branches_seq, graphs, mesh, bound=(), stamps=None):
    if len(branches_seq) != n_steps:
        raise ValueError(f"{len(branches_seq)} step branches for {n_steps} steps")
    if graphs is not None:
        return graphs.run(field, pose, intr, statics, alpha_volume, batch_of, bound, inputs_seq,
                          scalars_seq, noise_seq, branches_seq, n_steps, mesh)
    # a mesh whose collectives no graph captures (gloo) steps eagerly on a card
    if pose.r.device.type == "cuda" and (mesh is None or captures_collectives(mesh)):
        raise ValueError("a chunk on CUDA replays captured graphs: pass graphs=ChunkGraphs(device)")
    return run_steps(field, pose, intr, batch_of, inputs_seq, scalars_seq, statics, noise_seq, n_steps,
                     alpha_volume, branches_seq, mesh, stamps)


def run_steps(field, pose, intr, batch_of, inputs_seq, scalars_seq, statics, noise_seq, n_steps,
              alpha_volume, branches_seq, mesh=None, stamps=None):
    """K steps taken eagerly, one train_core after another (the chunk on
    the CPU and under a gloo mesh), step k stamped into row k of `stamps`.
    Returns (field, pose, intr, metrics {name: [K]})."""
    out = []
    for k in range(n_steps):
        if stamps is not None:
            stamps.row = k
        with profiling.stamping(stamps):
            profiling.stamp("start")
            field, pose, intr, metrics = train_core(
                field, pose, intr, batch_of(row(inputs_seq, k)), row(scalars_seq, k), statics,
                row(noise_seq, k), alpha_volume, branches_seq[k], mesh,
            )
            out.append(metrics)
            profiling.stamp("end")
    return field, pose, intr, {name: torch.stack([m[name] for m in out]) for name in out[0]}


def train_chunk(field, pose, intr, batches: dict, scalars_seq: dict, statics: StepStatics,
                noise_seq: dict, n_steps: int, alpha_volume=None, *,
                branches_seq: list[StepBranches], graphs=None, mesh=None, stamps=None):
    """K training steps on [K, ...]-stacked batches, scalars (stack_scalars)
    and noise (stack_noise); `branches_seq` holds each step's StepBranches.
    On the CPU a loop over train_core; on CUDA every step replays a captured
    graph of one step (`graphs`, a models.graph.ChunkGraphs): the PyTorch
    counterpart of JAX's one lax.scan dispatch; under a gloo `mesh`, whose
    collectives no graph captures, the loop again. The loop stamps step k
    into row k of `stamps` (a profiling.StampRing, or None); the graphs
    stamp into their own ring. Returns (field, pose, intr, metrics {name:
    [K]})."""
    return _run_chunk(field, pose, intr, lambda b: b, batches, scalars_seq, statics, noise_seq,
                      n_steps, alpha_volume, branches_seq, graphs, mesh, stamps=stamps)


def train_chunk_pooled(field, pose, intr, pool: dict, index_seq: dict, scalars_seq: dict,
                       statics: StepStatics, noise_seq: dict, n_steps: int, n_px: int,
                       alpha_volume=None, *, branches_seq: list[StepBranches], graphs=None,
                       mesh=None, stamps=None):
    """train_chunk over the device-resident pixel pool (data/pool.py): the
    host ships index streams {"px" [K, B], "slots" [K, V], "view_ids" [K, V],
    "gate" [K, Wc]} and every step gathers its pixel values from `pool`."""
    return _run_chunk(
        field, pose, intr, lambda idx: pooled_batch(pool, idx, statics.px_per_view, n_px),
        index_seq, scalars_seq, statics, noise_seq, n_steps, alpha_volume, branches_seq, graphs,
        mesh, bound=tuple(pool.values()), stamps=stamps,
    )


# ------------------------------ eval ------------------------------


@torch.no_grad()
def render_frame(field_params, cfg: TensorfConfig, ray_idx: torch.Tensor, cam2rf: torch.Tensor,
                 focal, center, *, w: int, h: int, floater_thresh: float = 0.0, white_bg: bool = True,
                 fov360: bool = False, refine=1.0, alpha_volume=None, quad: dict | None):
    """Whole-frame eval render against one field: ray_idx [n_chunks, chunk]
    pixel ids (the last chunk padded), one pose cam2rf [3, 4]. A loop over
    the chunks with no host sync (JAX's lax.scan). `quad` is the field's
    build_combined_quad_views, built by the caller (None on the
    grid-sample route). Returns (rgb [n_chunks * chunk, 3], depth
    [n_chunks * chunk])."""
    n_chunks, chunk = ray_idx.shape
    c2rf = cam2rf[None].expand(chunk, 3, 4)
    rgb = torch.empty((n_chunks, chunk, 3), device=ray_idx.device)
    depth = torch.empty((n_chunks, chunk), device=ray_idx.device)
    # while the tracer stamps a frame: chunk c at the ring's row cursor + c
    ring = profiling.active_ring()
    base = ring.row if ring is not None else 0
    for c in range(n_chunks):
        if ring is not None:
            ring.row = base + c
        profiling.stamp("start")
        i, j = ids2pixel(w, h, ray_idx[c])
        if fov360:
            directions = get_ray_directions_360(i, j, w, h)
        else:
            directions = get_ray_directions_lean(i, j, focal, center)
        rays_o, rays_d = get_rays_lean(directions, c2rf)
        rgb[c], depth[c] = render_rays(
            field_params, cfg, rays_o, rays_d, is_train=False, white_bg=white_bg, refine=refine,
            floater_thresh=floater_thresh, alpha_volume=alpha_volume, quad=quad,
        )
        profiling.stamp("end")
    if ring is not None:
        ring.row = base + n_chunks
    return rgb.reshape(-1, 3), depth.reshape(-1)
