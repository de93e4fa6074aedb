"""Training step for joint pose + field optimization (PyTorch port of
localrf_tpu/models/step.py).

Loss construction, backward, per-frame-gated Adam steps and lr decay for
one batch. Scalars the JAX package traces (lr factor, refine/regularize
flags, loss weights) are host Python numbers here, so its `lax.cond`s are
plain `if`s.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

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
from .render import render_rays
from .tensorf import TensorfConfig, density_l1, tv_loss_app, tv_loss_density


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


def cam2world_from_params(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[N,3,2]+[N,3] -> [N,3,4]."""
    return torch.cat([sixD_to_mtx(r), t[..., None]], dim=-1)


def _cam2cams_clamped(c2w: torch.Tensor, indices: torch.Tensor, offset: int, n_valid: int):
    """Relative pose from camera i to camera i+offset, the neighbour index
    clamped to the valid window prefix."""
    idx = torch.clamp(indices + offset, 0, n_valid - 1)
    world2cam = inverse_pose(c2w[idx])
    rot = torch.matmul(world2cam[:, :3, :3], c2w[indices, :3, :3])
    t = torch.matmul(world2cam[:, :3, :3], c2w[indices, :3, 3:])[..., 0]
    t = t + world2cam[:, :3, 3]
    return torch.cat([rot, t[..., None]], dim=-1)


def _focal(intr_params, init_focal, w_scale):
    return init_focal * intr_params["focal_offset"] * w_scale


def _center(intr_params, w, h):
    wh = torch.tensor([w, h], dtype=torch.float32, device=intr_params["center_rel"].device)
    return wh * intr_params["center_rel"]


def _apply_exposure(rgb, exposure, view_ids, px_per_view, n_valid: int, test_id: float):
    """Per-frame 3x3 exposure. In test-pose mode (test_id 1) use the detached
    average of the two neighbours' exposures."""
    v_m = torch.clamp(view_ids - 1, min=0)
    v_m = torch.where(v_m == view_ids, 1, v_m)
    v_p = torch.clamp(view_ids + 1, max=n_valid - 1)
    e_avg = ((exposure[v_m] + exposure[v_p]) / 2.0).detach()
    e_own = exposure[view_ids]
    e = e_avg * test_id + e_own * (1.0 - test_id)
    e = torch.repeat_interleave(e, px_per_view, dim=0)
    return torch.einsum("bij,bj->bi", e, rgb)


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
    test_id: float = 0.0,
    alpha_volume=None,
):
    """Rays from (pose, intrinsics), one-field render, exposure.
    Returns (rgb [B,3], depth [B], directions [B,3], ij [B,2], focal, center)."""
    s = statics
    i, j = ids2pixel(s.w, s.h, ray_idx)
    if s.fov360:
        directions = get_ray_directions_360(i, j, s.w, s.h)
        focal = torch.tensor(1.0, device=ray_idx.device)
        center = torch.tensor([s.w / 2, s.h / 2], dtype=torch.float32, device=ray_idx.device)
    else:
        focal = _focal(intr_params, scalars["init_focal"], scalars["w_scale"])
        center = _center(intr_params, s.w, s.h)
        directions = get_ray_directions_lean(i, j, focal, center)

    c2w = cam2world_from_params(pose.r[view_ids], pose.t[view_ids])  # [V,3,4]
    world2rf = torch.as_tensor(scalars["world2rf"], dtype=torch.float32, device=c2w.device)
    cam2rf = torch.cat([c2w[..., :3], (c2w[..., 3] + world2rf)[..., None]], dim=-1)
    cam2rf = torch.repeat_interleave(cam2rf, s.px_per_view, dim=0)  # [B,3,4]

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


def _losses(field_params, pose, intr_params, statics, batch, scalars, noise, *, alpha_volume=None):
    s = statics
    rgb, depth, directions, ij, focal, center = forward_rays(
        field_params, pose, intr_params, s, batch["ray_idx"], batch["view_ids"], scalars, noise,
        is_train=True, test_id=scalars.get("pose_only", 0.0), alpha_volume=alpha_volume,
    )
    lw = batch["loss_weights"]
    rgb_loss = 0.25 * torch.mean(torch.abs(rgb - batch["rgbs"]) * lw) / torch.mean(lw)
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

    # TV / density-L1 regularizers with host-computed weights
    zero = torch.zeros((), device=rgb.device)
    tv_wd, tv_wa, l1_w = scalars["tv_wd"], scalars["tv_wa"], scalars["l1_w"]
    tv = tv_loss_density(field_params) * tv_wd if tv_wd > 0 else zero
    if tv_wa > 0:
        tv = tv + tv_loss_app(field_params) * tv_wa
    l1 = density_l1(field_params, s.cfg) * l1_w if l1_w > 0 else zero
    total = total + tv + l1
    metrics["tv_loss"] = tv
    metrics["l1_loss"] = l1
    metrics["total_loss"] = total
    return total, metrics


def loss_grads(field_params, pose, intr_params, statics, batch, scalars, noise, alpha_volume=None):
    """Losses and their gradients w.r.t. the field parameters (by name), the
    pose window (r, t, exposure) and, when optimized, the intrinsics.
    Returns (g_field, (g_r, g_t, g_e), g_intr, metrics)."""
    named = dict(field_params.named_parameters())
    r, t, e = (x.detach().requires_grad_(True) for x in (pose.r, pose.t, pose.exposure))
    intr_p = {k: v.detach().requires_grad_(statics.intrinsics_on) for k, v in intr_params.items()}
    total, metrics = _losses(
        field_params, pose._replace(r=r, t=t, exposure=e), intr_p, statics, batch, scalars, noise,
        alpha_volume=alpha_volume,
    )
    leaves = list(named.values()) + [r, t, e]
    if statics.intrinsics_on:
        leaves += list(intr_p.values())
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    n = len(named)
    g_field = dict(zip(named, grads[:n]))
    g_intr = dict(zip(intr_p, grads[n + 3 :]))
    metrics = {k: v.detach() for k, v in metrics.items()}
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
):
    """One optimization step. `scalars["pose_only"]` (0/1) switches between
    the full joint step and photometric test-pose refinement: on pose-only
    steps the field/exposure/intrinsics updates and all lr decays are gated
    off and the exposure is neighbour-averaged. The field is updated in
    place; returns (field, pose, intr, metrics)."""
    s = statics
    full = not scalars.get("pose_only", 0.0)
    g_field, (g_r, g_t, g_e), g_intr, metrics = loss_grads(
        field.params, pose, intr.params, s, batch, scalars, noise, alpha_volume
    )

    lr_factor = scalars["lr_factor"]
    is_refining = scalars["is_refining"] > 0
    gate = batch["gate"]  # [Wc] bool: linked to the current RF, rf_iter < n_iters
    gate_full = gate if full else torch.zeros_like(gate)

    # --- field (stepped on joint steps; lr decays after the step while refining) ---
    base_lrs = field_base_lrs(field.params, s.lr_spatial, s.lr_net)
    params, f_opt = pytree_adam_update(field.params, g_field, field.opt, base_lrs, gate=full)
    if is_refining and full:
        f_opt = f_opt._replace(lr_scale=f_opt.lr_scale * lr_factor)
    new_field = FieldState(params, f_opt)

    # --- poses (decay lr first on joint steps, then gated step) ---
    if s.optimize_poses:
        r_opt = scale_lr(pose.r_opt, lr_factor, gate_full)
        t_opt = scale_lr(pose.t_opt, lr_factor, gate_full)
        new_r, r_opt = adam_update(pose.r, g_r, r_opt, gate)
        new_t, t_opt = adam_update(pose.t, g_t, t_opt, gate)
    else:
        new_r, r_opt, new_t, t_opt = pose.r, pose.r_opt, pose.t, pose.t_opt

    if s.exposure_on:
        e_opt = scale_lr(pose.e_opt, lr_factor, gate_full)
        new_e, e_opt = adam_update(pose.exposure, g_e, e_opt, gate_full)
    else:
        new_e, e_opt = pose.exposure, pose.e_opt
    new_pose = PoseState(new_r, new_t, new_e, r_opt, t_opt, e_opt)

    # --- intrinsics: only while optimizing the first RF and refining ---
    new_intr = intr
    if s.intrinsics_on:
        gate_i = scalars["is_first_rf"] > 0 and is_refining and full
        i_opt = intr.opt
        if gate_i:
            i_opt = i_opt._replace(lr_scale=i_opt.lr_scale * lr_factor)
        i_lrs = {k: scalars["lr_i_base"] for k in intr.params}
        i_params, i_opt = pytree_adam_update(intr.params, g_intr, i_opt, i_lrs, gate=gate_i)
        new_intr = IntrState(i_params, i_opt)

    return new_field, new_pose, new_intr, metrics


def train_step(field, pose, intr, batch, scalars, statics: StepStatics, noise, alpha_volume=None):
    """Single full joint step."""
    scalars = dict(scalars, pose_only=0.0)
    return train_core(field, pose, intr, batch, scalars, statics, noise, alpha_volume)
