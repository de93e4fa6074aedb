"""Core differentiable math primitives (PyTorch port of localrf_tpu/ops/math.py).

Same functions, names and conventions as the JAX module:
  * scene contraction, 6D rotations, alpha compositing,
  * pose algebra + flow reprojection,
  * the scale/shift-invariant depth loss and the TV regularizer.
"""
from __future__ import annotations

import numpy as np
import torch


def contract(x: torch.Tensor) -> torch.Tensor:
    """MERF-style L-inf scene contraction mapping R^3 -> [-2, 2]^3.

    x if ||x||_inf <= 1 else ((2*||x||_inf - 1) / ||x||_inf^2) * x
    """
    x_norm = torch.clamp(torch.amax(torch.abs(x), dim=-1, keepdim=True), min=1e-6)
    return torch.where(x_norm <= 1.0, x, ((2.0 * x_norm - 1.0) / (x_norm**2)) * x)


def positional_encoding(positions: torch.Tensor, freqs: int) -> torch.Tensor:
    """sin/cos positional encoding with 2^k frequency bands."""
    freq_bands = 2.0 ** torch.arange(freqs, dtype=positions.dtype, device=positions.device)
    pts = (positions[..., None] * freq_bands).reshape(
        positions.shape[:-1] + (freqs * positions.shape[-1],)
    )
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)


def sixD_to_mtx(r: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt 6D rotation -> 3x3 matrix. r: [..., 3, 2] -> [..., 3, 3]."""
    b1 = r[..., 0]
    b1 = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    b2 = r[..., 1] - torch.sum(b1 * r[..., 1], dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def mtx_to_sixD(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation -> 6D (first two columns). [..., 3, 3] -> [..., 3, 2]."""
    return torch.stack([m[..., 0], m[..., 1]], dim=-1)


def alpha2weights(alpha: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Alpha compositing weights via exclusive cumprod transmittance.

    The final sample's alpha is forced to 1 (opaque background terminator).
    alpha: [R, S] -> (weights [R, S], T [R, S+1]).
    """
    alpha = torch.cat([alpha[:, :-1], torch.ones_like(alpha[:, -1:])], dim=-1)
    t = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], dim=-1), dim=-1
    )
    weights = alpha * t[:, :-1]
    return weights, t


def inverse_pose(pose: torch.Tensor) -> torch.Tensor:
    """Invert [N, 3, 4] (or [N, 4, 4]-like) rigid poses; returns the same
    shape with the [3, 4] block filled (a 4th row stays zero, as in JAX)."""
    r_inv = pose[:, :3, :3].transpose(1, 2)
    t_inv = -torch.matmul(r_inv, pose[:, :3, 3:])[..., 0]
    out = torch.cat([r_inv, t_inv[..., None]], dim=-1)
    if pose.shape[1] > 3:
        out = torch.cat([out, torch.zeros_like(pose[:, 3:])], dim=1)
    return out


def get_cam2cams(cam2worlds: torch.Tensor, indices: torch.Tensor, offset: int) -> torch.Tensor:
    """Relative pose from camera `i` to camera `i+offset` (clamped at ends);
    the shape of inverse_pose's result."""
    idx = torch.clamp(indices + offset, 0, cam2worlds.shape[0] - 1)
    world2cam = inverse_pose(cam2worlds[idx])
    rot = torch.matmul(world2cam[:, :3, :3], cam2worlds[indices, :3, :3])
    t = torch.matmul(world2cam[:, :3, :3], cam2worlds[indices, :3, 3:])[..., 0]
    t = t + world2cam[:, :3, 3]
    out = torch.cat([rot, t[..., None]], dim=-1)
    return torch.cat([out, torch.zeros_like(world2cam[:, 3:])], dim=1)


def get_fwd_bwd_cam2cams(cam2worlds: torch.Tensor, indices: torch.Tensor):
    return get_cam2cams(cam2worlds, indices, 1), get_cam2cams(cam2worlds, indices, -1)


def pts2px(pts: torch.Tensor, f, center) -> torch.Tensor:
    """Project camera-space points to pixels (y/z axis flip, z clamped)."""
    x = pts[..., 0]
    y = -pts[..., 1]
    z = torch.clamp(-pts[..., 2], min=1e-6)
    return torch.stack([x / z * f + center[0] - 0.5, y / z * f + center[1] - 0.5], dim=-1)


def get_pred_flow(pts, ij, cam2cams, focal, center) -> torch.Tensor:
    """Predicted optical flow from per-view camera-space points + relative pose.

    pts: [V, P, 3], ij: [V, P, 2], cam2cams: [V, 3, 4].
    """
    new_pts = torch.einsum("vij,vpj->vpi", cam2cams[:, :3, :3], pts)
    new_pts = new_pts + cam2cams[:, None, :3, 3]
    new_ij = pts2px(new_pts, focal, center)
    return new_ij - ij.to(new_ij.dtype)


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median: the mean of the two middle values for an even count.
    torch.median returns the lower one, so this is the 0.5 quantile (linear
    interpolation, the same as jnp.quantile)."""
    return torch.quantile(x, 0.5, dim=-1, keepdim=True)


def compute_depth_loss(dyn_depth: torch.Tensor, gt_depth: torch.Tensor):
    """Scale/shift-invariant depth loss (median/MAD normalization per view).

    Inputs are [V, P]; returns (dyn_norm, gt_norm, squared diff).
    """
    t_d = _median(dyn_depth)
    s_d = torch.mean(torch.abs(dyn_depth - t_d), dim=-1, keepdim=True)
    dyn_norm = (dyn_depth - t_d) / s_d

    t_gt = _median(gt_depth)
    s_gt = torch.mean(torch.abs(gt_depth - t_gt), dim=-1, keepdim=True)
    gt_norm = (gt_depth - t_gt) / s_gt
    return dyn_norm, gt_norm, (dyn_norm - gt_norm) ** 2


def tv_loss(x: torch.Tensor) -> torch.Tensor:
    """Total-variation loss over the trailing two axes of a [N, C, H, W] grid:
    2 * (mean squared H-diff + mean squared W-diff), each term skipped when
    that axis has size 1."""
    h, w = x.shape[2], x.shape[3]
    tv = x.new_zeros(())
    if h > 1:
        tv = tv + torch.mean((x[:, :, 1:, :] - x[:, :, :-1, :]) ** 2)
    if w > 1:
        tv = tv + torch.mean((x[:, :, :, 1:] - x[:, :, :, :-1]) ** 2)
    return 2.0 * tv


def n_to_reso(n_voxels: int, aabb) -> list[int]:
    """Grid resolution with ~cubic voxels for a target total voxel count
    (float32 arithmetic: 64**3 voxels in a [-2,2]^3 box give [64,64,64])."""
    aabb = np.asarray(aabb, dtype=np.float32)
    xyz_min, xyz_max = aabb[0], aabb[1]
    voxel_size = np.float32(
        ((xyz_max - xyz_min).prod() / np.float32(n_voxels)) ** np.float32(1.0 / 3.0)
    )
    return [int(v) for v in (xyz_max - xyz_min) / voxel_size]
