"""Ray generation and contracted stratified sampling (PyTorch port of
localrf_tpu/ops/rays.py).

Differentiable w.r.t. focal/center/pose. The stratified jitter is passed in
as explicit uniform tensors (`noise`), drawn by the caller from a
`torch.Generator`, so tests can feed both packages the same numbers.
"""
from __future__ import annotations

import math

import torch

from .math import contract


def ids2pixel(w: int, h: int, ids: torch.Tensor):
    """Ray index -> (col, row)."""
    col = ids % w
    row = (ids // w) % h
    return col, row


def get_ray_directions_lean(i, j, focal, center) -> torch.Tensor:
    """Pinhole camera-space directions for pixel centers (i+0.5, j+0.5).

    i, j: integer pixel coords [B]; focal: scalar; center: (cx, cy).
    Returns [B, 3] (not normalized; z = -1).
    """
    i = i.to(torch.float32) + 0.5
    j = j.to(torch.float32) + 0.5
    return torch.stack(
        [(i - center[0]) / focal, -(j - center[1]) / focal, -torch.ones_like(i)], dim=-1
    )


def get_ray_directions_360(i, j, w: int, h: int) -> torch.Tensor:
    """Equirectangular (360) camera-space directions."""
    i = i.to(torch.float32) + 0.5
    j = j.to(torch.float32) + 0.5
    phi = j * math.pi / h - math.pi / 2.0
    theta = i * 2.0 * math.pi / w + math.pi
    x = torch.cos(phi) * torch.sin(theta)
    y = torch.sin(phi)
    z = torch.cos(phi) * torch.cos(theta)
    return torch.stack([x, y, z], dim=-1)


def get_rays_lean(directions: torch.Tensor, c2w: torch.Tensor):
    """Rotate camera-space dirs to world/field space.

    directions: [B, 3]; c2w: [B, 3, 4] -> (rays_o [B, 3], rays_d [B, 3]).
    """
    rays_o = c2w[:, :3, 3]
    rays_d = torch.einsum("bij,bj->bi", c2w[:, :3, :3], directions)
    return rays_o, rays_d


def sample_ray_contracted(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    n_samples_total: int,
    is_train: bool,
    noise: tuple[torch.Tensor, torch.Tensor] | None = None,
):
    """Contracted stratified sampling along rays.

    N = n_samples_total // 6 linear samples in t in [0,1) plus N
    disparity-spaced samples in [near=1, far=1e3], all offset by +0.1, then
    contracted to [-2, 2]^3. When training, `noise` = (u1, u2), two [1, N]
    uniform draws in [0, 1) (shared across rays, per sample). Returns
    (pts [R, 2N, 3], z_vals [1, 2N], dists [1, 2N]).
    """
    n = n_samples_total // 6
    t_vals = torch.arange(n, dtype=torch.float32, device=rays_o.device)[None, :] / n
    interpx = t_vals
    if is_train:
        u1, u2 = noise
        interpx = interpx + u1 / n
        t_vals = t_vals + u2 / n

    near, far = 1.0, 1e3
    disp = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    z_vals = torch.cat([interpx, disp], dim=1) + 1e-1  # [1, 2N]

    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    pts = contract(pts)

    dists = torch.cat(
        [z_vals[:, 1:] - z_vals[:, :-1], torch.zeros_like(z_vals[:, :1])], dim=-1
    )
    return pts, z_vals, dists
