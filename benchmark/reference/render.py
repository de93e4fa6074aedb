"""Rays, contracted stratified sampling, the occupancy probe and compaction,
and volume compositing, in plain f32.

A ray from the camera at pixel (i, j) runs along R [(i+0.5-cx)/f,
-(j+0.5-cy)/f, -1] from the camera centre. Its samples are N = n/6 linear
depths in [0, 1) and N disparity-spaced depths between 1 and 1000, all
+0.1, each jittered by one uniform draw per sample index when training,
and contracted to [-2, 2]^3 (MERF's L-inf contraction). With an occupancy
volume a ray keeps `occ_m` samples: the volume, max-pooled by `probe` and
dilated by one coarse voxel, is read at the midpoint of each group of
`probe` samples; the first occ_m / probe - 1 occupied groups (the last
group never; unoccupied ones fill the rest in order) and then the last
group give their samples, the last slot is the ray's final sample, and a
kept sample counts only where the full volume is occupied there. Compositing: alpha = 1 - exp(-sigma *
dist * 25) with the last alpha 1, weight = alpha * prod of (1 - alpha +
1e-10) before it; shading only where weight > 1e-4; a white background.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .field import density, full_f32, rounder, shade

NEAR, FAR = 1.0, 1e3
AABB = (-2.0, 2.0)
DIST_SCALE = 25.0
WEIGHT_THRES = 1e-4


def n_samples(grid: int, step_ratio: float = 0.5) -> int:
    """Samples a ray marches: the box diagonal over half a voxel."""
    size = AABB[1] - AABB[0]
    step = size / (grid - 1) * step_ratio
    return int(math.sqrt(3.0) * size / step) + 1


def compacted_samples(grid: int, occ_ratio: float = 0.45, occ_min: int = 256) -> int:
    """LocalRF-on-TPU's compaction width: 45% of the march (at least 256)."""
    s = n_samples(grid) // 6 * 2
    m = min(s, max(occ_min, int(s * occ_ratio)))
    return 0 if m > 0.85 * s else m


def focal_length(w: int, fov_deg: float = 85.6) -> float:
    return w / math.tan(fov_deg * math.pi / 180 / 2) / 2


def rotation(r6: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt of the 6D rotation [..., 3, 2] -> [..., 3, 3]."""
    a, b = r6[..., 0], r6[..., 1]
    b1 = a / a.norm(dim=-1, keepdim=True)
    b2 = b - (b1 * b).sum(dim=-1, keepdim=True) * b1
    b2 = b2 / b2.norm(dim=-1, keepdim=True)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


def camera_rays(px: torch.Tensor, c2w: torch.Tensor, w: int, h: int, focal, center):
    """Pixel ids [B] seen by cameras c2w [B, 3, 4] -> (origins, directions,
    camera-space directions, integer pixel coords (i, j) [B, 2])."""
    i, j = px % w, (px // w) % h
    d = torch.stack([(i.float() + 0.5 - center[0]) / focal, -(j.float() + 0.5 - center[1]) / focal,
                     -torch.ones_like(i, dtype=torch.float32)], dim=-1)
    rays_d = (c2w[:, :, :3] @ d[..., None])[..., 0]
    return c2w[:, :, 3], rays_d, d, torch.stack([i, j], dim=-1)


def sample_depths(n_total: int, device, noise: dict | None = None):
    """Depths [S] and their spacing [S] (0 after the last)."""
    n = n_total // 6
    t = torch.arange(n, dtype=torch.float32, device=device) / n
    lin, td = t, t
    if noise is not None:
        lin = t + noise["u1"].reshape(-1) / n
        td = t + noise["u2"].reshape(-1) / n
    disp = 1.0 / ((1.0 - td) / NEAR + td / FAR)
    z = torch.cat([lin, disp]) + 0.1
    return z, torch.cat([z[1:] - z[:-1], z.new_zeros(1)])


def contract(x: torch.Tensor) -> torch.Tensor:
    """x where ||x||_inf <= 1, else (2 - 1/||x||_inf) x / ||x||_inf."""
    n = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-6)
    return torch.where(n <= 1.0, x, (2.0 - 1.0 / n) * (x / n))


def to_unit(x: torch.Tensor) -> torch.Tensor:
    """Box coordinates -> [-1, 1]."""
    return (x - AABB[0]) / (AABB[1] - AABB[0]) * 2.0 - 1.0


def occupied(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear occupancy of vol [D, H, W] (0/1) at coords [..., 3] (x, y, z) > 0."""
    out = F.grid_sample(vol[None, None], coords.reshape(1, -1, 1, 1, 3), mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out.reshape(coords.shape[:-1]) > 0


def coarse_volume(vol: torch.Tensor, probe: int) -> torch.Tensor:
    """Max-pooled by `probe` (a ragged end pools what it has), then dilated by one voxel."""
    x = F.max_pool3d(vol[None, None], kernel_size=probe, stride=probe, ceil_mode=True)
    return F.max_pool3d(x, kernel_size=3, stride=1, padding=1)[0, 0]


def render(params: dict, model: dict, rays_o, rays_d, z, dists, alpha: torch.Tensor, coarse: torch.Tensor,
           occ_m: int, q, refine: float = 1.0, probe: int = 4):
    """rgb [R, 3], depth [R] of rays against one field with an occupancy
    volume `alpha` and its `coarse` probe volume. `model`: the field module
    ("field"), the density activation ("act") and the shading head
    ("shading_mode", "fea_pe", "view_pe"; harness/scene.py reference_model)."""
    r, s = rays_o.shape[0], z.numel()
    norm = rays_d.norm(dim=-1, keepdim=True)
    vd = rays_d / norm

    def points(zs):
        return to_unit(contract(rays_o[:, None, :] + vd[:, None, :] * zs[..., None]))

    zc = z[probe // 2::probe]
    sc = zc.numel()
    valid_c = occupied(coarse, points(zc[None].expand(r, sc)).detach())
    valid_c[:, -1] = False
    m_groups = occ_m // probe
    order = torch.arange(sc, device=z.device)
    keys = torch.where(valid_c, order, sc + order)
    groups = torch.argsort(keys, dim=1, stable=True)[:, :m_groups]
    groups = torch.cat([groups[:, :-1], groups.new_full((r, 1), sc - 1)], dim=1)
    group_ok = torch.gather(valid_c, 1, groups)
    idx = (groups[:, :, None] * probe + torch.arange(probe, device=z.device)).clamp(max=s - 1)
    idx = idx.reshape(r, m_groups * probe)
    idx = torch.cat([idx[:, :-1], idx.new_full((r, 1), s - 1)], dim=1)
    zs, ds = z[idx], dists[idx]
    pts = points(zs)
    keep = group_ok.repeat_interleave(probe, dim=1) & occupied(alpha, pts.detach())
    keep[:, -1] = False

    m = zs.shape[1]
    feat, app = model["field"].features(params, pts.reshape(-1, 3), q)
    sigma = torch.where(keep, density(feat, model["act"]).reshape(r, m), 0.0)
    a = 1.0 - torch.exp(-sigma * ds * DIST_SCALE)
    a = torch.cat([a[:, :-1], torch.ones_like(a[:, -1:])], dim=1)
    trans = torch.cumprod(torch.cat([torch.ones_like(a[:, :1]), 1.0 - a[:, :-1] + 1e-10], dim=1), dim=1)
    weight = a * trans
    depth = (weight * zs).sum(dim=1) / norm[:, 0]
    vdirs = vd.detach()[:, None, :].expand(r, m, 3).reshape(-1, 3)
    rgb_s = shade(params, app, vdirs, model, q, refine).reshape(r, m, 3)
    rgb_s = torch.where((weight > WEIGHT_THRES)[..., None], rgb_s, 0.0)
    rgb = (weight[..., None] * rgb_s).sum(dim=1) + (1.0 - weight.sum(dim=1))[:, None]
    return rgb, depth


def ball_volume(res: int, radius: float, device) -> torch.Tensor:
    """0/1 volume [res]^3 on a lattice over [-1, 1]: 1 inside the ball."""
    ax = torch.linspace(-1.0, 1.0, res, device=device)
    zz, yy, xx = torch.meshgrid(ax, ax, ax, indexing="ij")
    return ((xx**2 + yy**2 + zz**2) < radius**2).to(torch.float32)


def exposure_clip(rgb: torch.Tensor, exposure: torch.Tensor) -> torch.Tensor:
    """Per-ray 3x3 exposure exposure [R, 3, 3] applied to rgb [R, 3], then clipped to [0, 1]."""
    return torch.clamp((exposure @ rgb[..., None])[..., 0], 0.0, 1.0)


def render_frame(params: dict, model: dict, c2w: torch.Tensor, w: int, h: int, grid: int,
                 alpha: torch.Tensor, precision: str = "f32", chunk: int = 4096,
                 occ_min: int = 256) -> torch.Tensor:
    """An eval frame (no jitter) through one camera c2w [3, 4] at w x h with
    an identity exposure: rgb [H * W, 3]."""
    dev = c2w.device
    q = rounder(precision)
    coarse = coarse_volume(alpha, 4)
    z, dists = sample_depths(n_samples(grid), dev)
    occ_m = compacted_samples(grid, occ_min=occ_min)
    px_all = torch.arange(w * h, device=dev)
    focal = focal_length(w)
    center = (w * 0.5, h * 0.5)
    out = []
    with torch.no_grad(), full_f32():
        for c0 in range(0, px_all.numel(), chunk):
            px = px_all[c0:c0 + chunk]
            o, d, _, _ = camera_rays(px, c2w[None].expand(px.numel(), 3, 4), w, h, focal, center)
            rgb, _ = render(params, model, o, d, z, dists, alpha, coarse, occ_m, q)
            out.append(exposure_clip(rgb, torch.eye(3, device=dev).expand(px.numel(), 3, 3)))
    return torch.cat(out)
