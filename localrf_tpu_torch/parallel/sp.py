"""Sample-axis parallelism for the eval march (PyTorch port of
localrf_tpu/parallel/sp.py).

The march is the long axis of this system (S samples per ray). The ranks
of a mesh axis "sample" each take a contiguous segment of the S samples and
composite it alone; the segments are joined by the associative composition
of transmittance:

    per segment g:  T_g = prod(1 - alpha_i + 1e-10), and the segment's
                    weights with the transmittance local to it
    cross-segment:  prefix_g = prod_{h < g} T_h, from every segment's T
                    (an [n, R] sum of zero-filled rows: gloo has no gather
                    for CUDA tensors, so this is one all_reduce on every
                    backend); global weight = prefix_g * local weight
    totals:         one all_reduce(SUM) of [rgb, acc, depth] over "sample"

The algebra is exact; only the float association differs from
models/render.py::render_rays (eval, no compaction). On a 2-D mesh
("data", "sample") (make_dp_sp_mesh) the rays are split over "data" too.
The features go through the quad gathers, and an alpha volume culls with
occupancy_valid on its packed corners, which is JAX's `sample_alpha(...) >
0`; with cfg.fast_gather off, through the grid-sample route (bilinear
lookups in the f32 grids) and `sample_alpha(...) > 0` itself, as in JAX.
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..models.tensorf import (
    TensorfConfig,
    apply_mlp,
    build_combined_quad_views,
    compute_app_feature,
    compute_density_app_features,
    compute_density_feature,
    feature2density,
    normalize_coord,
    sample_alpha,
)
from ..ops.math import contract
from ..ops.occupancy import occupancy_valid, pack_alpha_corners
from ..ops.rays import sample_ray_contracted
from .sharding import DATA_AXIS, all_sum_, data_rank

SAMPLE_AXIS = "sample"


def make_sp_mesh(n: int, device_type: str = "cuda") -> DeviceMesh:
    """A 1-D mesh ("sample",) over the first n ranks of the default group."""
    return init_device_mesh(device_type, (n,), mesh_dim_names=(SAMPLE_AXIS,))


def make_dp_sp_mesh(n_data: int, n_sample: int, device_type: str = "cuda") -> DeviceMesh:
    """2-D ("data", "sample") mesh: ray-batch DP x the sample-axis march
    split. "data" is outermost, so each sample group is a run of adjacent
    ranks (on one host, the cards its collectives join most directly)."""
    return init_device_mesh(device_type, (n_data, n_sample), mesh_dim_names=(DATA_AXIS, SAMPLE_AXIS))


def _z_vals_dense(n_samples_total: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The deterministic (eval) z values and dists, [1, S] each, from
    ops/rays.sample_ray_contracted itself (a dummy ray), so that the
    schedule cannot drift from the sequential renderer's."""
    zero = torch.zeros((1, 3), device=device)
    _, z_vals, dists = sample_ray_contracted(zero, zero, n_samples_total, False, None)
    return z_vals, dists


@torch.no_grad()
def render_rays_sp(
    params,
    cfg: TensorfConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    mesh: DeviceMesh,
    *,
    white_bg: bool = True,
    refine=1.0,
    alpha_volume: torch.Tensor | None = None,
):
    """Deterministic eval render with the march split over the mesh axis
    "sample": render_rays(is_train=False) with no compaction, up to float
    association. rays_o / rays_d [R, 3], the same on every rank; on a 2-D
    ("data", "sample") mesh each data group marches its contiguous R / n_data
    rays (R must divide) and the result is gathered over "data". Every rank
    returns the whole (rgb [R, 3], depth [R])."""
    names = mesh.mesh_dim_names
    seg, n = mesh.get_local_rank(SAMPLE_AXIS), mesh.size(names.index(SAMPLE_AXIS))
    dev = rays_o.device
    r_all = rays_o.shape[0]
    viewdirs_norm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rows = slice(0, r_all)
    if DATA_AXIS in names:
        d, n_data = data_rank(mesh)
        if r_all % n_data:
            raise ValueError(f"{r_all} rays do not split over {n_data} data ranks")
        rows = slice(d * r_all // n_data, (d + 1) * r_all // n_data)
    rays_o, rays_d = rays_o[rows], rays_d[rows]
    viewdirs = rays_d / viewdirs_norm[rows]
    r = rays_o.shape[0]

    z_vals, dists = _z_vals_dense(cfg.n_samples, dev)
    pad = (-z_vals.shape[1]) % n
    if pad:
        # padded samples repeat the last z with dist 0: alpha 0, inert; the
        # terminator then lands on the same point as the sequential path's
        z_vals = torch.cat([z_vals, z_vals[:, -1:].expand(1, pad)], dim=1)
        dists = torch.cat([dists, dists.new_zeros(1, pad)], dim=1)
    m = z_vals.shape[1] // n
    z_seg, d_seg = z_vals[:, seg * m : (seg + 1) * m], dists[:, seg * m : (seg + 1) * m]

    pts = contract(rays_o[:, None, :] + viewdirs[:, None, :] * z_seg[..., None])
    flat = normalize_coord(pts, cfg).reshape(-1, 3)
    if cfg.fast_gather:
        sigma_feat, app_feat = compute_density_app_features(params, flat, cfg,
                                                            build_combined_quad_views(params, cfg))
    else:
        sigma_feat, app_feat = compute_density_feature(params, flat, cfg), None
    sigma = feature2density(sigma_feat.reshape(r, m), cfg)
    if alpha_volume is not None:
        if cfg.fast_gather:
            occ = occupancy_valid(pack_alpha_corners(alpha_volume), tuple(alpha_volume.shape), flat)
        else:
            occ = sample_alpha(alpha_volume, pts.reshape(-1, 3), cfg) > 0
        sigma = torch.where(occ.reshape(r, m), sigma, 0.0)

    alpha = 1.0 - torch.exp(-sigma * d_seg * cfg.distance_scale)
    if seg == n - 1:
        # the opaque background terminator, on the march's last sample only
        alpha = torch.cat([alpha[:, :-1], torch.ones_like(alpha[:, -1:])], dim=1)
    one_m = 1.0 - alpha + 1e-10  # the epsilon of ops/math.alpha2weights
    t_local = torch.cumprod(torch.cat([torch.ones_like(one_m[:, :1]), one_m[:, :-1]], dim=1), dim=1)
    w_local = alpha * t_local
    t_all = torch.zeros((n, r), device=dev)
    t_all[seg] = t_local[:, -1] * one_m[:, -1]  # this segment's transmittance
    all_sum_(t_all, mesh, SAMPLE_AXIS)
    before = torch.arange(n, device=dev)[:, None] < seg
    weight = torch.prod(torch.where(before, t_all, 1.0), dim=0)[:, None] * w_local

    vd = viewdirs[:, None, :].expand(r, m, 3).reshape(-1, 3)
    if app_feat is None:
        app_feat = compute_app_feature(params, flat, cfg)
    rgb = apply_mlp(params["mlp"], flat, vd, app_feat, cfg, refine).reshape(r, m, 3)
    rgb = torch.where((weight > cfg.ray_march_weight_thres)[..., None], rgb, 0.0)
    part = torch.cat([torch.sum(weight[..., None] * rgb, dim=-2), torch.sum(weight, dim=-1, keepdim=True),
                      torch.sum(weight * z_seg, dim=-1, keepdim=True)], dim=-1)  # [r, 5]
    out = all_sum_(part, mesh, SAMPLE_AXIS)
    if DATA_AXIS in names:
        out = torch.zeros((r_all, 5), device=dev)
        out[rows] = part
        all_sum_(out, mesh, DATA_AXIS)
    rgb_map, acc_map = out[:, :3], out[:, 3]
    depth_map = out[:, 4] / viewdirs_norm[..., 0]
    if white_bg:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, depth_map
