"""Volume rendering forward pass (PyTorch port of localrf_tpu/models/render.py).

Contracted stratified sampling, occupancy culling (coarse probe + exact
compaction, or a dense cull), factored-grid density, softplus, the
compositing scan (the K1 kernel when cfg.pallas_composite), shading of
every (compacted) sample from the shared gather or in the fused march core
(the K4 kernel when cfg.fused_march) or, on the grid-sample route
(cfg.fast_gather off), of every sample or of the top-K by weight
(cfg.app_top_k), the eval renders' floater suppression, white background.
Static shapes: masked samples are zeroed, not dropped, which gives the
same composited outputs as the reference's ragged gathers.
"""
from __future__ import annotations

import torch

from ..ops.kernels.march import fused_march_features, fused_march_supported
from ..ops.math import alpha2weights, contract
from ..ops.occupancy import (
    coarsen_alpha,
    compact_valid_samples,
    occupancy_valid,
    pack_alpha_corners,
)
from ..ops.rays import sample_ray_contracted
from ..utils import profiling
from .tensorf import (
    TensorfConfig,
    apply_mlp,
    build_combined_quad_views,
    compute_app_feature,
    compute_density_app_features,
    compute_density_feature,
    feature2density,
    normalize_coord,
)


def draw_noise(n_samples_total: int, generator: torch.Generator, device) -> dict:
    """The random numbers of one training render: stratified jitter u1, u2
    ([1, N] uniform, N = n_samples_total // 6) and the background flip draw."""
    n = n_samples_total // 6
    return {
        "u1": torch.rand((1, n), generator=generator, device=device),
        "u2": torch.rand((1, n), generator=generator, device=device),
        "bg": torch.rand((), generator=generator, device=device),
    }


def _gather_z_dists(z_vals, dists, sel):
    """z and dist at the compacted sample indices: [1, S] x [R, M] -> 2 x [R, M]."""
    zd = torch.stack([z_vals[0], dists[0]], dim=-1)  # [S, 2]
    rows = zd[sel]  # [R, M, 2]
    return rows[..., 0], rows[..., 1]


def _zero_last(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[:, :-1], torch.zeros_like(x[:, -1:])], dim=1)


def render_rays(
    params,
    cfg: TensorfConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    *,
    is_train: bool,
    white_bg: bool,
    refine=1.0,
    floater_thresh: float = 0.0,
    alpha_volume: torch.Tensor | None = None,
    noise: dict | None = None,
    n_samples: int = -1,
    quad: dict | None = None,
):
    """Render a chunk of rays against one field.

    rays_o/rays_d: [R, 3] field-space origins and (unnormalized) directions.
    `noise` (see draw_noise) is required when is_train. `floater_thresh` > 0
    (path renders) zeroes every sample before that fraction of the ray's
    weighted mean sample index; it turns compaction and K1 off, as in JAX.
    `quad` is the field's build_combined_quad_views, built here when None
    (an eval frame builds it once for all its chunks). With
    cfg.fast_gather off the field is read by bilinear lookups in its f32
    grids instead (the grid-sample route, JAX's oracle: no quad views, no
    fused march), and 0 < cfg.app_top_k < S shades only the K samples of
    each ray with the largest weights.
    Returns (rgb_map [R, 3], depth_map [R]).
    """
    n_total = n_samples if n_samples > 0 else cfg.n_samples

    viewdirs_norm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    viewdirs = rays_d / viewdirs_norm

    pts, z_vals, dists = sample_ray_contracted(
        rays_o, viewdirs, n_total, is_train, (noise["u1"], noise["u2"]) if is_train else None
    )
    r, s = pts.shape[0], pts.shape[1]
    pts_norm = normalize_coord(pts, cfg)

    compact = alpha_volume is not None and 0 < cfg.occ_m < s and floater_thresh == 0.0
    probe = cfg.occ_probe_ds if compact and 1 < cfg.occ_probe_ds < s else 0
    if probe:
        # coarse march probe: one lookup in the ds-pooled + dilated alpha
        # volume per group of `probe` samples, compaction at group
        # granularity, then the exact fine cull at the selected samples
        coarse = coarsen_alpha(alpha_volume, probe)
        packed_c = pack_alpha_corners(coarse)
        z_probe = z_vals[:, probe // 2 :: probe]  # [1, Sc] group midpoints
        sc = z_probe.shape[1]
        pts_probe = contract(rays_o[:, None, :] + viewdirs[:, None, :] * z_probe[..., None])
        valid_c = occupancy_valid(
            packed_c, tuple(coarse.shape), normalize_coord(pts_probe, cfg).detach().reshape(-1, 3)
        ).reshape(r, sc)
        # the forced last slot (Sc-1) must never duplicate a selected group
        valid_c[:, -1] = False
        mc = max(1, cfg.occ_m // probe)
        sel_c, selv_c = compact_valid_samples(valid_c, mc)
        sel_valid = selv_c[:, :, None].expand(r, mc, probe).reshape(r, mc * probe)
        # one [2*probe]-wide (z, dist) row per selected group; rows past S-1
        # replicate the terminator row, a sub-group tail is unreachable
        zd = torch.stack([z_vals[0], dists[0]], dim=-1)  # [S, 2]
        target = sc * probe
        if target > s:
            zd = torch.cat([zd, zd[s - 1 : s].expand(target - s, 2)])
        elif target < s:
            zd = zd[:target]
        rows = zd.reshape(sc, probe * 2)[sel_c].reshape(r, mc * probe, 2)
        # forced dense terminator in the last slot
        z_vals = torch.cat([rows[:, :-1, 0], z_vals[:, s - 1 :].expand(r, 1)], dim=1)
        dists = torch.cat([rows[:, :-1, 1], dists[:, s - 1 :].expand(r, 1)], dim=1)
        pts_norm = normalize_coord(
            contract(rays_o[:, None, :] + viewdirs[:, None, :] * z_vals[..., None]), cfg
        )
        if cfg.occ_refine:
            fine_v = occupancy_valid(
                pack_alpha_corners(alpha_volume),
                tuple(alpha_volume.shape),
                pts_norm.detach().reshape(-1, 3),
            ).reshape(r, mc * probe)
            sel_valid = sel_valid & fine_v
        sel_valid = _zero_last(sel_valid)
        s = mc * probe
    elif compact:
        # exact cull: one packed-byte gather per sample, then density only
        # at the first occ_m occupied samples per ray
        valid = occupancy_valid(
            pack_alpha_corners(alpha_volume),
            tuple(alpha_volume.shape),
            pts_norm.detach().reshape(-1, 3),
        ).reshape(r, s)
        valid[:, -1] = False  # terminator handled separately
        sel, sel_valid = compact_valid_samples(valid, cfg.occ_m)
        # recompute the selected points from the gathered z values: the same
        # floats as gathering pts_norm rows, with the gradient path to the
        # pose kept elementwise
        z_vals, dists = _gather_z_dists(z_vals, dists, sel)
        pts_norm = normalize_coord(
            contract(rays_o[:, None, :] + viewdirs[:, None, :] * z_vals[..., None]), cfg
        )
        s = cfg.occ_m

    # the field features, between the tracer's marks: made after the
    # sampling and the cull, so their backward runs as one block (autograd
    # runs later-made nodes first), the quad tables' backward included
    (flat,) = profiling.mark("features", "features.bwd_end", pts_norm.reshape(-1, 3))
    vd = viewdirs.detach()[:, None, :].expand(r, s, 3).reshape(-1, 3)
    if quad is None and cfg.fast_gather:
        quad = build_combined_quad_views(params, cfg)
    rgb_all = app_feat_all = None
    if not cfg.fast_gather:
        # the grid-sample route: appearance only once the weights are known
        sigma_feat = compute_density_feature(params, flat, cfg)
    elif cfg.fused_march and fused_march_supported(cfg):
        # the fused march core (K4) shades every (compacted) sample itself
        sigma_feat, rgb_all = fused_march_features(params, quad, flat, vd, cfg)
    else:
        sigma_feat, app_feat_all = compute_density_app_features(params, flat, cfg, quad)
    sigma_feat, rgb_all, app_feat_all = profiling.mark("features.end", "features.bwd", sigma_feat, rgb_all,
                                                       app_feat_all)
    sigma = feature2density(sigma_feat.reshape(r, s), cfg)

    if compact:
        sigma = torch.where(sel_valid, sigma, 0.0)
    elif alpha_volume is not None:
        # dense cull via the packed-corner lookup
        occ = occupancy_valid(
            pack_alpha_corners(alpha_volume), tuple(alpha_volume.shape), flat.detach()
        ).reshape(r, s)
        sigma = torch.where(occ, sigma, 0.0)

    # last sample excluded from density
    sigma = _zero_last(sigma)

    if cfg.pallas_composite and floater_thresh == 0.0:
        from ..ops.kernels.composite import fused_weights

        weight = fused_weights(sigma, dists, cfg.distance_scale)
    else:
        alpha = 1.0 - torch.exp(-sigma * dists * cfg.distance_scale)
        weight, _ = alpha2weights(alpha)

    acc_map = torch.sum(weight, dim=-1)
    depth_map = torch.sum(weight * z_vals, dim=-1) / viewdirs_norm[..., 0]

    if floater_thresh > 0:
        # suppress near-camera floaters: re-weight with every sample before
        # floater_thresh x the weighted mean sample index made transparent
        sample_idx = torch.arange(s, dtype=weight.dtype, device=weight.device)[None]
        idx_map = torch.sum(weight * sample_idx, dim=-1, keepdim=True)
        alpha = torch.where(sample_idx < idx_map * floater_thresh, 0.0, alpha)
        weight, _ = alpha2weights(alpha)

    if not cfg.fast_gather and 0 < cfg.app_top_k < s:
        # shade only the K samples of each ray with the largest weights: the
        # reference's `weight > thres` gather whenever fewer than K pass
        k = cfg.app_top_k
        w_k, idx_k = torch.topk(weight, k, dim=-1)
        pts_k = torch.gather(pts_norm, 1, idx_k[..., None].expand(r, k, 3)).reshape(-1, 3)
        vd_k = viewdirs.detach()[:, None, :].expand(r, k, 3).reshape(-1, 3)
        rgb_k = apply_mlp(params["mlp"], pts_k, vd_k, compute_app_feature(params, pts_k), cfg, refine)
        rgb_k = torch.where((w_k > cfg.ray_march_weight_thres)[..., None], rgb_k.reshape(r, k, 3), 0.0)
        rgb_map = torch.sum(w_k[..., None] * rgb_k, dim=-2)
    else:
        # shade every (compacted) sample (in the fused core, from the shared
        # gather, or by grid sampling); zero samples below the weight
        # threshold (the reference's masked ragged gather)
        app_mask = weight > cfg.ray_march_weight_thres
        if rgb_all is None:
            if app_feat_all is None:
                app_feat_all = compute_app_feature(params, flat)
            rgb_all = apply_mlp(params["mlp"], flat, vd, app_feat_all, cfg, refine)
        rgb = torch.where(app_mask[..., None], rgb_all.reshape(r, s, 3), 0.0)
        rgb_map = torch.sum(weight[..., None] * rgb, dim=-2)

    # white background, or randomly flipped white background in training
    if white_bg:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    elif is_train:
        flip = (noise["bg"] < 0.5).to(rgb_map.dtype)
        rgb_map = rgb_map + flip * (1.0 - acc_map[..., None])
    return rgb_map, depth_map
