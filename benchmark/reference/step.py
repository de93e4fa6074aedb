"""LocalRF's joint training step in plain f32: the rgb, optical-flow,
monodepth and density-L1 losses, their gradients by autograd w.r.t. the
field, the camera poses and the exposures, and Adam.

One step, at refinement iteration `it` of a schedule whose lr decays by
`lr_factor` a step:
- rgb: 0.25 * mean |rgb - gt| (unit loss weights), rgb after the frame's
  3x3 exposure and a clip to [0, 1];
- flow: each ray's point (camera direction * depth) moved into the next
  and the previous frame's camera (neighbours clamped to the window) and
  projected; |predicted - given flow| summed over both, masked (no forward
  flow on the last frame); per view the values above its 90th percentile
  dropped; mean * weight * lr_factor^it / ((W + H) / 2);
- depth: per view, inverse depth and the given inverse depth each shifted
  by its median and scaled by its mean absolute deviation; squared
  difference; per view the values above its 80th percentile dropped; mean
  * weight * lr_factor^it;
- L1: the field module's density_l1_grads * its weight.
Adam (0.9, 0.99, eps 1e-8) on every leaf: the pose and exposure learning
rates first decay by lr_factor; the field's groups (factor grids at the
spatial rate, basis and MLP at the network rate) share a scale that
decays by lr_factor after the step.
"""
from __future__ import annotations

import numpy as np
import torch

from .field import full_f32, rounder
from .render import (
    ball_volume,
    camera_rays,
    coarse_volume,
    compacted_samples,
    exposure_clip,
    focal_length,
    n_samples,
    render,
    rotation,
    sample_depths,
)

B1, B2, EPS = 0.9, 0.99, 1e-8
POSE_LEAVES = ("pose_r", "pose_t", "exposure")


def sampled_batches(seed: int, n_batches: int, n_frames: int, n_px: int, n_views: int,
                    batch_size: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """LocalRF's sampler in refinement, with pose optimization and no
    held-out frames, on a numpy generator seeded with `seed`: per batch the
    held-out-pose coin (never taken), n_views frames uniform over the
    window, then batch_size pixel ids uniform over a frame. Returns
    [(views [V], px [V, P])]."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        rng.uniform()
        views = rng.integers(0, n_frames, n_views).astype(np.int64)
        px = rng.integers(0, n_px, batch_size).astype(np.int64).reshape(n_views, -1)
        out.append((views, px))
    return out


def noise_draws(seed: int, n_batches: int, n_total: int, device) -> list[dict]:
    """Each step's jitter: two [1, n_total // 6] uniform draws and the
    background coin, in that order, from a torch generator on `device`
    seeded with `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = n_total // 6
    return [{"u1": torch.rand((1, n), generator=gen, device=device),
             "u2": torch.rand((1, n), generator=gen, device=device),
             "bg": torch.rand((), generator=gen, device=device)} for _ in range(n_batches)]


def _robust_mean(arr: torch.Tensor, q: float) -> torch.Tensor:
    """Mean of arr [V, P] with each view's values above its q-quantile set to 0."""
    return torch.where(arr > torch.quantile(arr, q, dim=1, keepdim=True), 0.0, arr).mean()


def _normalized(x: torch.Tensor) -> torch.Tensor:
    t = torch.quantile(x, 0.5, dim=1, keepdim=True)
    return (x - t) / (x - t).abs().mean(dim=1, keepdim=True)


def losses(params: dict, pose: tuple, batch: dict, cell: dict, noise: dict, reg_w: float, q) -> dict:
    """The step's losses but L1 (tensors with their graph). `batch`: "views"
    [V], "px" [V, P] and the pixels' "rgbs" [V, P, 3], "invdepths" [V, P],
    "fwd_flow" / "bwd_flow" [V, P, 2], "fwd_mask" / "bwd_mask" [V, P]."""
    r6, t, expo = pose
    views, px = batch["views"], batch["px"]
    v, p = px.shape
    w, h, n_valid = cell["w"], cell["h"], cell["n_frames"]
    focal, center = focal_length(w), (w * 0.5, h * 0.5)
    c2w = torch.cat([rotation(r6), t[..., None]], dim=-1)
    cams = c2w[views][:, None].expand(v, p, 3, 4).reshape(-1, 3, 4)
    o, d, dirs, ij = camera_rays(px.reshape(-1), cams, w, h, focal, center)
    z, dists = sample_depths(n_samples(cell["grid"]), o.device, noise)
    rgb, depth = render(params, cell["model"], o, d, z, dists, cell["alpha"], cell["coarse"],
                        cell["occ_m"], q)
    rgb = exposure_clip(rgb, expo[views].repeat_interleave(p, dim=0))
    out = {"rgb_loss": 0.25 * (rgb - batch["rgbs"].reshape(-1, 3)).abs().mean()}

    depth = depth.reshape(v, p)
    pts = dirs.reshape(v, p, 3) * depth[..., None]
    ij = ij.reshape(v, p, 2)

    def flow_error(offset: int, key: str) -> torch.Tensor:
        nb = torch.clamp(views + offset, 0, n_valid - 1)
        rt = c2w[nb, :, :3].transpose(1, 2)
        rot = rt @ c2w[views, :, :3]
        tr = (rt @ (c2w[views, :, 3] - c2w[nb, :, 3])[..., None])[..., 0]
        moved = (rot[:, None] @ pts[..., None])[..., 0] + tr[:, None]
        zc = torch.clamp(-moved[..., 2], min=1e-6)
        pred = torch.stack([moved[..., 0] / zc * focal + center[0] - 0.5,
                            -moved[..., 1] / zc * focal + center[1] - 0.5], dim=-1) - ij
        return (pred - batch[key]).abs().sum(dim=-1)

    fwd_mask = batch["fwd_mask"] * (views != n_valid - 1)[:, None]
    arr = flow_error(-1, "bwd_flow") * batch["bwd_mask"] + flow_error(1, "fwd_flow") * fwd_mask
    out["flow_loss"] = _robust_mean(arr, 0.9) * cell["flow_weight"] * reg_w / ((w + h) / 2)
    inv = 1.0 / torch.clamp(depth, min=1e-6)
    arr = (_normalized(inv) - _normalized(batch["invdepths"])) ** 2
    out["depth_loss"] = _robust_mean(arr, 0.8) * cell["depth_weight"] * reg_w
    return out


def _norms(tree: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def train_steps(weights: dict, batches: list, noises: list, cell: dict, precision: str = "f32",
                fault: str | None = None) -> dict:
    """len(batches) steps from `weights` ({name: f32 tensor}), identity poses
    and exposures for cell["n_frames"] frames. `batches` as `losses` takes
    them, `noises` [{"u1", "u2" [1, N]}]. `fault="half_batch"`
    takes each step's losses over the first half of its views only.
    Returns {"losses": [{name: float}] per step, "grad1": {leaf: norm of
    the first step's gradient}, "grad1_tensors": {leaf: that gradient, on
    the host}, "update": {leaf: norm of the change over all steps}}."""
    dev = next(iter(weights.values())).device
    q = rounder(precision)
    n = cell["n_frames"]
    cell = dict(cell)
    cell["alpha"] = ball_volume(cell["grid"] // 2, cell["ball_radius"], dev)
    cell["coarse"] = coarse_volume(cell["alpha"], 4)
    cell["occ_m"] = compacted_samples(cell["grid"], occ_min=cell["occ_min"])
    eye = torch.eye(3, device=dev)
    p = {k: v.detach().clone() for k, v in weights.items()}
    p.update(pose_r=eye[:, :2].expand(n, 3, 2).clone(), pose_t=torch.zeros((n, 3), device=dev),
             exposure=eye.expand(n, 3, 3).clone())
    start = {k: v.clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    s2 = {k: torch.zeros_like(v) for k, v in p.items()}
    # the decay per step once every frame of the window trains
    decay = cell["lr_decay_target_ratio"] ** (1 / (cell["n_iters_per_frame"] * n))
    lr_factor = np.float32(decay)
    lr = {k: cell["lr_basis"] if k == "basis_mat" or k.startswith("mlp.") else cell["lr_spatial"] for k in weights}
    pose_lr = {"pose_r": np.float32(cell["lr_r"]), "pose_t": np.float32(cell["lr_t"]),
               "exposure": np.float32(cell["lr_exposure"])}
    scale = np.float32(1.0)
    out = {"losses": []}
    with full_f32():
        for k, (batch, noise) in enumerate(zip(batches, noises)):
            if fault == "half_batch":
                batch = {key: val[: val.shape[0] // 2] for key, val in batch.items()}
            reg_w = float(np.float32(decay ** (cell["rf_iter"] + k)))
            leaves = {key: val.detach().requires_grad_(True) for key, val in p.items()}
            parts = losses({key: leaves[key] for key in weights}, tuple(leaves[x] for x in POSE_LEAVES),
                           batch, cell, noise, reg_w, q)
            grads = torch.autograd.grad(sum(parts.values()), list(leaves.values()), allow_unused=True)
            grads = {key: torch.zeros_like(leaves[key]) if g is None else g for key, g in zip(leaves, grads)}
            l1, l1_grads = cell["model"]["field"].density_l1_grads(p, cell["model"]["act"])
            for key, g in l1_grads.items():
                grads[key] = grads[key] + cell["l1_weight"] * g
            parts["l1_loss"] = l1 * cell["l1_weight"]
            parts["total_loss"] = sum(parts.values())
            out["losses"].append({key: float(val.detach()) for key, val in parts.items()})
            if k == 0:
                out["grad1"] = _norms(grads)
                out["grad1_tensors"] = {key: g.detach().cpu() for key, g in grads.items()}
            for key in POSE_LEAVES:
                pose_lr[key] = np.float32(pose_lr[key] * lr_factor)
            step = k + 1
            with torch.no_grad():
                for key, g in grads.items():
                    m[key] = B1 * m[key] + (1 - B1) * g
                    s2[key] = B2 * s2[key] + (1 - B2) * g * g
                    rate = float(pose_lr[key]) if key in pose_lr else lr[key] * float(scale)
                    mhat = m[key] / (1 - B1**step)
                    vhat = s2[key] / (1 - B2**step)
                    p[key] = p[key] - rate * mhat / (torch.sqrt(vhat) + EPS)
            scale = np.float32(scale * lr_factor)
    out["update"] = _norms({k: p[k] - start[k] for k in p})
    return out
