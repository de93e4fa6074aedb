"""TensoRF-CP field in plain f32 (the field module of a configuration whose
"field" is "cp"; the interface: reference/__init__.py): TensoRF's TensorCP
(Chen et al., ECCV 2022, https://github.com/apchenstu/TensoRF), line
lookups by F.grid_sample, LocalRF's density L1 term, and the field's
operation and byte counts.

Parameters: `density_line_i` [R_sigma, D], `app_line_i` [R_app, D],
`basis_mat` [R_app, app_dim] and the head's `mlp.*`; the ranks are the
single entries of the configuration's n_lamb_sigma and n_lamb_sh. Each
component is the product of three lines, line i along axis LINE_AXIS[i]
(TensoRF's vecMode 2, 1, 0):

    sigma_feat(x) = sum_c l0[c, x_2] l1[c, x_1] l2[c, x_0]
    app(x)        = (a0[:, x_2] a1[:, x_1] a2[:, x_0]) @ basis_mat

Where this departs from TensoRF's TensorCP:
- the L1 term is LocalRF's, the mean over the whole grid of sqrt(density)
  (`density_l1_grads`), the term LocalRF trains every field with; TensorCP's
  own density_L1, the mean absolute line entry, is not used;
- the lines are read through F.grid_sample of a [D, 1] image with border
  padding and align_corners, as the VM field's lines are here (TensorCP
  reads a [D, 1] image too);
- the shading head, the density activation and everything else of the step
  are the shared ones (field.py, render.py, step.py).
"""
from __future__ import annotations

import torch

from .field import LERP, LINE_AXIS, density, line_lookup

# bytes of a cotangent row entry the step feeds K3: the configuration's
# bf16 gather tables round the gathered rows to bf16, and their gradient
# arrives in bf16
COTANGENT_BYTES = 2


def _ranks(wd: dict) -> tuple[int, int]:
    (r_sigma,), (r_app,) = wd["density"], wd["app"]
    return r_sigma, r_app


def weight_shapes(wd: dict, grid: int) -> tuple[dict, dict]:
    """({name: shape} of the six lines, {"basis_mat": shape}) at grid^3."""
    r_sigma, r_app = _ranks(wd)
    factors = {f"{kind}_line_{i}": (r, grid) for kind, r in (("density", r_sigma), ("app", r_app))
               for i in range(3)}
    return factors, {"basis_mat": (r_app, wd["app_dim"])}


def _product(params: dict, kind: str, pts: torch.Tensor, q) -> torch.Tensor:
    """[P, R] products of the kind's three line lookups."""
    out = 1.0
    for i, axis in enumerate(LINE_AXIS):
        out = out * line_lookup(q(params[f"{kind}_line_{i}"]), pts[:, axis])
    return out


def features(params: dict, pts: torch.Tensor, q) -> tuple[torch.Tensor, torch.Tensor]:
    """Density feature [P] and appearance feature [P, app_dim] at normalized
    points [P, 3] in [-1, 1]."""
    sigma = _product(params, "density", pts, q).sum(dim=-1)
    return sigma, _product(params, "app", pts, q) @ q(params["basis_mat"])


def density_l1_grads(params: dict, act: str, voxels_per_block: int = 2**23) -> tuple[torch.Tensor, dict]:
    """LocalRF's L1 term of the CP field: the sum over every voxel (x, y, z)
    of sqrt(max(density(f, act), 1e-5)), f = sum_c l2[c, x] l1[c, y] l0[c,
    z], divided by the voxel count; with its gradients w.r.t. the three
    density lines, by autograd, in blocks of x-slices of about
    `voxels_per_block` voxels (500^3 is 125M voxels)."""
    lines = [params[f"density_line_{i}"].detach().clone().requires_grad_(True) for i in range(3)]
    l0, l1, l2 = lines
    gx, gy, gz = l2.shape[1], l1.shape[1], l0.shape[1]
    n_vox = gx * gy * gz
    step = max(1, voxels_per_block // (gy * gz))
    grads = [torch.zeros_like(ln) for ln in lines]
    total = torch.zeros((), dtype=torch.float64, device=l0.device)
    for x0 in range(0, gx, step):
        x1 = min(x0 + step, gx)
        plane = (l2[:, x0:x1, None] * l1[:, None, :]).reshape(l0.shape[0], -1)  # [C, bx * gy]
        feat = plane.t() @ l0  # [bx * gy, gz]
        s = torch.sqrt(torch.clamp(density(feat, act), min=1e-5)).sum()
        for g, d in zip(grads, torch.autograd.grad(s, lines)):
            g += d
        total += s.detach().double()
    out = {f"density_line_{i}": grads[i] / n_vox for i in range(3)}
    return (total / n_vox).float(), out


def lookup_ops(wd: dict) -> int:
    """Operations of the lookups at one sample point: per component three
    line lerps and two products, plus the density sum."""
    r_sigma, r_app = _ranks(wd)
    return (3 * LERP + 2) * (r_sigma + r_app) + r_sigma


def l1_voxel_ops(wd: dict) -> int:
    """Operations of the L1 term at one voxel: the dot product of the
    virtual plane's R_sigma products (l1 l2, made once per (x, y) pixel,
    not per voxel) with the line l0, the activation and the root."""
    r_sigma, _ = _ranks(wd)
    return 2 * r_sigma + 6


def plane_sum_bytes(wd: dict, grid: int, rays: int, samples: int) -> None:
    """No planes, so no plane sums."""
    return None


def line_sum_bytes(wd: dict, grid: int, rays: int, samples: int) -> int:
    """Bytes the step's three line sums (K3) must move: each orientation
    reads its cotangent rows [P, 2 (R_sigma + R_app)] (a quad line row of
    the density and appearance components per point) in bf16 and its
    int64 row ids [P] once, and writes the f32 gradient table [grid, 2
    (R_sigma + R_app)] once; P = rays * samples."""
    r_sigma, r_app = _ranks(wd)
    p, width = rays * samples, 2 * (r_sigma + r_app)
    return 3 * (p * width * COTANGENT_BYTES + p * 8 + grid * width * 4)
