"""A line-only (CP) field module for the tests, in the form of TensoRF's
TensorCP: each density and appearance component is the product of three
line factors, one along each axis (TensoRF's vecMode 2, 1, 0). Not a
benchmark configuration: the tests copy it into a copy of the benchmark's
reference/ folder, as a configuration of a new field adds its module, and
check that the harness takes the field's shapes, features, L1 term and
counts from it.

Parameters: `density_line_i` [R_sigma, D], `app_line_i` [R_app, D],
`basis_mat` [R_app, app_dim]; the ranks are the single entries of the
configuration's n_lamb_sigma and n_lamb_sh.
"""
from __future__ import annotations

import torch

from .field import LERP, LINE_AXIS, line_lookup


def weight_shapes(wd: dict, grid: int) -> tuple[dict, dict]:
    (r_sigma,), (r_app,) = wd["density"], wd["app"]
    factors = {f"{kind}_line_{i}": (r, grid) for kind, r in (("density", r_sigma), ("app", r_app)) for i in range(3)}
    return factors, {"basis_mat": (r_app, wd["app_dim"])}


def _product(params: dict, kind: str, pts: torch.Tensor, q) -> torch.Tensor:
    out = 1.0
    for i, axis in enumerate(LINE_AXIS):
        out = out * line_lookup(q(params[f"{kind}_line_{i}"]), pts[:, axis])
    return out


def features(params: dict, pts: torch.Tensor, q) -> tuple[torch.Tensor, torch.Tensor]:
    sigma = _product(params, "density", pts, q).sum(dim=-1)
    return sigma, _product(params, "app", pts, q) @ q(params["basis_mat"])


def density_l1_grads(params: dict, act: str) -> tuple[torch.Tensor, dict]:
    """TensorCP's density_L1, the sum over the three density lines of the
    mean absolute entry (it reads no density, so `act` plays no part)."""
    lines = {f"density_line_{i}": params[f"density_line_{i}"].detach() for i in range(3)}
    total = sum(v.abs().mean() for v in lines.values())
    return total, {k: torch.sign(v) / v.numel() for k, v in lines.items()}


def lookup_ops(wd: dict) -> int:
    """Per component three line lerps and two products, plus the density sum."""
    (r_sigma,), (r_app,) = wd["density"], wd["app"]
    return (3 * LERP + 2) * (r_sigma + r_app) + r_sigma


def l1_voxel_ops(wd: dict) -> int:
    """The L1 term reads the lines, no voxel of the grid."""
    return 0


def plane_sum_bytes(wd: dict, grid: int, rays: int, samples: int) -> None:
    """No planes, so no plane sums."""
    return None
