"""Operations of the model, counted from the configuration's widths and the
work's shapes (not from the kernels that run), and the H100's peaks.

Per sample point, forward: the field's lookups (the field module's
`lookup_ops`: for TensoRF-VM each orientation's plane and line lookups,
their product per channel, the density sum); the appearance basis and the
shading MLP as 2 * in * out a layer, with biases and activations;
compositing at 10 a sample. The backward of each is counted at twice its
forward, so a trained point costs 3 forwards (no recompute). The density
L1 term evaluates every voxel of the grid (the field module's
`l1_voxel_ops`) at 3 times that with its backward; Adam costs 12 a
parameter. A field's plane sums (K2) move the field module's
`plane_sum_bytes`.
"""
from __future__ import annotations

import math

from .scene import mlp_shapes, weight_shapes

# H100 SXM (NVIDIA's data sheet): dense bf16 tensor-core rate and HBM3 rate
PEAK_BF16_FLOP_S = 989e12
HBM_BYTES_S = 3.35e12


def point_forward(field, wd: dict) -> int:
    """Forward operations at one sample point."""
    basis = 2 * sum(wd["app"]) * wd["app_dim"]
    layers = mlp_shapes(wd).values()
    mlp = sum(2 * fi * fo + 2 * fo for fi, fo in layers)
    pe = 4 * (wd["fea_pe"] * wd["app_dim"] + wd["view_pe"] * 3)
    return field.lookup_ops(wd) + basis + mlp + pe + 10


def l1_voxel(field, wd: dict) -> int:
    return field.l1_voxel_ops(wd)


def n_params(field, wd: dict, grid: int) -> int:
    return sum(math.prod(s) for s in weight_shapes(field, wd, grid).values())


def train_step(field, wd: dict, grid: int, rays: int, samples: int) -> float:
    """Operations of one training step of `rays` rays of `samples` kept samples."""
    return (3.0 * point_forward(field, wd) * rays * samples + 3.0 * l1_voxel(field, wd) * grid**3
            + 12.0 * n_params(field, wd, grid))


def eval_frame(field, wd: dict, pixels: int, samples: int) -> float:
    """Operations of one eval frame of `pixels` rays of `samples` kept samples."""
    return float(point_forward(field, wd)) * pixels * samples


def k2_bytes(field, wd: dict, grid: int, rays: int, samples: int) -> int | None:
    """Bytes the step's plane sums (K2) must move, None for a field with no
    plane sums."""
    return field.plane_sum_bytes(wd, grid, rays, samples)
