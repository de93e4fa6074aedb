"""Operations of the model, counted from the configuration's widths and the
work's shapes (not from the kernels that run), and the H100's peaks.

Per sample point, forward: each orientation's plane (3 lerps) and line (1
lerp) lookups at 3 operations a lerp and their product, per channel, plus
the density sum; the appearance basis and the shading MLP as 2 * in * out
a layer, with biases and activations; compositing at 10 a sample. The
backward of each is counted at twice its forward, so a trained point
costs 3 forwards (no recompute). The density L1 term evaluates every
voxel of the grid (3 dot products of the density ranks, the softplus and
the root) at 3 times that with its backward; Adam costs 12 a parameter.
"""
from __future__ import annotations

import math

from .scene import mlp_shapes, weight_shapes

# H100 SXM (NVIDIA's data sheet): dense bf16 tensor-core rate and HBM3 rate
PEAK_BF16_FLOP_S = 989e12
HBM_BYTES_S = 3.35e12
LERP = 3


def point_forward(wd: dict) -> int:
    """Forward operations at one sample point."""
    lookups = sum((3 * LERP + LERP + 1) * (d + a) + d for d, a in zip(wd["density"], wd["app"]))
    basis = 2 * sum(wd["app"]) * wd["app_dim"]
    layers = mlp_shapes(wd).values()
    mlp = sum(2 * fi * fo + 2 * fo for fi, fo in layers)
    pe = 4 * (wd["fea_pe"] * wd["app_dim"] + wd["view_pe"] * 3)
    return lookups + basis + mlp + pe + 10


def l1_voxel(wd: dict) -> int:
    return 2 * sum(wd["density"]) + 6


def n_params(wd: dict, grid: int) -> int:
    return sum(math.prod(s) for s in weight_shapes(wd, grid).values())


def train_step(wd: dict, grid: int, rays: int, samples: int) -> float:
    """Operations of one training step of `rays` rays of `samples` kept samples."""
    return 3.0 * point_forward(wd) * rays * samples + 3.0 * l1_voxel(wd) * grid**3 + 12.0 * n_params(wd, grid)


def eval_frame(wd: dict, pixels: int, samples: int) -> float:
    """Operations of one eval frame of `pixels` rays of `samples` kept samples."""
    return float(point_forward(wd)) * pixels * samples


def k2_bytes(wd: dict, grid: int, rays: int, samples: int) -> int:
    """Bytes the step's three plane sums (K2) must move: each reads its
    bf16 payload [P, 4C] (a quad row of the density and appearance
    channels per point) and its int64 row ids [P] once, and writes the
    bf16 gradient table [grid^2, 4C] once; P = rays * samples."""
    p = rays * samples
    return sum(p * 4 * (d + a) * 2 + p * 8 + grid * grid * 4 * (d + a) * 2
               for d, a in zip(wd["density"], wd["app"]))
