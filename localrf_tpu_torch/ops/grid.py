"""Grid sampling (align_corners=True, border padding) — PyTorch port of
localrf_tpu/ops/grid.py.

Coordinates are in [-1, 1] with `align_corners=True` normalization (-1 ->
texel 0 center, +1 -> texel N-1 center); out-of-range coordinates are
clamped (border padding). Outputs are point-major [P, C].

The hot path reads factor grids through quad-packed tables: all four
bilinear corners of texel (y, x) sit in ONE row of a derived [H*W, 4C]
table, so a point costs one row gather (and one backward scatter-add). The
derived tables are built with dense shifts from the canonical [C, H, W]
parameters, so optimizer state, TV, upsampling and checkpoints stay in the
canonical layout. The `grid_sample_*` functions are the oracles.
"""
from __future__ import annotations

import torch


def plane_coords(pts: torch.Tensor, m0: int, m1: int) -> torch.Tensor:
    """pts[:, (m0, m1)] -> [P, 2], without the index tensor that tuple
    indexing copies from the host (a sync, refused in a captured step)."""
    return torch.stack([pts[:, m0], pts[:, m1]], dim=-1)


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """[-1, 1] -> [0, size-1] texel space, clamped (border padding).

    NaN coordinates (e.g. from a diverged pose) map to texel 0; the clamp is
    what keeps every derived row index inside its table."""
    x = (torch.nan_to_num(coord) + 1.0) * 0.5 * (size - 1)
    return torch.clamp(x, 0.0, size - 1)


def grid_sample_1d(line: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Linear sampling of a stack of 1D signals. line [C, D]; coords [P] -> [P, C]."""
    d = line.shape[1]
    x = _unnormalize(coords, d)
    x0 = torch.floor(x).long()
    x1 = torch.clamp(x0 + 1, max=d - 1)
    w1 = (x - x0.to(x.dtype))[:, None]
    v0 = line[:, x0].T  # [P, C]
    v1 = line[:, x1].T
    return v0 * (1.0 - w1) + v1 * w1


def grid_sample_2d(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of a multi-channel 2D grid.

    plane: [C, H, W]; coords: [P, 2] as (x, y) with x indexing W, y indexing H
    (torch grid_sample convention)  ->  [P, C].
    """
    c, h, w = plane.shape
    x = _unnormalize(coords[:, 0], w)
    y = _unnormalize(coords[:, 1], h)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    wx = (x - x0.to(x.dtype))[:, None]
    wy = (y - y0.to(y.dtype))[:, None]

    flat = plane.reshape(c, h * w)
    v00 = flat[:, y0 * w + x0].T  # [P, C]
    v01 = flat[:, y0 * w + x1].T
    v10 = flat[:, y1 * w + x0].T
    v11 = flat[:, y1 * w + x1].T

    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return top * (1.0 - wy) + bot * wy


def grid_sample_3d(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear sampling of a single-channel 3D volume.

    vol: [D, H, W]; coords: [P, 3] as (x, y, z) -> [P].
    """
    d, h, w = vol.shape
    x = _unnormalize(coords[:, 0], w)
    y = _unnormalize(coords[:, 1], h)
    z = _unnormalize(coords[:, 2], d)
    x0, y0, z0 = torch.floor(x).long(), torch.floor(y).long(), torch.floor(z).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    z1 = torch.clamp(z0 + 1, max=d - 1)
    wx = x - x0.to(x.dtype)
    wy = y - y0.to(y.dtype)
    wz = z - z0.to(z.dtype)

    flat = vol.reshape(-1)

    def at(zi, yi, xi):
        return flat[(zi * h + yi) * w + xi]

    c00 = at(z0, y0, x0) * (1 - wx) + at(z0, y0, x1) * wx
    c01 = at(z0, y1, x0) * (1 - wx) + at(z0, y1, x1) * wx
    c10 = at(z1, y0, x0) * (1 - wx) + at(z1, y0, x1) * wx
    c11 = at(z1, y1, x0) * (1 - wx) + at(z1, y1, x1) * wx
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    return c0 * (1 - wz) + c1 * wz


def build_quad_plane(plane: torch.Tensor) -> torch.Tensor:
    """[C, H, W] -> [H*W, 4C] rows: [p(y,x) | p(y,x1) | p(y1,x) | p(y1,x1)];
    the +1 shifted copies duplicate the last row/column (border clamp)."""
    c, h, w = plane.shape
    px = torch.cat([plane[:, :, 1:], plane[:, :, -1:]], dim=2)
    py = torch.cat([plane[:, 1:, :], plane[:, -1:, :]], dim=1)
    pxy = torch.cat([px[:, 1:, :], px[:, -1:, :]], dim=1)
    quad = torch.stack([plane, px, py, pxy], dim=0)  # [4, C, H, W]
    return quad.permute(2, 3, 0, 1).reshape(h * w, 4 * c)


def build_quad_line(line: torch.Tensor) -> torch.Tensor:
    """[C, D] -> [D, 2C] rows: [l(d) | l(d1)]."""
    ln = torch.cat([line[:, 1:], line[:, -1:]], dim=1)
    return torch.cat([line.T, ln.T], dim=1)


def plane_texel(h: int, w: int, coords: torch.Tensor):
    """coords [P, 2] as (x, y) -> (flat row index [P] int64, wx [P,1], wy [P,1])."""
    x = _unnormalize(coords[:, 0], w)
    y = _unnormalize(coords[:, 1], h)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    wx = (x - x0.to(x.dtype))[:, None]
    wy = (y - y0.to(y.dtype))[:, None]
    return y0 * w + x0, wx, wy


def quad_lerp_2d(rows: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor, c: int) -> torch.Tensor:
    """Bilinear lerp over gathered quad rows [P, 4C] -> [P, C], in the table
    dtype: with bf16 tables the weights are rounded to bf16 too."""
    wx = wx.to(rows.dtype)
    wy = wy.to(rows.dtype)
    v00, v01, v10, v11 = (
        rows[:, :c],
        rows[:, c : 2 * c],
        rows[:, 2 * c : 3 * c],
        rows[:, 3 * c : 4 * c],
    )
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return top * (1.0 - wy) + bot * wy


def quad_sample_2d(
    quad: torch.Tensor, h: int, w: int, coords: torch.Tensor, c: int, binned: bool = False
) -> torch.Tensor:
    """Bilinear sample from a quad-packed plane. coords [P, 2] as (x, y).

    binned=True routes the backward scatter-add through the hand-written
    segment-sum kernel (ops/kernels/binned_scatter.py); otherwise autograd's
    index_select backward scatters."""
    idx, wx, wy = plane_texel(h, w, coords)
    if binned:
        from .kernels.binned_scatter import take_rows_binned

        rows = take_rows_binned(quad, idx)
    else:
        rows = quad.index_select(0, idx)
    return quad_lerp_2d(rows, wx, wy, c)


def line_texel(d: int, coords: torch.Tensor):
    """coords [P] in [-1, 1] -> (row index x0 [P] int64, lerp weight w1 [P, 1]).
    The clamp keeps x0 <= d - 1, and the quad line's last row duplicates
    the border, so x0 always indexes a whole row pair."""
    x = _unnormalize(coords, d)
    x0 = torch.floor(x).long()
    w1 = (x - x0.to(x.dtype))[:, None]
    return x0, w1


def quad_lerp_1d(rows: torch.Tensor, w1: torch.Tensor, c: int) -> torch.Tensor:
    """Linear lerp over gathered quad-line rows [P, 2C] -> [P, C] (table dtype)."""
    w1 = w1.to(rows.dtype)
    return rows[:, :c] * (1.0 - w1) + rows[:, c : 2 * c] * w1


def quad_sample_1d(
    quad: torch.Tensor, d: int, coords: torch.Tensor, c: int, mode: str = "gather",
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Linear sample from a quad-packed line, coords [P] in [-1, 1].

    `mode` selects the backward of the row gather:
      - "gather": autograd's `index_select` backward (a scatter-add);
      - "segsum": the K3 kernel (ops/kernels/segsum.py `take_rows`): `quad`
        is the f32 table, the rows are rounded to `dtype`, the gradient
        stays f32 as in JAX;
      - "onehot": an f32 `index_add_` cast to the table dtype (JAX's pure-XLA
        one-hot matmul).
    """
    from .kernels.segsum import take_rows, take_rows_onehot

    x0, w1 = line_texel(d, coords)
    if mode == "segsum":
        rows = take_rows(quad, x0, dtype)
    elif mode == "onehot":
        rows = take_rows_onehot(quad, x0)
    elif mode == "gather":
        rows = quad.index_select(0, x0)
    else:
        raise ValueError(f"unknown line mode {mode!r}")
    return quad_lerp_1d(rows, w1, c)


def resize_align_corners_2d(plane: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """Bilinear resize with align_corners=True semantics. plane: [C, H, W]."""
    ys = torch.linspace(-1.0, 1.0, new_h, device=plane.device)
    xs = torch.linspace(-1.0, 1.0, new_w, device=plane.device)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")  # [new_h, new_w]
    coords = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    out = grid_sample_2d(plane, coords)  # [new_h*new_w, C]
    return out.T.reshape(plane.shape[0], new_h, new_w)


def resize_align_corners_1d(line: torch.Tensor, new_d: int) -> torch.Tensor:
    """Linear resize with align_corners=True semantics. line: [C, D]."""
    coords = torch.linspace(-1.0, 1.0, new_d, device=line.device)
    return grid_sample_1d(line, coords).T  # [C, new_d]
