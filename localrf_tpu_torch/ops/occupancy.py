"""Bit-packed occupancy lookup + static-shape sample compaction (PyTorch port
of localrf_tpu/ops/occupancy.py).

  * the 8 trilinear corner occupancies of every voxel are packed into one
    uint8, so the `occ > 0` test is ONE byte gather per point;
  * each ray's valid samples are compacted to a static M slots (order
    preserving), so density gathers, the transmittance scan and shading run
    on [R, M] instead of [R, S].

trilinear(vol, p) > 0  <=>  some corner has bit=1 AND nonzero trilinear
weight — exactly the reference's cull decision (alpha values are >= 0).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .grid import _unnormalize


def _shift_edge(a: torch.Tensor, dim: int) -> torch.Tensor:
    """a shifted by +1 along `dim`, the last slice repeated (edge clamp)."""
    d = a.shape[dim]
    return torch.cat([a.narrow(dim, 1, d - 1), a.narrow(dim, d - 1, 1)], dim=dim)


def pack_alpha_corners(vol: torch.Tensor) -> torch.Tensor:
    """Binary volume [D, H, W] -> uint8 [D*H*W]; bit k = corner (dz,dy,dx)
    occupancy with k = dz*4 + dy*2 + dx, +1 shifts edge-clamped."""
    v = vol > 0
    bits = torch.zeros(v.shape, dtype=torch.uint8, device=vol.device)
    k = 0
    for dz in (0, 1):
        az = _shift_edge(v, 0) if dz else v
        for dy in (0, 1):
            ay = _shift_edge(az, 1) if dy else az
            for dx in (0, 1):
                ax = _shift_edge(ay, 2) if dx else ay
                bits = bits | (ax.to(torch.uint8) << k)
                k += 1
    return bits.reshape(-1)


def occupancy_valid(packed: torch.Tensor, dhw: tuple[int, int, int], coords: torch.Tensor) -> torch.Tensor:
    """coords [P, 3] as (x, y, z) in [-1, 1] -> bool [P]: trilinear occ > 0.

    One plain byte gather per point; the byte is widened to int32 before
    the bit shifts."""
    d, h, w = dhw
    fx = _unnormalize(coords[:, 0], w)
    fy = _unnormalize(coords[:, 1], h)
    fz = _unnormalize(coords[:, 2], d)
    x0, y0, z0 = torch.floor(fx).long(), torch.floor(fy).long(), torch.floor(fz).long()
    wx = fx - x0.to(fx.dtype)
    wy = fy - y0.to(fy.dtype)
    wz = fz - z0.to(fz.dtype)

    byte = packed[(z0 * h + y0) * w + x0].to(torch.int32)
    valid = torch.zeros(coords.shape[0], dtype=torch.bool, device=coords.device)
    k = 0
    for dz in (0, 1):
        cz = (wz > 0) if dz else (wz < 1)
        for dy in (0, 1):
            cy = (wy > 0) if dy else (wy < 1)
            for dx in (0, 1):
                cx = (wx > 0) if dx else (wx < 1)
                bit = (byte >> k) & 1
                valid = valid | ((bit > 0) & cx & cy & cz)
                k += 1
    return valid


def coarsen_alpha(vol: torch.Tensor, ds: int) -> torch.Tensor:
    """Downsample a binary occupancy volume by `ds` per axis (maxpool) and
    dilate the result by one coarse voxel (3^3 maxpool).

    A ragged end is padded with -inf first, which is what JAX's
    reduce_window padding does and what F.max_pool3d's own padding cannot
    express (it pads both ends)."""
    d, h, w = vol.shape
    x = F.pad(
        vol[None, None], (0, (-w) % ds, 0, (-h) % ds, 0, (-d) % ds), value=float("-inf")
    )
    pooled = F.max_pool3d(x, kernel_size=ds, stride=ds)
    dilated = F.max_pool3d(pooled, kernel_size=3, stride=1, padding=1)
    return dilated[0, 0]


def compact_valid_samples(valid: torch.Tensor, m: int):
    """Select the first m valid sample indices per ray, in ascending order;
    the final slot is reserved for the dense terminator sample S-1.

    valid: [R, S] bool -> (sel [R, m] int64, sel_valid [R, m] bool). Keys are
    distinct per row, so top-k has no ties and matches JAX's lax.top_k.
    """
    r, s = valid.shape
    idx = torch.arange(s, device=valid.device)[None, :]
    keys = torch.where(valid, idx, s + idx)
    neg_keys, sel = torch.topk(-keys, m, dim=1)  # m smallest keys, ascending
    sel[:, -1] = s - 1
    sel_valid = -neg_keys < s
    sel_valid[:, -1] = False
    return sel, sel_valid
