"""Optical-flow color-wheel visualization (Middlebury convention): the
port's copy of localrf_tpu/preprocess/flow_vis.py (numpy only)."""
from __future__ import annotations

import numpy as np


def _make_colorwheel() -> np.ndarray:
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    ncols = ry + yg + gc + cb + bm + mr
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:ry, 0] = 255
    wheel[0:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col : col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col : col + yg, 1] = 255
    col += yg
    wheel[col : col + gc, 1] = 255
    wheel[col : col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col : col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col : col + cb, 2] = 255
    col += cb
    wheel[col : col + bm, 2] = 255
    wheel[col : col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col : col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col : col + mr, 0] = 255
    return wheel


_WHEEL = _make_colorwheel()


def flow_to_color(flow: np.ndarray, clip_rad: float | None = None) -> np.ndarray:
    """flow [H, W, 2] -> RGB uint8 [H, W, 3]."""
    u, v = flow[..., 0].astype(np.float64), flow[..., 1].astype(np.float64)
    rad = np.sqrt(u**2 + v**2)
    rad_max = clip_rad if clip_rad else max(float(rad.max()), 1e-6)
    u, v = u / rad_max, v / rad_max
    rad = np.sqrt(u**2 + v**2)

    ncols = _WHEEL.shape[0]
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int) % ncols
    k1 = (k0 + 1) % ncols
    f = fk - np.floor(fk)

    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for c in range(3):
        col0 = _WHEEL[k0, c] / 255
        col1 = _WHEEL[k1, c] / 255
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        img[..., c] = np.floor(255 * col)
    return img
