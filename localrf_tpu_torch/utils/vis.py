"""Host-side visualization: depth colormaps and camera-pose wireframes (the
port's copy of localrf_tpu/utils/vis.py; ref: utils/utils.py:73-129,
155-197).

`draw_poses` draws with cv2, not matplotlib (which the card's machine does
not have): the same wireframes, projected orthographically from
matplotlib's default 3D view (elevation 30, azimuth -60 degrees) inside the
same cube of axis limits, on a 640x480 canvas in matplotlib's default
colours.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def to_uint8(x) -> np.ndarray:
    """[0,1] float image -> uint8 by rounding to nearest (the JAX package's
    choice: the reference truncates, which biases every saved render half a
    quantum low)."""
    return np.clip(np.rint(_host(x) * 255), 0, 255).astype(np.uint8)


def visualize_depth(depth, minmax=None):
    """Depth -> JET colormap uint8 [H, W, 3] plus the (mi, ma) used."""
    import cv2

    x = np.nan_to_num(_host(depth))
    if minmax is None:
        positive = x[x > 0]
        mi = float(np.min(positive)) if positive.size else 0.0
        ma = float(np.max(x))
    else:
        mi, ma = minmax
    x = (x - mi) / (ma - mi + 1e-8)
    x = (255 * np.clip(x, 0, 1)).astype(np.uint8)
    colored = cv2.applyColorMap(x, cv2.COLORMAP_JET)[..., ::-1]  # BGR -> RGB
    return colored, [mi, ma]


def get_camera_mesh(poses: np.ndarray, depth: float = 1.0):
    """Camera frustum wireframe vertices for [N, 3, 4] poses."""
    vertices = (
        np.array(
            [[-0.5, -0.5, -1], [0.5, -0.5, -1], [0.5, 0.5, -1], [-0.5, 0.5, -1], [0, 0, 0]],
            np.float32,
        )
        * depth
    )
    verts = vertices @ np.swapaxes(poses[:, :3, :3], -1, -2)
    verts = verts + poses[:, None, :3, 3]
    verts[..., 1:] *= -1  # axis flip for display
    wireframe = verts[:, [0, 1, 2, 3, 0, 4, 1, 2, 4, 3]]
    return verts, wireframe


# matplotlib's default colour cycle C0..C9, as RGB
_COLOURS = {f"C{i}": tuple(int(h[k:k + 2], 16) for k in (1, 3, 5)) for i, h in enumerate((
    "#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
    "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf"))}
_CANVAS = (480, 640)  # matplotlib's default figure, 6.4 x 4.8 in at 100 dpi
_ELEV, _AZIM = math.radians(30.0), math.radians(-60.0)


def _project(p: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """Points [..., 3] inside the cube [lo, hi]^3 -> pixel coordinates of
    an orthographic view from (_ELEV, _AZIM), the cube's centre in the
    canvas' centre."""
    q = (p - (lo + hi) / 2) / (hi - lo)
    right = np.array([-math.sin(_AZIM), math.cos(_AZIM), 0.0])
    up = np.array([-math.sin(_ELEV) * math.cos(_AZIM), -math.sin(_ELEV) * math.sin(_AZIM), math.cos(_ELEV)])
    h, w = _CANVAS
    scale = 0.55 * min(h, w)
    return np.stack([w / 2 + scale * (q @ right), h / 2 - scale * (q @ up)], axis=-1)


def draw_poses(poses: np.ndarray, colours: list[str]) -> np.ndarray:
    """3D wireframe plot of camera poses -> RGB uint8 image [480, 640, 3]."""
    import cv2

    poses = np.asarray(poses, np.float32).copy()
    poses[:, :, 3] -= poses[:, :, 3].mean(axis=0, keepdims=True)
    verts, wireframe = get_camera_mesh(poses, 0.05)
    center = verts[:, -1]
    ps = max(float(center.max()), 0.1)
    ms = min(float(center.min()), -0.1)
    img = np.full((*_CANVAS, 3), 255, np.uint8)
    corners = np.array([[x, y, z] for x in (ms, ps) for y in (ms, ps) for z in (ms, ps)])
    for a in range(8):
        for b in range(a + 1, 8):
            if np.count_nonzero(corners[a] != corners[b]) == 1:  # the cube's 12 edges
                pa, pb = _project(corners[[a, b]], ms, ps)
                cv2.line(img, tuple(int(v) for v in np.rint(pa)), tuple(int(v) for v in np.rint(pb)),
                         (200, 200, 200), 1, cv2.LINE_AA)
    px = _project(wireframe, ms, ps)
    for c in range(wireframe.shape[0]):
        colour = _COLOURS[colours[c] if c < len(colours) else "C0"]
        pts = np.rint(px[c]).astype(np.int32).reshape(-1, 1, 2)
        cv2.polylines(img, [pts], False, colour, 1, cv2.LINE_AA)
    return img
