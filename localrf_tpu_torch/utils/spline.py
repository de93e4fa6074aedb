"""Smoothed camera trajectories for path rendering (the port's copy of
localrf_tpu/utils/spline.py, numpy and scipy only).

A robust median prefilter, a per-channel smoothing-spline fit of the
translation and of the rotation's forward/up axes, then
re-orthonormalization (ref: utils/utils.py:394-440).
"""
from __future__ import annotations

import numpy as np
from scipy.interpolate import UnivariateSpline

# translation-step scale target and median window half-width used by the
# reference (ref: utils/utils.py:421, 407-410)
_STEP_SCALE = 2e-2
_MEDIAN_HALF_WIDTH = 5


def _block_median_resample(x: np.ndarray, t: np.ndarray, half: int) -> np.ndarray:
    """Median over consecutive non-overlapping windows of 2*half+1 samples
    (tail truncated), linearly resampled back onto every timestamp."""
    w = 2 * half + 1
    k = (x.size - w) // w + 1
    meds = np.median(x[: k * w].reshape(k, w), axis=1)
    centers = t[half::w][:k]
    return np.interp(t, centers, meds)


def _smooth_channels(
    m: np.ndarray, t: np.ndarray, smoothing: float, prefilter: bool
) -> np.ndarray:
    """Smoothing-spline fit of each column of m [N, C] over t [N]."""
    if prefilter:
        cols = [_block_median_resample(c, t, _MEDIAN_HALF_WIDTH) for c in m.T]
        m = np.stack(cols, axis=1)
    out = np.empty_like(m)
    for c in range(m.shape[1]):
        spline = UnivariateSpline(t, m[:, c])
        spline.set_smoothing_factor(smoothing)
        out[:, c] = spline(t)
    return out


def _orthonormal_frame(fwd: np.ndarray, up_hint: np.ndarray):
    """Right-handed (x, y, z) from a forward axis and an approximate up."""
    z = fwd / np.linalg.norm(fwd, axis=-1, keepdims=True)
    x = np.cross(z, up_hint)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    y = np.cross(x, z)
    return x, y, z


def smooth_poses_spline(
    poses: np.ndarray, st: float = 0.5, sr: float = 4, median_prefilter: bool = True
) -> np.ndarray:
    """Smooth a [N, 3, 4] camera-to-world trajectory for path rendering.

    st / sr: spline smoothing factors for translation / rotation axes. The
    median prefilter is disabled for short (<30 frame) trajectories, exactly
    as the reference does.
    """
    c2w = np.array(poses, dtype=np.float32)
    n = len(c2w)
    prefilter = median_prefilter and n >= 30

    # mirror the x row during smoothing (the reference's axis convention)
    c2w[:, 0] *= -1.0

    # normalize translations so the spline smoothing factors are scale-free
    steps = np.linalg.norm(np.diff(c2w[:, :3, 3], axis=0), axis=-1)
    scale = _STEP_SCALE / np.median(steps)
    c2w[:, :3, 3] *= scale

    t = np.linspace(0.0, 1.0, n)
    trans = _smooth_channels(c2w[:, :, 3], t, st, prefilter)
    fwd = _smooth_channels(c2w[:, :, 2], t, sr, prefilter)
    up = _smooth_channels(c2w[:, :, 1], t, sr, prefilter)
    x, y, z = _orthonormal_frame(fwd, up)

    out = np.stack([x, y, z, trans], axis=-1)
    out[:, 0] *= -1.0
    out[:, :3, 3] /= scale
    return out.astype(np.float32)
