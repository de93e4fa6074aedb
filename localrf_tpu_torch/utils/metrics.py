"""Evaluation metrics: PSNR and the mipnerf SSIM (the port's copy of
localrf_tpu/utils/metrics.py).

Images are [H, W, 3] tensors (or numpy arrays) in [0, 1]; the metrics are
computed in float32 on the image's device and returned as Python floats.
SSIM filters with a separable Gaussian (11 taps, sigma 1.5) in "valid"
mode, as two conv2d passes (the taps are symmetric, so the correlation
conv2d computes is the convolution JAX's scipy computes). LPIPS is not
ported: the repo holds no weights for it.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _image(x) -> torch.Tensor:
    return (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))).float()


def mse2psnr(mse: float) -> float:
    return float(-10.0 * math.log(mse) / math.log(10.0))


def rgb_psnr(img0, img1) -> float:
    img0, img1 = _image(img0), _image(img1)
    return mse2psnr(float(torch.mean((img0 - img1) ** 2)))


def _gaussian_taps(filter_size: int, filter_sigma: float) -> np.ndarray:
    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((np.arange(filter_size) - hw + shift) / filter_sigma) ** 2
    filt = np.exp(-0.5 * f_i)
    return (filt / np.sum(filt)).astype(np.float32)


def rgb_ssim(
    img0,
    img1,
    max_val: float,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    return_map: bool = False,
):
    img0, img1 = _image(img0), _image(img1)
    if img0.ndim != 3 or img0.shape[-1] != 3 or img0.shape != img1.shape:
        raise ValueError(f"rgb_ssim takes two [H, W, 3] images, got {tuple(img0.shape)}, {tuple(img1.shape)}")
    img1 = img1.to(img0.device)
    taps = torch.from_numpy(_gaussian_taps(filter_size, filter_sigma)).to(img0.device)
    a, b = img0.permute(2, 0, 1), img1.permute(2, 0, 1)  # [3, H, W]
    # the five filtered quantities of each channel in one batch: [15, 1, H, W]
    z = torch.cat([a, b, a * a, b * b, a * b])[:, None]
    z = F.conv2d(z, taps.view(1, 1, -1, 1))  # along rows
    z = F.conv2d(z, taps.view(1, 1, 1, -1))  # along columns
    mu0, mu1, e00, e11, e01 = z[:, 0].permute(1, 2, 0).split(3, dim=-1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = torch.clamp(e00 - mu00, min=0.0)
    sigma11 = torch.clamp(e11 - mu11, min=0.0)
    sigma01 = e01 - mu01
    sigma01 = torch.sign(sigma01) * torch.minimum(torch.sqrt(sigma00 * sigma11), torch.abs(sigma01))
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    ssim_map = numer / denom
    return ssim_map if return_map else float(torch.mean(ssim_map))
