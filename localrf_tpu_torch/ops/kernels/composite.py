"""K1: fused volume-compositing weights with an analytic backward.

CUDA kernels in csrc/composite.cu (forward and backward; see the note there
for what bounds them on the card), replacing the Pallas TPU kernel
localrf_tpu/ops/pallas/composite.py `fused_weights`. `fused_weights_plain`
is the same max-form scan in plain PyTorch (torch.cumprod, autograd
backward): the CPU path and the on-card reference.
"""
from __future__ import annotations

import torch

from . import _build

EPS = 1e-10
LAUNCHES = {"fused_weights_fwd": 0, "fused_weights_bwd": 0}


def fused_weights_plain(sigma: torch.Tensor, dists: torch.Tensor, scale: float) -> torch.Tensor:
    """w_i = a_i * prod_{j<i} max(1 - a_j, EPS), a = 1 - exp(-sigma*dists*scale),
    a_{S-1} = 1. No gradient flows to `dists`."""
    alpha = 1.0 - torch.exp(-sigma * dists.detach() * scale)
    alpha = torch.cat([alpha[:, :-1], torch.ones_like(alpha[:, -1:])], dim=-1)
    b = torch.clamp(1.0 - alpha, min=EPS)
    t = torch.cumprod(torch.cat([torch.ones_like(b[:, :1]), b[:, :-1]], dim=-1), dim=-1)
    return alpha * t


def _dist_stride(sigma: torch.Tensor, dists: torch.Tensor) -> int:
    r, s = sigma.shape
    if sigma.dtype != torch.float32 or dists.dtype != torch.float32:
        raise TypeError(f"fused_weights takes float32, got {sigma.dtype}, {dists.dtype}")
    if dists.device != sigma.device:
        raise ValueError("sigma and dists must be on the same device")
    if dists.shape == (1, s):
        return 0
    if dists.shape == (r, s):
        return s
    raise ValueError(f"dists must be [1, {s}] or [{r}, {s}], got {list(dists.shape)}")


def _launch_fwd(sigma, dists, scale: float) -> torch.Tensor:
    stride = _dist_stride(sigma, dists)
    w = torch.empty_like(sigma)
    r, s = sigma.shape
    if r:
        _build.launch(
            "lrf_composite_fwd", sigma.data_ptr(), dists.data_ptr(), w.data_ptr(),
            r, s, stride, float(scale), _build.stream_ptr(sigma.device),
        )
        LAUNCHES["fused_weights_fwd"] += 1
    return w


def _launch_bwd(sigma, dists, g, scale: float) -> torch.Tensor:
    stride = _dist_stride(sigma, dists)
    if g.shape != sigma.shape or g.dtype != torch.float32:
        raise ValueError(f"cotangent must be float32 {list(sigma.shape)}")
    dsigma = torch.empty_like(sigma)
    r, s = sigma.shape
    if r:
        _build.launch(
            "lrf_composite_bwd", sigma.data_ptr(), dists.data_ptr(), g.data_ptr(),
            dsigma.data_ptr(), r, s, stride, float(scale), _build.stream_ptr(sigma.device),
        )
        LAUNCHES["fused_weights_bwd"] += 1
    return dsigma


class _FusedWeights(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigma, dists, scale):
        sigma, dists = sigma.contiguous(), dists.contiguous()
        ctx.save_for_backward(sigma, dists)
        ctx.scale = scale
        with torch.cuda.device(sigma.device):
            return _launch_fwd(sigma, dists, scale)

    @staticmethod
    def backward(ctx, g):
        sigma, dists = ctx.saved_tensors
        with torch.cuda.device(sigma.device):
            dsigma = _launch_bwd(sigma, dists, g.contiguous(), ctx.scale)
        return dsigma, None, None


def fused_weights(sigma: torch.Tensor, dists: torch.Tensor, scale: float) -> torch.Tensor:
    """Compositing weights for [R, S] densities and [1 or R, S] dists.

    CPU tensors take `fused_weights_plain`; CUDA tensors launch the kernels."""
    if sigma.device.type == "cpu":
        return fused_weights_plain(sigma, dists, scale)
    if sigma.device.type != "cuda":
        raise ValueError(f"fused_weights: no kernel for device {sigma.device}")
    return _FusedWeights.apply(sigma, dists, scale)
