"""LPIPS perceptual distance, AlexNet backbone, v0.1 semantics (PyTorch
port of localrf_tpu/utils/lpips.py).

Inputs scaled to [-1, 1], whitened by LPIPS's fixed shift and scale, five
AlexNet conv taps (after each ReLU, 3x3/2 max-pools after the first two),
channel-unit-normalized, squared difference, a non-negative 1x1 weighting
per layer, spatial mean, sum over layers. The convolutions and pools are
PyTorch's own calls (the JAX package computes them with `lax.conv` outside
any Pallas kernel).

Weights: `load_torch_state` takes the official state dicts (torchvision
AlexNet `features.*` and lpips `lin*.model.1.weight`), `load_weights_file`
the combined .npz the JAX package reads (`weights/lpips_alex.npz`, or the
path in LOCALRF_TPU_LPIPS_WEIGHTS). Without a weights file the backbone is
He-initialized from a torch.Generator seeded 0: finite and usable as a
relative distance, but neither a published LPIPS number nor equal to the
JAX package's random backbone (a jax.random draw torch cannot repeat);
`has_pretrained()` says which is active.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

# (out_ch, in_ch, kernel, stride, pad) of the 5 AlexNet conv layers
_ALEX_CONVS = (
    (64, 3, 11, 4, 2),
    (192, 64, 5, 1, 2),
    (384, 192, 3, 1, 1),
    (256, 384, 3, 1, 1),
    (256, 256, 3, 1, 1),
)
# 3x3/stride-2 max-pool after relu1 and relu2
_POOL_AFTER = (0, 1)

# fixed input whitening of LPIPS's ScalingLayer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def init_params(seed: int = 0, device="cuda") -> dict:
    """Seeded He-initialized backbone and uniform lin weights (the fallback
    without a weights file)."""
    gen = torch.Generator().manual_seed(seed)
    params: dict = {"convs": [], "lins": []}
    for co, ci, ks, _, _ in _ALEX_CONVS:
        std = math.sqrt(2.0 / (ci * ks * ks))
        w = std * torch.randn((co, ci, ks, ks), generator=gen)
        params["convs"].append({"w": w.to(device), "b": torch.zeros((co,), device=device)})
        params["lins"].append(torch.full((co,), 1.0 / co, device=device))
    return params


def _tensor(x, device) -> torch.Tensor:
    t = x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, copy=True))
    return t.to(device=device, dtype=torch.float32)


def load_torch_state(alex_state: dict, lin_state: dict, device="cuda") -> dict:
    """The official checkpoints as params: alex_state is a torchvision
    AlexNet state dict (keys `features.{0,3,6,8,10}.{weight,bias}`),
    lin_state an lpips one (keys `lin{0..4}.model.1.weight`, [1, Co, 1, 1]);
    tensors or numpy arrays."""
    params: dict = {"convs": [], "lins": []}
    for li, fi in enumerate((0, 3, 6, 8, 10)):
        params["convs"].append({"w": _tensor(alex_state[f"features.{fi}.weight"], device),
                                "b": _tensor(alex_state[f"features.{fi}.bias"], device)})
        params["lins"].append(_tensor(lin_state[f"lin{li}.model.1.weight"], device).reshape(-1))
    return params


def load_weights_file(path: str, device="cuda") -> dict:
    """The combined .npz (`conv{i}_w`, `conv{i}_b`, `lin{i}`)."""
    data = np.load(path)
    return {
        "convs": [{"w": _tensor(data[f"conv{i}_w"], device), "b": _tensor(data[f"conv{i}_b"], device)}
                  for i in range(5)],
        "lins": [_tensor(data[f"lin{i}"], device) for i in range(5)],
    }


def _features(params: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """x: [N, 3, H, W] in [-1, 1] -> the 5 post-ReLU feature maps."""
    shift = torch.tensor(_SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=x.device).view(1, 3, 1, 1)
    x = (x - shift) / scale
    taps = []
    for li, ((_, _, _, stride, pad), conv) in enumerate(zip(_ALEX_CONVS, params["convs"])):
        x = F.relu(F.conv2d(x, conv["w"], conv["b"], stride=stride, padding=pad))
        taps.append(x)
        if li in _POOL_AFTER:
            x = F.max_pool2d(x, kernel_size=3, stride=2)
    return taps


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / (torch.sqrt(torch.sum(f**2, dim=1, keepdim=True)) + eps)


@torch.no_grad()
def lpips_nchw(params: dict, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """LPIPS distance [N] for batches [N, 3, H, W] already scaled to [-1, 1]."""
    total = x0.new_zeros(x0.shape[0])
    for t0, t1, lin in zip(_features(params, x0), _features(params, x1), params["lins"]):
        diff = (_unit_normalize(t0) - _unit_normalize(t1)) ** 2
        total = total + torch.einsum("nchw,c->nhw", diff, lin).mean(dim=(1, 2))
    return total


def _nchw(img, device) -> torch.Tensor:
    t = img if isinstance(img, torch.Tensor) else torch.from_numpy(np.asarray(img))
    return t.to(device=device, dtype=torch.float32).permute(2, 0, 1)[None]


def lpips(params: dict, img0, img1) -> float:
    """LPIPS between two [H, W, 3] images in [0, 1] (tensors or arrays; the
    normalize=True mode), on the params' device. Images under 32 px on a
    side are upscaled bilinearly first (half-pixel centres, as JAX's
    jax.image.resize): AlexNet downsamples ~32x."""
    device = params["lins"][0].device
    x0, x1 = _nchw(img0, device), _nchw(img1, device)
    h, w = x0.shape[2:]
    if min(h, w) < 32:
        scale = 32.0 / min(h, w)
        size = (int(round(h * scale)), int(round(w * scale)))
        x0, x1 = (F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=False)
                  for x in (x0, x1))
    return float(lpips_nchw(params, x0 * 2.0 - 1.0, x1 * 2.0 - 1.0)[0])


WEIGHTS_ENV = "LOCALRF_TPU_LPIPS_WEIGHTS"
_DEFAULT_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "weights", "lpips_alex.npz")
# device -> params; "pretrained" -> whether a weights file was found
_CACHED: dict = {}


def _weights_path() -> str | None:
    path = os.environ.get(WEIGHTS_ENV) or os.path.abspath(_DEFAULT_PATH)
    return path if os.path.exists(path) else None


def get_params(device="cuda") -> dict:
    """Pretrained params if a weights file exists, else the seeded
    fallback; made once per device."""
    key = str(torch.device(device))
    if key not in _CACHED:
        path = _weights_path()
        _CACHED[key] = load_weights_file(path, device) if path else init_params(0, device)
        _CACHED["pretrained"] = path is not None
    return _CACHED[key]


def has_pretrained() -> bool:
    if "pretrained" not in _CACHED:
        _CACHED["pretrained"] = _weights_path() is not None
    return bool(_CACHED["pretrained"])
