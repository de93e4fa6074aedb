"""RAFT optical flow in PyTorch (the port of localrf_tpu/preprocess/raft.py).

RAFT (Teed & Deng, ECCV'20) as the reference's flow preprocessing runs it:
feature and context encoders, the all-pairs 4-level correlation pyramid,
the separable ConvGRU update iterations, convex upsampling. An `nn.Module`
in NCHW whose parameter names are the official `raft-things.pth` names
(after its DataParallel "module." prefix), so `preprocess/convert.py`
loads that file with `load_state_dict(strict=True)` and no remap. The
convolutions are `F.conv2d` and the correlation a `torch.matmul`, as JAX
runs them with `lax.conv` and an einsum outside any Pallas kernel; on the
card they run in full f32 (`ops/math.py::full_f32`), since thirty GRU
iterations amplify TF32's rounding.

The arithmetic follows JAX's, step for step: images scaled by 1/127.5 - 1,
instance norm with the biased variance (eps 1e-5), batch norm from running
statistics (eps 1e-5), taps sampled by an explicit four-corner gather (each
corner out of the map is zero on its own) with the x offset slowest over
the (2r+1)^2 taps, convex upsampling over the 3x3 neighbourhood (dy outer,
dx inner) with the mask channel k*64 + u*8 + v.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.math import full_f32

HDIM = 128  # GRU hidden
CDIM = 128  # context
CORR_LEVELS = 4
CORR_RADIUS = 4


def _conv(cin: int, cout: int, k, stride: int = 1) -> nn.Conv2d:
    """torch pads (k // 2) on both sides, as JAX's conv2d does explicitly
    (XLA's "SAME" would pad a strided conv asymmetrically)."""
    kh, kw = (k, k) if isinstance(k, int) else k
    return nn.Conv2d(cin, cout, (kh, kw), stride=stride, padding=(kh // 2, kw // 2))


# ----------------------------- encoder -----------------------------


class ResidualBlock(nn.Module):
    """Two 3x3 convs with a norm after each; a strided block's shortcut is
    a 1x1 conv (`downsample.0`) then `norm3`. The official module also
    lists norm3 as `downsample.1`; here it is kept once, as the official
    key listing has it (tests/raft_things_manifest.py)."""

    def __init__(self, cin: int, cout: int, norm: str, stride: int):
        super().__init__()
        self.norm = norm
        self.conv1 = _conv(cin, cout, 3, stride)
        self.conv2 = _conv(cout, cout, 3)
        if norm == "batch":
            self.norm1, self.norm2 = nn.BatchNorm2d(cout), nn.BatchNorm2d(cout)
            if stride != 1:
                self.norm3 = nn.BatchNorm2d(cout)
        self.downsample = nn.Sequential(_conv(cin, cout, 1, stride)) if stride != 1 else None

    def _norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.instance_norm(x, eps=1e-5) if self.norm == "instance" else getattr(self, name)(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self._norm("norm1", self.conv1(x)))
        y = F.relu(self._norm("norm2", self.conv2(y)))
        if self.downsample is not None:
            x = self._norm("norm3", self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """7x7/2 stem, 3 residual stages (64, 96/2, 128/2), 1x1 out to 256.
    Input [N, 3, H, W] in [-1, 1]; output at 1/8 resolution."""

    def __init__(self, norm: str):
        super().__init__()
        if norm not in ("instance", "batch"):
            raise ValueError(norm)
        self.norm = norm
        self.conv1 = _conv(3, 64, 7, 2)
        if norm == "batch":
            self.norm1 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, norm, 1), ResidualBlock(64, 64, norm, 1))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, norm, 2), ResidualBlock(96, 96, norm, 1))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, norm, 2), ResidualBlock(128, 128, norm, 1))
        self.conv2 = _conv(128, 256, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        x = F.instance_norm(x, eps=1e-5) if self.norm == "instance" else self.norm1(x)
        x = self.layer3(self.layer2(self.layer1(F.relu(x))))
        return self.conv2(x)


# ----------------------------- correlation -----------------------------


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor) -> list[torch.Tensor]:
    """All-pairs correlation / sqrt(D), then 3 average poolings over the
    target dims (2x2, stride 2, odd sizes floored).

    fmap1/2: [B, D, H, W] -> list of [B*H*W, 1, H/2^l, W/2^l] volumes."""
    b, d, h, w = fmap1.shape
    corr = torch.matmul(fmap1.reshape(b, d, h * w).transpose(1, 2), fmap2.reshape(b, d, h * w))
    corr = (corr / math.sqrt(d)).reshape(b * h * w, 1, h, w)
    pyramid = [corr]
    for _ in range(CORR_LEVELS - 1):
        # a level under 2 pixels pools to an empty one, as JAX's "VALID"
        # window does (tiny images); its taps read zero
        empty = min(corr.shape[2:]) < 2
        corr = corr[:, :, :0, :0] if empty else F.avg_pool2d(corr, 2, stride=2)
        pyramid.append(corr)
    return pyramid


def _bilinear_taps(img: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """img [N, h, w]; pts [N, K, 2] as (x, y) pixel coords -> [N, K]. Each
    of the four corners reads zero where it falls off the map."""
    n, h, w = img.shape
    if h * w == 0:
        return pts.new_zeros(pts.shape[:2])
    x, y = pts[..., 0], pts[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    flat = img.reshape(n, h * w)

    def tap(xi, yi):
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        return torch.where(inb, torch.gather(flat, 1, idx), 0.0)

    top = tap(x0, y0) * (1 - wx) + tap(x0 + 1, y0) * wx
    bot = tap(x0, y0 + 1) * (1 - wx) + tap(x0 + 1, y0 + 1) * wx
    return top * (1 - wy) + bot * wy


def corr_lookup(pyramid: list[torch.Tensor], coords: torch.Tensor) -> torch.Tensor:
    """(2r+1)^2 taps around `coords` at each pyramid level.

    coords: [B, 2, H, W] (x, y) target coords at level 0.
    Returns [B, CORR_LEVELS * (2r+1)^2, H, W], level-major."""
    b, _, h, w = coords.shape
    # (x, y) offsets, the x offset slowest: the official convc1 weights are
    # per tap, so a transposed order runs but gives a wrong flow
    d = torch.arange(-CORR_RADIUS, CORR_RADIUS + 1, dtype=torch.float32, device=coords.device)
    dd = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1).reshape(-1, 2)
    c = coords.permute(0, 2, 3, 1).reshape(b * h * w, 1, 2)
    out = [_bilinear_taps(corr[:, 0], c / (2.0**lvl) + dd[None]) for lvl, corr in enumerate(pyramid)]
    return torch.cat(out, dim=-1).reshape(b, h, w, -1).permute(0, 3, 1, 2)


# ----------------------------- update block -----------------------------


class MotionEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        cor_planes = CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2
        self.convc1 = _conv(cor_planes, 256, 1)
        self.convc2 = _conv(256, 192, 3)
        self.convf1 = _conv(2, 128, 7)
        self.convf2 = _conv(128, 64, 3)
        self.conv = _conv(192 + 64, 128 - 2, 3)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        m = F.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([m, flow], dim=1)


class SepConvGRU(nn.Module):
    """A ConvGRU over 1x5 convs, then one over 5x1 convs."""

    def __init__(self, hidden: int = HDIM, inputs: int = CDIM + 128):
        super().__init__()
        for i, k in (("1", (1, 5)), ("2", (5, 1))):
            for g in ("z", "r", "q"):
                setattr(self, f"conv{g}{i}", _conv(hidden + inputs, hidden, k))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for i in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{i}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{i}")(hx))
            q = torch.tanh(getattr(self, f"convq{i}")(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = _conv(HDIM, 256, 3)
        self.conv2 = _conv(256, 2, 3)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(h)))


class UpdateBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = MotionEncoder()
        self.gru = SepConvGRU()
        self.flow_head = FlowHead()
        self.mask = nn.Sequential(_conv(HDIM, 256, 3), nn.ReLU(), _conv(256, 64 * 9, 1))


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """8x convex upsampling: per fine pixel a softmax over the 3x3 coarse
    neighbourhood of 8 * flow. flow [N, 2, H, W], mask [N, 576, H, W] (the
    channel k*64 + u*8 + v) -> [N, 2, 8H, 8W]."""
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
    neigh = F.unfold(8.0 * flow, (3, 3), padding=1).view(n, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * neigh, dim=2)  # [N, 2, 8, 8, H, W]
    return up.permute(0, 1, 4, 2, 5, 3).reshape(n, 2, 8 * h, 8 * w)


# ----------------------------- full model -----------------------------


class RAFT(nn.Module):
    """The official RAFT (not the small variant). Inference only: the batch
    norms use their running statistics (the module is built in eval mode)."""

    def __init__(self):
        super().__init__()
        self.fnet = BasicEncoder("instance")
        self.cnet = BasicEncoder("batch")
        self.update_block = UpdateBlock()
        self.eval()

    @torch.no_grad()
    @full_f32()
    def forward(self, image1: torch.Tensor, image2: torch.Tensor, iters: int = 30) -> torch.Tensor:
        """image1/2: [B, 3, H, W] in [0, 255], H and W multiples of 8.
        Returns the flow from image1 to image2, [B, 2, H, W] in pixels."""
        fmap1 = self.fnet(image1 / 127.5 - 1.0)
        fmap2 = self.fnet(image2 / 127.5 - 1.0)
        pyramid = build_corr_pyramid(fmap1, fmap2)

        cmap = self.cnet(image1 / 127.5 - 1.0)
        net, inp = torch.tanh(cmap[:, :HDIM]), F.relu(cmap[:, HDIM:])

        b, _, h, w = fmap1.shape
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=fmap1.device),
                                torch.arange(w, dtype=torch.float32, device=fmap1.device), indexing="ij")
        coords0 = torch.stack([xs, ys])[None].expand(b, 2, h, w)
        flow = torch.zeros_like(coords0)
        ub = self.update_block
        for _ in range(iters):
            corr = corr_lookup(pyramid, coords0 + flow)
            net = ub.gru(net, torch.cat([inp, ub.encoder(flow, corr)], dim=1))
            flow = flow + ub.flow_head(net)
        return convex_upsample(flow, 0.25 * ub.mask(net))


def init_raft(generator: torch.Generator | None = None, device="cuda") -> RAFT:
    """Random-weight RAFT, as the JAX package's init_raft draws it: conv
    weights normal / sqrt(fan in), zero biases, identity batch norms.
    `generator` is a CPU generator."""
    model = RAFT()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) / math.sqrt(m.weight[0].numel()))
                m.bias.zero_()
    return model.to(device)


class InputPadder:
    """Pad [N, C, H, W] images to multiples of 8 (edge values, as JAX's
    `edge`), and crop flows back."""

    def __init__(self, shape):
        h, w = shape[-2], shape[-1]
        self.pad_h = (8 - h % 8) % 8
        self.pad_w = (8 - w % 8) % 8

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        ph, pw = self.pad_h, self.pad_w
        return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2), mode="replicate")

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        h0, w0 = self.pad_h // 2, self.pad_w // 2
        return x[..., h0:x.shape[-2] - (self.pad_h - h0), w0:x.shape[-1] - (self.pad_w - w0)]
