"""DPT monocular depth in PyTorch (the port of localrf_tpu/preprocess/dpt.py).

DPT (Ranftl et al., ICCV'21) as the Hugging Face `DPTForDepthEstimation`
graph computes it for a plain ViT backbone: the ViT with hooks, the
readout-projected reassemble stage, the RefineNet-style fusion and the
3-conv depth head. An `nn.Module` whose parameter names are Hugging Face's,
so the official Intel/dpt-large state dict loads with
`load_state_dict(strict=True)`. `dpt.layernorm` (the ViT's final norm) is
kept for those names; the depth head never reads it.

Where the JAX package and Hugging Face differ, the port follows JAX:
- bilinear resizes with half-pixel centres (the position-embedding grid,
  a fusion lateral of another size) are `jax.image.resize`, which
  antialiases when it shrinks: `F.interpolate(..., antialias=True)` here
  (Hugging Face does not antialias; at an input of `image_size`, the
  default, the position grid is not resized at all);
- the x2 resizes with aligned corners go through the port's
  `ops/grid.py::resize_align_corners_2d`, as JAX's go through its own.
GELU is exact and attention is a plain q k^T / sqrt(d), softmax, @ v in
f32, as JAX's `_attention` computes it; on the card every conv and matmul
runs in full f32 (`ops/math.py::full_f32`), and the convolutions run
without cuDNN (PyTorch's im2col and a cuBLAS product): in full f32, cuDNN
9.2 on an H100 runs the head's 3x3 conv of 256 -> 128 channels at
192x192 (DPT-Large at 384) in ~200 ms with a 16 GiB workspace, where
im2col and cuBLAS take 0.8 ms and 0.33 GiB (`scripts/preprocess_f32.py`
times both).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.grid import resize_align_corners_2d
from ..ops.math import full_f32


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    patch_size: int = 16
    image_size: int = 384  # pos-embed native grid
    out_indices: tuple[int, ...] = (2, 5, 8, 11)
    neck_hidden_sizes: tuple[int, ...] = (96, 192, 384, 768)
    reassemble_factors: tuple[float, ...] = (4, 2, 1, 0.5)
    fusion_hidden_size: int = 256
    layer_norm_eps: float = 1e-12

    @classmethod
    def large(cls) -> "DPTConfig":
        """DPT-Large (Intel/dpt-large): 24 layers of width 1024."""
        return cls(
            hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096,
            out_indices=(5, 11, 17, 23), neck_hidden_sizes=(256, 512, 1024, 1024),
        )

    @classmethod
    def from_hf(cls, c) -> "DPTConfig":
        """From a `transformers.DPTConfig`."""
        return cls(
            hidden_size=c.hidden_size, num_layers=c.num_hidden_layers, num_heads=c.num_attention_heads,
            intermediate_size=c.intermediate_size, patch_size=c.patch_size, image_size=c.image_size,
            out_indices=tuple(c.backbone_out_indices), neck_hidden_sizes=tuple(c.neck_hidden_sizes),
            reassemble_factors=tuple(c.reassemble_factors), fusion_hidden_size=c.fusion_hidden_size,
            layer_norm_eps=c.layer_norm_eps,
        )


def _ns(**children) -> nn.Module:
    """A bare module holding `children` under their names (Hugging Face's
    nesting, for the state dict's keys)."""
    m = nn.Module()
    for k, v in children.items():
        setattr(m, k, v)
    return m


def _vit_layer(cfg: DPTConfig) -> nn.Module:
    d, eps = cfg.hidden_size, cfg.layer_norm_eps
    return _ns(
        attention=_ns(attention=_ns(query=nn.Linear(d, d), key=nn.Linear(d, d), value=nn.Linear(d, d)),
                      output=_ns(dense=nn.Linear(d, d))),
        intermediate=_ns(dense=nn.Linear(d, cfg.intermediate_size)),
        output=_ns(dense=nn.Linear(cfg.intermediate_size, d)),
        layernorm_before=nn.LayerNorm(d, eps=eps), layernorm_after=nn.LayerNorm(d, eps=eps),
    )


def _reassemble_layer(d: int, c: int, factor: float) -> nn.Module:
    if factor > 1:
        resize = nn.ConvTranspose2d(c, c, int(factor), stride=int(factor))
    elif factor < 1:
        resize = nn.Conv2d(c, c, 3, stride=int(1 / factor), padding=1)
    else:
        resize = None
    return _ns(projection=nn.Conv2d(d, c, 1), resize=resize)


def _residual_unit(f: int) -> nn.Module:
    return _ns(convolution1=nn.Conv2d(f, f, 3, padding=1), convolution2=nn.Conv2d(f, f, 3, padding=1))


@contextlib.contextmanager
def _without_cudnn():
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = saved


def _resize_half_pixel(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """jax.image.resize(..., "bilinear"): half-pixel centres, antialiased
    when shrinking. x: [B, C, H, W]."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=True)


def _resize_x2_aligned(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear with align_corners=True, per image. x: [B, C, H, W]."""
    return torch.stack([resize_align_corners_2d(img, 2 * x.shape[2], 2 * x.shape[3]) for img in x])


class DPT(nn.Module):
    """DPTForDepthEstimation for a plain ViT backbone (not DPT-Hybrid).
    Inference only."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.hidden_size, cfg.fusion_hidden_size
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        emb = _ns(patch_embeddings=_ns(projection=nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size)))
        emb.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        emb.position_embeddings = nn.Parameter(torch.zeros(1, n_pos, d))
        self.dpt = _ns(
            embeddings=emb,
            encoder=_ns(layer=nn.ModuleList(_vit_layer(cfg) for _ in range(cfg.num_layers))),
            layernorm=nn.LayerNorm(d, eps=cfg.layer_norm_eps),
        )
        sizes, factors = cfg.neck_hidden_sizes, cfg.reassemble_factors
        self.neck = _ns(
            reassemble_stage=_ns(
                readout_projects=nn.ModuleList(nn.Sequential(nn.Linear(2 * d, d), nn.GELU()) for _ in factors),
                layers=nn.ModuleList(_reassemble_layer(d, c, k) for c, k in zip(sizes, factors)),
            ),
            convs=nn.ModuleList(nn.Conv2d(c, f, 3, padding=1, bias=False) for c in sizes),
            fusion_stage=_ns(layers=nn.ModuleList(
                _ns(projection=nn.Conv2d(f, f, 1), residual_layer1=_residual_unit(f),
                    residual_layer2=_residual_unit(f))
                for _ in sizes)),
        )
        # Hugging Face's head: conv, x2 upsample, conv, ReLU, conv, ReLU
        self.head = _ns(head=nn.Sequential(
            nn.Conv2d(f, f // 2, 3, padding=1), nn.Identity(), nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1), nn.ReLU()))
        self.eval()

    def _attention(self, p: nn.Module, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        heads = self.cfg.num_heads
        dh = d // heads

        def proj(lin):
            return lin(x).reshape(b, n, heads, dh).transpose(1, 2)

        a = p.attention
        att = torch.softmax(proj(a.query) @ proj(a.key).transpose(2, 3) / math.sqrt(dh), dim=-1)
        return p.output.dense((att @ proj(a.value)).transpose(1, 2).reshape(b, n, d))

    def _backbone(self, pixels: torch.Tensor) -> tuple[list[torch.Tensor], tuple[int, int]]:
        cfg, emb = self.cfg, self.dpt.embeddings
        b, _, h, w = pixels.shape
        ph, pw = h // cfg.patch_size, w // cfg.patch_size
        x = emb.patch_embeddings.projection(pixels).flatten(2).transpose(1, 2)  # [B, N, D]

        # the position grid resized to this input's grid
        pos = emb.position_embeddings
        g0 = int(round(math.sqrt(pos.shape[1] - 1)))
        grid = pos[:, 1:].reshape(1, g0, g0, -1).permute(0, 3, 1, 2)
        grid = _resize_half_pixel(grid, ph, pw).permute(0, 2, 3, 1).reshape(1, ph * pw, -1)
        pos = torch.cat([pos[:, :1], grid], dim=1)
        x = torch.cat([emb.cls_token.expand(b, 1, -1), x], dim=1) + pos

        hooks = []
        for i, layer in enumerate(self.dpt.encoder.layer):
            x = x + self._attention(layer.attention, layer.layernorm_before(x))
            h1 = F.gelu(layer.intermediate.dense(layer.layernorm_after(x)), approximate="none")
            x = x + layer.output.dense(h1)
            if i in cfg.out_indices:
                hooks.append(x)
        return hooks, (ph, pw)

    def _reassemble(self, hooks: list[torch.Tensor], grid: tuple[int, int]) -> list[torch.Tensor]:
        stage = self.neck.reassemble_stage
        out = []
        for i, tokens in enumerate(hooks):
            cls, feat = tokens[:, :1], tokens[:, 1:]
            # readout "project": the cls token beside every token, linear + gelu
            feat = stage.readout_projects[i](torch.cat([feat, cls.expand_as(feat)], dim=-1))
            feat = feat.transpose(1, 2).reshape(feat.shape[0], -1, *grid)
            layer = stage.layers[i]
            feat = layer.projection(feat)
            out.append(feat if layer.resize is None else layer.resize(feat))
        return out

    @staticmethod
    def _residual(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return x + p.convolution2(F.relu(p.convolution1(F.relu(x))))

    @torch.no_grad()
    @full_f32()
    @_without_cudnn()
    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels: [B, 3, H, W], normalized to [-1, 1]; H, W multiples of 32.
        Returns inverse depth [B, H, W] (four fusion x2 upsamples from H/32
        and the head's x2 restore the input resolution)."""
        hooks, grid = self._backbone(pixels)
        feats = [conv(f) for conv, f in zip(self.neck.convs, self._reassemble(hooks, grid))]
        fused = None
        for p, lateral in zip(self.neck.fusion_stage.layers, feats[::-1]):  # deepest first
            if fused is None:
                fused = lateral
            else:
                if fused.shape[2:] != lateral.shape[2:]:
                    lateral = _resize_half_pixel(lateral, *fused.shape[2:])
                fused = fused + self._residual(p.residual_layer1, lateral)
            fused = p.projection(_resize_x2_aligned(self._residual(p.residual_layer2, fused)))
        head = self.head.head
        x = _resize_x2_aligned(head[0](fused))
        x = F.relu(head[4](F.relu(head[2](x))))
        return x[:, 0]


def init_dpt(cfg: DPTConfig, generator: torch.Generator | None = None, device="cuda") -> DPT:
    """Random-weight DPT: every weight and embedding normal / sqrt(its fan
    in), zero biases, unit layer norms. `generator` is a CPU generator."""
    model = DPT(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim > 1:
                p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(p[0].numel()))
            elif name.endswith("bias"):
                p.zero_()
    return model.to(device)


def load_dpt_checkpoint(model_dir_or_sd, cfg: DPTConfig | None = None, device="cuda") -> DPT:
    """DPT on `device` from a Hugging Face state dict (`cfg` its config,
    DPT-Large by default) or from a local Hugging Face snapshot directory
    (e.g. weights/dpt-large; read by `transformers`, imported only then,
    with the config from the snapshot)."""
    if isinstance(model_dir_or_sd, dict):
        sd, cfg = model_dir_or_sd, cfg or DPTConfig.large()
    else:
        from transformers import DPTForDepthEstimation

        hf = DPTForDepthEstimation.from_pretrained(model_dir_or_sd)
        sd, cfg = hf.state_dict(), DPTConfig.from_hf(hf.config)
    model = DPT(cfg)
    model.load_state_dict(sd, strict=True)
    return model.to(device)
