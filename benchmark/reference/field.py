"""TensoRF-VM field in plain f32 (the field module of a configuration with
no "field" key; the interface: reference/__init__.py): factor-grid lookups
by F.grid_sample, the density L1 regularizer and the field's operation and
byte counts. Beside it, what every field shares: the density activation,
the shading heads of TensoRF and LocalRF, the fp8 rounding and full_f32.

Parameters are a {name: tensor} dict with the published layout: for each
orientation i, `density_plane_i` / `app_plane_i` [C, H, W] and
`density_line_i` / `app_line_i` [C, D]; `basis_mat` [sum(app ranks),
app_dim]; the head's `mlp.w1` ... `mlp.b3` with weights [fan_in, fan_out].
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

# plane i spans axes PLANE_AXES[i] (x indexes its width, y its height); its
# line runs along LINE_AXIS[i] (TensoRF's matMode / vecMode)
PLANE_AXES = ((0, 1), (0, 2), (1, 2))
LINE_AXIS = (2, 1, 0)
DENSITY_SHIFT = -5.0
# operations of one linear interpolation (a lerp) in a lookup
LERP = 3
FP8_MAX = 448.0
FP8_GRAD_MAX = 57344.0


@contextlib.contextmanager
def full_f32():
    """f32 matmuls and convolutions in full f32 (no TF32) inside the block."""
    matmul, conv = torch.backends.cuda.matmul, torch.backends.cudnn
    if hasattr(matmul, "fp32_precision"):
        saved = matmul.fp32_precision, conv.conv.fp32_precision
        matmul.fp32_precision = conv.conv.fp32_precision = "ieee"
        try:
            yield
        finally:
            matmul.fp32_precision, conv.conv.fp32_precision = saved
    else:
        saved = matmul.allow_tf32, conv.allow_tf32
        matmul.allow_tf32 = conv.allow_tf32 = False
        try:
            yield
        finally:
            matmul.allow_tf32, conv.allow_tf32 = saved


class _Fp8(torch.autograd.Function):
    """x rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude maps to 448); the incoming gradient rounded to float8 e5m2
    (largest 57344) the same way: the formats of an fp8 training step."""

    @staticmethod
    def forward(ctx, x):
        return _scaled(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _scaled(g, torch.float8_e5m2, FP8_GRAD_MAX)


def _scaled(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


def rounder(precision: str):
    """Identity for "f32"; for "fp8", each tensor it is applied to in float8
    (forward e4m3, gradient e5m2, per-tensor scales)."""
    if precision == "f32":
        return lambda x: x
    if precision == "fp8":
        return _Fp8.apply
    raise ValueError(f"precision {precision!r}")


def plane_lookup(plane: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup (align_corners, border) of plane [C, H, W] at xy [P, 2] -> [P, C]."""
    out = F.grid_sample(plane[None], xy.reshape(1, -1, 1, 2), mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out[0, :, :, 0].t()


def line_lookup(line: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Linear lookup of line [C, D] at z [P] -> [P, C]: a [D, 1] image read at (0, z)."""
    grid = torch.stack([torch.zeros_like(z), z], dim=-1).reshape(1, -1, 1, 2)
    out = F.grid_sample(line[None, :, :, None], grid, mode="bilinear", padding_mode="border",
                        align_corners=True)
    return out[0, :, :, 0].t()


def weight_shapes(wd: dict, grid: int) -> tuple[dict, dict]:
    """({name: shape} of the factor tables, {name: shape} of the dense
    weights) of a field at grid^3, in the published layout."""
    factors = {}
    for kind in ("density", "app"):
        for i in range(3):
            factors[f"{kind}_plane_{i}"] = (wd[kind][i], grid, grid)
            factors[f"{kind}_line_{i}"] = (wd[kind][i], grid)
    return factors, {"basis_mat": (sum(wd["app"]), wd["app_dim"])}


def features(params: dict, pts: torch.Tensor, q) -> tuple[torch.Tensor, torch.Tensor]:
    """Density feature [P] and appearance feature [P, app_dim] at normalized
    points [P, 3] in [-1, 1]."""
    sigma = 0.0
    prods = []
    for i, (a, b) in enumerate(PLANE_AXES):
        xy = torch.stack([pts[:, a], pts[:, b]], dim=-1)
        z = pts[:, LINE_AXIS[i]]
        dens = plane_lookup(q(params[f"density_plane_{i}"]), xy) * line_lookup(q(params[f"density_line_{i}"]), z)
        sigma = sigma + dens.sum(dim=-1)
        prods.append(plane_lookup(q(params[f"app_plane_{i}"]), xy) * line_lookup(q(params[f"app_line_{i}"]), z))
    app = torch.cat(prods, dim=-1) @ q(params["basis_mat"])
    return sigma, app


def density(feat: torch.Tensor, act: str) -> torch.Tensor:
    """TensoRF's feature2density: softplus(feat - 5) or relu(feat)."""
    if act == "softplus":
        return F.softplus(feat + DENSITY_SHIFT)
    if act == "relu":
        return torch.relu(feat)
    raise ValueError(f"fea2denseAct {act!r}")


def positional_encoding(x: torch.Tensor, freqs: int) -> torch.Tensor:
    """TensoRF's encoding: [sin(x * 2^k), cos(x * 2^k)], k < freqs, per channel."""
    bands = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    y = (x[..., None] * bands).reshape(*x.shape[:-1], -1)
    return torch.cat([torch.sin(y), torch.cos(y)], dim=-1)


def shade(params: dict, feat: torch.Tensor, viewdirs: torch.Tensor, head: dict, q,
          refine: float = 1.0) -> torch.Tensor:
    """rgb [P, 3] of the shading head `head` ({"shading_mode", "fea_pe",
    "view_pe"}): LocalRF's MLP_Fea_late_view (features, and their encoding
    scaled by `refine`, through two hidden layers; view directions join
    before the last) or TensoRF's MLP_Fea (features, view directions and
    both encodings into the first layer)."""
    fea_pe, view_pe = head.get("fea_pe", 0), head.get("view_pe", 0)
    w = {k: q(params[f"mlp.{k}"]) for k in ("w1", "w2", "w3")}

    def layer(x, k):
        return q(x) @ w[f"w{k}"] + params[f"mlp.b{k}"]

    view = [viewdirs] + ([positional_encoding(viewdirs, view_pe)] if view_pe else [])
    mode = head["shading_mode"]
    if mode == "MLP_Fea_late_view":
        x = [feat] + ([positional_encoding(feat, fea_pe) * refine] if fea_pe else [])
        h = torch.relu(layer(torch.relu(layer(torch.cat(x, dim=-1), 1)), 2))
        return torch.sigmoid(layer(torch.cat([h] + view, dim=-1), 3))
    if mode == "MLP_Fea":
        x = [feat, viewdirs] + ([positional_encoding(feat, fea_pe)] if fea_pe else []) + view[1:]
        h = torch.relu(layer(torch.relu(layer(torch.cat(x, dim=-1), 1)), 2))
        return torch.sigmoid(layer(h, 3))
    raise NotImplementedError(f"shading mode {mode}")


def density_l1_grads(params: dict, act: str, rows_per_block: int = 16384) -> tuple[torch.Tensor, dict]:
    """LocalRF's L1 term, sum over the voxels of sqrt(max(density(f, act),
    1e-5)), where the feature f of voxel (p, d) of a cubic grid adds
    plane_i[:, p] . line_i[:, d] over the three orientations (each plane's
    outer product with its line flattened in its own (p, d) order, as the
    published code sums them), divided by the voxel count; with its
    gradients w.r.t. the density planes and lines. Evaluated in blocks of
    plane pixels."""
    planes = [params[f"density_plane_{i}"].detach() for i in range(3)]
    lines = [params[f"density_line_{i}"].detach() for i in range(3)]
    n_pix, n_d = planes[0][0].numel(), lines[0].shape[1]
    if any(p[0].numel() != n_pix for p in planes) or any(ln.shape[1] != n_d for ln in lines):
        raise NotImplementedError("density_l1_grads takes a cubic grid")
    flat = [p.reshape(p.shape[0], -1) for p in planes]
    n_vox = n_pix * n_d
    g_planes = [torch.zeros_like(f) for f in flat]
    g_lines = [torch.zeros_like(ln) for ln in lines]
    total = torch.zeros((), dtype=torch.float64, device=flat[0].device)
    for r0 in range(0, n_pix, rows_per_block):
        r1 = min(r0 + rows_per_block, n_pix)
        leaves = [f[:, r0:r1].clone().requires_grad_(True) for f in flat] + [
            ln.clone().requires_grad_(True) for ln in lines]
        feat = sum(leaves[i].t() @ leaves[3 + i] for i in range(3))
        s = torch.sqrt(torch.clamp(density(feat, act), min=1e-5)).sum()
        grads = torch.autograd.grad(s, leaves)
        for i in range(3):
            g_planes[i][:, r0:r1] += grads[i]
            g_lines[i] += grads[3 + i]
        total += s.detach().double()
    out = {f"density_plane_{i}": g_planes[i].reshape(planes[i].shape) / n_vox for i in range(3)}
    out.update({f"density_line_{i}": g_lines[i] / n_vox for i in range(3)})
    return (total / n_vox).float(), out


def lookup_ops(wd: dict) -> int:
    """Operations of the lookups at one sample point: per orientation and
    channel a plane (3 lerps) and a line (1 lerp) and their product, plus
    the density sum."""
    return sum((3 * LERP + LERP + 1) * (d + a) + d for d, a in zip(wd["density"], wd["app"]))


def l1_voxel_ops(wd: dict) -> int:
    """Operations of the L1 term at one voxel: 3 dot products of the density
    ranks, the activation and the root."""
    return 2 * sum(wd["density"]) + 6


def plane_sum_bytes(wd: dict, grid: int, rays: int, samples: int) -> int:
    """Bytes the step's three plane sums (K2) must move: each reads its
    bf16 payload [P, 4C] (a quad row of the density and appearance
    channels per point) and its int64 row ids [P] once, and writes the
    bf16 gradient table [grid^2, 4C] once; P = rays * samples."""
    p = rays * samples
    return sum(p * 4 * (d + a) * 2 + p * 8 + grid * grid * 4 * (d + a) * 2
               for d, a in zip(wd["density"], wd["app"]))
