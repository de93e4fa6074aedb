"""TensoRF-VM and TensoRF-CP factored radiance fields (the VM field is
the PyTorch port of localrf_tpu/models/tensorf.py).

The field is an `nn.Module` whose parameters carry the JAX dict keys
(`density_plane_{i}`, `density_line_{i}`, `app_plane_{i}`, `app_line_{i}`,
`basis_mat`, and `mlp.w1` ... `mlp.b3` with weights stored [fan_in,
fan_out] as in JAX); `field["mlp"]["w1"]` indexes it like the JAX pytree,
so the functions below take either. Coarse-to-fine upsampling returns a new
field.

Density: 3 planes [8, H, W] + 3 lines [8, D]; appearance: 3x [24, ., .]
planes + lines; feature = sum over planes of plane*line products;
appearance products feed a 72->27 basis matmul. matMode=[[0,1],[0,2],[1,2]],
vecMode=[2,1,0].

`TensorfConfig.decomposition="cp"` selects TensoRF's TensorCP instead: no
planes, and each of the R_sigma density and R_app appearance components is
the product of three lines (`density_line_{i}` [R_sigma, D],
`app_line_{i}` [R_app, D], the ranks given as 1-tuples), so feature =
line_0[x_2] * line_1[x_1] * line_2[x_0] per component; density sums the
first R_sigma products, the other R_app feed the basis.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.grid import (
    build_quad_line,
    build_quad_plane,
    grid_sample_1d,
    grid_sample_2d,
    grid_sample_3d,
    plane_coords,
    quad_sample_1d,
    quad_sample_2d,
    resize_align_corners_1d,
    resize_align_corners_2d,
)
from ..ops.kernels import density_l1 as l1_kernel
from ..ops.math import positional_encoding, tv_loss
from ..utils import profiling

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the shading heads of the JAX package (apply_mlp); RGB needs app_dim 3
SHADING_MODES = ("MLP_Fea_late_view", "MLP_Fea", "MLP_Fea_woView", "MLP_PE", "MLP", "RGB")
# field decompositions: TensoRF-VM (planes and lines) and TensoRF-CP (lines only)
DECOMPOSITIONS = ("vm", "cp")


@dataclasses.dataclass(frozen=True)
class TensorfConfig:
    """Static field configuration; the same fields as the JAX TensorfConfig
    (see there for what each does), plus `l1_stream_min_vox` and
    `decomposition`. The three `fused_*_gather` flags (XLA's gather
    workarounds, not ported) must stay at their defaults. One default
    differs from JAX's: `fused_march` is on, since on the card the fused
    march core does the feature and shading work of the unfused path in
    one kernel a direction; JAX's False still loads from its checkpoints."""

    grid_size: tuple[int, int, int]
    density_n_comp: tuple[int, int, int] = (8, 8, 8)
    app_n_comp: tuple[int, int, int] = (24, 24, 24)
    app_dim: int = 27
    feature_c: int = 128
    density_shift: float = -5.0
    distance_scale: float = 25.0
    ray_march_weight_thres: float = 1e-4
    alpha_mask_thres: float = 1e-4
    app_top_k: int = 0
    fast_gather: bool = True
    gather_dtype: str = "float32"
    mlp_dtype: str = "float32"
    # hand-written compositing kernel (ops/kernels/composite.py)
    pallas_composite: bool = False
    # line-gather backward: "onehot" (f32 index_add_), "segsum" (the K3
    # kernel, ops/kernels/segsum.py) or "gather" (autograd's scatter)
    line_bwd: str = "onehot"
    matmul_segsum: bool = False
    # plane-table backward through the segment-sum kernel
    # (ops/kernels/binned_scatter.py) for tables of >= binned_min_rows rows
    binned_scatter: bool = True
    binned_min_rows: int = 2000
    fused_plane_gather: bool = False
    fused_fwd_gather: int = 0
    fused_line_gather: bool = False
    occ_m: int = 0
    occ_probe_ds: int = 4
    occ_refine: bool = True
    # the fused march core, K4 (ops/kernels/march.py), where
    # fused_march_supported(cfg); the unfused path otherwise. On by default
    # (JAX's default is off): every field that fits the kernel takes it
    fused_march: bool = True
    step_ratio: float = 0.5
    n_samples_cap: int = int(1e6)
    fea2dense_act: str = "softplus"
    shading_mode: str = "MLP_Fea_late_view"
    pos_pe: int = 0
    view_pe: int = 0
    fea_pe: int = 0
    aabb_lo: tuple[float, float, float] = (-2.0, -2.0, -2.0)
    aabb_hi: tuple[float, float, float] = (2.0, 2.0, 2.0)
    # density_l1 evaluates the voxel grid in checkpointed blocks at and above
    # this many voxels (the JAX package reads LOCALRF_L1_STREAM* env vars)
    l1_stream_min_vox: int = 4 * 2**20
    # "vm" (three planes and three lines a kind) or "cp" (three lines a kind;
    # density_n_comp and app_n_comp are 1-tuples)
    decomposition: str = "vm"

    def __post_init__(self):
        # the XLA gather-emitter workarounds are not ported (ROADMAP.md)
        unported = {
            "fused_plane_gather": (self.fused_plane_gather, False),
            "fused_fwd_gather": (self.fused_fwd_gather, 0),
            "fused_line_gather": (self.fused_line_gather, False),
        }
        for name, (value, default) in unported.items():
            if value != default:
                raise NotImplementedError(
                    f"TensorfConfig.{name}={value!r}: only {default!r} is ported"
                )
        if self.shading_mode not in SHADING_MODES:
            raise ValueError(f"unknown shading mode {self.shading_mode}")
        if self.line_bwd not in ("gather", "segsum", "onehot"):
            raise ValueError(f"TensorfConfig.line_bwd={self.line_bwd!r}")
        if self.decomposition not in DECOMPOSITIONS:
            raise ValueError(f"TensorfConfig.decomposition={self.decomposition!r}")
        if self.is_cp and (len(self.density_n_comp) != 1 or len(self.app_n_comp) != 1):
            raise ValueError(
                "a CP field takes one rank a kind (n_lamb_sigma [R], n_lamb_sh [R]), got "
                f"{list(self.density_n_comp)} and {list(self.app_n_comp)}")

    @property
    def is_cp(self) -> bool:
        """Whether the field is line-only (TensoRF-CP)."""
        return self.decomposition == "cp"

    @property
    def line_mode(self) -> str:
        """Effective line-gather backward mode (the legacy flag wins)."""
        return "segsum" if self.matmul_segsum else self.line_bwd

    @property
    def aabb(self) -> np.ndarray:
        return np.array([self.aabb_lo, self.aabb_hi], dtype=np.float32)

    @property
    def aabb_size(self) -> np.ndarray:
        return self.aabb[1] - self.aabb[0]

    @property
    def units(self) -> np.ndarray:
        return self.aabb_size / (np.array(self.grid_size) - 1)

    @property
    def step_size(self) -> float:
        return float(np.mean(self.units) * self.step_ratio)

    @property
    def n_samples(self) -> int:
        aabb_diag = float(np.linalg.norm(self.aabb_size))
        return min(int(self.n_samples_cap), int(aabb_diag / self.step_size) + 1)

    def with_grid(self, grid_size) -> "TensorfConfig":
        return dataclasses.replace(self, grid_size=tuple(int(g) for g in grid_size))


class ParamDict(nn.Module):
    """Parameters registered under given names, readable as `module[name]`."""

    def __init__(self, tensors: dict[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))

    def __getitem__(self, name: str):
        return getattr(self, name)


class TensorfField(ParamDict):
    """Factor grids + basis matrix as parameters, the shading MLP as the
    `mlp` submodule; built from a flat {name: tensor} dict whose MLP entries
    are named `mlp.<key>` (the names `named_parameters()` returns)."""

    def __init__(self, tensors: dict[str, torch.Tensor]):
        super().__init__({k: v for k, v in tensors.items() if not k.startswith("mlp.")})
        self.mlp = ParamDict({k[4:]: v for k, v in tensors.items() if k.startswith("mlp.")})


def _uniform(shape, bound: float, generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return u * (2.0 * bound) - bound


def init_mlp(cfg: TensorfConfig, generator: torch.Generator, device) -> dict[str, torch.Tensor]:
    """The shading head's parameters for cfg.shading_mode (SHADING_MODES);
    torch.nn.Linear-style init, last bias zero. RGB has none. Layer 1 takes
    JAX's inputs of the mode: MLP_Fea_late_view feat(+PE), then viewdirs
    (+PE) join before the last layer; MLP_Fea feat, viewdirs (+ their PE);
    MLP_Fea_woView feat(+PE); MLP_PE feat, viewdirs, PE(pts), PE(viewdirs)
    (sized to those inputs, as JAX sizes it); MLP feat, viewdirs(+PE)."""
    mode, fea = cfg.shading_mode, cfg.app_dim
    if mode == "RGB":
        return {}
    in_view = 0
    if mode == "MLP_Fea_late_view":
        in_mlp = 2 * cfg.fea_pe * fea + fea
        in_view = 2 * cfg.view_pe * 3 + 3
    elif mode == "MLP_Fea":
        in_mlp = 2 * cfg.view_pe * 3 + 2 * cfg.fea_pe * fea + 3 + fea
    elif mode == "MLP_Fea_woView":
        in_mlp = 2 * cfg.fea_pe * fea + fea
    elif mode == "MLP_PE":
        in_mlp = fea + 3 + 2 * cfg.pos_pe * 3 + 2 * cfg.view_pe * 3
    else:  # "MLP"
        in_mlp = fea + 3 + 2 * cfg.view_pe * 3
    out = {}
    for name, fan_in, fan_out in (
        ("1", in_mlp, cfg.feature_c),
        ("2", cfg.feature_c, cfg.feature_c),
        ("3", cfg.feature_c + in_view, 3),
    ):
        bound = 1.0 / math.sqrt(fan_in)
        out[f"mlp.w{name}"] = _uniform((fan_in, fan_out), bound, generator, device)
        out[f"mlp.b{name}"] = _uniform((fan_out,), bound, generator, device)
    out["mlp.b3"] = torch.zeros_like(out["mlp.b3"])
    return out


def factor_names(cfg: TensorfConfig, kind: str) -> list[str]:
    """The factor tables of one kind ("density" or "app"): its planes, then
    its lines (a CP field has lines only)."""
    parts = ("line",) if cfg.is_cp else ("plane", "line")
    return [f"{kind}_{part}_{i}" for part in parts for i in range(3)]


def init_tensorf(cfg: TensorfConfig, generator: torch.Generator, device) -> TensorfField:
    """Random init: factor grids 0.1*randn, basis/MLP torch-Linear-style."""
    g = cfg.grid_size
    names = set(factor_names(cfg, "density") + factor_names(cfg, "app"))
    t = {}
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        for kind, n_comp in (("density", cfg.density_n_comp), ("app", cfg.app_n_comp)):
            c = n_comp[i % len(n_comp)]  # a CP field's one rank serves all three
            for name, shape in ((f"{kind}_plane_{i}", (c, g[m1], g[m0])), (f"{kind}_line_{i}", (c, g[VEC_MODE[i]]))):
                if name in names:
                    t[name] = 0.1 * torch.randn(shape, generator=generator, device=device)
    n_app = sum(cfg.app_n_comp)
    t["basis_mat"] = _uniform((n_app, cfg.app_dim), 1.0 / math.sqrt(n_app), generator, device)
    t.update(init_mlp(cfg, generator, device))
    return TensorfField(t)


# (aabb_lo, aabb_hi, device) -> (aabb_lo, 2 / aabb_size) on that device
_AABB_CONSTS: dict = {}


def _filled(values, device) -> torch.Tensor:
    """A float32 vector filled on the device from Python numbers: no
    host-to-device copy, which would synchronise a card."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32, device=device) for v in values])


def _aabb_consts(cfg: TensorfConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The aabb's lower corner and 2 / size as device tensors, made once per
    device and cached (a captured step reads the cached ones)."""
    key = (cfg.aabb_lo, cfg.aabb_hi, str(device))
    if key not in _AABB_CONSTS:
        _AABB_CONSTS[key] = (_filled(cfg.aabb_lo, device), 2.0 / _filled(cfg.aabb_size, device))
    return _AABB_CONSTS[key]


def normalize_coord(pts: torch.Tensor, cfg: TensorfConfig) -> torch.Tensor:
    """World (contracted) coords -> [-1, 1] grid coords."""
    aabb_lo, inv = _aabb_consts(cfg, pts.device)
    return (pts - aabb_lo) * inv - 1.0


def build_quad_views(params, cfg: TensorfConfig, kinds=("density", "app")) -> dict:
    """Quad-packed gather views of each factor grid (see ops/grid.py)."""
    return {name: (build_quad_plane if "_plane_" in name else build_quad_line)(params[name])
            for kind in kinds for name in factor_names(cfg, kind)}


def build_combined_quad_views(params, cfg: TensorfConfig) -> dict:
    """Quad views with density and appearance factors fused per orientation:
    [8+24]-channel planes quad-pack to rows of 4*32 = 128 values, so ONE
    gather (and one backward segment sum) per orientation serves both
    features. Tables are cast to `cfg.gather_dtype`, except the line tables
    in the "segsum" line mode: K3 takes them in f32 and rounds the gathered
    rows (ops/kernels/segsum.py `take_rows`). A CP field has the lines
    only: [R_sigma + R_app]-channel lines, rows of 2 (R_sigma + R_app)."""
    dt = _DTYPES[cfg.gather_dtype]
    line_dt = torch.float32 if cfg.line_mode == "segsum" else dt
    views = {}
    for name in factor_names(cfg, "density"):
        part = name.removeprefix("density_")  # "plane_i" or "line_i"
        table = torch.cat([params[name], params[f"app_{part}"]], dim=0)
        if "plane" in part:
            views[f"comb_{part}"] = build_quad_plane(table.to(dt))
        else:
            views[f"comb_{part}"] = build_quad_line(table.to(line_dt))
    return views


def compute_density_app_features(params, pts: torch.Tensor, cfg: TensorfConfig, quad: dict):
    """Density feature [P] (f32) and appearance feature [P, app_dim] (f32)
    from ONE shared gather per orientation."""
    if cfg.is_cp:
        return _cp_density_app_features(params, pts, cfg, quad)
    sigma = 0.0
    prods = []
    g = cfg.grid_size
    dt = _DTYPES[cfg.gather_dtype]
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        v = VEC_MODE[i]
        cd = params[f"density_plane_{i}"].shape[0]
        c = cd + params[f"app_plane_{i}"].shape[0]
        table = quad[f"comb_plane_{i}"]
        binned = cfg.binned_scatter and table.shape[0] >= cfg.binned_min_rows
        pf = quad_sample_2d(table, g[m1], g[m0], plane_coords(pts, m0, m1), c, binned)
        lf = quad_sample_1d(quad[f"comb_line_{i}"], g[v], pts[:, v], c, cfg.line_mode, dt)
        prod = pf * lf  # [P, cd+ca]
        sigma = sigma + torch.sum(prod[:, :cd].to(torch.float32), dim=-1)
        prods.append(prod[:, cd:])
    feat = torch.cat(prods, dim=-1)  # [P, sum(app_n_comp)]
    # f32 product of table-dtype inputs (JAX: preferred_element_type=f32)
    basis = params["basis_mat"].to(feat.dtype)
    app = torch.matmul(feat.to(torch.float32), basis.to(torch.float32))
    return sigma, app


def _cp_density_app_features(params, pts: torch.Tensor, cfg: TensorfConfig, quad: dict):
    """compute_density_app_features of a CP field: one combined line gather
    per orientation, the three lines' product per component in the table
    dtype; sigma sums the first R_sigma products in f32, the other R_app
    go through the basis in f32."""
    g = cfg.grid_size
    dt = _DTYPES[cfg.gather_dtype]
    cd = params["density_line_0"].shape[0]
    c = cd + params["app_line_0"].shape[0]
    prod = None
    for i in range(3):
        v = VEC_MODE[i]
        lf = quad_sample_1d(quad[f"comb_line_{i}"], g[v], pts[:, v], c, cfg.line_mode, dt)
        prod = lf if prod is None else prod * lf
    sigma = torch.sum(prod[:, :cd].to(torch.float32), dim=-1)
    feat = prod[:, cd:]
    basis = params["basis_mat"].to(feat.dtype)
    return sigma, torch.matmul(feat.to(torch.float32), basis.to(torch.float32))


def compute_density_feature(params, pts: torch.Tensor, cfg: TensorfConfig, quad: dict | None = None
                            ) -> torch.Tensor:
    """Raw density feature at normalized points [P, 3] -> [P]: from
    density-only quad views (build_quad_views(..., kinds=("density",))), or
    with quad=None (cfg.fast_gather off) by bilinear lookups in the f32
    factor grids (the grid-sample route, JAX's oracle; the same math). A CP
    field sums its three density lines' product over the components."""
    g = cfg.grid_size
    if cfg.is_cp:
        prod = 1.0
        for i in range(3):
            v = VEC_MODE[i]
            line = params[f"density_line_{i}"]
            if quad is None:
                prod = prod * grid_sample_1d(line, pts[:, v])
            else:
                prod = prod * quad_sample_1d(quad[f"density_line_{i}"], g[v], pts[:, v], line.shape[0])
        return torch.sum(prod, dim=-1)
    out = 0.0
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        v = VEC_MODE[i]
        if quad is None:
            pf = grid_sample_2d(params[f"density_plane_{i}"], plane_coords(pts, m0, m1))
            lf = grid_sample_1d(params[f"density_line_{i}"], pts[:, v])
        else:
            c = params[f"density_plane_{i}"].shape[0]
            pf = quad_sample_2d(quad[f"density_plane_{i}"], g[m1], g[m0], plane_coords(pts, m0, m1), c)
            lf = quad_sample_1d(quad[f"density_line_{i}"], g[v], pts[:, v], c)
        out = out + torch.sum(pf * lf, dim=-1)
    return out


def compute_app_feature(params, pts: torch.Tensor, cfg: TensorfConfig) -> torch.Tensor:
    """Appearance feature at normalized points [P, 3] -> [P, app_dim] on the
    grid-sample route: bilinear lookups in the f32 factor grids, their
    products through the basis in f32 (a CP field: the three appearance
    lines' product)."""
    if cfg.is_cp:
        prod = 1.0
        for i in range(3):
            prod = prod * grid_sample_1d(params[f"app_line_{i}"], pts[:, VEC_MODE[i]])
        return torch.matmul(prod, params["basis_mat"])
    prods = []
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        pf = grid_sample_2d(params[f"app_plane_{i}"], plane_coords(pts, m0, m1))
        lf = grid_sample_1d(params[f"app_line_{i}"], pts[:, VEC_MODE[i]])
        prods.append(pf * lf)
    return torch.matmul(torch.cat(prods, dim=-1), params["basis_mat"])


def density_relu(cfg: TensorfConfig) -> bool:
    """Whether the density activation is relu (else softplus(f + shift));
    raises for any other cfg.fea2dense_act."""
    if cfg.fea2dense_act not in ("softplus", "relu"):
        raise ValueError(cfg.fea2dense_act)
    return cfg.fea2dense_act == "relu"


def feature2density(feat: torch.Tensor, cfg: TensorfConfig) -> torch.Tensor:
    return F.relu(feat) if density_relu(cfg) else F.softplus(feat + cfg.density_shift)


def apply_mlp(mlp, pts, viewdirs, features, cfg: TensorfConfig, refine=1.0) -> torch.Tensor:
    """The shading head of cfg.shading_mode, with JAX's inputs in JAX's
    order: MLP_Fea_late_view [feat, PE(feat) * refine] with [viewdirs,
    PE(viewdirs)] joining before the last layer; MLP_Fea [feat, viewdirs,
    PE(feat), PE(viewdirs)] (its feature PE unscaled by `refine`);
    MLP_Fea_woView [feat, PE(feat)]; MLP_PE [feat, viewdirs, PE(pts),
    PE(viewdirs)], pts the normalized (compacted) sample points; MLP [feat,
    viewdirs, PE(viewdirs)]; RGB the features themselves (no sigmoid). A PE
    with 0 frequencies is left out. Hidden layers run in `cfg.mlp_dtype`
    (bias and relu in it too); the last layer takes the hidden activations
    and weights rounded to that dtype and multiplies them in f32, like
    JAX's preferred_element_type=f32. `refine` (0/1) scales the late-view
    head's feature PE only."""
    mode = cfg.shading_mode
    if mode == "RGB":
        return features
    dt = _DTYPES[cfg.mlp_dtype]

    def hidden(x, w, b):
        return F.relu(torch.matmul(x.to(dt), w.to(dt)) + b.to(dt))

    def pe(x, freqs):
        return [positional_encoding(x, freqs)] if freqs > 0 else []

    view_in = []
    if mode == "MLP_Fea_late_view":
        indata = [features] + [e * refine for e in pe(features, cfg.fea_pe)]
        view_in = [viewdirs, *pe(viewdirs, cfg.view_pe)]
    elif mode == "MLP_Fea":
        indata = [features, viewdirs, *pe(features, cfg.fea_pe), *pe(viewdirs, cfg.view_pe)]
    elif mode == "MLP_Fea_woView":
        indata = [features, *pe(features, cfg.fea_pe)]
    elif mode == "MLP_PE":
        indata = [features, viewdirs, *pe(pts, cfg.pos_pe), *pe(viewdirs, cfg.view_pe)]
    else:  # "MLP"
        indata = [features, viewdirs, *pe(viewdirs, cfg.view_pe)]
    x = hidden(torch.cat(indata, dim=-1), mlp["w1"], mlp["b1"])
    x = hidden(x, mlp["w2"], mlp["b2"])
    if view_in:
        x = torch.cat([x, *(v.to(dt) for v in view_in)], dim=-1)
    w3 = mlp["w3"].to(dt).to(torch.float32)
    return torch.sigmoid(torch.matmul(x.to(torch.float32), w3) + mlp["b3"])


def sample_alpha(alpha_volume: torch.Tensor, pts: torch.Tensor, cfg: TensorfConfig) -> torch.Tensor:
    """Occupancy lookup: trilinear sample of the alpha volume at world
    (contracted) points [P, 3] -> [P]."""
    return grid_sample_3d(alpha_volume, normalize_coord(pts, cfg))


# ----------------------------- regularizers -----------------------------


def _tv_kind(params, kind: str) -> torch.Tensor:
    total = 0.0
    for i in range(3):
        plane = params[f"{kind}_plane_{i}"][:, None]  # [C, 1, H, W]
        line = params[f"{kind}_line_{i}"][:, None, :, None]  # [C, 1, D, 1]
        total = total + tv_loss(plane) * 1e-2 + tv_loss(line) * 1e-3
    return total


def tv_loss_density(params) -> torch.Tensor:
    """TV on density planes (1e-2) and lines (1e-3)."""
    return _tv_kind(params, "density")


def tv_loss_app(params) -> torch.Tensor:
    return _tv_kind(params, "app")


def _l1_block_size(d_sizes, n_vox: int, target: int) -> int:
    """Largest B <= ~target that is a multiple of every line length and a
    divisor of n_vox (0 if none exists)."""
    lcm = 1
    for d in d_sizes:
        lcm = lcm * d // math.gcd(lcm, d)
    if lcm > n_vox or n_vox % lcm:
        return 0
    q = n_vox // lcm
    for k in range(min(q, max(1, target // lcm)), 0, -1):
        if q % k == 0:
            return lcm * k
    return lcm


# voxels per density_l1 block: ~16.8M voxels keeps a block's f32 working set
# to a few hundred MB while 640^3 needs only 16 blocks
L1_BLOCK_TARGET = 1 << 24


def _l1_block(cfg: TensorfConfig, *tensors) -> torch.Tensor:
    n = len(tensors) // 2
    planes, lines = tensors[:n], tensors[n:]
    feat = 0.0
    for i in range(n):
        feat = feat + torch.einsum("cp,cd->pd", planes[i], lines[i]).reshape(-1)
    sigmas = feature2density(feat, cfg)
    return torch.sum(torch.sqrt(torch.clamp(sigmas, min=1e-5)))


def density_l1(params, cfg: TensorfConfig) -> torch.Tensor:
    """mean sqrt(density) over the full outer-product grid, each plane's
    [P, D] outer product flattened in its own axis order before the three
    are summed (the reference's layout quirk). A cubic grid on the card
    takes the kernel (ops/kernels/density_l1.py: one pass for the value and
    both gradients; there every orientation's voxel p D + d has the same
    (p, d)) and counts `l1.kernel`; any other grid, and every grid on the
    CPU, takes density_l1_blocked and counts `l1.blocked`.

    A CP field's feature is the product of its three density lines, f[(a,
    b), d] = sum_c line_1[c, a] line_2[c, b] line_0[c, d]: the same form
    with one plane, the virtual plane line_1 (x) line_2 [C, G_1, G_2] built
    under autograd (its backward gives the two lines' gradients), and
    line_0 (`l1_factors`); it counts `l1.cp` too."""
    g = cfg.grid_size
    planes, lines = l1_factors(params, cfg)
    if planes[0].device.type == "cuda" and g[0] == g[1] == g[2]:
        profiling.count("l1.kernel")
        return l1_kernel.density_l1(planes, lines, cfg.density_shift, density_relu(cfg))
    profiling.count("l1.blocked")
    return _density_l1_blocked(planes, lines, cfg)


def l1_factors(params, cfg: TensorfConfig) -> tuple[list, list]:
    """The density L1 term's (planes [C_i, H, W], lines [C_i, D]): a VM
    field's three of each; a CP field's virtual plane line_1 (x) line_2
    and line_0 (counted as `l1.cp`)."""
    if not cfg.is_cp:
        return ([params[f"density_plane_{i}"] for i in range(3)],
                [params[f"density_line_{i}"] for i in range(3)])
    profiling.count("l1.cp")
    plane = params["density_line_1"][:, :, None] * params["density_line_2"][:, None, :]
    return [plane], [params["density_line_0"]]


def density_l1_blocked(params, cfg: TensorfConfig) -> torch.Tensor:
    """density_l1 in plain PyTorch, on any grid: at and above
    cfg.l1_stream_min_vox voxels the grid is produced in checkpointed blocks
    (same per-voxel values; only the order of the f32 sum differs), so
    neither pass holds the dense volume. The kernel's plain version."""
    return _density_l1_blocked(*l1_factors(params, cfg), cfg)


def _density_l1_blocked(planes: list, lines: list, cfg: TensorfConfig) -> torch.Tensor:
    n_vox = int(np.prod(cfg.grid_size))
    planes = [p.reshape(p.shape[0], -1) for p in planes]
    blk = _l1_block_size([ln.shape[1] for ln in lines], n_vox, L1_BLOCK_TARGET)
    if n_vox < cfg.l1_stream_min_vox or not blk:
        total = _l1_block(cfg, *planes, *lines)
        return total / n_vox
    rows = [blk // ln.shape[1] for ln in lines]
    acc = 0.0
    for b in range(n_vox // blk):
        sl = [p[:, b * r : (b + 1) * r] for p, r in zip(planes, rows)]
        # no RNG in a block: without the RNG stash the step stays capturable
        acc = acc + checkpoint(_l1_block, cfg, *sl, *lines, use_reentrant=False,
                               preserve_rng_state=False)
    return acc / n_vox


# ----------------------------- upsampling -----------------------------


@torch.no_grad()
def upsample_tensorf(params, cfg: TensorfConfig, new_grid) -> tuple[TensorfField, TensorfConfig]:
    """Bilinear align_corners upsample of all factor grids to `new_grid` (a
    CP field's lines only). Returns (new field, new config)."""
    new_cfg = cfg.with_grid(new_grid)
    g = new_cfg.grid_size
    out = {name: p.detach() for name, p in params.named_parameters()}
    for name in factor_names(cfg, "density") + factor_names(cfg, "app"):
        i = int(name[-1])
        if "_plane_" in name:
            m0, m1 = MAT_MODE[i]
            out[name] = resize_align_corners_2d(params[name], g[m1], g[m0])
        else:
            out[name] = resize_align_corners_1d(params[name], g[VEC_MODE[i]])
    return TensorfField({k: v.clone() for k, v in out.items()}), new_cfg


# ----------------------------- alpha mask -----------------------------

# lattice points per dense-alpha slab (the working set of one evaluation)
_DENSE_ALPHA_CHUNK_PTS = 2_097_152


@torch.no_grad()
def compute_dense_alpha(params, cfg: TensorfConfig, grid_size) -> torch.Tensor:
    """Dense alpha at `grid_size` lattice points over the aabb, through the
    density quad views (or the grid-sample route with cfg.fast_gather off).
    Returns [gx, gy, gz]; evaluated in x-slabs above _DENSE_ALPHA_CHUNK_PTS
    points."""
    gx, gy, gz = (int(v) for v in grid_size)
    dev = params["basis_mat"].device
    xs = torch.linspace(0.0, 1.0, gx, device=dev)
    ys = torch.linspace(0.0, 1.0, gy, device=dev)
    zs = torch.linspace(0.0, 1.0, gz, device=dev)
    aabb = torch.as_tensor(cfg.aabb, device=dev)
    quad = build_quad_views(params, cfg, kinds=("density",)) if cfg.fast_gather else None

    def eval_pts(grid01):
        pts = aabb[0] * (1.0 - grid01) + aabb[1] * grid01
        pts_flat = normalize_coord(pts.reshape(-1, 3), cfg)
        sigma = feature2density(compute_density_feature(params, pts_flat, cfg, quad), cfg)
        return 1.0 - torch.exp(-sigma * cfg.step_size)

    if gx * gy * gz <= _DENSE_ALPHA_CHUNK_PTS:
        grid = torch.stack(torch.meshgrid(xs, ys, zs, indexing="ij"), dim=-1)
        return eval_pts(grid).reshape(gx, gy, gz)
    gyz = torch.stack(torch.meshgrid(ys, zs, indexing="ij"), dim=-1)  # [gy, gz, 2]
    slabs = [
        eval_pts(torch.cat([x.expand(gy, gz)[..., None], gyz], dim=-1)) for x in xs
    ]
    return torch.stack(slabs).reshape(gx, gy, gz)


@torch.no_grad()
def update_alpha_volume(params, cfg: TensorfConfig, grid_size) -> torch.Tensor:
    """Binary occupancy volume: dense alpha -> 3x3x3 maxpool -> threshold.
    Returns [gz, gy, gx] float 0/1."""
    alpha = compute_dense_alpha(params, cfg, grid_size)
    alpha = torch.clamp(alpha, 0.0, 1.0).permute(2, 1, 0)  # -> [z, y, x]
    pooled = F.max_pool3d(alpha[None, None], kernel_size=3, stride=1, padding=1)[0, 0]
    return (pooled >= cfg.alpha_mask_thres).to(torch.float32)
