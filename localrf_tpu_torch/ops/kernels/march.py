"""K4: the fused march core, forward and analytic backward.

`march_core` launches the CUDA kernels in csrc/march.cu (see the note there
for what bounds them on the card), replacing the Pallas TPU kernels
localrf_tpu/ops/pallas/march.py `_march_fwd_impl` and `_march_bwd`: per
sample, the three plane-row bilerps, line lerps and factor products, the
density feature, the 72 -> 27 basis product and the MLP_Fea_late_view MLP,
in one kernel with an analytic backward. The plane-row gathers stay
outside (`fused_march_features`), their backward is K2.

`march_core_plain` is the same forward and the same hand-written backward
in plain PyTorch, rounding where the Pallas kernel rounds (the lerp weights,
lerps and products in the table dtype; f32 sums; hidden dots rounded to the
MLP dtype before the bias; d_app rounded to the table dtype): the CPU path
and the on-card reference. Against it the kernel agrees to f32 rounding
in everything the atomic adds and the reordered f32 sums touch (dlines,
the parameter gradients, sigma, app), and bit for bit elsewhere up to
those f32 differences crossing a bf16 rounding.

Which kernels a CUDA call runs is a function of the dtypes alone: bf16
tables with the bf16 MLP (the training CLI's defaults) take the tensor-core
kernels (`march_fwd_mma_kernel`, `march_bwd_mlp_mma_kernel`: every operand
of their basis and MLP products is a bf16 value, `march_products_plain`
lists them, so bf16 MMAs with f32 sums compute the same products); any f32
table or MLP takes the CUDA-core kernels. Both need sm_90a; neither stands
in for the other when a launch fails (the wrapper raises).

Layouts (the JAX kernel's `aux` column split into its parts):
  rows0..2 [P, 128] table dtype (f32 or bf16): gathered quad plane rows
  wxy [P, 6] f32: wx0 wy0 wx1 wy1 wx2 wy2;  w1l [P, 3] f32;  x0 [P, 3] int32
  vd [P, 3] f32;  lines [3, G, 64] table dtype
  basis [72, 27], w1 [27, 128], b1 [128], w2 [128, 128], b2 [128],
  w3 [131, 3], b3 [3], all f32
  out [P, 4] f32: sigma feature | rgb
Gradients flow to every input but x0 and vd.
"""
from __future__ import annotations

import torch

from . import _build

CD, CA = 8, 24
C = CD + CA
APP_DIM = 27
FEAT_C = 128
# the backward's packed parameter gradient: basis, w1, b1, w2, b2, w3, b3
PARAM_SHAPES = (
    (3 * CA, APP_DIM), (APP_DIM, FEAT_C), (FEAT_C,), (FEAT_C, FEAT_C), (FEAT_C,),
    (FEAT_C + 3, 3), (3,),
)
N_PARAMS = sum(int(torch.Size(s).numel()) for s in PARAM_SHAPES)

LAUNCHES = {"march_fwd": 0, "march_bwd": 0}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32 = torch.float32


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 product of (possibly bf16-valued) operands: exact products, f32 sums."""
    return torch.matmul(a.to(F32), b.to(F32))


def _forward(rows, wxy, w1l, x0, vd, lines, basis, w1, b1, w2, b2, w3, b3, mdt):
    """The forward and what the backward recomputes from it."""
    tdt = rows[0].dtype
    p = rows[0].shape[0]
    sigma = torch.zeros(p, dtype=F32, device=wxy.device)
    feats, lerp = [], []
    for i in range(3):
        wx = wxy[:, 2 * i : 2 * i + 1].to(tdt)
        wy = wxy[:, 2 * i + 1 : 2 * i + 2].to(tdt)
        wl = w1l[:, i : i + 1].to(tdt)
        r = rows[i]
        v00, v01, v10, v11 = r[:, :C], r[:, C : 2 * C], r[:, 2 * C : 3 * C], r[:, 3 * C :]
        top = v00 * (1.0 - wx) + v01 * wx
        bot = v10 * (1.0 - wx) + v11 * wx
        f = top * (1.0 - wy) + bot * wy
        lr = lines[i].index_select(0, x0[:, i].long())
        l = lr[:, :C] * (1.0 - wl) + lr[:, C:] * wl
        prod = f * l
        sigma = sigma + prod[:, :CD].to(F32).sum(-1)
        feats.append(prod[:, CD:])
        lerp.append((f, l, lr, (v00, v01, v10, v11, top, bot), wx, wy, wl))
    app = torch.zeros((p, APP_DIM), dtype=F32, device=wxy.device)
    for i in range(3):
        app = app + _mm(feats[i], basis[i * CA : (i + 1) * CA].to(tdt))
    x0m = app.to(mdt)
    w1m, w2m, w3m = w1.to(mdt), w2.to(mdt), w3.to(mdt)
    pre1 = _mm(x0m, w1m).to(mdt) + b1.to(mdt)
    h1 = torch.relu(pre1)
    pre2 = _mm(h1, w2m).to(mdt) + b2.to(mdt)
    h2 = torch.relu(pre2)
    vdm = vd.to(mdt)
    pre3 = _mm(h2, w3m[:FEAT_C]) + _mm(vdm, w3m[FEAT_C:]) + b3
    rgb = torch.sigmoid(pre3)
    mlp = (x0m, pre1, h1, pre2, h2, vdm, w1m, w2m, w3m)
    return sigma, rgb, feats, lerp, mlp


def march_fwd_plain(rows0, rows1, rows2, wxy, w1l, x0, vd, lines, basis, w1, b1, w2, b2, w3, b3,
                    mlp_dtype: str) -> torch.Tensor:
    """out [P, 4] f32 = sigma feature | rgb (no autograd graph of its own)."""
    with torch.no_grad():
        sigma, rgb, *_ = _forward((rows0, rows1, rows2), wxy, w1l, x0, vd, lines, basis,
                                  w1, b1, w2, b2, w3, b3, _DTYPES[mlp_dtype])
        return torch.cat([sigma[:, None], rgb], dim=-1)


def march_bwd_plain(rows0, rows1, rows2, wxy, w1l, x0, vd, lines, basis, w1, b1, w2, b2, w3, b3,
                    gout, mlp_dtype: str):
    """The Pallas kernel's VJP: recompute the forward, then (d_rows0, d_rows1,
    d_rows2 [table dtype], d_wxy, d_w1l, dlines [table dtype], dbasis, dw1,
    db1, dw2, db2, dw3, db3 [f32])."""
    return _backward((rows0, rows1, rows2), wxy, w1l, x0, vd, lines, basis, w1, b1, w2, b2, w3, b3,
                     gout, mlp_dtype)[0]


def march_products_plain(rows0, rows1, rows2, wxy, w1l, x0, vd, lines, basis, w1, b1, w2, b2, w3,
                         b3, gout, mlp_dtype: str) -> dict:
    """{name: (a, b)}: the operands of every basis and MLP product that the
    forward and march_bwd_plain form, each computed there as _mm(a, b). The
    tensor-core kernels take these operands as bf16."""
    return _backward((rows0, rows1, rows2), wxy, w1l, x0, vd, lines, basis, w1, b1, w2, b2, w3, b3,
                     gout, mlp_dtype)[1]


def _backward(rows, wxy, w1l, x0, vd, lines, basis, w1, b1, w2, b2, w3, b3, gout, mlp_dtype):
    """march_bwd_plain's outputs, and the operands of its products."""
    with torch.no_grad():
        tdt, mdt = rows[0].dtype, _DTYPES[mlp_dtype]
        _, rgb, feats, lerp, mlp = _forward(rows, wxy, w1l, x0, vd, lines, basis,
                                            w1, b1, w2, b2, w3, b3, mdt)
        x0m, pre1, h1, pre2, h2, vdm, w1m, w2m, w3m = mlp
        gs, gr = gout[:, 0], gout[:, 1:4]

        # MLP backward (apply_mlp's dtype flow)
        d_pre3 = gr * rgb * (1.0 - rgb)
        d_pre3m = d_pre3.to(mdt)
        d_h2 = _mm(d_pre3m, w3m[:FEAT_C].T).to(mdt)
        dw3 = torch.cat([_mm(h2.T, d_pre3m), _mm(vdm.T, d_pre3m)])
        db3 = d_pre3.sum(0)
        # relu masks compare in f32
        d_pre2 = torch.where(pre2.to(F32) > 0, d_h2, 0.0).to(mdt)
        d_h1 = _mm(d_pre2, w2m.T).to(mdt)
        dw2 = _mm(h1.T, d_pre2)
        db2 = d_pre2.to(F32).sum(0)
        d_pre1 = torch.where(pre1.to(F32) > 0, d_h1, 0.0).to(mdt)
        d_app = _mm(d_pre1, w1m.T)
        dw1 = _mm(x0m.T, d_pre1)
        db1 = d_pre1.to(F32).sum(0)

        # basis + per-orientation factor backward
        d_app_t = d_app.to(tdt)
        gs_t = gs.to(tdt)[:, None]
        d_rows, d_wxy, d_w1l, dlines, dbasis = [], [], [], [], []
        products = {
            "h1": (x0m, w1m), "h2": (h1, w2m), "pre3": (h2, w3m[:FEAT_C]),
            "d_h2": (d_pre3m, w3m[:FEAT_C].T), "dw3": (h2.T, d_pre3m), "d_h1": (d_pre2, w2m.T),
            "dw2": (h1.T, d_pre2), "d_app": (d_pre1, w1m.T), "dw1": (x0m.T, d_pre1),
        }
        for i in range(3):
            f, l, lr, (v00, v01, v10, v11, top, bot), wx, wy, wl = lerp[i]
            basis_i = basis[i * CA : (i + 1) * CA].to(tdt)
            products[f"app{i}"] = (feats[i], basis_i)
            products[f"dbasis{i}"] = (feats[i].T, d_app_t)
            products[f"d_feat{i}"] = (d_app_t, basis_i.T)
            d_feat = _mm(d_app_t, basis_i.T).to(tdt)
            dbasis.append(_mm(feats[i].T, d_app_t))
            d_prod = torch.cat([gs_t.expand(-1, CD), d_feat], dim=-1)
            d_f = d_prod * l
            d_l = d_prod * f
            d_lr = torch.cat([d_l * (1.0 - wl), d_l * wl], dim=-1)
            dl = torch.zeros(lines.shape[1:], dtype=F32, device=lines.device)
            dlines.append(dl.index_add_(0, x0[:, i].long(), d_lr.to(F32)))
            d_w1l.append((d_l * (lr[:, C:] - lr[:, :C])).sum(-1))
            d_top = d_f * (1.0 - wy)
            d_bot = d_f * wy
            d_rows.append(torch.cat(
                [d_top * (1.0 - wx), d_top * wx, d_bot * (1.0 - wx), d_bot * wx], dim=-1))
            d_wxy.append((d_top * (v01 - v00) + d_bot * (v11 - v10)).sum(-1))
            d_wxy.append((d_f * (bot - top)).sum(-1))
        grads = (
            *d_rows,
            torch.stack(d_wxy, dim=-1).to(F32),
            torch.stack(d_w1l, dim=-1).to(F32),
            torch.stack(dlines).to(lines.dtype),
            torch.cat(dbasis), dw1, db1, dw2, db2, dw3, db3,
        )
        return grads, products


def _check(rows0, rows1, rows2, wxy, w1l, x0, vd, lines, basis, w1, b1, w2, b2, w3, b3,
           mlp_dtype: str):
    """Raise on anything the CUDA kernels do not take."""
    p = rows0.shape[0]
    tdt = rows0.dtype
    if tdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"march_core: table dtype must be float32/bfloat16, got {tdt}")
    want = {
        "rows0": (rows0, (p, 4 * C), tdt), "rows1": (rows1, (p, 4 * C), tdt),
        "rows2": (rows2, (p, 4 * C), tdt), "wxy": (wxy, (p, 6), F32), "w1l": (w1l, (p, 3), F32),
        "x0": (x0, (p, 3), torch.int32), "vd": (vd, (p, 3), F32),
        "lines": (lines, (3, lines.shape[1], 2 * C), tdt),
    }
    names = ("basis", "w1", "b1", "w2", "b2", "w3", "b3")
    for name, t, shape in zip(names, (basis, w1, b1, w2, b2, w3, b3), PARAM_SHAPES):
        want[name] = (t, shape, F32)
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"march_core: {name} must be {dtype} {list(shape)},"
                             f" got {t.dtype} {list(t.shape)}")
        if t.device != rows0.device:
            raise ValueError(f"march_core: {name} is on {t.device}, rows on {rows0.device}")
        if not t.is_contiguous():
            raise ValueError(f"march_core: {name} must be contiguous")
    # the tensor-core kernels copy plane and line rows in 16-byte pieces
    if tdt == torch.bfloat16 and mlp_dtype == "bfloat16":
        for name in ("rows0", "rows1", "rows2", "lines"):
            if want[name][0].data_ptr() % 16:
                raise ValueError(f"march_core: {name} must start on a 16-byte boundary")


def _n_blocks(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_fwd(args, mlp_dtype: str) -> torch.Tensor:
    _check(*args, mlp_dtype)
    rows0, lines = args[0], args[7]
    p = rows0.shape[0]
    out = torch.empty((p, 4), dtype=F32, device=rows0.device)
    if p:
        with torch.cuda.device(rows0.device):
            _build.launch(
                "lrf_march_fwd", *(t.data_ptr() for t in args), out.data_ptr(), p, lines.shape[1],
                int(rows0.dtype == torch.bfloat16), int(mlp_dtype == "bfloat16"),
                _n_blocks(rows0.device), _build.stream_ptr(rows0.device),
            )
        LAUNCHES["march_fwd"] += 1
    return out


def _launch_bwd(args, gout, mlp_dtype: str):
    _check(*args, mlp_dtype)
    if gout.shape != (args[0].shape[0], 4) or gout.dtype != F32 or not gout.is_contiguous():
        raise ValueError(f"march_core: cotangent must be contiguous float32 [{args[0].shape[0]}, 4]")
    rows0, lines = args[0], args[7]
    p, dev = rows0.shape[0], rows0.device
    d_rows = [torch.empty_like(rows0) for _ in range(3)]
    d_wxy = torch.empty((p, 6), dtype=F32, device=dev)
    d_w1l = torch.empty((p, 3), dtype=F32, device=dev)
    dlines = torch.zeros(lines.shape, dtype=F32, device=dev)
    dparams = torch.zeros(N_PARAMS, dtype=F32, device=dev)
    if p:
        n_blocks = _n_blocks(dev)
        d_feat = torch.empty((p, 3 * CA), dtype=rows0.dtype, device=dev)
        partials = torch.empty((n_blocks, N_PARAMS), dtype=F32, device=dev)
        with torch.cuda.device(dev):
            if _build.library().lrf_march_n_params() != N_PARAMS:
                raise RuntimeError("march.cu and march.py disagree on the parameter layout")
            _build.launch(
                "lrf_march_bwd", *(t.data_ptr() for t in args), gout.data_ptr(),
                *(t.data_ptr() for t in d_rows), d_wxy.data_ptr(), d_w1l.data_ptr(),
                dlines.data_ptr(), d_feat.data_ptr(), partials.data_ptr(), dparams.data_ptr(),
                p, lines.shape[1], int(rows0.dtype == torch.bfloat16), int(mlp_dtype == "bfloat16"),
                n_blocks, _build.stream_ptr(dev),
            )
        LAUNCHES["march_bwd"] += 1
    params, off = [], 0
    for shape in PARAM_SHAPES:
        n = int(torch.Size(shape).numel())
        params.append(dparams[off : off + n].view(shape))
        off += n
    return (*d_rows, d_wxy, d_w1l, dlines.to(lines.dtype), *params)


class _MarchCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plain, mlp_dtype, *args):
        ctx.save_for_backward(*args)
        ctx.plain, ctx.mlp_dtype = plain, mlp_dtype
        if plain:
            return march_fwd_plain(*args, mlp_dtype)
        return _launch_fwd(args, mlp_dtype)

    @staticmethod
    def backward(ctx, gout):
        args = ctx.saved_tensors
        gout = gout.contiguous()
        if ctx.plain:
            grads = march_bwd_plain(*args, gout, ctx.mlp_dtype)
        else:
            grads = _launch_bwd(args, gout, ctx.mlp_dtype)
        # no gradient to x0 (indices) or vd (view directions)
        return (None, None, *grads[:5], None, None, *grads[5:])


def march_core_plain(rows0, rows1, rows2, wxy, w1l, x0, vd, lines, basis, w1, b1, w2, b2, w3, b3,
                     mlp_dtype: str = "float32") -> torch.Tensor:
    """The fused march core in plain PyTorch on any device (layouts in the
    module docstring); out [P, 4] f32."""
    return _MarchCore.apply(True, mlp_dtype, rows0, rows1, rows2, wxy, w1l, x0, vd, lines,
                            basis, w1, b1, w2, b2, w3, b3)


def march_core(rows0, rows1, rows2, wxy, w1l, x0, vd, lines, basis, w1, b1, w2, b2, w3, b3,
               mlp_dtype: str = "float32") -> torch.Tensor:
    """The fused march core; out [P, 4] f32. CPU tensors take
    `march_core_plain`; CUDA tensors launch the kernels."""
    dev = rows0.device
    if dev.type == "cpu":
        return march_core_plain(rows0, rows1, rows2, wxy, w1l, x0, vd, lines, basis,
                                w1, b1, w2, b2, w3, b3, mlp_dtype)
    if dev.type != "cuda":
        raise ValueError(f"march_core: no kernel for device {dev}")
    return _MarchCore.apply(False, mlp_dtype, rows0, rows1, rows2, wxy, w1l, x0, vd, lines,
                            basis, w1, b1, w2, b2, w3, b3)


def fused_march_supported(cfg) -> bool:
    """The kernel is specialised to the reference's default shape config."""
    g = cfg.grid_size
    return (
        tuple(cfg.density_n_comp) == (CD, CD, CD)
        and tuple(cfg.app_n_comp) == (CA, CA, CA)
        and cfg.app_dim == APP_DIM
        and cfg.feature_c == FEAT_C
        and cfg.shading_mode == "MLP_Fea_late_view"
        and cfg.fea_pe == 0 and cfg.view_pe == 0
        and g[0] == g[1] == g[2]
    )


def fused_march_features(params, quad, pts, viewdirs, cfg):
    """Gather the plane rows (K2 as their backward where binned applies),
    then run the fused march core.

    pts [P, 3] normalized coords; viewdirs [P, 3] (no gradient).
    Returns (sigma_feat [P] f32, rgb [P, 3] f32)."""
    from ...models.tensorf import MAT_MODE, VEC_MODE
    from ..grid import line_texel, plane_coords, plane_texel
    from .binned_scatter import take_rows_binned

    g = cfg.grid_size
    rows, wxy, w1s, x0s = [], [], [], []
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        idx, wx, wy = plane_texel(g[m1], g[m0], plane_coords(pts, m0, m1))
        table = quad[f"comb_plane_{i}"]
        if cfg.binned_scatter and table.shape[0] >= cfg.binned_min_rows:
            rows.append(take_rows_binned(table, idx))
        else:
            rows.append(table.index_select(0, idx))
        wxy += [wx, wy]
        x0, w1l = line_texel(g[VEC_MODE[i]], pts[:, VEC_MODE[i]])
        x0s.append(x0)
        w1s.append(w1l)
    # the segsum line mode keeps f32 line tables (tensorf.build_combined_quad_views)
    lines = torch.stack([quad[f"comb_line_{i}"] for i in range(3)]).to(rows[0].dtype)
    mlp = params["mlp"]
    out = march_core(
        *rows, torch.cat(wxy, dim=-1), torch.cat(w1s, dim=-1),
        torch.stack(x0s, dim=-1).to(torch.int32), viewdirs.detach().contiguous(), lines,
        params["basis_mat"], mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"], mlp["w3"], mlp["b3"],
        cfg.mlp_dtype,
    )
    return out[:, 0], out[:, 1:4]
