"""Port parity: localrf_tpu_torch ops/, models/tensorf.py and optim.py against
the JAX package on the CPU, on the same numpy inputs.

Values and gradients agree to rtol 1e-5 / atol 1e-6 in float32 (both sides
run the same arithmetic; only XLA's and PyTorch's reduction orders differ)
unless a test states otherwise; occupancy masks, packed bytes and compacted
indices must match exactly.
"""
import ast
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localrf_tpu.models import tensorf as jtf
from localrf_tpu.ops import grid as jgrid
from localrf_tpu.ops import math as jmath
from localrf_tpu.ops import occupancy as jocc
from localrf_tpu.ops import rays as jrays
from localrf_tpu import optim as joptim
from localrf_tpu_torch.convert import field_from_jax, params_from_jax
from localrf_tpu_torch.models import tensorf as ttf
from localrf_tpu_torch.ops import grid as tgrid
from localrf_tpu_torch.ops import math as tmath
from localrf_tpu_torch.ops import occupancy as tocc
from localrf_tpu_torch.ops import rays as trays
from localrf_tpu_torch.ops.kernels import density_l1 as l1_kernel
from localrf_tpu_torch.utils import profiling
from localrf_tpu_torch import optim as toptim

RTOL, ATOL = 1e-5, 1e-6
REPO = pathlib.Path(__file__).resolve().parents[1]


def T(x, dtype=None):
    t = torch.from_numpy(np.array(x, copy=True))
    return t if dtype is None else t.to(dtype)


def close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol)


def tgrad(fn, *xs):
    """Gradient of sum(fn(*xs) * fixed weights) w.r.t. every x, torch side."""
    xs = [T(x).requires_grad_(True) for x in xs]
    out = fn(*xs)
    w = torch.linspace(-1.0, 1.0, out.numel()).reshape(out.shape)
    return torch.autograd.grad((out * w).sum(), xs)


def jgrad(fn, *xs):
    def f(*a):
        out = fn(*a)
        w = jnp.linspace(-1.0, 1.0, out.size).reshape(out.shape)
        return jnp.sum(out * w)

    return jax.jit(jax.grad(f, argnums=tuple(range(len(xs)))))(*[jnp.asarray(x) for x in xs])


# ------------------------------- math -------------------------------


def test_contract_and_positional_encoding(rng):
    x = rng.normal(0, 2, (257, 3)).astype(np.float32)
    close(tmath.contract(T(x)), jmath.contract(jnp.asarray(x)))
    for g_t, g_j in zip(tgrad(tmath.contract, x), jgrad(jmath.contract, x)):
        close(g_t, g_j)
    close(tmath.positional_encoding(T(x), 4), jmath.positional_encoding(jnp.asarray(x), 4))


def test_sixd_rotation_roundtrip_and_grad(rng):
    r = rng.normal(size=(9, 3, 2)).astype(np.float32)
    m_t = tmath.sixD_to_mtx(T(r))
    close(m_t, jmath.sixD_to_mtx(jnp.asarray(r)))
    close(tmath.mtx_to_sixD(m_t), jmath.mtx_to_sixD(jmath.sixD_to_mtx(jnp.asarray(r))))
    close(tgrad(tmath.sixD_to_mtx, r)[0], jgrad(jmath.sixD_to_mtx, r)[0], atol=1e-5)


def test_alpha2weights(rng):
    alpha = rng.uniform(0, 1, (33, 20)).astype(np.float32)
    w_t, t_t = tmath.alpha2weights(T(alpha))
    w_j, t_j = jmath.alpha2weights(jnp.asarray(alpha))
    close(w_t, w_j)
    close(t_t, t_j)


@pytest.mark.parametrize("rows", [3, 4])
def test_inverse_pose(rng, rows):
    pose = rng.normal(size=(5, rows, 4)).astype(np.float32)
    close(tmath.inverse_pose(T(pose)), jmath.inverse_pose(jnp.asarray(pose)), atol=1e-5)


def test_pred_flow_values_and_grads(rng):
    pts = rng.normal(0, 1, (4, 50, 3)).astype(np.float32)
    pts[..., 2] -= 3.0
    ij = rng.uniform(0, 60, (4, 50, 2)).astype(np.float32)
    c2c = rng.normal(0, 0.1, (4, 3, 4)).astype(np.float32) + np.eye(3, 4, dtype=np.float32)
    focal = np.float32(55.0)
    center = np.array([31.0, 22.5], np.float32)
    args = (pts, ij, c2c, focal, center)
    close(tmath.get_pred_flow(*map(T, args)), jmath.get_pred_flow(*map(jnp.asarray, args)), atol=1e-4)
    g_t = tgrad(tmath.get_pred_flow, *args)
    g_j = jgrad(jmath.get_pred_flow, *args)
    for a, b in zip(g_t, g_j):
        close(a, b, rtol=1e-4, atol=1e-4)


def test_depth_loss_median_averages_middle_pair(rng):
    """jnp.median averages the two middle values of an even count; the port
    uses torch.quantile(., 0.5), not torch.median (the lower one)."""
    dyn = rng.uniform(0.5, 3.0, (4, 64)).astype(np.float32)
    gt = rng.uniform(0.1, 1.0, (4, 64)).astype(np.float32)
    assert not np.allclose(torch.median(T(dyn), dim=-1).values.numpy(), np.median(dyn, -1))
    close(tmath._median(T(dyn))[:, 0], np.median(dyn, -1))
    for a, b in zip(tmath.compute_depth_loss(T(dyn), T(gt)),
                    jmath.compute_depth_loss(jnp.asarray(dyn), jnp.asarray(gt))):
        close(a, b, atol=1e-5)
    g_t = tgrad(lambda d, g: tmath.compute_depth_loss(d, g)[2], dyn, gt)
    g_j = jgrad(lambda d, g: jmath.compute_depth_loss(d, g)[2], dyn, gt)
    for a, b in zip(g_t, g_j):
        close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("q", [0.8, 0.9])
def test_quantile_interpolates_linearly(rng, q):
    arr = rng.uniform(0, 1, (16, 37)).astype(np.float32)
    close(torch.quantile(T(arr), q, dim=1, keepdim=True),
          jnp.quantile(jnp.asarray(arr), q, axis=1, keepdims=True))


def test_tv_loss_and_n_to_reso(rng):
    x = rng.normal(size=(3, 2, 7, 5)).astype(np.float32)
    close(tmath.tv_loss(T(x)), jmath.tv_loss(jnp.asarray(x)))
    close(tmath.tv_loss(T(x[:, :, :, :1])), jmath.tv_loss(jnp.asarray(x[:, :, :, :1])))
    aabb = np.array([[-2, -2, -2], [2, 2, 2]], np.float32)
    for n in (64**3, 101**3, 161**3, 255**3, 640**3, 12345):
        assert tmath.n_to_reso(n, aabb) == jmath.n_to_reso(n, aabb)


# ------------------------------- rays -------------------------------


def test_ray_directions_and_rays_with_grads(rng):
    ids = rng.integers(0, 5 * 40 * 30, 64)
    col_t, row_t = trays.ids2pixel(40, 30, T(ids))
    col_j, row_j = jrays.ids2pixel(40, 30, jnp.asarray(ids))
    np.testing.assert_array_equal(col_t.numpy(), np.asarray(col_j))
    np.testing.assert_array_equal(row_t.numpy(), np.asarray(row_j))
    i, j = np.asarray(col_j), np.asarray(row_j)
    close(trays.get_ray_directions_360(T(i), T(j), 40, 30),
          jrays.get_ray_directions_360(jnp.asarray(i), jnp.asarray(j), 40, 30))

    c2w = rng.normal(0, 0.3, (64, 3, 4)).astype(np.float32) + np.eye(3, 4, dtype=np.float32)

    def t_fn(focal, center, c2w):
        d = trays.get_ray_directions_lean(T(i), T(j), focal, center)
        return torch.cat(trays.get_rays_lean(d, c2w), -1)

    def j_fn(focal, center, c2w):
        d = jrays.get_ray_directions_lean(jnp.asarray(i), jnp.asarray(j), focal, center)
        return jnp.concatenate(jrays.get_rays_lean(d, c2w), -1)

    args = (np.float32(35.0), np.array([20.0, 15.0], np.float32), c2w)
    close(t_fn(*map(T, args)), j_fn(*map(jnp.asarray, args)))
    for a, b in zip(tgrad(t_fn, *args), jgrad(j_fn, *args)):
        close(a, b, rtol=1e-4, atol=1e-4)


def _jax_stratified_noise(key, n):
    """JAX's stratified jitter, split exactly as sample_ray_contracted does."""
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.uniform(k1, (1, n))), np.asarray(jax.random.uniform(k2, (1, n))))


@pytest.mark.parametrize("is_train", [False, True])
def test_sample_ray_contracted(rng, is_train):
    o = rng.uniform(-0.5, 0.5, (20, 3)).astype(np.float32)
    d = rng.normal(size=(20, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    n_total = 96
    noise = tuple(map(T, _jax_stratified_noise(key, n_total // 6))) if is_train else None
    out_t = trays.sample_ray_contracted(T(o), T(d), n_total, is_train, noise)
    out_j = jrays.sample_ray_contracted(jnp.asarray(o), jnp.asarray(d), n_total, is_train, key)
    for a, b in zip(out_t, out_j):
        close(a, b, atol=1e-5)


# ------------------------------- grid -------------------------------


def test_unnormalize_nan_and_clamp():
    c = np.array([np.nan, -3.0, -1.0, 0.0, 0.3, 1.0, 4.0], np.float32)
    close(tgrid._unnormalize(T(c), 9), jgrid._unnormalize(jnp.asarray(c), 9))


def test_quad_tables_and_texels(rng):
    plane = rng.normal(size=(5, 6, 7)).astype(np.float32)
    line = rng.normal(size=(5, 9)).astype(np.float32)
    np.testing.assert_array_equal(
        tgrid.build_quad_plane(T(plane)).numpy(), np.asarray(jgrid.build_quad_plane(jnp.asarray(plane))))
    np.testing.assert_array_equal(
        tgrid.build_quad_line(T(line)).numpy(), np.asarray(jgrid.build_quad_line(jnp.asarray(line))))
    coords = rng.uniform(-1.2, 1.2, (100, 2)).astype(np.float32)
    for a, b in zip(tgrid.plane_texel(6, 7, T(coords)), jgrid.plane_texel(6, 7, jnp.asarray(coords))):
        close(a.float(), b)
    for a, b in zip(tgrid.line_texel(9, T(coords[:, 0])), jgrid.line_texel(9, jnp.asarray(coords[:, 0]))):
        close(a.float(), b)


def test_quad_lerp_rounds_weights_to_table_dtype(rng):
    """bf16 tables: the lerp weights are rounded to bf16 before the lerp
    (grid.py:183-184), so the result is the table-dtype lerp."""
    rows = rng.normal(size=(64, 16)).astype(np.float32)
    wx = rng.uniform(0, 1, (64, 1)).astype(np.float32)
    wy = rng.uniform(0, 1, (64, 1)).astype(np.float32)
    out = tgrid.quad_lerp_2d(T(rows, torch.bfloat16), T(wx), T(wy), 4)
    assert out.dtype == torch.bfloat16
    want = jgrid.quad_lerp_2d(jnp.asarray(rows, jnp.bfloat16), jnp.asarray(wx), jnp.asarray(wy), 4)
    close(out, np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)
    wxr = T(wx, torch.bfloat16).float().numpy()
    wyr = T(wy, torch.bfloat16).float().numpy()
    rb = T(rows, torch.bfloat16).float().numpy()
    ref = (rb[:, :4] * (1 - wxr) + rb[:, 4:8] * wxr) * (1 - wyr) + (rb[:, 8:12] * (1 - wxr) + rb[:, 12:] * wxr) * wyr
    close(out, ref, rtol=2e-2, atol=2e-2)
    close(tgrid.quad_lerp_1d(T(rows), T(wx), 8), jgrid.quad_lerp_1d(jnp.asarray(rows), jnp.asarray(wx), 8))


@pytest.mark.parametrize("binned", [False, True])
def test_quad_sample_2d_values_and_grads(rng, binned):
    c, h, w = 32, 12, 10
    plane = rng.normal(size=(c, h, w)).astype(np.float32)
    coords = rng.uniform(-1.1, 1.1, (700, 2)).astype(np.float32)

    def t_fn(plane, coords):
        return tgrid.quad_sample_2d(tgrid.build_quad_plane(plane), h, w, coords, c, binned)

    def j_fn(plane, coords):
        return jgrid.quad_sample_2d(jgrid.build_quad_plane(plane), h, w, coords, c, binned)

    close(t_fn(T(plane), T(coords)), j_fn(jnp.asarray(plane), jnp.asarray(coords)))
    for a, b in zip(tgrad(t_fn, plane, coords), jgrad(j_fn, plane, coords)):
        close(a, b, rtol=1e-4, atol=1e-4)


def test_quad_sample_1d_onehot_grads(rng):
    c, d = 32, 17
    line = rng.normal(size=(c, d)).astype(np.float32)
    coords = rng.uniform(-1.1, 1.1, (500,)).astype(np.float32)

    def t_fn(line, coords):
        return tgrid.quad_sample_1d(tgrid.build_quad_line(line), d, coords, c, "onehot")

    def j_fn(line, coords):
        return jgrid.quad_sample_1d(jgrid.build_quad_line(line), d, coords, c, "onehot")

    close(t_fn(T(line), T(coords)), j_fn(jnp.asarray(line), jnp.asarray(coords)))
    for a, b in zip(tgrad(t_fn, line, coords), jgrad(j_fn, line, coords)):
        close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["gather", "segsum", "onehot"])
def test_quad_sample_1d_modes_values_and_grads(rng, mode):
    """All three line modes against JAX's same mode (f32; segsum runs the
    K3 plain version here and JAX's Pallas kernel in interpret mode)."""
    c, d = 32, 23
    line = rng.normal(size=(c, d)).astype(np.float32)
    coords = rng.uniform(-1.1, 1.1, (700,)).astype(np.float32)

    def t_fn(line, coords):
        return tgrid.quad_sample_1d(tgrid.build_quad_line(line), d, coords, c, mode)

    def j_fn(line, coords):
        return jgrid.quad_sample_1d(jgrid.build_quad_line(line), d, coords, c, mode)

    close(t_fn(T(line), T(coords)), j_fn(jnp.asarray(line), jnp.asarray(coords)))
    for a, b in zip(tgrad(t_fn, line, coords), jgrad(j_fn, line, coords)):
        close(a, b, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="line mode"):
        tgrid.quad_sample_1d(tgrid.build_quad_line(T(line)), d, T(coords), c, "scatter")


def test_grid_sample_oracles_and_resize(rng):
    line = rng.normal(size=(3, 11)).astype(np.float32)
    plane = rng.normal(size=(3, 8, 9)).astype(np.float32)
    vol = rng.normal(size=(5, 6, 7)).astype(np.float32)
    c3 = rng.uniform(-1.1, 1.1, (200, 3)).astype(np.float32)
    close(tgrid.grid_sample_1d(T(line), T(c3[:, 0])), jgrid.grid_sample_1d(jnp.asarray(line), jnp.asarray(c3[:, 0])))
    close(tgrid.grid_sample_2d(T(plane), T(c3[:, :2])), jgrid.grid_sample_2d(jnp.asarray(plane), jnp.asarray(c3[:, :2])))
    close(tgrid.grid_sample_3d(T(vol), T(c3)), jgrid.grid_sample_3d(jnp.asarray(vol), jnp.asarray(c3)))
    close(tgrid.resize_align_corners_2d(T(plane), 13, 15),
          jgrid.resize_align_corners_2d(jnp.asarray(plane), 13, 15), atol=1e-5)
    close(tgrid.resize_align_corners_1d(T(line), 20),
          jgrid.resize_align_corners_1d(jnp.asarray(line), 20), atol=1e-5)


# ----------------------------- occupancy -----------------------------


def _blobs(rng, shape):
    """A binary volume of a few random balls (realistic occupancy)."""
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, n) for n in shape], indexing="ij")
    vol = np.zeros(shape, np.float32)
    for c in rng.uniform(-0.7, 0.7, (3, 3)):
        vol[(zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2 < 0.15] = 1.0
    return vol


def test_pack_and_occupancy_valid_exact(rng):
    vol = _blobs(rng, (9, 10, 11))
    packed_t = tocc.pack_alpha_corners(T(vol))
    packed_j = jocc.pack_alpha_corners(jnp.asarray(vol))
    assert packed_t.dtype == torch.uint8
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(packed_j))
    coords = rng.uniform(-1.1, 1.1, (5000, 3)).astype(np.float32)
    coords[:50] = np.round(coords[:50] * 4) / 4  # exact texel corners
    v_t = tocc.occupancy_valid(packed_t, vol.shape, T(coords))
    v_j = jocc.occupancy_valid(packed_j, vol.shape, jnp.asarray(coords))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert 0 < int(v_t.sum()) < len(coords)


@pytest.mark.parametrize("shape,ds", [((16, 16, 16), 4), ((13, 10, 7), 4), ((9, 9, 9), 2)])
def test_coarsen_alpha_end_padding_exact(rng, shape, ds):
    """Ragged ends: JAX pads with -inf at the END only, which the port does
    with F.pad before F.max_pool3d."""
    vol = _blobs(rng, shape)
    np.testing.assert_array_equal(
        tocc.coarsen_alpha(T(vol), ds).numpy(), np.asarray(jocc.coarsen_alpha(jnp.asarray(vol), ds)))


@pytest.mark.parametrize("m", [1, 5, 12])
def test_compact_valid_samples_exact(rng, m):
    valid = rng.uniform(0, 1, (40, 12)) < 0.4
    valid[:, -1] = False
    sel_t, sv_t = tocc.compact_valid_samples(T(valid), m)
    sel_j, sv_j = jocc.compact_valid_samples(jnp.asarray(valid), m)
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    np.testing.assert_array_equal(sv_t.numpy(), np.asarray(sv_j))


# ------------------------------ tensorf ------------------------------

GRID = (12, 10, 14)


def _cfgs(**kw):
    jcfg = jtf.TensorfConfig(grid_size=GRID, **kw)
    tcfg = ttf.TensorfConfig(grid_size=GRID, **kw)
    return jcfg, tcfg


def _field(seed=0, cfg=None, density_scale=1.0):
    """A random field as a JAX pytree of numpy arrays and as the port's
    module (shapes from JAX's init_tensorf, values from numpy)."""
    jcfg = cfg or jtf.TensorfConfig(grid_size=GRID)
    shapes = jax.eval_shape(lambda k: jtf.init_tensorf(k, jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        scale = 0.1 * (density_scale if "density" in name else 1.0)
        return (scale * rng.normal(size=s.shape)).astype(np.float32)

    jp = jax.tree_util.tree_map_with_path(fill, shapes)
    return jp, field_from_jax(jp, device="cpu")


def _flat(tree: dict, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def test_init_layout_matches_jax():
    jcfg, tcfg = _cfgs()
    shapes = jax.eval_shape(lambda k: jtf.init_tensorf(k, jcfg), jax.random.PRNGKey(0))
    field = ttf.init_tensorf(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = {k: tuple(v.shape) for k, v in _flat(shapes).items()}
    got = {k: tuple(p.shape) for k, p in field.named_parameters()}
    assert got == want
    assert field["mlp"]["w1"] is field.mlp.w1
    assert not field["mlp"]["b3"].detach().any()
    assert all(p.dtype == torch.float32 for p in field.parameters())


def test_config_rejects_unported_options():
    """The gather-emitter workarounds stay unported; the fused march and the
    three line modes construct, with JAX's line_mode (legacy flag wins)."""
    for kw in (dict(fused_plane_gather=True), dict(fused_fwd_gather=1), dict(fused_line_gather=True)):
        with pytest.raises(NotImplementedError):
            ttf.TensorfConfig(grid_size=GRID, **kw)
    with pytest.raises(ValueError):
        ttf.TensorfConfig(grid_size=GRID, line_bwd="scatter")
    assert ttf.TensorfConfig(grid_size=GRID, fused_march=True).fused_march
    for kw in (dict(), dict(line_bwd="segsum"), dict(line_bwd="gather"), dict(matmul_segsum=True),
               dict(line_bwd="gather", matmul_segsum=True)):
        assert ttf.TensorfConfig(grid_size=GRID, **kw).line_mode == jtf.TensorfConfig(grid_size=GRID, **kw).line_mode
    assert ttf.TensorfConfig(grid_size=GRID).n_samples == jtf.TensorfConfig(grid_size=GRID).n_samples


def test_normalize_and_combined_views(rng):
    jcfg, tcfg = _cfgs()
    pts = rng.uniform(-2.5, 2.5, (50, 3)).astype(np.float32)
    close(ttf.normalize_coord(T(pts), tcfg), jtf.normalize_coord(jnp.asarray(pts), jcfg))
    jp, field = _field()
    jv = jtf.build_combined_quad_views(jp, jcfg)
    tv = ttf.build_combined_quad_views(field, tcfg)
    for k in jv:
        np.testing.assert_array_equal(tv[k].detach().numpy(), np.asarray(jv[k]))


def test_density_app_features_and_grads(rng):
    """Binned plane backward on (min rows lowered) + one-hot line backward."""
    jcfg, tcfg = _cfgs(binned_min_rows=100)
    jp, field = _field()
    pts = rng.uniform(-1.05, 1.05, (600, 3)).astype(np.float32)

    def j_fn(p, x):
        sig, app = jtf.compute_density_app_features(p, x, jcfg, jtf.build_combined_quad_views(p, jcfg))
        return jnp.sum(sig * jnp.linspace(0, 1, sig.size)) + jnp.sum(app * jnp.linspace(-1, 1, app.size).reshape(app.shape))

    x_t = T(pts).requires_grad_(True)
    sig, app = ttf.compute_density_app_features(field, x_t, tcfg, ttf.build_combined_quad_views(field, tcfg))
    sig_j, app_j = jax.jit(
        lambda p, x: jtf.compute_density_app_features(p, x, jcfg, jtf.build_combined_quad_views(p, jcfg))
    )(jp, jnp.asarray(pts))
    close(sig, sig_j, atol=1e-5)
    close(app, app_j, atol=1e-5)
    loss = (sig * torch.linspace(0, 1, sig.numel())).sum() + (app * torch.linspace(-1, 1, app.numel()).reshape(app.shape)).sum()
    names = [n for n, _ in field.named_parameters()]
    g_t = dict(zip(names + ["x"], torch.autograd.grad(loss, list(field.parameters()) + [x_t], allow_unused=True)))
    g_pj, g_xj = jax.jit(jax.grad(j_fn, argnums=(0, 1)))(jp, jnp.asarray(pts))
    g_j = params_from_jax(jax.device_get(g_pj), device="cpu")
    for k, v in g_j.items():
        if k.startswith("mlp."):
            continue
        close(g_t[k], v.numpy(), rtol=1e-4, atol=1e-5)
    close(g_t["x"], g_xj, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("line_bwd", ["segsum", "gather"])
def test_density_app_features_line_modes(rng, line_bwd):
    """The segsum (K3) and gather line backwards inside the shared-gather
    features, f32 values and gradients against JAX."""
    jcfg, tcfg = _cfgs(binned_min_rows=100, line_bwd=line_bwd)
    jp, field = _field()
    pts = rng.uniform(-1.05, 1.05, (500, 3)).astype(np.float32)
    w_app = np.linspace(-1, 1, 500 * 27, dtype=np.float32).reshape(500, 27)

    def j_fn(p, x):
        sig, app = jtf.compute_density_app_features(p, x, jcfg, jtf.build_combined_quad_views(p, jcfg))
        return jnp.sum(sig * jnp.linspace(0, 1, sig.size)) + jnp.sum(app * w_app)

    x_t = T(pts).requires_grad_(True)
    sig, app = ttf.compute_density_app_features(field, x_t, tcfg, ttf.build_combined_quad_views(field, tcfg))
    loss = (sig * torch.linspace(0, 1, sig.numel())).sum() + (app * T(w_app)).sum()
    close(loss, jax.jit(j_fn)(jp, jnp.asarray(pts)), rtol=1e-5, atol=1e-4)
    names = [n for n, _ in field.named_parameters()]
    g_t = dict(zip(names + ["x"], torch.autograd.grad(loss, list(field.parameters()) + [x_t], allow_unused=True)))
    g_pj, g_xj = jax.jit(jax.grad(j_fn, argnums=(0, 1)))(jp, jnp.asarray(pts))
    for k, v in params_from_jax(jax.device_get(g_pj), device="cpu").items():
        if not k.startswith("mlp."):
            close(g_t[k], v.numpy(), rtol=1e-4, atol=1e-5)
    close(g_t["x"], g_xj, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fused_march_features_matches_jax(rng, dt):
    """fused_march_features (K4 plain, K2 plain behind the plane rows) vs
    JAX's (the Pallas kernels in interpret mode): sigma, rgb, and the
    gradients to every parameter and to the points (the pose path). f32 at
    rtol 1e-4 and 1e-4 of each gradient's largest entry; bf16 at the
    kernel's own bf16 tolerances, 2e-2 and 6e-2 of max."""
    from localrf_tpu.ops.pallas import march as jmarch
    from localrf_tpu_torch.ops.kernels import march as tmarch

    assert not tmarch.fused_march_supported(ttf.TensorfConfig(grid_size=(16, 16, 12)))
    f32 = dt == "float32"
    for k, (got, want) in _fused_march_vs_jax(rng, gather_dtype=dt, mlp_dtype=dt).items():
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        if k in ("sig", "rgb"):
            close(got, want, *((1e-4, 1e-5) if f32 else (2e-2, 2e-2)))
        else:
            assert err <= (1e-4 if f32 else 6e-2) * scale, f"{k}: {err:.2e} of max {scale:.2e}"


def _fused_march_vs_jax(rng, **kw) -> dict:
    """fused_march_features of the port and of JAX on one random field and
    600 points with random cotangents: {name: (port, JAX)} as f32 tensors
    for sig, rgb, every parameter's gradient and the points' ("x")."""
    from localrf_tpu.ops.pallas import march as jmarch
    from localrf_tpu_torch.ops.kernels import march as tmarch

    kw = dict(grid_size=(16, 16, 16), fused_march=True, binned_min_rows=100, **kw)
    jcfg, tcfg = jtf.TensorfConfig(**kw), ttf.TensorfConfig(**kw)
    assert tmarch.fused_march_supported(tcfg) and jmarch.fused_march_supported(jcfg)
    jp, field = _field(cfg=jcfg)
    pts = rng.uniform(-1.05, 1.05, (600, 3)).astype(np.float32)
    vd = rng.normal(size=(600, 3)).astype(np.float32)
    # random cotangents: a symmetric ramp would cancel the MLP gradients'
    # sums down to their f32 rounding
    w_sig = rng.normal(size=600).astype(np.float32)
    w_rgb = rng.normal(size=(600, 3)).astype(np.float32)

    def j_fn(p, x):
        sig, rgb = jmarch.fused_march_features(p, jtf.build_combined_quad_views(p, jcfg), x, jnp.asarray(vd), jcfg)
        return jnp.sum(sig * w_sig) + jnp.sum(rgb * w_rgb), (sig, rgb)

    x_t = T(pts).requires_grad_(True)
    sig, rgb = tmarch.fused_march_features(field, ttf.build_combined_quad_views(field, tcfg), x_t, T(vd), tcfg)
    (_, (sig_j, rgb_j)), (g_pj, g_xj) = jax.jit(jax.value_and_grad(j_fn, argnums=(0, 1), has_aux=True))(
        jp, jnp.asarray(pts))
    loss = (sig * T(w_sig)).sum() + (rgb * T(w_rgb)).sum()
    names = [n for n, _ in field.named_parameters()]
    g_t = dict(zip(names + ["x"], torch.autograd.grad(loss, list(field.parameters()) + [x_t], allow_unused=True)))
    want = {**params_from_jax(jax.device_get(g_pj), device="cpu"), "x": T(g_xj)}
    out = {"sig": (sig.detach(), T(sig_j)), "rgb": (rgb.detach(), T(rgb_j))}
    out.update({k: (g_t[k].detach().float(), v.float()) for k, v in want.items()})
    return out


def test_fused_march_with_segsum_lines_matches_jax(rng):
    """The fused march with the segsum line mode in bf16 (tables and MLP):
    the port builds f32 quad line views for that mode and casts them to
    bf16 for K4, JAX casts the lines before building the views; forward
    values agree as in test_fused_march_features_matches_jax, and the line
    tables' gradients to 1e-5 of their largest entry (measured: equal; JAX
    on the CPU adds the two quad-row cotangents of a line row in f32, as
    the port does, while a bf16 sum would miss by ~2e-3), the other
    gradients to 6e-2 of their largest entry."""
    got = _fused_march_vs_jax(rng, gather_dtype="bfloat16", mlp_dtype="bfloat16", line_bwd="segsum")
    lines = [k for k in got if "_line_" in k]
    assert len(lines) == 6
    for k, (port, want) in got.items():
        scale = float(want.abs().max())
        err = float((port - want).abs().max())
        if k in ("sig", "rgb"):
            close(port, want, 2e-2, 2e-2)
        else:
            assert err <= (1e-5 if k in lines else 6e-2) * scale, f"{k}: {err:.2e} of max {scale:.2e}"


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_apply_mlp(rng, dt):
    """f32 at the module tolerance; bf16 (hidden layers in bf16, the last one
    from bf16 inputs in f32) to bf16 tolerance."""
    jcfg, tcfg = _cfgs(mlp_dtype=dt, fea_pe=2, view_pe=2)
    jp, field = _field(cfg=jcfg)
    feat = rng.normal(size=(300, 27)).astype(np.float32)
    vd = rng.normal(size=(300, 3)).astype(np.float32)
    out_t = ttf.apply_mlp(field["mlp"], None, T(vd), T(feat), tcfg, refine=1.0)
    out_j = jtf.apply_mlp(jp["mlp"], None, jnp.asarray(vd), jnp.asarray(feat), jcfg, refine=1.0)
    assert out_t.dtype == torch.float32
    tol = (1e-5, 1e-6) if dt == "float32" else (2e-2, 1e-2)
    close(out_t, out_j, *tol)


def test_feature2density_and_tv(rng):
    jcfg, tcfg = _cfgs()
    feat = rng.normal(0, 8, (400,)).astype(np.float32)
    close(ttf.feature2density(T(feat), tcfg), jtf.feature2density(jnp.asarray(feat), jcfg))
    jp, field = _field()
    close(ttf.tv_loss_density(field), jtf.tv_loss_density(jp))
    close(ttf.tv_loss_app(field), jtf.tv_loss_app(jp))


@pytest.mark.parametrize("streamed,grid,ranks,scale,act", [
    pytest.param(False, (8, 12, 10), (8, 8, 8), 1.0, "softplus", id="False"),
    pytest.param(True, (8, 12, 10), (8, 8, 8), 1.0, "softplus", id="True"),
    # cubic grids, the kernel's on the card: on the CPU the blocked path
    pytest.param(True, (10, 10, 10), (8, 8, 8), 1.0, "softplus", id="cubic-8-8-8"),
    pytest.param(True, (10, 10, 10), (16, 4, 4), 1.0, "softplus", id="cubic-16-4-4"),
    # features of std ~20: voxels past softplus's threshold and under the clamp
    pytest.param(True, (10, 10, 10), (8, 8, 8), 20.0, "softplus", id="cubic-8-8-8-wide"),
    pytest.param(True, (10, 10, 10), (8, 8, 8), 1.0, "relu", id="cubic-relu"),
])
def test_density_l1_dense_and_streamed(monkeypatch, streamed, grid, ranks, scale, act):
    """The streamed/dense choice is TensorfConfig.l1_stream_min_vox in the
    port (env vars in JAX); both match JAX's dense sum, values and grads.
    On the CPU every grid, cubic (even and uneven ranks) or not, takes the
    blocked path: `l1.blocked` counts, `l1.kernel` does not."""
    jcfg = jtf.TensorfConfig(grid_size=grid, density_n_comp=ranks, fea2dense_act=act)
    tcfg = ttf.TensorfConfig(grid_size=grid, density_n_comp=ranks, fea2dense_act=act,
                             l1_stream_min_vox=1 if streamed else 10**9)
    monkeypatch.setattr(ttf, "L1_BLOCK_TARGET", 240)
    jp, field = _field(cfg=jcfg, density_scale=scale)
    names = [f"density_{part}_{i}" for part in ("plane", "line") for i in range(3)]
    profiling.RECORDER.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        val = ttf.density_l1(field, tcfg)
        counts = profiling.counters()
    assert counts.get("l1.blocked") == 1 and "l1.kernel" not in counts
    val_j, g_pj = jax.jit(jax.value_and_grad(lambda p: jtf.density_l1(p, jcfg)))(jp)
    close(val, val_j)
    g_t = dict(zip(names, torch.autograd.grad(val, [field[n] for n in names])))
    g_j = params_from_jax(jax.device_get(g_pj), device="cpu")
    for k in names:
        close(g_t[k], g_j[k].numpy(), rtol=1e-4, atol=1e-7)


def test_density_l1_kernel_has_no_cpu_route():
    """The kernel's wrapper launches or raises: a CPU tensor is refused (the
    program sends it to the blocked path), and so is a non-cubic grid."""
    planes = [torch.zeros(8, 10, 10) for _ in range(3)]
    lines = [torch.zeros(8, 10) for _ in range(3)]
    with pytest.raises(ValueError, match="no kernel"):
        l1_kernel.density_l1(planes, lines, -5.0)
    with pytest.raises(ValueError, match="cubic"):
        l1_kernel._check_cubic([torch.zeros(8, 10, 12)] * 3, lines)


def test_upsample_dense_alpha_and_alpha_volume():
    jcfg, tcfg = _cfgs(alpha_mask_thres=0.5)
    jp, field = _field(cfg=jcfg, density_scale=10.0)  # ~half the volume occupied
    new_t, cfg_t = ttf.upsample_tensorf(field, tcfg, (15, 13, 17))
    new_j = jax.jit(lambda p: jtf.upsample_tensorf(p, jcfg, (15, 13, 17))[0])(jp)
    cfg_j = jcfg.with_grid((15, 13, 17))
    assert cfg_t.grid_size == cfg_j.grid_size
    for k, v in params_from_jax(jax.device_get(new_j), device="cpu").items():
        close(new_t[k] if "." not in k else new_t["mlp"][k[4:]], v.numpy(), atol=1e-5)
    alpha_j, vol_j = jax.jit(lambda p: (jtf.compute_dense_alpha(p, jcfg, (12, 10, 14)),
                                        jtf.update_alpha_volume(p, jcfg, (12, 10, 14))))(jp)
    # alpha = 1 - exp(-sigma * step) of large sigmas: rtol 1e-4
    close(ttf.compute_dense_alpha(field, tcfg, (12, 10, 14)), alpha_j, rtol=1e-4, atol=1e-6)
    vol_t = ttf.update_alpha_volume(field, tcfg, (12, 10, 14))
    np.testing.assert_array_equal(vol_t.numpy(), np.asarray(vol_j))
    assert 0 < float(vol_t.mean()) < 1


# ------------------------------- optim -------------------------------


def test_gated_per_frame_adam(rng):
    p = rng.normal(size=(6, 3, 2)).astype(np.float32)
    st_t = toptim.adam_init(T(p), 5e-3, per_frame=True)
    st_j = joptim.adam_init(jnp.asarray(p), 5e-3, per_frame=True)
    pt, pj = T(p), jnp.asarray(p)
    for k in range(4):
        g = rng.normal(size=p.shape).astype(np.float32)
        gate = rng.uniform(size=6) < 0.6
        st_t = toptim.scale_lr(st_t, 0.9, T(gate))
        st_j = joptim.scale_lr(st_j, 0.9, jnp.asarray(gate))
        pt, st_t = toptim.adam_update(pt, T(g), st_t, T(gate))
        pj, st_j = joptim.adam_update(pj, jnp.asarray(g), st_j, jnp.asarray(gate))
    close(pt, pj)
    np.testing.assert_array_equal(st_t.step.numpy(), np.asarray(st_j.step))
    close(st_t.lr, st_j.lr)
    close(st_t.m, st_j.m)
    close(st_t.v, st_j.v)


def test_pytree_adam_tensor_gate_matches_jax(rng):
    """The gate is a 0-d bool tensor, as JAX's: off, it freezes parameters,
    moments and the step count (a tensor updated in place), so a replayed
    graph can run gated steps. Gates on, off, on against JAX's jitted
    update: rtol 1e-5 / atol 1e-6 (f32 rounding)."""
    jp, field = _field()
    lrs_t = toptim.field_base_lrs(field, 0.02, 1e-3)
    lrs_j = joptim.field_base_lrs(jp, 0.02, 1e-3)
    st_t = toptim.pytree_adam_init(field)
    st_j = joptim.pytree_adam_init(jp)
    step_t = st_t.step
    pj = jp
    for on in (True, False, True):
        g_j = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)), jp)
        before = {k: p.detach().clone() for k, p in field.named_parameters()}
        field, st_t = toptim.pytree_adam_update(field, params_from_jax(jax.device_get(g_j), device="cpu"), st_t,
                                                lrs_t, gate=torch.tensor(on))
        pj, st_j = jax.jit(joptim.pytree_adam_update)(pj, g_j, st_j, lrs_j, jnp.asarray(on))
        if not on:
            for k, p in field.named_parameters():
                assert torch.equal(p, before[k]), k
        assert st_t.step is step_t and int(st_t.step) == int(st_j.step)
    assert int(st_t.step) == 2
    want = params_from_jax(jax.device_get(pj), device="cpu")
    for k, p in field.named_parameters():
        close(p, want[k].numpy(), 1e-5, 1e-6)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_pytree_adam_in_place(rng, moment_dtype):
    jp, field = _field()
    lrs_t = toptim.field_base_lrs(field, 0.02, 1e-3)
    lrs_j = joptim.field_base_lrs(jp, 0.02, 1e-3)
    assert lrs_t == _flat(lrs_j)
    st_t = toptim.pytree_adam_init(field, moment_dtype)
    st_j = joptim.pytree_adam_init(jp, moment_dtype)
    pj = jp
    for k in range(2):
        g_j = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)), jp)
        g_t = params_from_jax(jax.device_get(g_j), device="cpu")
        field, st_t = toptim.pytree_adam_update(field, g_t, st_t, lrs_t)
        pj, st_j = jax.jit(joptim.pytree_adam_update)(pj, g_j, st_j, lrs_j)
        st_t = st_t._replace(lr_scale=st_t.lr_scale * 0.95)
        st_j = st_j._replace(lr_scale=st_j.lr_scale * 0.95)
    assert st_t.step.shape == () and int(st_t.step) == int(st_j.step)
    tol = (1e-5, 1e-6) if moment_dtype == "float32" else (1e-2, 1e-4)
    want = params_from_jax(jax.device_get(pj), device="cpu")
    for k, p in field.named_parameters():
        close(p, want[k].numpy(), *tol)
    m_j = params_from_jax(jax.device_get(st_j.m), device="cpu")
    assert st_t.m["density_plane_0"].dtype == getattr(torch, moment_dtype)
    close(st_t.m["mlp.w2"].float(), m_j["mlp.w2"].float().numpy(), *tol)


# ------------------------------- imports -------------------------------


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax or anything
    of the JAX package (source scan: `localrf_tpu` itself, even its
    numpy-only modules), and importing the port's modules (the checkpoint,
    config, train and renderer modules, utils/, preprocess/ and parallel/ included) and chip_smoke
    in a fresh interpreter loads neither."""
    files = [*sorted((REPO / "localrf_tpu_torch").rglob("*.py")), REPO / "chip_smoke.py"]
    n_imports = 0
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            for n in names:
                n_imports += 1
                assert n.split(".")[0] not in ("jax", "jaxlib", "localrf_tpu"), f"{path}: imports {n}"
    assert n_imports > 50
    code = (
        "import sys\n"
        "def loaded():\n"
        "    return sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'localrf_tpu'})\n"
        "pre = loaded()\n"
        "import localrf_tpu_torch, localrf_tpu_torch.convert, localrf_tpu_torch.optim\n"
        "import localrf_tpu_torch.models.local, localrf_tpu_torch.models.render, localrf_tpu_torch.models.graph\n"
        "import localrf_tpu_torch.models.step, localrf_tpu_torch.models.tensorf\n"
        "import localrf_tpu_torch.ops.kernels.composite, localrf_tpu_torch.ops.kernels.binned_scatter\n"
        "import localrf_tpu_torch.ops.kernels.segsum, localrf_tpu_torch.ops.kernels.march\n"
        "import localrf_tpu_torch.data.dataset, localrf_tpu_torch.data.flow_io, localrf_tpu_torch.data.pool\n"
        "import localrf_tpu_torch.utils.metrics, localrf_tpu_torch.utils.lpips\n"
        "import localrf_tpu_torch.utils.spline, localrf_tpu_torch.utils.vis, localrf_tpu_torch.utils.mesh\n"
        "import localrf_tpu_torch.preprocess.flow_vis, localrf_tpu_torch.preprocess.raft\n"
        "import localrf_tpu_torch.preprocess.convert, localrf_tpu_torch.preprocess.run_flow\n"
        "import localrf_tpu_torch.preprocess.dpt, localrf_tpu_torch.preprocess.run_depth\n"
        "import localrf_tpu_torch.checkpoint, localrf_tpu_torch.config, localrf_tpu_torch.renderer\n"
        "import localrf_tpu_torch.parallel.sharding, localrf_tpu_torch.parallel.sp\n"
        "import localrf_tpu_torch.utils.profiling\n"
        "import localrf_tpu_torch.train\n"
        "import chip_smoke\n"
        "print(pre, loaded())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "[]"], out.stdout


def _dataset_arrays(seed: int, n_frames: int = 9, h: int = 6, w: int = 10) -> dict:
    rng = np.random.default_rng(seed)
    shape = (n_frames, h, w)
    return dict(
        rgbs=rng.random((*shape, 3), dtype=np.float32),
        invdepths=0.1 + 0.9 * rng.random(shape, dtype=np.float32),
        fwd_flow=rng.normal(0, 1, (*shape, 2)).astype(np.float32),
        fwd_mask=(rng.random(shape) > 0.2).astype(np.float32),
        bwd_flow=rng.normal(0, 1, (*shape, 2)).astype(np.float32),
        bwd_mask=(rng.random(shape) > 0.2).astype(np.float32),
    )


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_torch_dataset_matches_jax(seed):
    """The port's copy of the datasets (localrf_tpu_torch/data/dataset.py)
    and the JAX package's give identical batches from the same data: rgb,
    flow, depth, masks, indices and views, across n_views, the coarse and
    refining samplers, index-only batches and a slid window with held-out
    test frames; and their pixel pools hold identical contents."""
    from localrf_tpu.data import pool as jpool
    from localrf_tpu.data.dataset import SyntheticDataset as JSyntheticDataset
    from localrf_tpu_torch.data.dataset import SyntheticDataset
    from localrf_tpu_torch.data.pool import DevicePixelPool

    arrays = _dataset_arrays(seed)
    kw = dict(n_init_frames=6, test_frame_every=4, frames_chunk=3)
    ds_j = JSyntheticDataset(arrays["rgbs"], "train", **{k: v for k, v in arrays.items() if k != "rgbs"}, **kw)
    ds_t = SyntheticDataset(arrays["rgbs"], "train", **{k: v for k, v in arrays.items() if k != "rgbs"}, **kw)
    pool_j, pool_t = jpool.DevicePixelPool(ds_j, capacity=8), DevicePixelPool(ds_t, capacity=8, device="cpu")
    n_batches = 0
    for rnd in range(3):
        if rnd:
            for ds in (ds_j, ds_t):
                ds.activate_frames(1)
                ds.deactivate_frames(ds.active_frames_bounds[0] + 1)
        assert ds_t.active_frames_bounds == ds_j.active_frames_bounds
        for n_views, refining, poses, values in [(4, True, True, True), (8, False, True, True),
                                                 (2, True, False, True), (4, False, True, False)]:
            bj = ds_j.sample(8 * n_views, refining, poses, n_views=n_views, values=values)
            bt = ds_t.sample(8 * n_views, refining, poses, n_views=n_views, values=values)
            assert bt.keys() == bj.keys()
            for k, v in bj.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(bt[k], v, err_msg=k)
                else:
                    assert bt[k] == v, k
            n_batches += 1
        pool_j.sync()
        pool_t.sync()
        assert pool_t.slot_of_frame == pool_j.slot_of_frame
        for k, v in pool_j.arrays.items():
            np.testing.assert_array_equal(pool_t.arrays[k].numpy(), np.asarray(v), err_msg=k)
    assert n_batches == 12


def test_entry_points_default_to_the_card():
    """LocalTensorfs, DevicePixelPool and the convert.py functions run on
    the card unless the caller asks for the CPU (signature defaults; the
    CPU tests pass device="cpu"). Without a card, asking for it raises:
    nothing falls back to the CPU."""
    import inspect

    from localrf_tpu_torch import convert
    from localrf_tpu_torch.data.dataset import SyntheticDataset
    from localrf_tpu_torch.data.pool import DevicePixelPool
    from localrf_tpu_torch.models.local import LocalTensorfs

    fns = [LocalTensorfs.__init__, DevicePixelPool.__init__, convert.params_from_jax,
           convert.field_from_jax, convert.adam_from_jax, convert.pose_from_jax]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    if not torch.cuda.is_available():
        arrays = _dataset_arrays(0)
        ds = SyntheticDataset(arrays["rgbs"], "train", n_init_frames=2, test_frame_every=0)
        with pytest.raises((RuntimeError, AssertionError)):
            DevicePixelPool(ds, capacity=2)
        with pytest.raises((RuntimeError, AssertionError)):
            convert.params_from_jax({"w": np.ones(3, np.float32)})


def test_full_f32_scopes_tf32_off_and_restores():
    """Inside full_f32 cuDNN convolutions and cuBLAS matmuls are "ieee"
    (full f32) whatever the caller set; on exit, also after a raise, the
    caller's settings come back; it works as a decorator too."""
    conv, matmul = torch.backends.cudnn.conv, torch.backends.cuda.matmul
    saved = conv.fp32_precision, matmul.fp32_precision
    try:
        conv.fp32_precision, matmul.fp32_precision = "tf32", "tf32"
        with tmath.full_f32():
            assert (conv.fp32_precision, matmul.fp32_precision) == ("ieee", "ieee")
        assert (conv.fp32_precision, matmul.fp32_precision) == ("tf32", "tf32")
        with pytest.raises(KeyError), tmath.full_f32():
            raise KeyError
        assert (conv.fp32_precision, matmul.fp32_precision) == ("tf32", "tf32")

        @tmath.full_f32()
        def inside():
            return conv.fp32_precision, matmul.fp32_precision

        assert inside() == ("ieee", "ieee") and conv.fp32_precision == "tf32"
    finally:
        conv.fp32_precision, matmul.fp32_precision = saved


def test_metrics_and_preprocess_networks_convolve_in_full_f32(monkeypatch):
    """Every conv2d of rgb_ssim, rgb_lpips, RAFT and DPT runs inside
    full_f32, under torch's default flags (cuDNN's TF32 allowed): recorded
    at each call of F.conv2d, so the scope is checked here even though the
    CPU has no TF32."""
    from localrf_tpu_torch.preprocess.dpt import DPT, DPTConfig
    from localrf_tpu_torch.preprocess.raft import RAFT
    from localrf_tpu_torch.utils.metrics import rgb_lpips, rgb_ssim

    assert torch.backends.cudnn.conv.fp32_precision == "tf32"  # torch's default
    seen = []
    conv2d = torch.nn.functional.conv2d

    def recording(*args, **kw):
        seen.append((torch.backends.cudnn.conv.fp32_precision, torch.backends.cuda.matmul.fp32_precision))
        return conv2d(*args, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv2d", recording)
    img = np.random.default_rng(0).uniform(0, 1, (40, 48, 3)).astype(np.float32)
    rgb_ssim(img, img * 0.9, 1.0)
    rgb_lpips(img, img * 0.9)
    x = torch.rand(1, 3, 16, 16) * 255
    RAFT()(x, x, iters=1)
    cfg = DPTConfig(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32, image_size=32,
                    out_indices=(0, 0, 0, 0), neck_hidden_sizes=(4, 8, 16, 16), fusion_hidden_size=8)
    DPT(cfg)(torch.rand(1, 3, 32, 32))
    assert len(seen) > 50 and set(seen) == {("ieee", "ieee")}
    assert torch.backends.cudnn.conv.fp32_precision == "tf32"
