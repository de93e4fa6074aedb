"""Port parity of the grid-sample route (`TensorfConfig.fast_gather=False`:
bilinear lookups in the f32 factor grids, JAX's oracle) with its top-K
appearance shading (`app_top_k`), of compute_dense_alpha on that route,
and of K4-bwd's fixed-order line gradient in plain PyTorch.

Inputs are made from seeds with numpy (rays, march-core inputs) and by JAX
(the field init, carried across with params_from_jax); JAX runs jitted,
f32. Tolerances: rgb and depth rtol 1e-4 / atol 1e-5 (depth atol 1e-4),
gradients to 1e-4 of each tensor's largest entry (summation orders
differ). Top-K: culled samples all weigh 0, so many weights tie, and
torch.topk and jax.lax.top_k may pick different zero-weight samples; such
a sample is masked out of the colour and adds 0 to every gradient, so the
outputs and gradients are compared, never the indices.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import _march_inputs, _torch_march_args
from test_torch_slice import T, _ball, grad_close, jax_noise

from localrf_tpu.models import render as jrender
from localrf_tpu.models import tensorf as jtf
from localrf_tpu.ops.pallas import march as jmarch
from localrf_tpu_torch.convert import field_from_jax, params_from_jax
from localrf_tpu_torch.models import render as trender
from localrf_tpu_torch.models import tensorf as ttf
from localrf_tpu_torch.ops.kernels import march as k4

GRID = (16, 16, 16)
N_SAMPLES = 48


def _rays(n=17):
    """tests/test_topk_and_sharding.py's rays."""
    rng = np.random.default_rng(5)
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


# app_top_k: (is_train, alpha volume) — K = 0 dense shading, K = 12 of 48
# with a ball that culls most samples of the rays outside it (ties at
# weight 0), K = 47 (every sample but one) in eval
TOPK_CASES = {0: (True, False), 12: (True, True), 47: (False, False)}


@pytest.mark.parametrize("k", list(TOPK_CASES))
def test_grid_route_with_top_k_matches_jax(k):
    """render_rays on the grid-sample route: rgb, depth and the gradients of
    every parameter and of the rays against JAX's; with pallas_composite
    (K1's plain version) and the late-view head with a feature PE."""
    is_train, with_alpha = TOPK_CASES[k]
    kw = dict(grid_size=GRID, fast_gather=False, app_top_k=k, pallas_composite=True, fea_pe=2)
    jcfg, tcfg = jtf.TensorfConfig(**kw), ttf.TensorfConfig(**kw)
    jp = jax.device_get(jtf.init_tensorf(jax.random.PRNGKey(0), jcfg))
    field = field_from_jax(jp, device="cpu")
    o, d = _rays()
    alpha = _ball((8, 9, 10), radius=0.4) if with_alpha else None
    rng = np.random.default_rng(4)
    wr = rng.normal(size=(o.shape[0], 3)).astype(np.float32)
    wd = rng.normal(size=(o.shape[0],)).astype(np.float32) * 1e-3
    key = jax.random.PRNGKey(1)

    def j_fn(p, o, d):
        rgb, depth = jrender.render_rays(
            p, jcfg, o, d, is_train=is_train, white_bg=not is_train, n_samples=N_SAMPLES,
            alpha_volume=None if alpha is None else jnp.asarray(alpha), key=key if is_train else None)
        return jnp.sum(rgb * wr) + jnp.sum(depth * wd), (rgb, depth)

    (_, (rgb_j, depth_j)), g_j = jax.jit(jax.value_and_grad(j_fn, argnums=(0, 1, 2), has_aux=True))(
        jp, jnp.asarray(o), jnp.asarray(d))
    ot, dt = T(o).requires_grad_(True), T(d).requires_grad_(True)
    rgb, depth = trender.render_rays(
        field, tcfg, ot, dt, is_train=is_train, white_bg=not is_train, n_samples=N_SAMPLES,
        alpha_volume=None if alpha is None else T(alpha),
        noise=jax_noise(key, N_SAMPLES) if is_train else None)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(rgb_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(depth.detach().numpy(), np.asarray(depth_j), rtol=1e-4, atol=1e-4)
    loss = (rgb * T(wr)).sum() + (depth * T(wd)).sum()
    names = [n for n, _ in field.named_parameters()]
    grads = torch.autograd.grad(loss, list(field.parameters()) + [ot, dt], allow_unused=True)
    got = dict(zip(names + ["o", "d"], grads))
    want = {**params_from_jax(jax.device_get(g_j[0]), device="cpu"), "o": g_j[1], "d": g_j[2]}
    for name, v in want.items():
        grad_close(got[name] if got[name] is not None else torch.zeros(v.shape), np.asarray(v))


def test_grid_route_equals_quad_route_and_top_k_covering_every_sample():
    """The same math on both routes (test_topk_and_sharding's oracle check):
    the grid-sample route with K = 0 against the quad route to 1e-5, and
    with K = 47 of 48 samples against K = 0 (the last sample is the
    terminator, weight of the background only) to 1e-5."""
    jp = jax.device_get(jtf.init_tensorf(jax.random.PRNGKey(0), jtf.TensorfConfig(grid_size=GRID)))
    field = field_from_jax(jp, device="cpu")
    o, d = (T(a) for a in _rays())
    out = {}
    for name, kw in (("quad", dict(fused_march=False)), ("grid", dict(fast_gather=False)),
                     ("top47", dict(fast_gather=False, app_top_k=47))):
        cfg = ttf.TensorfConfig(grid_size=GRID, **kw)
        with torch.no_grad():
            out[name] = trender.render_rays(field, cfg, o, d, is_train=False, white_bg=True, n_samples=N_SAMPLES)
    for name in ("grid", "top47"):
        for got, want in zip(out[name], out["quad"]):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_compute_dense_alpha_on_the_grid_route_matches_jax():
    """compute_dense_alpha with fast_gather=False against JAX's (both dense
    and, above the slab threshold, in x-slabs) and against the quad route."""
    kw = dict(grid_size=(18, 14, 22), fast_gather=False)
    jcfg, tcfg = jtf.TensorfConfig(**kw), ttf.TensorfConfig(**kw)
    jp = jax.device_get(jtf.init_tensorf(jax.random.PRNGKey(2), jcfg))
    # a field with density: shift the density grids up
    for i in range(3):
        jp[f"density_plane_{i}"] = jp[f"density_plane_{i}"] + 0.6
        jp[f"density_line_{i}"] = jp[f"density_line_{i}"] + 0.6
    field = field_from_jax(jp, device="cpu")
    lattice = (20, 17, 23)
    want = np.asarray(jtf.compute_dense_alpha(jp, jcfg, lattice))
    got = ttf.compute_dense_alpha(field, tcfg, lattice).numpy()
    assert want.max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    quad = ttf.compute_dense_alpha(field, dataclasses.replace(tcfg, fast_gather=True), lattice).numpy()
    np.testing.assert_allclose(got, quad, rtol=1e-5, atol=1e-6)
    small = ttf._DENSE_ALPHA_CHUNK_PTS
    try:
        ttf._DENSE_ALPHA_CHUNK_PTS = 64  # the x-slab loop
        # the same values, batched another way: the CPU's vectorised sums
        # over the 8 channels may round an f32 ulp apart
        np.testing.assert_allclose(ttf.compute_dense_alpha(field, tcfg, lattice).numpy(), got,
                                   rtol=1e-6, atol=1e-7)
    finally:
        ttf._DENSE_ALPHA_CHUNK_PTS = small


def test_sample_alpha_is_the_trilinear_alpha_volume_lookup():
    """sample_alpha against JAX's at world points inside and outside the aabb."""
    alpha = _ball((8, 9, 10), radius=0.5)
    pts = np.random.default_rng(0).uniform(-2.5, 2.5, (300, 3)).astype(np.float32)
    cfg = dict(grid_size=GRID)
    want = np.asarray(jtf.sample_alpha(jnp.asarray(alpha), jnp.asarray(pts), jtf.TensorfConfig(**cfg)))
    got = ttf.sample_alpha(T(alpha), T(pts), ttf.TensorfConfig(**cfg)).numpy()
    assert (want > 0).any() and (want == 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# -------------------- K4-bwd's fixed-order line gradient --------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fixed_order_line_gradient_plain_matches_index_add_and_jax(rng, dtype):
    """K4-bwd's fixed-order route in plain PyTorch (march_dlines_ordered of
    march_line_cotangents_plain: K3's order over the per-point cotangents)
    against march_bwd_plain's index_add_ (rtol 1e-4 / atol 1e-5 of the
    largest entry: the same f32 adds in another order) and against JAX's
    Pallas _march_bwd in interpret mode (1e-5 of the largest entry in f32;
    6e-2 in bf16, where the two round backward intermediates at different
    places, as test_march_core_plain_matches_pallas)."""
    d = _march_inputs(rng, p=3000, g=24)
    p = d["wxy"].shape[0]
    tdt = getattr(torch, dtype)
    args = [a.detach() for a in _torch_march_args(d, tdt)]
    gout = T(d["gout"])
    d_lr = k4.march_line_cotangents_plain(*args, gout, dtype)
    assert d_lr.shape == (3, p, 64) and d_lr.dtype == tdt
    fixed = k4.march_dlines_ordered(args[5], d_lr, 24)
    assert fixed.dtype == torch.float32 and fixed.shape == (3, 24, 64)
    assert torch.equal(fixed, k4.march_dlines_ordered(args[5], d_lr, 24))
    dlines = k4.march_bwd_plain(*args, gout, dtype)[5]
    scale = float(dlines.float().abs().max())
    np.testing.assert_allclose(fixed.to(tdt).float().numpy(), dlines.float().numpy(),
                               rtol=1e-4 if dtype == "float32" else 1e-2, atol=1e-5 * scale)

    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    aux = np.concatenate([d["wxy"], d["w1l"], d["x0"].astype(np.float32), d["vd"], np.zeros((p, 1), np.float32)], -1)
    jargs = [jnp.asarray(r, jdt) for r in d["rows"]] + [
        jnp.asarray(aux), jnp.asarray(d["lines"], jdt), jnp.asarray(d["basis"]), jnp.asarray(d["w1"]),
        jnp.asarray(d["b1"][None]), jnp.asarray(d["w2"]), jnp.asarray(d["b2"][None]),
        jnp.asarray(np.concatenate([d["w3"], d["b3"][None]])),
    ]
    _, vjp = jax.vjp(lambda *a: jmarch.march_core(*a, dtype), *jargs)
    want = np.asarray(vjp(jnp.asarray(np.concatenate([d["gout"], np.zeros((p, 4), np.float32)], -1)))[4],
                      np.float32)
    err = float(np.abs(fixed.to(tdt).float().numpy() - want).max())
    assert err <= (1e-5 if dtype == "float32" else 6e-2) * float(np.abs(want).max())
