"""Port parity of the eval path: render_rays' floater suppression,
LocalTensorfs.forward_eval over two blended fields (render_frame for one
view, render_chunk for several) and the metrics, against the JAX package
on the CPU.

Setup: a JAX model and the port's with the same two fields (the first
field's weights carried across with params_from_jax before the spawn, the
second's after it; the density planes scaled up so that rays saturate), a
ball alpha volume on both fields with occ_m 12 (coarse probe + compaction,
which floater_thresh turns off), K1 on (its plain version here, the Pallas
kernel in interpret mode on the JAX side), and the same perturbed poses,
exposures and intrinsics. Frames of 40x30; the spawn cross-fades the last
3 of 7 frames.

Tolerances: rgb and depth rtol 1e-4 / atol 1e-4 in f32 and with bf16
tables and MLP; directions and pixel coordinates to 1e-6. With bf16 tables
the JAX side runs op by op (`jax.disable_jit()`): XLA's CPU compiler fuses
the f32 sample positions' multiply-adds, and a position one f32 ulp away
can round a bf16 lerp weight to its neighbour. Jitted JAX and JAX op by op
then differ by 1.4e-4 of one ray's depth in 1,200 (measured), while the
port rounds where JAX's ops do (within 8e-6 of JAX op by op). PSNR to rtol 1e-6 and SSIM to
atol 1e-5 against JAX's float64 numpy (the port computes in float32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localrf_tpu.models import local as jlocal
from localrf_tpu.models import render as jrender
from localrf_tpu.models import tensorf as jtf
from localrf_tpu.utils import metrics as jmetrics
from localrf_tpu_torch.convert import field_from_jax
from localrf_tpu_torch.models import local as tlocal
from localrf_tpu_torch.models import render as trender
from localrf_tpu_torch.models import tensorf as ttf
from localrf_tpu_torch.optim import pytree_adam_init
from localrf_tpu_torch.utils import metrics as tmetrics

W, H = 40, 30
TF_KW = dict(grid_size=(24, 24, 24), pallas_composite=True, binned_min_rows=100)
BF16 = dict(gather_dtype="bfloat16", mlp_dtype="bfloat16")
OCC_M = 12


def T(x):
    return torch.from_numpy(np.array(x, copy=True))


def _ball(shape, radius=0.55):
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, n) for n in shape], indexing="ij")
    return ((xx**2 + yy**2 + zz**2) < radius**2).astype(np.float32)


def _opaque(jp: dict) -> dict:
    """JAX field params with the density planes scaled by 20: rays then
    saturate inside the ball instead of passing through nearly empty."""
    return {k: (v * 20 if k.startswith("density_plane") else v) for k, v in jp.items()}


def _carry(jm, tm):
    """The port's current field := JAX's (density planes scaled), on both."""
    jp = _opaque(jax.device_get(jm.fields[-1]["params"]))
    jm.fields[-1]["params"] = jax.tree.map(jnp.asarray, jp)
    field = field_from_jax(jp, device="cpu")
    tm.fields[-1]["params"] = field
    tm.fields[-1]["opt"] = pytree_adam_init(field)


def two_field_models(tf_kw=None, **local_kw):
    """JAX and port models with 7 frames, perturbed poses, exposures and
    intrinsics, and a second field spawned over the last 3 frames; both
    fields with the ball alpha volume at occ_m 12."""
    tf = dict(TF_KW, **(tf_kw or {}))
    common = dict(WH=(W, H), n_init_frames=4, n_views=4, batch_size=128, n_overlap=3, **local_kw)
    jm = jlocal.LocalTensorfs(jlocal.LocalConfig(tensorf=jtf.TensorfConfig(**tf), **common))
    tm = tlocal.LocalTensorfs(tlocal.LocalConfig(tensorf=ttf.TensorfConfig(**tf), **common), device="cpu")
    _carry(jm, tm)
    rng = np.random.default_rng(3)
    n = 7
    r = (np.eye(3, dtype=np.float32)[:, :2] + 0.05 * rng.normal(size=(n, 3, 2))).astype(np.float32)
    t = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    e = (np.eye(3) + 0.05 * rng.normal(size=(n, 3, 3))).astype(np.float32)
    for m in (jm, tm):
        for _ in range(3):
            m.append_frame()
        m.r_all[:], m.t_all[:], m.exp_all[:] = r, t, e
        m._build_window()
        m.append_rf(3)
    _carry(jm, tm)
    jm.intr = jm.intr._replace(params={"focal_offset": jnp.asarray(1.03, jnp.float32),
                                       "center_rel": jnp.asarray([0.48, 0.53], jnp.float32)})
    tm.intr.params["focal_offset"] = torch.tensor(1.03)
    tm.intr.params["center_rel"] = torch.tensor([0.48, 0.53])
    alpha = _ball((12, 12, 12))
    for fj, ft in zip(jm.fields, tm.fields):
        fj["alpha_volume"] = jnp.asarray(alpha)
        ft["alpha_volume"] = T(alpha)
        fj["cfg"] = dataclasses.replace(fj["cfg"], occ_m=OCC_M)
        ft["cfg"] = dataclasses.replace(ft["cfg"], occ_m=OCC_M)
    return jm, tm


# ------------------------------ render_rays ------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_rays_floater_thresh_matches_jax(rng, dtype):
    """floater_thresh 0.5 with an alpha volume and occ_m set: no compaction,
    no K1, the plain alpha2weights re-weighted by sample index (JAX
    render.py:96, 234, 245-250); and the port's K1 wrapper is not called."""
    kw = dict(TF_KW, occ_m=OCC_M, **(BF16 if dtype == "bfloat16" else {}))
    jcfg, tcfg = jtf.TensorfConfig(**kw), ttf.TensorfConfig(**kw)
    jp = _opaque(jax.device_get(jtf.init_tensorf(jax.random.PRNGKey(3), jcfg)))
    o = rng.uniform(-0.4, 0.4, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    alpha = _ball((10, 11, 12))
    rgb_j, depth_j = jax.jit(lambda p, o, d: jrender.render_rays(
        p, jcfg, o, d, is_train=False, white_bg=True, floater_thresh=0.5, alpha_volume=jnp.asarray(alpha),
    ))(jax.tree.map(jnp.asarray, jp), jnp.asarray(o), jnp.asarray(d))
    from localrf_tpu_torch.ops.kernels import composite

    calls = []
    orig = composite.fused_weights
    composite.fused_weights = lambda *a: calls.append(1) or orig(*a)
    try:
        rgb, depth = trender.render_rays(field_from_jax(jp, device="cpu"), tcfg, T(o), T(d), is_train=False,
                                         white_bg=True, floater_thresh=0.5, alpha_volume=T(alpha))
        trender.render_rays(field_from_jax(jp, device="cpu"), tcfg, T(o), T(d), is_train=False,
                            white_bg=True, alpha_volume=T(alpha))
    finally:
        composite.fused_weights = orig
    assert len(calls) == 1  # the render without floater_thresh only
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(rgb_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(depth.detach().numpy(), np.asarray(depth_j), rtol=1e-4, atol=1e-4)
    assert float(np.abs(np.asarray(rgb_j) - 1.0).max()) > 0.1  # the rays hit density


# ------------------------------ forward_eval ------------------------------

EVAL_CASES = {
    # name: (view_ids, forward_eval kwargs, LocalConfig overrides)
    "one-view-blended": ([5], {}, {}),
    "one-view-retired-field-only": ([1], {}, {}),
    "two-views": ([5, 1], {}, {}),
    "test-id-first-frame": ([0], dict(test_id=True), {}),
    "floater": ([5], dict(floater_thresh=0.5), {}),
    "fov360-two-views": ([6, 4], {}, dict(fov=360.0)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_forward_eval_matches_jax(case, dtype):
    """forward_eval's rgb, depth, directions and pixel coordinates equal
    JAX's: the single-view fast path (render_frame, chunks padded with ray
    id 0) on a frame inside the cross-fade (0 < w < 1 on both fields) and
    on one only the retired field covers (its host params uploaded), the
    multi-view path (render_chunk), test_id's neighbour exposure on frame 0
    (whose previous neighbour is frame 1), floater_thresh and 360 rays."""
    views, kw, local_kw = EVAL_CASES[case]
    jm, tm = two_field_models(BF16 if dtype == "bfloat16" else None, **local_kw)
    assert tm.fields[0]["opt"] is None
    per_view = np.random.default_rng(1).permutation(W * H)[:W * H if len(views) == 1 else 500]
    ids = np.concatenate([per_view] * len(views))
    chunk = 512  # frames of 1,200 rays: the last chunk is padded
    with jax.disable_jit(dtype == "bfloat16"):  # see the module docstring
        rgb_j, depth_j, dirs_j, ij_j = jm.forward_eval(ids, np.array(views), W, H, chunk=chunk, **kw)
    rgb, depth, dirs, ij = tm.forward_eval(ids, np.array(views), W, H, chunk=chunk, **kw)
    for got in (rgb, depth, dirs, ij):
        assert isinstance(got, torch.Tensor) and got.device == tm.device
    np.testing.assert_allclose(rgb.numpy(), rgb_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(depth.numpy(), depth_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dirs.numpy(), dirs_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ij.numpy(), ij_j)
    assert float(rgb.min()) >= 0 and float(rgb.max()) <= 1
    assert float(np.abs(rgb_j - 1.0).max()) > 0.1  # the rays hit density
    bw = tm.blending_weights[views]
    if case == "one-view-blended":
        assert (0 < bw).all() and (bw < 1).all()
    if case == "one-view-retired-field-only":
        assert bw[0, 1] == 0 and "_dev_cache" in tm.fields[0]


def test_forward_eval_rejects_views_without_a_field():
    _, tm = two_field_models()
    with pytest.raises(RuntimeError, match="No valid field"):
        tm.forward_eval(np.arange(10), np.array([5]), W, H, blending_weights=np.zeros((1, 2), np.float32))


def test_eval_cache_uploads_a_retired_field_once():
    """The retired field's host params go through the eval cache, built
    once per host module and reused; clear_eval_cache drops it; the current
    field renders from its live params (no cache)."""
    _, tm = two_field_models()
    host = tm.fields[0]["params"]
    assert all(p.device.type == "cpu" for p in host.parameters())
    made = []
    orig = tlocal.TensorfField
    tlocal.TensorfField = lambda tensors: made.append(1) or orig(tensors)
    try:
        ids = np.arange(W * H)
        first = tm.forward_eval(ids, np.array([5]), W, H, chunk=600)[0]
        second = tm.forward_eval(ids, np.array([5]), W, H, chunk=600)[0]
        assert len(made) == 1
        cached = tm.fields[0]["_dev_cache"]
        assert cached[0] is host and "_dev_cache" not in tm.fields[1]
        assert tm._eval_params(tm.fields[1]) is tm.fields[1]["params"]
        torch.testing.assert_close(first, second, rtol=0, atol=0)
        tm.clear_eval_cache()
        assert all("_dev_cache" not in f for f in tm.fields)
        tm.forward_eval(ids, np.array([5]), W, H, chunk=600)
        assert len(made) == 2
    finally:
        tlocal.TensorfField = orig


# ------------------------------ metrics ------------------------------


@pytest.mark.parametrize("shape,noise", [((30, 40, 3), 0.1), ((64, 48, 3), 0.02), ((23, 57, 3), 0.3)])
def test_metrics_match_jax(shape, noise):
    """rgb_psnr to rtol 1e-6 and rgb_ssim (mean and map) to atol 1e-5
    against JAX utils/metrics.py; the metrics take tensors or arrays."""
    rng = np.random.default_rng(shape[0])
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + noise * rng.normal(size=shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(tmetrics.rgb_psnr(T(a), T(b)), jmetrics.rgb_psnr(a, b), rtol=1e-6)
    np.testing.assert_allclose(tmetrics.rgb_psnr(a, b), jmetrics.rgb_psnr(a, b), rtol=1e-6)
    np.testing.assert_allclose(tmetrics.rgb_ssim(T(a), T(b), 1.0), jmetrics.rgb_ssim(a, b, 1.0), atol=1e-5)
    ssim_map = tmetrics.rgb_ssim(a, b, 1.0, return_map=True)
    np.testing.assert_allclose(ssim_map.numpy(), jmetrics.rgb_ssim(a, b, 1.0, return_map=True), atol=1e-5)
    assert tmetrics.mse2psnr(0.01) == jmetrics.mse2psnr(0.01)
