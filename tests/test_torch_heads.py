"""Port parity of the six shading heads (`TensorfConfig.shading_mode`):
render_rays forward and gradients against the JAX package on the CPU for
each head, one training step in TensoRF's published head (MLP_Fea, fea_pe 2,
view_pe 2), and the config's checks.

Inputs are made from seeds with numpy (rays) and by JAX (the field init,
carried across with params_from_jax); JAX runs jitted, f32 throughout.
Tolerances: rgb and depth rtol 1e-4 (depth also atol 1e-4: it reaches the
far plane), gradients to 1e-4 of each tensor's largest entry (summation
orders differ), as tests/test_torch_slice.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import (
    BATCH,
    H,
    N_FRAMES,
    N_VIEWS,
    W,
    T,
    _ball,
    _dataset,
    _models,
    _train_step_against_jax,
    grad_close,
    jax_noise,
)

from localrf_tpu.models import render as jrender
from localrf_tpu.models import tensorf as jtf
from localrf_tpu_torch.convert import field_from_jax, params_from_jax
from localrf_tpu_torch.models import render as trender
from localrf_tpu_torch.models import tensorf as ttf

GRID = (18, 14, 22)
N_RAYS, N_SAMPLES = 33, 48
# each head with the positional encodings it reads (RGB shades the
# features themselves, so they are rgb: app_dim 3)
HEADS = {
    "MLP_Fea_late_view": dict(fea_pe=2, view_pe=2),
    "MLP_Fea": dict(fea_pe=2, view_pe=2),
    "MLP_Fea_woView": dict(fea_pe=2),
    "MLP_PE": dict(pos_pe=2, view_pe=2),
    "MLP": dict(view_pe=2),
    "RGB": dict(app_dim=3),
}
# refine (JAX's traced 0/1 scalar) at 0.5: it scales the late-view head's
# feature PE and no other head's, so a head that scaled the wrong PE shows
REFINE = 0.5


def _rays(rng):
    o = rng.uniform(-0.5, 0.5, (N_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True) * rng.uniform(0.8, 1.4, (N_RAYS, 1))


@pytest.mark.parametrize("mode", list(HEADS))
def test_render_rays_head_matches_jax(mode):
    """A training render through each head with the coarse probe and
    compaction to occ_m samples (MLP_PE then reads the compacted points) and
    the random background: rgb, depth and the gradients of every parameter
    and of the rays against JAX's."""
    kw = dict(grid_size=GRID, shading_mode=mode, occ_m=12, **HEADS[mode])
    jcfg, tcfg = jtf.TensorfConfig(**kw), ttf.TensorfConfig(**kw)
    jp = jax.device_get(jtf.init_tensorf(jax.random.PRNGKey(7), jcfg))
    field = field_from_jax(jp, device="cpu")
    assert {n for n, _ in field.named_parameters() if n.startswith("mlp.")} == {
        f"mlp.{k}" for k in jp["mlp"]}
    rng = np.random.default_rng(2)
    o, d = _rays(rng)
    alpha = _ball((10, 11, 12))
    wr = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    wd = rng.normal(size=(N_RAYS,)).astype(np.float32) * 1e-3
    key = jax.random.PRNGKey(11)

    def j_fn(p, o, d):
        rgb, depth = jrender.render_rays(p, jcfg, o, d, is_train=True, white_bg=False, refine=REFINE,
                                         alpha_volume=jnp.asarray(alpha), key=key, n_samples=N_SAMPLES)
        return jnp.sum(rgb * wr) + jnp.sum(depth * wd), (rgb, depth)

    (_, (rgb_j, depth_j)), g_j = jax.jit(jax.value_and_grad(j_fn, argnums=(0, 1, 2), has_aux=True))(
        jp, jnp.asarray(o), jnp.asarray(d))
    ot, dt = T(o).requires_grad_(True), T(d).requires_grad_(True)
    rgb, depth = trender.render_rays(field, tcfg, ot, dt, is_train=True, white_bg=False, refine=REFINE,
                                     alpha_volume=T(alpha), noise=jax_noise(key, N_SAMPLES),
                                     n_samples=N_SAMPLES)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(rgb_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(depth.detach().numpy(), np.asarray(depth_j), rtol=1e-4, atol=1e-4)
    loss = (rgb * T(wr)).sum() + (depth * T(wd)).sum()
    names = [n for n, _ in field.named_parameters()]
    grads = torch.autograd.grad(loss, list(field.parameters()) + [ot, dt], allow_unused=True)
    got = dict(zip(names + ["o", "d"], grads))
    want = {**params_from_jax(jax.device_get(g_j[0]), device="cpu"), "o": g_j[1], "d": g_j[2]}
    assert want.keys() == got.keys()
    for k, v in want.items():
        grad_close(got[k] if got[k] is not None else torch.zeros(v.shape), np.asarray(v))


def test_rgb_head_has_no_mlp_and_no_sigmoid():
    """RGB: no MLP parameters at all, and the shaded colour is the
    appearance feature as it is (JAX's apply_mlp returns it unsquashed)."""
    cfg = ttf.TensorfConfig(grid_size=(8, 8, 8), shading_mode="RGB", app_dim=3)
    field = ttf.init_tensorf(cfg, torch.Generator().manual_seed(0), "cpu")
    assert not list(field.mlp.parameters())
    feat = torch.tensor([[-2.0, 0.5, 3.0]])
    assert torch.equal(ttf.apply_mlp(field.mlp, None, None, feat, cfg), feat)


def test_heads_size_layer_one_as_jax():
    """init_mlp's shapes for every head equal JAX's, MLP_PE sized to its real
    inputs, RGB empty."""
    for mode, pe in HEADS.items():
        for extra in ({}, dict(pos_pe=3, view_pe=1, fea_pe=1)):
            kw = dict(grid_size=(8, 8, 8), shading_mode=mode, **{**pe, **extra})
            want = {k: v.shape for k, v in jtf.init_mlp(jax.random.PRNGKey(0), jtf.TensorfConfig(**kw)).items()}
            got = {k[4:]: tuple(v.shape) for k, v in
                   ttf.init_mlp(ttf.TensorfConfig(**kw), torch.Generator().manual_seed(0), "cpu").items()}
            assert got == want, (mode, extra)


def test_config_accepts_the_six_heads_and_the_grid_route():
    """Every head and fast_gather=False are accepted; another head name is a
    ValueError (as JAX's init_mlp); the fused_*_gather flags stay unported."""
    for mode in ttf.SHADING_MODES:
        ttf.TensorfConfig(grid_size=(8, 8, 8), shading_mode=mode)
    assert set(ttf.SHADING_MODES) == set(HEADS)
    ttf.TensorfConfig(grid_size=(8, 8, 8), fast_gather=False, app_top_k=12)
    with pytest.raises(ValueError, match="shading mode SH"):
        ttf.TensorfConfig(grid_size=(8, 8, 8), shading_mode="SH")
    with pytest.raises(ValueError, match="shading mode SH"):
        jtf.init_mlp(jax.random.PRNGKey(0), jtf.TensorfConfig(grid_size=(8, 8, 8), shading_mode="SH"))
    for flag in (dict(fused_plane_gather=True), dict(fused_fwd_gather=1), dict(fused_line_gather=True)):
        with pytest.raises(NotImplementedError):
            ttf.TensorfConfig(grid_size=(8, 8, 8), **flag)


def test_fused_march_is_the_late_view_head_only():
    """--fused_march is honoured only where the kernel's shape config holds:
    the other heads (and the late-view head with a PE) run unfused, as in
    JAX (render.py's fused_march_supported)."""
    from localrf_tpu.ops.pallas.march import fused_march_supported as j_supported
    from localrf_tpu_torch.ops.kernels.march import fused_march_supported

    base = ttf.TensorfConfig(grid_size=(16, 16, 16), fused_march=True)
    assert fused_march_supported(base)
    for mode, pe in HEADS.items():
        kw = dict(grid_size=(16, 16, 16), fused_march=True, shading_mode=mode, **pe)
        assert not fused_march_supported(ttf.TensorfConfig(**kw))
        assert not j_supported(jtf.TensorfConfig(**kw))


def test_train_step_mlp_fea_matches_jax():
    """One training step in TensoRF's published head (configs/lego.txt:
    MLP_Fea, fea_pe 2, view_pe 2): losses, gradients, new params and poses
    against JAX's (test_torch_slice's comparison)."""
    jm, tm = _models(dict(shading_mode="MLP_Fea", fea_pe=2, view_pe=2))
    assert tm.fields[-1]["params"]["mlp"]["w1"].shape == (27 + 3 + 2 * 2 * 27 + 2 * 2 * 3, 128)
    _train_step_against_jax(jm, tm)


def test_rgb_head_trains_a_chunk_with_an_empty_mlp():
    """The RGB head's empty MLP through the chunk path: field_base_lrs, Adam
    over no MLP group, train_chunk's parameter list; the losses are finite
    and the field moves."""
    from localrf_tpu_torch.data.pool import DevicePixelPool
    from localrf_tpu_torch.models.local import LocalConfig, LocalTensorfs

    ds = _dataset()
    cfg = LocalConfig(WH=(W, H), n_init_frames=N_FRAMES, n_views=N_VIEWS, batch_size=BATCH,
                      tensorf=ttf.TensorfConfig(grid_size=(16, 16, 16), shading_mode="RGB", app_dim=3))
    m = LocalTensorfs(cfg, device="cpu")
    m.attach_pool(DevicePixelPool(ds, N_FRAMES, device="cpu"))
    m.is_refining = True
    m.rf_iter[-1] = 2
    before = m.fields[-1]["params"]["basis_mat"].detach().clone()
    m.run_chunk(m.plan_chunk(ds, True, max_len=4), optimize_poses=True)
    assert all(np.isfinite(v).all() for v in (np.asarray(x) for x in m.chunk_metrics.values()))
    assert not torch.equal(before, m.fields[-1]["params"]["basis_mat"])
    assert not any(k.startswith("mlp.") for k in m.fields[-1]["opt"].m)
