"""Port parity of the training-step slice: render_rays, one train_core step
and LocalTensorfs.run_chunk's steps (chunks of one) against the JAX
package's train_step and optimizer_steps on the CPU, on
weights carried across with params_from_jax and the stratified noise JAX
draws from its key. A small grid with binned_min_rows lowered, so the
compositing kernel (K1) and the segment sum (K2) run, and with
fused_march (K4) or line_bwd="segsum" (K3) where a case says so (their
plain versions here, the Pallas kernels in interpret mode on the JAX side).

Tolerances: rgb/depth and losses rtol 1e-4 (depth also atol 1e-4, it
reaches the far plane); gradients to 1e-4 of each tensor's largest entry
in float32 (summation orders differ) and to 5e-2 with bf16 tables and MLP
(the two frameworks round backward intermediates to bf16 at different
places; measured up to 3e-2, while the bf16 forward agrees to 3e-7). Adam's first step is ~lr*sign(g), so a
near-zero gradient whose sign differs by summation order moves its
parameter by 2*lr: new parameters are compared where |g| > 1e-3 max|g|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localrf_tpu.data.dataset import SyntheticDataset as JSyntheticDataset
from localrf_tpu.models import local as jlocal
from localrf_tpu.models import render as jrender
from localrf_tpu.models import step as jstep
from localrf_tpu.models import tensorf as jtf
from localrf_tpu_torch.convert import field_from_jax, params_from_jax, pose_from_jax
from localrf_tpu_torch.data.dataset import SyntheticDataset
from localrf_tpu_torch.models import local as tlocal
from localrf_tpu_torch.models import render as trender
from localrf_tpu_torch.models import step as tstep
from localrf_tpu_torch.models import tensorf as ttf
from localrf_tpu_torch.optim import pytree_adam_init

W, H, N_FRAMES, N_VIEWS, BATCH = 40, 30, 4, 4, 128
GRID = (24, 24, 24)
# the unfused feature path, JAX's default (the port's default is the fused march)
TF_KW = dict(grid_size=GRID, pallas_composite=True, binned_min_rows=100, fused_march=False)


def T(x):
    return torch.from_numpy(np.array(x, copy=True))


def grad_close(got, want, rel=1e-4):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) + 1e-12
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max err {err:.3e} vs max |g| {scale:.3e}"


def jax_noise(key, n_samples_total: int) -> dict:
    """JAX's render randomness, split exactly as render.py:74 and
    rays.py:85-87 split the key."""
    key_strat, key_bg = jax.random.split(key)
    k1, k2 = jax.random.split(key_strat)
    n = n_samples_total // 6
    return {
        "u1": T(jax.random.uniform(k1, (1, n))),
        "u2": T(jax.random.uniform(k2, (1, n))),
        "bg": T(jax.random.uniform(key_bg, ())),
    }


def _ball(shape, radius=0.55):
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, n) for n in shape], indexing="ij")
    return ((xx**2 + yy**2 + zz**2) < radius**2).astype(np.float32)


# ------------------------------ render ------------------------------

BF16 = dict(gather_dtype="bfloat16", mlp_dtype="bfloat16")
RENDER_CASES = {
    # name: (is_train, white_bg, alpha volume, TensorfConfig overrides)
    "eval-no-alpha": (False, True, False, {}),
    "train-noise-flip-bg": (True, False, False, {}),
    "train-probe-compact": (True, True, True, dict(occ_m=12)),
    "eval-exact-compact": (False, True, True, dict(occ_m=12, occ_probe_ds=0)),
    "eval-dense-cull": (False, True, True, {}),
    "eval-no-alpha-bf16": (False, True, False, BF16),
    "train-probe-compact-bf16": (True, True, True, dict(occ_m=12, **BF16)),
    "eval-fused-march-no-alpha": (False, True, False, dict(fused_march=True)),
    "train-fused-march-probe-compact-bf16": (True, True, True, dict(occ_m=12, fused_march=True, **BF16)),
    "train-segsum-lines-probe-compact": (True, False, True, dict(occ_m=12, line_bwd="segsum")),
    "eval-segsum-lines-bf16": (False, True, False, dict(line_bwd="segsum", **BF16)),
}


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_render_rays_matches_jax(rng, case):
    is_train, white_bg, with_alpha, kw = RENDER_CASES[case]
    jcfg = jtf.TensorfConfig(**{**TF_KW, **kw})
    tcfg = ttf.TensorfConfig(**{**TF_KW, **kw})
    jp = jax.device_get(jtf.init_tensorf(jax.random.PRNGKey(3), jcfg))
    field = field_from_jax(jp, device="cpu")
    o = rng.uniform(-0.4, 0.4, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    alpha = _ball((10, 11, 12)) if with_alpha else None
    key = jax.random.PRNGKey(11)
    wr = rng.normal(size=(64, 3)).astype(np.float32)
    wd = rng.normal(size=(64,)).astype(np.float32) * 1e-3

    def j_fn(p, o, d):
        rgb, depth = jrender.render_rays(
            p, jcfg, o, d, is_train=is_train, white_bg=white_bg,
            alpha_volume=None if alpha is None else jnp.asarray(alpha), key=key if is_train else None,
        )
        return jnp.sum(rgb * wr) + jnp.sum(depth * wd), (rgb, depth)

    (_, (rgb_j, depth_j)), g_j = jax.jit(jax.value_and_grad(j_fn, argnums=(0, 1, 2), has_aux=True))(
        jp, jnp.asarray(o), jnp.asarray(d))

    ot, dt = T(o).requires_grad_(True), T(d).requires_grad_(True)
    rgb, depth = trender.render_rays(
        field, tcfg, ot, dt, is_train=is_train, white_bg=white_bg,
        alpha_volume=None if alpha is None else T(alpha),
        noise=jax_noise(key, tcfg.n_samples) if is_train else None,
    )
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(rgb_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(depth.detach().numpy(), np.asarray(depth_j), rtol=1e-4, atol=1e-4)
    loss = (rgb * T(wr)).sum() + (depth * T(wd)).sum()
    names = [n for n, _ in field.named_parameters()]
    grads = torch.autograd.grad(loss, list(field.parameters()) + [ot, dt], allow_unused=True)
    g_t = dict(zip(names + ["o", "d"], grads))
    want = {**params_from_jax(jax.device_get(g_j[0]), device="cpu"), "o": g_j[1], "d": g_j[2]}
    for k, v in want.items():
        got = g_t[k] if g_t[k] is not None else torch.zeros(v.shape)
        grad_close(got, v.numpy() if isinstance(v, torch.Tensor) else v,
                   rel=5e-2 if kw.get("gather_dtype") == "bfloat16" else 1e-4)


# ------------------------ train_core / LocalTensorfs ------------------------


def _dataset(seed=0, cls=SyntheticDataset):
    """The port's dataset (cls=JSyntheticDataset for the JAX side: both
    draw the same batches from the same seed)."""
    rng = np.random.default_rng(seed)
    shape = (N_FRAMES, H, W)
    return cls(
        rng.random((*shape, 3), dtype=np.float32), "train",
        invdepths=0.1 + 0.9 * rng.random(shape, dtype=np.float32),
        fwd_flow=rng.normal(0, 1, (*shape, 2)).astype(np.float32), fwd_mask=np.ones(shape, np.float32),
        bwd_flow=rng.normal(0, 1, (*shape, 2)).astype(np.float32), bwd_mask=np.ones(shape, np.float32),
        n_init_frames=N_FRAMES, test_frame_every=0,
    )


def _models(tf_kw=None, camera_prior=None, **local_kw):
    """A JAX LocalTensorfs and the port's, the port's field carried across."""
    common = dict(WH=(W, H), n_init_frames=N_FRAMES, n_views=N_VIEWS, batch_size=BATCH, **local_kw)
    tf = dict(TF_KW, **(tf_kw or {}))
    jm = jlocal.LocalTensorfs(jlocal.LocalConfig(tensorf=jtf.TensorfConfig(**tf), **common),
                              camera_prior=camera_prior)
    tm = tlocal.LocalTensorfs(tlocal.LocalConfig(tensorf=ttf.TensorfConfig(**tf), **common),
                              camera_prior=camera_prior, device="cpu")
    field = field_from_jax(jax.device_get(jm.fields[-1]["params"]), device="cpu")
    tm.fields[-1]["params"] = field
    tm.fields[-1]["opt"] = pytree_adam_init(field)
    for m in (jm, tm):
        m.is_refining = True
        m.rf_iter[-1] = 2
    return jm, tm


TRAIN_CONFIGS = {
    "default": {},
    "fused-march": dict(fused_march=True),  # K4 (+ K1, K2)
    "segsum-lines": dict(line_bwd="segsum"),  # K3 (+ K1, K2)
}


@pytest.mark.parametrize("config", list(TRAIN_CONFIGS))
def test_train_step_matches_jax(config):
    """One train_core step against JAX's train_step: losses,
    field/pose/exposure gradients, new params."""
    _train_step_against_jax(*_models(TRAIN_CONFIGS[config]))


def test_train_step_fov360_matches_jax():
    """fov = 360: the equirectangular rays (get_ray_directions_360, focal 1,
    centre at the image middle) and no flow or depth loss, as in JAX
    (step.py forward_rays, local.py _statics)."""
    jm, tm = _models(fov=360)
    assert tm._statics(True).fov360 and not tm._statics(True).flow_on
    # these rays see little density: the density tables' gradients are
    # ~3e-8 at most, sums of cancelling terms that land 5e-12 apart (2e-4
    # of their largest entry); the rest, poses included, agree to 1e-4
    _train_step_against_jax(jm, tm, field_rel=1e-3)


def _train_step_against_jax(jm, tm, field_rel=1e-4):
    """One step (JAX's train_step, the port's train_core) of two models
    from _models on the same batch and
    noise: losses, field/pose/exposure gradients (the field's to
    `field_rel` of each tensor's largest entry), new params (where the
    gradient is over 10 field_rel of its largest entry)."""
    batch = _dataset().sample(BATCH, True, True, n_views=N_VIEWS)
    key = jax.random.PRNGKey(5)
    f = jm.fields[-1]
    j_stat = jm._statics(True)
    j_batch = jm._device_batch(_dataset(cls=JSyntheticDataset).sample(BATCH, True, True, n_views=N_VIEWS))
    j_scal = dict(jm._scalars(), pose_only=jnp.zeros(()))
    pose = jm._pose_dev

    def loss_fn(fp, rte):
        p = pose._replace(r=rte[0], t=rte[1], exposure=rte[2])
        return jstep._losses(fp, p, jm.intr.params, j_stat, j_batch, j_scal, key)

    g_j, m_j = jax.jit(jax.grad(loss_fn, argnums=(0, 1), has_aux=True))(
        f["params"], (pose.r, pose.t, pose.exposure))
    new_f, new_p, _, _ = jstep.train_step(
        jstep.FieldState(f["params"], f["opt"]), pose, jm.intr, j_batch, jm._scalars(),
        j_stat, key, None)

    t_stat = tm._statics(True)
    t_batch = tstep.row(tm._stage([batch], [tm._gate()]), 0)
    noise = jax_noise(key, t_stat.cfg.n_samples)
    tf_ = tm.fields[-1]
    g_field, g_pose, _, m_t = tstep.loss_grads(
        tf_["params"], tm._pose_dev, tm.intr.params, t_stat, t_batch, tm._scalars_py(), noise)
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    g_fj = params_from_jax(jax.device_get(g_j[0]), device="cpu")
    for k, v in g_fj.items():
        grad_close(g_field[k], v.numpy(), rel=field_rel)
    # window rows past the live frames are zero-padded poses (NaN gradients
    # in both packages, never read back); compare the live frames
    for got, want in zip(g_pose, g_j[1]):
        grad_close(got[:N_FRAMES], np.asarray(want)[:N_FRAMES])

    new_field, new_pose, _, _ = tstep.train_core(
        tstep.FieldState(tf_["params"], tf_["opt"]), tm._pose_dev, tm.intr, t_batch,
        tm._scalars_py(), t_stat, noise)
    want_p = params_from_jax(jax.device_get(new_f.params), device="cpu")
    for k, p in new_field.params.named_parameters():
        g = g_fj[k].numpy()
        # entries whose gradient is 10x the gradients' tolerance (module docstring)
        mask = np.abs(g) > 10 * field_rel * np.abs(g).max()
        assert mask.any()
        # an Adam step on a gradient near its eps (1e-8) moves with the
        # gradient's own error, so atol follows field_rel
        np.testing.assert_allclose(p.detach().numpy()[mask], want_p[k].numpy()[mask], rtol=1e-5,
                                   atol=1e-6 * field_rel / 1e-4)
    want_pose = pose_from_jax(jax.device_get(new_p), device="cpu")
    for name in ("r", "t", "exposure"):
        np.testing.assert_allclose(getattr(new_pose, name).numpy()[:N_FRAMES],
                                   getattr(want_pose, name).numpy()[:N_FRAMES],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(new_pose.r_opt.step.numpy(), want_pose.r_opt.step.numpy())
    assert new_field.opt.step.shape == () and int(new_field.opt.step) == int(new_f.opt.step)


@pytest.mark.parametrize("config", list(TRAIN_CONFIGS))
def test_local_tensorfs_two_steps_with_alpha_refresh(config):
    """Two steps (JAX's optimizer_steps, the port's chunks of one); an
    occupancy refresh after the first, so the
    second marches against the alpha volume (coarse probe + compaction).
    The second step starts from parameters a first Adam step may have moved
    apart (see the module docstring), so its losses get rtol 1e-3."""
    jm, tm = _models(TRAIN_CONFIGS[config], update_AlphaMask_list=[2], occ_min=4)
    ds_j, ds_t = _dataset(1, JSyntheticDataset), _dataset(1)
    for step in range(2):
        _, sub = jax.random.split(jm._key)  # the key jm's step will draw
        tm._next_noise = lambda cfg, sub=sub: jax_noise(sub, cfg.n_samples)
        jm.optimizer_step(ds_j.sample(BATCH, True, True, n_views=N_VIEWS), optimize_poses=True)
        tm.run_chunk([ds_t.sample(BATCH, True, True, n_views=N_VIEWS)], optimize_poses=True)
        rtol = 1e-4 if step == 0 else 1e-3
        for k, v in jm.last_metrics.items():
            np.testing.assert_allclose(tm.last_metrics[k], v, rtol=rtol, atol=1e-7, err_msg=k)
        if step == 0:
            av_t, av_j = tm.fields[-1]["alpha_volume"], jm.fields[-1]["alpha_volume"]
            np.testing.assert_array_equal(av_t.numpy(), np.asarray(av_j))
            assert tm.fields[-1]["cfg"].occ_m == jm.fields[-1]["cfg"].occ_m > 0
    assert tm.rf_iter == jm.rf_iter == [4]
    jm.sync_window_to_host()
    tm.sync_window_to_host()
    np.testing.assert_allclose(tm.r_all, jm.r_all, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.t_all, jm.t_all, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.exp_all, jm.exp_all, rtol=1e-5, atol=1e-5)
    for k, v in jm.pose_opt_all.items():
        np.testing.assert_allclose(tm.pose_opt_all[k], v, rtol=1e-4, atol=1e-7, err_msg=k)


def test_upsample_keeps_lr_scale_without_reset():
    """lr_upsample_reset=False: the upsample after the first step starts a
    fresh Adam state but keeps the decayed lr_scale (JAX local.py
    _apply_post_step_events); the next step's losses and its update, whose
    size is lr * lr_scale (a first Adam step moves by ~lr_scale * lr), as
    in JAX."""
    jm, tm = _models(N_voxel_list={2: 30**3}, lr_upsample_reset=False)
    ds_j, ds_t = _dataset(2, JSyntheticDataset), _dataset(2)
    for m in (jm, tm):
        m.lr_factor = 0.5
    for step in range(2):
        _, sub = jax.random.split(jm._key)
        tm._next_noise = lambda cfg, sub=sub: jax_noise(sub, cfg.n_samples)
        before_t = {k: p.detach().clone() for k, p in tm.fields[-1]["params"].named_parameters()}
        before_j = params_from_jax(jax.device_get(jm.fields[-1]["params"]), device="cpu")
        jm.optimizer_step(ds_j.sample(BATCH, True, True, n_views=N_VIEWS), optimize_poses=True)
        tm.run_chunk([ds_t.sample(BATCH, True, True, n_views=N_VIEWS)], optimize_poses=True)
        for k, v in jm.last_metrics.items():
            np.testing.assert_allclose(tm.last_metrics[k], v, rtol=1e-4 if step == 0 else 1e-3, atol=1e-7,
                                       err_msg=k)
        scale_t, scale_j = float(tm.fields[-1]["opt"].lr_scale), float(jm.fields[-1]["opt"].lr_scale)
        np.testing.assert_allclose(scale_t, scale_j, rtol=1e-6)
        if step == 0:  # the upsample: a new grid and Adam state, lr_scale kept
            assert tm.fields[-1]["cfg"].grid_size == jm.fields[-1]["cfg"].grid_size == (30, 30, 30)
            assert scale_t < 1.0 and int(tm.fields[-1]["opt"].step) == 0
            continue
        after_j = params_from_jax(jax.device_get(jm.fields[-1]["params"]), device="cpu")
        for k, p in tm.fields[-1]["params"].named_parameters():
            moved_t = float((p.detach() - before_t[k]).abs().max())
            moved_j = float((after_j[k] - before_j[k]).abs().max())
            np.testing.assert_allclose(moved_t, moved_j, rtol=1e-3, err_msg=k)


def test_camera_prior_focal_and_relative_poses():
    """camera_prior: the focal from the prior's fl_x at its width, scaled to
    the model's, and every appended frame's pose chained from the last one
    by the prior's relative pose (JAX local.py __init__ and append_frame);
    then one step on those poses."""
    rng = np.random.default_rng(7)
    rel = []
    for _ in range(N_FRAMES + 1):
        axis = rng.normal(size=3)
        angle = rng.uniform(0.05, 0.3)
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]) / np.linalg.norm(axis)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k
        m[:3, 3] = rng.uniform(-0.1, 0.1, 3)
        rel.append(m)
    prior = {"transforms": {"fl_x": 57.0, "w": 2 * W}, "rel_poses": rel}
    jm, tm = _models(camera_prior=prior)
    assert tm.init_focal == jm.init_focal == 57.0 * W / (2 * W)
    tm.append_frame()
    jm.append_frame()
    np.testing.assert_allclose(tm.r_all, jm.r_all, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm.t_all, jm.t_all, rtol=1e-6, atol=1e-6)
    assert not np.allclose(tm.t_all[1:], tm.t_all[:-1])  # the prior moved every frame
    _, sub = jax.random.split(jm._key)
    tm._next_noise = lambda cfg: jax_noise(sub, cfg.n_samples)
    jm.optimizer_step(_dataset(3, JSyntheticDataset).sample(BATCH, True, True, n_views=N_VIEWS), optimize_poses=True)
    tm.run_chunk([_dataset(3).sample(BATCH, True, True, n_views=N_VIEWS)], optimize_poses=True)
    for k, v in jm.last_metrics.items():
        np.testing.assert_allclose(tm.last_metrics[k], v, rtol=1e-4, atol=1e-7, err_msg=k)


def test_append_frame_links_with_threshold():
    """append_frame links a frame to the first field whose blending weight
    exceeds 1e-6 (a float residue in a retired column must not link)."""
    cfg = tlocal.LocalConfig(WH=(W, H), n_init_frames=2, tensorf=ttf.TensorfConfig(grid_size=(8, 8, 8)))
    m = tlocal.LocalTensorfs(cfg, device="cpu")
    m.blending_weights = np.array([[1.0, 0.0], [1e-16, 1.0]])
    m.append_frame()
    assert m.pose_linked_rf[-1] == 1
    assert m.n_frames == 3 and m._pose_dev.r.shape == (64, 3, 2)
    np.testing.assert_allclose(m.r_all[-1], np.eye(3, dtype=np.float32)[:, :2])


def test_train_core_pose_only_gating():
    """pose_only = 1 (test-pose refinement): poses step, while the field,
    the exposure and every lr decay are gated off (JAX train_core)."""
    _, tm = _models()
    tm.lr_factor = 0.5
    f = tm.fields[-1]
    before = {k: p.detach().clone() for k, p in f["params"].named_parameters()}
    pose0 = tm._pose_dev
    batch = tstep.row(tm._stage([_dataset().sample(BATCH, True, True, n_views=N_VIEWS)], [tm._gate()]), 0)
    scal = dict(tm._scalars_py(), pose_only=1.0)
    new_field, new_pose, _, metrics = tstep.train_core(
        tstep.FieldState(f["params"], f["opt"]), pose0, tm.intr, batch, scal, tm._statics(True),
        trender.draw_noise(f["cfg"].n_samples, torch.Generator().manual_seed(0), "cpu"))
    assert all(torch.isfinite(v) for v in metrics.values())
    for k, p in new_field.params.named_parameters():
        assert torch.equal(p, before[k]), k
    assert new_field.opt.step == 0 and new_field.opt.lr_scale == 1.0
    assert torch.equal(new_pose.exposure, pose0.exposure)
    assert not torch.equal(new_pose.r[:N_FRAMES], pose0.r[:N_FRAMES])
    assert torch.equal(new_pose.r_opt.lr, pose0.r_opt.lr)
    assert torch.equal(new_pose.e_opt.step, pose0.e_opt.step)


def test_intrinsics_step_on_first_field_while_refining():
    """lr_i_init > 0: focal offset and principal point take a gated Adam
    step (first field, refining), and their lr_scale decays first."""
    _, tm = _models(lr_i_init=1e-3)
    tm.lr_factor = 0.5
    assert tm._statics(True).intrinsics_on
    tm._next_noise = lambda cfg: trender.draw_noise(cfg.n_samples, torch.Generator().manual_seed(0), "cpu")
    tm.run_chunk([_dataset().sample(BATCH, True, True, n_views=N_VIEWS)], optimize_poses=True)
    assert tm.intr.opt.step == 1 and tm.intr.opt.lr_scale == 0.5
    assert float(tm.intr.params["focal_offset"]) != 1.0
    assert not torch.equal(tm.intr.params["center_rel"], torch.full((2,), 0.5))
    np.testing.assert_allclose(abs(float(tm.intr.params["focal_offset"]) - 1.0), 0.5e-3, rtol=1e-3)
