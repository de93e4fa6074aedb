"""Port parity of the local-field life cycle: spawning a field (append_rf),
sliding the window (set_window_start), the queries the training loop reads
to decide spawns, and training after a spawn and a slide, against the JAX
package on the CPU.

Setup for the training cases: 4 initial frames of 40x30, 3 more appended
with the dataset's window, the same perturbed poses and exposures on both
sides, a spawn over the last 3 frames, the dataset's window and the pose
window slid to the new field's first frame, and one frame appended after
the spawn (linked to the new field, so its pose gate is on). Both fields'
weights are carried across with params_from_jax (the new one after the
spawn); K1 on and binned_min_rows lowered so K2 runs (their plain versions
here, the Pallas kernels in interpret mode on the JAX side), JAX's
stratified noise injected, as in tests/test_torch_slice.py.

Tolerances as in tests/test_torch_slice.py: losses rtol 1e-4, gradients to
1e-4 of each tensor's largest entry in float32, new parameters where the
gradient is over 1e-3 of its largest entry; for a chunk of 4 steps those of
tests/test_torch_chunk.py (losses rtol 1e-4 on the first step and 1e-3
after, poses 1e-5, parameters 2e-3 absolute). Spawn bookkeeping is equal
bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localrf_tpu.data import pool as jpool
from localrf_tpu.data.dataset import SyntheticDataset as JSyntheticDataset
from localrf_tpu.models import local as jlocal
from localrf_tpu.models import step as jstep
from localrf_tpu.models import tensorf as jtf
from localrf_tpu_torch.convert import field_from_jax, params_from_jax
from localrf_tpu_torch.data.dataset import SyntheticDataset
from localrf_tpu_torch.data.pool import DevicePixelPool
from localrf_tpu_torch.models import local as tlocal
from localrf_tpu_torch.models import step as tstep
from localrf_tpu_torch.models import tensorf as ttf
from localrf_tpu_torch.optim import pytree_adam_init

W, H, N_VIEWS, BATCH = 40, 30, 4, 128
# the unfused feature path, JAX's default (the port's default is the fused march)
TF_KW = dict(grid_size=(24, 24, 24), pallas_composite=True, binned_min_rows=100, fused_march=False)


def T(x):
    return torch.from_numpy(np.array(x, copy=True))


def jax_noise(key, n_samples_total: int) -> dict:
    """JAX's render randomness, split as render.py:74 and rays.py:85-87 do."""
    key_strat, key_bg = jax.random.split(key)
    k1, k2 = jax.random.split(key_strat)
    n = n_samples_total // 6
    return {
        "u1": T(jax.random.uniform(k1, (1, n))),
        "u2": T(jax.random.uniform(k2, (1, n))),
        "bg": T(jax.random.uniform(key_bg, ())),
    }


def grad_close(got, want, rel=1e-4):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) + 1e-12
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max err {err:.3e} vs max |g| {scale:.3e}"


# ------------------------------ bookkeeping ------------------------------


def _small_pair(n_init: int, **kw):
    common = dict(fov=60.0, n_init_frames=n_init, WH=(W, H), **kw)
    jm = jlocal.LocalTensorfs(jlocal.LocalConfig(tensorf=jtf.TensorfConfig(grid_size=(12, 12, 12)), **common))
    tm = tlocal.LocalTensorfs(
        tlocal.LocalConfig(tensorf=ttf.TensorfConfig(grid_size=(12, 12, 12)), **common), device="cpu")
    return jm, tm


def _same_bookkeeping(jm, tm):
    assert tm.blending_weights.dtype == jm.blending_weights.dtype == np.float32
    np.testing.assert_array_equal(tm.blending_weights, jm.blending_weights)
    assert tm.pose_linked_rf == jm.pose_linked_rf
    assert len(tm.world2rf) == len(jm.world2rf)
    for a, b in zip(tm.world2rf, jm.world2rf):
        np.testing.assert_array_equal(a, b)
    assert tm.win_start == jm.win_start and tm.win_len == jm.win_len and tm._wc == jm._wc
    np.testing.assert_array_equal(tm._gate(), jm._gate())
    assert tm.rf_iter == jm.rf_iter and tm.is_refining == jm.is_refining


@pytest.mark.parametrize("n_overlap", [2, 3, 5, 6, 7])
def test_spawn_bookkeeping_matches_jax(n_overlap):
    """The counterpart of test_pose_links_follow_spawns_any_overlap, held
    against JAX: after a spawn over n_overlap frames the blending weights
    (the k/n ladder, exactly 1.0 and 0.0 at its ends), the pose links,
    world2rf (minus the last frame's position), the slid window and the pose
    gate equal JAX's bit for bit, through a second spawn; the retired field's
    parameters are on the host, equal to what it trained, and its optimizer
    state is gone."""
    jm, tm = _small_pair(3, n_overlap=n_overlap)
    t = np.random.default_rng(n_overlap).uniform(-1, 1, (n_overlap + 5, 3)).astype(np.float32)
    for m in (jm, tm):
        for _ in range(n_overlap + 2):
            m.append_frame()
        m.t_all[:] = t
        m._build_window()
    before = {k: p.detach().clone() for k, p in tm.fields[0]["params"].named_parameters()}
    for m in (jm, tm):
        m.is_refining = True
        m.append_rf(n_added_frames=n_overlap)
    _same_bookkeeping(jm, tm)
    assert tm.blending_weights[-1, 1] == 1.0 and tm.blending_weights[-1, 0] == 0.0
    np.testing.assert_array_equal(tm.world2rf[1], -t[-1])
    retired = tm.fields[0]
    assert retired["opt"] is None
    for k, p in retired["params"].named_parameters():
        assert p.device.type == "cpu" and torch.equal(p, before[k]), k
    first = int(np.argmax(tm.blending_weights[:, -1] > 0))
    assert first == int(np.argmax(jm.blending_weights[:, -1] > 0)) > 1
    for m in (jm, tm):
        m.set_window_start(first)
        for _ in range(3):
            m.append_frame()
    assert tm.win_start == first - 1  # one frame kept before the first active one
    assert tm.pose_linked_rf[-3:] == [1, 1, 1]
    _same_bookkeeping(jm, tm)
    assert tm._gate()[: tm.win_len].any()
    for m in (jm, tm):
        m.append_rf(n_added_frames=min(3, n_overlap))
        m.append_frame()
    assert tm.pose_linked_rf[-1] == 2
    _same_bookkeeping(jm, tm)


def test_append_rf_drops_graphs_before_the_field_leaves():
    """append_rf drops the chunk graphs (a captured graph keeps every tensor
    it read alive) while the retiring field's parameters are still the
    trained ones, then moves them; a slide drops them too."""
    _, tm = _small_pair(3)
    trained = tm.fields[0]["params"]
    seen = []
    tm.drop_graphs = lambda: seen.append(tm.fields[0]["params"] is trained)
    tm.append_rf(2)
    assert seen[0] is True
    assert tm.fields[0]["params"] is not trained
    n = len(seen)
    tm.set_window_start(3)
    assert len(seen) > n and tm.win_start == 2


def test_slide_keeps_one_frame_and_syncs_the_window():
    """set_window_start keeps one frame before the first active one, pulls
    the trained window back to the host first, and rebuilds the window from
    there; a start at 0 or 1 keeps the window at 0."""
    _, tm = _small_pair(6)
    tm._pose_dev.t[:6].add_(torch.arange(18, dtype=torch.float32).reshape(6, 3))
    tm.set_window_start(1)
    assert tm.win_start == 0
    tm.set_window_start(4)
    assert tm.win_start == 3 and tm.win_len == 3
    np.testing.assert_array_equal(tm.t_all, np.arange(18, dtype=np.float32).reshape(6, 3))
    np.testing.assert_array_equal(tm._pose_dev.t[:3].numpy(), tm.t_all[3:])


# ------------------------------ training after a spawn ------------------------------


def _dataset(cls):
    rng = np.random.default_rng(0)
    shape = (10, H, W)
    return cls(
        rng.random((*shape, 3), dtype=np.float32), "train",
        invdepths=0.1 + 0.9 * rng.random(shape, dtype=np.float32),
        fwd_flow=rng.normal(0, 1, (*shape, 2)).astype(np.float32), fwd_mask=np.ones(shape, np.float32),
        bwd_flow=rng.normal(0, 1, (*shape, 2)).astype(np.float32), bwd_mask=np.ones(shape, np.float32),
        n_init_frames=4, test_frame_every=0,
    )


def _carry(jm, tm):
    field = field_from_jax(jax.device_get(jm.fields[-1]["params"]), device="cpu")
    tm.fields[-1]["params"] = field
    tm.fields[-1]["opt"] = pytree_adam_init(field)


def spawned_pair(pool: bool = False):
    """JAX and port models (and datasets) after the spawn and slide of the
    module docstring, refining from rf_iter 2 on the new field."""
    common = dict(WH=(W, H), n_init_frames=4, n_views=N_VIEWS, batch_size=BATCH, n_overlap=3)
    jm = jlocal.LocalTensorfs(jlocal.LocalConfig(tensorf=jtf.TensorfConfig(**TF_KW), **common))
    tm = tlocal.LocalTensorfs(tlocal.LocalConfig(tensorf=ttf.TensorfConfig(**TF_KW), **common), device="cpu")
    ds_j, ds_t = _dataset(JSyntheticDataset), _dataset(SyntheticDataset)
    _carry(jm, tm)
    rng = np.random.default_rng(5)
    r = (np.eye(3, dtype=np.float32)[:, :2] + 0.05 * rng.normal(size=(7, 3, 2))).astype(np.float32)
    t = rng.uniform(-0.2, 0.2, (7, 3)).astype(np.float32)
    e = (np.eye(3) + 0.02 * rng.normal(size=(7, 3, 3))).astype(np.float32)
    for m, ds in ((jm, ds_j), (tm, ds_t)):
        for _ in range(3):
            m.append_frame()
            ds.activate_frames()
        m.r_all[:], m.t_all[:], m.exp_all[:] = r, t, e
        m._build_window()
        m.append_rf(3)
    _carry(jm, tm)
    first = int(np.argmax(tm.blending_weights[:, -1] > 0))
    for m, ds in ((jm, ds_j), (tm, ds_t)):
        ds.deactivate_frames(first)
        m.set_window_start(first)
        m.append_frame()
        ds.activate_frames()
        m.is_refining = True
        m.rf_iter[-1] = 2
    if pool:
        jm.attach_pool(jpool.DevicePixelPool(ds_j, capacity=8))
        tm.attach_pool(DevicePixelPool(ds_t, capacity=8, device="cpu"))
    assert tm.win_start == first - 1 == 3 and tm.pose_linked_rf[-1] == 1
    return jm, tm, ds_j, ds_t


def test_step_after_spawn_and_slide_matches_jax():
    """On the new field after a spawn and a slide: the losses and the
    gradients of one step (field, poses, exposures), then one step's
    losses, new field parameters and pose window (JAX's optimizer_step, the
    port's chunk of one)."""
    jm, tm, ds_j, ds_t = spawned_pair()
    batch_t = ds_t.sample(BATCH, True, True, n_views=N_VIEWS)
    batch_j = ds_j.sample(BATCH, True, True, n_views=N_VIEWS)
    np.testing.assert_array_equal(batch_t["view_ids"], batch_j["view_ids"])
    assert batch_t["view_ids"].min() >= tm.win_start
    _, sub = jax.random.split(jm._key)  # the key jm's step will draw
    noise = jax_noise(sub, tm.fields[-1]["cfg"].n_samples)

    f = jm.fields[-1]
    j_stat = jm._statics(True)
    j_batch = jm._device_batch(batch_j)
    j_scal = dict(jm._scalars(), pose_only=jnp.zeros(()))
    pose = jm._pose_dev

    def loss_fn(fp, rte):
        p = pose._replace(r=rte[0], t=rte[1], exposure=rte[2])
        return jstep._losses(fp, p, jm.intr.params, j_stat, j_batch, j_scal, sub)

    g_j, m_j = jax.jit(jax.grad(loss_fn, argnums=(0, 1), has_aux=True))(
        f["params"], (pose.r, pose.t, pose.exposure))
    tf_ = tm.fields[-1]
    g_field, g_pose, _, m_t = tstep.loss_grads(
        tf_["params"], tm._pose_dev, tm.intr.params, tm._statics(True), tstep.row(tm._stage([batch_t], [tm._gate()]), 0),
        tm._scalars_py(), noise)
    assert float(m_j["flow_loss"]) > 0 and float(m_j["depth_loss"]) > 0
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    g_fj = params_from_jax(jax.device_get(g_j[0]), device="cpu")
    for k, v in g_fj.items():
        grad_close(g_field[k], v.numpy())
    n = tm.win_len
    for got, want in zip(g_pose, g_j[1]):
        grad_close(got[:n], np.asarray(want)[:n])
    # the frames of the retired field (gate off) get no update; the new one does
    np.testing.assert_array_equal(tm._gate()[:n], jm._gate()[:n])
    assert tm._gate()[:n].tolist() == [False, False, False, False, True]

    tm._next_noise = lambda cfg: noise
    jm.optimizer_step(batch_j, optimize_poses=True)
    tm.run_chunk([batch_t], optimize_poses=True)
    for k, v in jm.last_metrics.items():
        np.testing.assert_allclose(tm.last_metrics[k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    want = params_from_jax(jax.device_get(jm.fields[-1]["params"]), device="cpu")
    for k, p in tm.fields[-1]["params"].named_parameters():
        g = g_fj[k].numpy()
        mask = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(p.detach().numpy()[mask], want[k].numpy()[mask], rtol=1e-5, atol=1e-6)
    jm.sync_window_to_host()
    tm.sync_window_to_host()
    np.testing.assert_allclose(tm.r_all, jm.r_all, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.t_all, jm.t_all, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.exp_all, jm.exp_all, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tm.t_all[:6], jm.t_all[:6])  # gated off: unchanged


def test_pooled_chunk_after_spawn_and_slide_matches_jax():
    """A pooled run_chunk of 4 steps on the new field after a spawn and a
    slide (the pool has freed the slid-out frames' slots) against JAX's."""
    jm, tm, ds_j, ds_t = spawned_pair(pool=True)
    tm.pool.sync()
    jm.pool.sync()
    assert tm.pool.slot_of_frame == jm.pool.slot_of_frame
    assert sorted(tm.pool.slot_of_frame) == list(range(4, 8))
    k = 4
    bj = [ds_j.sample(BATCH, True, True, n_views=N_VIEWS, values=False) for _ in range(k)]
    bt = [ds_t.sample(BATCH, True, True, n_views=N_VIEWS, values=False) for _ in range(k)]
    key, noise = jm._key, []
    for _ in range(k):  # the keys jm.run_chunk will draw, in order
        key, sub = jax.random.split(key)
        noise.append(jax_noise(sub, tm.fields[-1]["cfg"].n_samples))
    tm._next_noise = lambda cfg: noise.pop(0)
    jm.run_chunk(bj, optimize_poses=True)
    tm.run_chunk(bt, optimize_poses=True)
    assert tm.rf_iter == jm.rf_iter == [0, 6]
    for name, v in jm.chunk_metrics.items():
        for step in range(k):
            np.testing.assert_allclose(tm.chunk_metrics[name][step], v[step],
                                       rtol=1e-4 if step == 0 else 1e-3, atol=1e-7, err_msg=f"{name} {step}")
    jm.sync_window_to_host()
    tm.sync_window_to_host()
    np.testing.assert_allclose(tm.r_all, jm.r_all, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.t_all, jm.t_all, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.exp_all, jm.exp_all, rtol=1e-5, atol=1e-5)
    want = params_from_jax(jax.device_get(jm.fields[-1]["params"]), device="cpu")
    for name, p in tm.fields[-1]["params"].named_parameters():
        err = np.abs(p.detach().numpy() - want[name].numpy())
        assert err.max() <= 2e-3 and np.median(err) <= 1e-6, name


# ------------------------------ queries ------------------------------


def test_queries_match_jax():
    """get_cam2world (all, by view ids, from a starting id),
    get_dist_to_last_rf, focal and center after a spawn and a slide, with
    moved intrinsics."""
    jm, tm, _, _ = spawned_pair()
    jm.intr = jm.intr._replace(params={"focal_offset": jnp.asarray(0.97, jnp.float32),
                                       "center_rel": jnp.asarray([0.51, 0.46], jnp.float32)})
    tm.intr.params["focal_offset"] = torch.tensor(0.97)
    tm.intr.params["center_rel"] = torch.tensor([0.51, 0.46])
    for m in (jm, tm):  # a window pose that differs from the host copy
        m._pose_dev = m._pose_dev._replace(t=m._pose_dev.t + 0.25)
    np.testing.assert_allclose(tm.get_cam2world(), jm.get_cam2world(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm.get_cam2world([6, 2]), jm.get_cam2world([6, 2]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm.get_cam2world(starting_id=5), jm.get_cam2world(starting_id=5),
                               rtol=1e-6, atol=1e-6)
    assert tm.get_cam2world().shape == (8, 3, 4)
    np.testing.assert_allclose(tm.get_dist_to_last_rf(), jm.get_dist_to_last_rf(), rtol=1e-6)
    assert tm.get_dist_to_last_rf() > 0.25
    for w in (W, 2 * W, 17):
        np.testing.assert_allclose(tm.focal(w), jm.focal(w), rtol=1e-7)
        np.testing.assert_array_equal(tm.center(w, H + w), jm.center(w, H + w))
    assert isinstance(tm.focal(W), float) and tm.center(W, H).dtype == np.float32
