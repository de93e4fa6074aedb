"""Port parity of the chunk path (the JAX package's default `--scan_chunk 16
--pixel_pool 1`): the device pixel pool, plan_chunk and run_chunk against
the JAX package on the CPU, and run_chunk against the same steps taken one
at a time (chunks of one).

Setup: 6 frames of 40x30 with every third a held-out test frame, so the
sampler's third batch is a pose-only (test-pose) step; weights carried
across with params_from_jax and JAX's stratified noise injected, as in
tests/test_torch_slice.py. The chunk of 4 steps starts at rf_iter 2 with
n_iters_reg 4, so the density L1 term is on for the first two steps and off
after (a branch flip inside the chunk), and an alpha refresh is due after
the last joint step.

Tolerances: per-step losses rtol 1e-4 on step 0 and 1e-3 after (later steps
start from parameters a first Adam step may have moved apart: see
tests/test_torch_slice.py); the pose window after the chunk rtol / atol
1e-5 as there; the field parameters to 2e-3 absolute (Adam's first steps
are ~lr * sign(g) with lr 0.02, so a near-zero gradient whose sign differs
by summation order moves that entry apart by up to 2 lr; the bulk agrees
to f32 rounding, checked by the median); the alpha volume bit for bit.
run_chunk against single steps on the CPU: bit for bit.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from localrf_tpu.data import pool as jpool
from localrf_tpu.data.dataset import SyntheticDataset as JSyntheticDataset
from localrf_tpu.models import local as jlocal
from localrf_tpu.models import tensorf as jtf
from localrf_tpu_torch.convert import field_from_jax, params_from_jax
from localrf_tpu_torch.data.dataset import SyntheticDataset
from localrf_tpu_torch.data.pool import DevicePixelPool
from localrf_tpu_torch.models import local as tlocal
from localrf_tpu_torch.models import step as tstep
from localrf_tpu_torch.models import tensorf as ttf
from localrf_tpu_torch.optim import pytree_adam_init

W, H, N_FRAMES, N_VIEWS, BATCH = 40, 30, 6, 4, 128
# the unfused feature path, JAX's default (the port's default is the fused march)
TF_KW = dict(grid_size=(24, 24, 24), pallas_composite=True, binned_min_rows=100, fused_march=False)
K = 4


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


def _dataset(test_every=3, n_frames=N_FRAMES, n_init=N_FRAMES, cls=SyntheticDataset):
    """The port's dataset (cls=JSyntheticDataset for the JAX side)."""
    rng = np.random.default_rng(0)
    shape = (n_frames, H, W)
    return cls(
        rng.random((*shape, 3), dtype=np.float32), "train",
        invdepths=0.1 + 0.9 * rng.random(shape, dtype=np.float32),
        fwd_flow=rng.normal(0, 1, (*shape, 2)).astype(np.float32), fwd_mask=np.ones(shape, np.float32),
        bwd_flow=rng.normal(0, 1, (*shape, 2)).astype(np.float32), bwd_mask=np.ones(shape, np.float32),
        n_init_frames=n_init, test_frame_every=test_every,
    )


def _config(mod, tf_mod, **kw):
    return mod.LocalConfig(WH=(W, H), n_init_frames=N_FRAMES, n_views=N_VIEWS, batch_size=BATCH,
                           tensorf=tf_mod.TensorfConfig(**TF_KW), **kw)


def _schedule(m, rf_iter=2, n_iters_reg=4):
    m.is_refining = True
    m.rf_iter[-1] = rf_iter
    m.n_iters_reg = n_iters_reg


def test_pixel_pool_matches_jax_across_a_slid_window():
    """Slots, recycling and uploaded values equal JAX's DevicePixelPool."""
    ds_j, ds_t = _dataset(n_frames=10, n_init=6, cls=JSyntheticDataset), _dataset(n_frames=10, n_init=6)
    jp, tp = jpool.DevicePixelPool(ds_j, capacity=8), DevicePixelPool(ds_t, capacity=8, device="cpu")
    addrs = {k: v.data_ptr() for k, v in tp.arrays.items()}
    for step in range(3):
        if step:
            for ds in (ds_j, ds_t):
                ds.activate_frames(2)
                ds.deactivate_frames(ds.active_frames_bounds[0] + 2)
        jp.sync()
        tp.sync()
        assert tp.slot_of_frame == jp.slot_of_frame
        assert set(tp.slot_of_frame) == set(range(*ds_t.active_frames_bounds))
        for k, v in jp.arrays.items():
            np.testing.assert_array_equal(tp.arrays[k].numpy(), np.asarray(v), err_msg=k)
        view_ids = np.arange(*ds_t.active_frames_bounds)
        np.testing.assert_array_equal(tp.slots_for(view_ids), jp.slots_for(view_ids))
    # uploads write in place: the arrays a captured step reads never move
    assert {k: v.data_ptr() for k, v in tp.arrays.items()} == addrs


PLAN_CASES = {
    # name: (rf_iter, is_refining, N_voxel_list, update_AlphaMask_list)
    "upsample": (2, True, {5: 30**3}, []),
    "alpha-refresh": (3, True, {}, [4]),
    "rf-iter-1": (0, True, {}, []),
    "coarse": (5, False, {}, []),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_chunk_matches_jax(case):
    """The same batches and break points as JAX's plan_chunk around an
    upsample, an alpha refresh and the rescale at rf_iter 1."""
    rf_iter, refining, n_vox, alpha_list = PLAN_CASES[case]
    jm = jlocal.LocalTensorfs(_config(jlocal, jtf))
    tm = tlocal.LocalTensorfs(_config(tlocal, ttf), device="cpu")
    ds_j, ds_t = _dataset(cls=JSyntheticDataset), _dataset()
    jm.pool = object()  # index-only batches, as with a pool attached
    tm.pool = object()
    for m in (jm, tm):
        m.is_refining = refining
        m.rf_iter[-1] = rf_iter
        m.N_voxel_list = dict(n_vox)
        m.update_AlphaMask_list = list(alpha_list)
    for rnd in range(2):
        bj = jm.plan_chunk(ds_j, True, max_len=16)
        bt = tm.plan_chunk(ds_t, True, max_len=16)
        assert len(bt) == len(bj)
        if rnd == 0:  # the first chunk ends at its event
            assert (len(bt) < 16) == (case != "coarse")
        for a, b in zip(bt, bj):
            assert set(a) == set(b) == {"idx", "view_ids", "train_test_poses"}
            np.testing.assert_array_equal(a["idx"], b["idx"])
            assert a["train_test_poses"] == b["train_test_poses"]
        n_joint = sum(not b["train_test_poses"] for b in bt)
        for m in (jm, tm):
            m.rf_iter[-1] += n_joint if m.is_refining else 0


def _batches(ds, n=K):
    out = [ds.sample(BATCH, True, True, n_views=N_VIEWS) for _ in range(n)]
    assert [b["train_test_poses"] for b in out] == [False, False, True, False]
    return out


def test_run_chunk_pooled_matches_jax():
    """One pooled run_chunk of 4 steps (a pose-only step, an L1 on -> off
    flip, an alpha refresh after the last joint step) against JAX's."""
    jm = jlocal.LocalTensorfs(_config(jlocal, jtf, update_AlphaMask_list=[4], occ_min=4))
    tm = tlocal.LocalTensorfs(_config(tlocal, ttf, update_AlphaMask_list=[4], occ_min=4), device="cpu")
    field = field_from_jax(jax.device_get(jm.fields[-1]["params"]), device="cpu")
    tm.fields[-1]["params"] = field
    tm.fields[-1]["opt"] = pytree_adam_init(field)
    ds_j, ds_t = _dataset(cls=JSyntheticDataset), _dataset()
    jm.attach_pool(jpool.DevicePixelPool(ds_j, capacity=8))
    tm.attach_pool(DevicePixelPool(ds_t, capacity=8, device="cpu"))
    for m in (jm, tm):
        _schedule(m)
    bj = _batches(ds_j)
    bt = _batches(ds_t)

    key, noise = jm._key, []
    for _ in range(K):  # the keys jm.run_chunk will draw, in order
        key, sub = jax.random.split(key)
        noise.append(jax_noise(sub, tm.fields[-1]["cfg"].n_samples))
    tm._next_noise = lambda cfg: noise.pop(0)
    jm.run_chunk(bj, optimize_poses=True)
    tm.run_chunk(bt, optimize_poses=True)

    assert tm.rf_iter == jm.rf_iter == [5]
    assert set(tm.chunk_metrics) == set(jm.chunk_metrics)
    for k, v in jm.chunk_metrics.items():
        for step in range(K):
            np.testing.assert_allclose(tm.chunk_metrics[k][step], v[step],
                                       rtol=1e-4 if step == 0 else 1e-3, atol=1e-7, err_msg=f"{k} {step}")
    assert jm.chunk_metrics["l1_loss"][1] > 0 and jm.chunk_metrics["l1_loss"][2] == 0
    # the alpha refresh after the last joint step
    np.testing.assert_array_equal(tm.fields[-1]["alpha_volume"].numpy(),
                                  np.asarray(jm.fields[-1]["alpha_volume"]))
    assert tm.fields[-1]["cfg"].occ_m == jm.fields[-1]["cfg"].occ_m > 0
    jm.sync_window_to_host()
    tm.sync_window_to_host()
    np.testing.assert_allclose(tm.r_all, jm.r_all, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.t_all, jm.t_all, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.exp_all, jm.exp_all, rtol=1e-5, atol=1e-5)
    for k, v in jm.pose_opt_all.items():
        np.testing.assert_allclose(tm.pose_opt_all[k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    want = params_from_jax(jax.device_get(jm.fields[-1]["params"]), device="cpu")
    for k, p in tm.fields[-1]["params"].named_parameters():
        err = np.abs(p.detach().numpy() - want[k].numpy())
        assert err.max() <= 2e-3 and np.median(err) <= 1e-6, (k, err.max(), np.median(err))
    assert int(tm.fields[-1]["opt"].step) == int(jm.fields[-1]["opt"].step) == 3
    np.testing.assert_allclose(float(tm.fields[-1]["opt"].lr_scale),
                               float(jm.fields[-1]["opt"].lr_scale), rtol=1e-6)


@pytest.mark.parametrize("pooled", [True, False], ids=["pooled", "host-batches"])
def test_run_chunk_is_the_same_steps_one_at_a_time(pooled):
    """On the CPU, one run_chunk of 4 batches is bit for bit the same as 4
    run_chunks of one batch each (the pose-only step a chunk of its own):
    state, metrics, schedule, noise stream and the post-step alpha
    refresh. The chunks of one ship their batch values from the host; in
    the pooled case the chunk of 4 gathers them from a pixel pool, which
    must equal the host's values."""
    kw = dict(update_AlphaMask_list=[4], occ_min=4, lr_i_init=1e-3)
    m1 = tlocal.LocalTensorfs(_config(tlocal, ttf, **kw), device="cpu")
    m2 = tlocal.LocalTensorfs(_config(tlocal, ttf, **kw), device="cpu")
    ds1, ds2 = _dataset(), _dataset()
    if pooled:
        m2.attach_pool(DevicePixelPool(ds2, capacity=8, device="cpu"))
    for m in (m1, m2):
        _schedule(m)
    b1, b2 = _batches(ds1), _batches(ds2)
    steps = []
    for b in b1:
        m1.run_chunk([b], optimize_poses=True)
        steps.append(dict(m1.last_metrics))
    m2.run_chunk(b2, optimize_poses=True)

    assert m1.rf_iter == m2.rf_iter == [5]
    for i, m in enumerate(steps):
        for k, v in m.items():
            assert m2.chunk_metrics[k][i] == np.float32(v), (k, i)
    assert m2.last_metrics == steps[-1]
    f1, f2 = m1.fields[-1], m2.fields[-1]
    for (k, p1), (_, p2) in zip(f1["params"].named_parameters(), f2["params"].named_parameters()):
        assert torch.equal(p1, p2), k
        assert torch.equal(f1["opt"].m[k], f2["opt"].m[k]) and torch.equal(f1["opt"].v[k], f2["opt"].v[k])
    assert torch.equal(f1["opt"].step, f2["opt"].step) and torch.equal(f1["opt"].lr_scale, f2["opt"].lr_scale)
    assert torch.equal(f1["alpha_volume"], f2["alpha_volume"]) and f1["cfg"] == f2["cfg"]
    # the padded window rows hold NaN in both (see tests/test_torch_slice.py):
    # assert_array_equal counts NaN == NaN
    for name, a, b in zip(tstep.PoseState._fields, m1._pose_dev, m2._pose_dev):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=name)
    for k in m1.intr.params:
        assert torch.equal(m1.intr.params[k], m2.intr.params[k]), k
    assert torch.equal(m1.intr.opt.lr_scale, m2.intr.opt.lr_scale)
    assert torch.equal(m1._gen.get_state(), m2._gen.get_state())


def test_eager_reference_is_the_cpu_chunk():
    """eager_chunks.eager_steps, the eager reference that captured graphs
    are held against on a card, stands in for a model's graphs through
    ChunkGraphs.run's interface. On the CPU its chunk of 4 (a pose-only
    step and an alpha refresh among them) is bit for bit the CPU's own:
    metrics, field, pose window and noise stream."""
    from eager_chunks import EagerSteps, eager_steps

    kw = dict(update_AlphaMask_list=[4], occ_min=4, lr_i_init=1e-3)
    m1 = tlocal.LocalTensorfs(_config(tlocal, ttf, **kw), device="cpu")
    m2 = tlocal.LocalTensorfs(_config(tlocal, ttf, **kw), device="cpu")
    ds1, ds2 = _dataset(), _dataset()
    for m in (m1, m2):
        _schedule(m)
    m1.run_chunk(_batches(ds1), optimize_poses=True)
    with eager_steps(m2):
        assert isinstance(m2._graphs, EagerSteps)
        m2.run_chunk(_batches(ds2), optimize_poses=True)
    assert m2._graphs is None

    assert m1.rf_iter == m2.rf_iter == [5]
    for k, v in m1.chunk_metrics.items():
        np.testing.assert_array_equal(m2.chunk_metrics[k], v, err_msg=k)
    f1, f2 = m1.fields[-1], m2.fields[-1]
    for (k, p1), (_, p2) in zip(f1["params"].named_parameters(), f2["params"].named_parameters()):
        assert torch.equal(p1, p2), k
    assert torch.equal(f1["alpha_volume"], f2["alpha_volume"]) and f1["cfg"] == f2["cfg"]
    for name, a, b in zip(tstep.PoseState._fields, m1._pose_dev, m2._pose_dev):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=name)
    assert torch.equal(m1._gen.get_state(), m2._gen.get_state())


EVENTS = {"upsample": dict(N_voxel_list={4: 30**3}), "alpha-refresh": dict(update_AlphaMask_list=[4], occ_min=4)}


@pytest.mark.parametrize("event", list(EVENTS))
def test_test_pose_chunk_applies_no_event(event, monkeypatch):
    """A chunk of one test-pose batch at an rf_iter that keys a post-step
    event (an upsample, an alpha refresh) takes a pose-only step and
    applies no event: the field's grid and alpha volume stay as they were,
    rf_iter too, and it returns False. The next joint step applies the
    event once."""
    calls = {"upsample_tensorf": 0, "update_alpha_volume": 0}
    for name in calls:
        def counted(*args, _f=getattr(tlocal, name), _n=name, **kwargs):
            calls[_n] += 1
            return _f(*args, **kwargs)
        monkeypatch.setattr(tlocal, name, counted)
    m = tlocal.LocalTensorfs(_config(tlocal, ttf, **EVENTS[event]), device="cpu")
    ds = _dataset()
    _schedule(m, rf_iter=4)
    joint, _, test_pose, _ = _batches(ds)
    grid = m.fields[-1]["cfg"].grid_size
    pose_r = m._pose_dev.r.clone()
    assert not m.run_chunk([test_pose], optimize_poses=True)
    assert m.rf_iter == [4] and not torch.equal(m._pose_dev.r[:N_FRAMES], pose_r[:N_FRAMES])
    assert m.fields[-1]["cfg"].grid_size == grid and m.fields[-1]["alpha_volume"] is None
    assert calls == {"upsample_tensorf": 0, "update_alpha_volume": 0}
    m.run_chunk([joint], optimize_poses=True)
    assert m.rf_iter == [5]
    if event == "upsample":
        assert calls == {"upsample_tensorf": 1, "update_alpha_volume": 0}
        assert m.fields[-1]["cfg"].grid_size == (30, 30, 30) != grid
    else:
        assert calls == {"upsample_tensorf": 0, "update_alpha_volume": 1}
        assert m.fields[-1]["alpha_volume"] is not None


def test_chunk_on_cuda_needs_graphs():
    """A chunk on a card replays captured graphs: without an executor it
    raises (no eager fallback); a graph executor takes CUDA devices only."""
    from localrf_tpu_torch.models.graph import ChunkGraphs

    with pytest.raises(ValueError, match="CUDA"):
        ChunkGraphs("cpu")

    class OnCard:  # a pose window's device, all the executor looks at first
        class r:
            device = torch.device("cuda", 0)

    with pytest.raises(ValueError, match="replays captured graphs"):
        tstep.train_chunk(None, OnCard, None, {}, {}, None, {}, 1,
                          branches_seq=[tstep.StepBranches()])


class _NoHostData(TorchDispatchMode):
    """Raises on `aten.lift_fresh` of an array: a tensor made from host data
    (torch.tensor of a list, indexing with a tuple or list of ints), which on
    a card is a host-to-device copy inside the step. A 0-d lift is a Python
    scalar assigned into a slice (`x[:, -1] = False`), which a card fills in
    with a kernel argument, as a captured graph allows."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.lift_fresh.default and args[0].dim() > 0:
            raise AssertionError("a tensor made from host data inside the training step")
        return func(*args, **(kwargs or {}))


def _refuse(name):
    def fn(*args, **kwargs):
        raise AssertionError(f"{name} inside the training step")

    return fn


@contextlib.contextmanager
def _capture_trap(trap, monkeypatch):
    if trap == "host-data":
        with monkeypatch.context() as mp, _NoHostData():
            mp.setattr(torch, "as_tensor", _refuse("torch.as_tensor"))
            mp.setattr(torch, "from_numpy", _refuse("torch.from_numpy"))
            yield
    else:  # the RNG-state stash a checkpoint makes by default
        with monkeypatch.context() as mp:
            mp.setattr(torch, "get_rng_state", _refuse("torch.get_rng_state"))
            yield


@pytest.mark.parametrize("trap", ["host-data", "rng-state"])
def test_chunk_steps_fall_in_no_capture_trap(trap, monkeypatch):
    """What a captured CUDA graph refuses, caught on the CPU inside the
    chunk path's step (the pooled batch gather and train_core, which a card
    captures whole): a tensor made from host data (a host-to-device copy on
    a card: the aabb constants, the pixel centre, world2rf, tuple indexing)
    or the RNG-state stash of density_l1's checkpointed blocks (streamed here
    from a small grid on: l1_stream_min_vox 1, blocks of 3 planes' rows).
    The steps must still compute: the same losses as outside the trap."""
    monkeypatch.setattr(ttf, "L1_BLOCK_TARGET", 24 * 24 * 6)
    models = []
    for armed in (False, True):
        cfg = tlocal.LocalConfig(
            WH=(W, H), n_init_frames=N_FRAMES, n_views=N_VIEWS, batch_size=BATCH,
            update_AlphaMask_list=[4], occ_min=4, lr_i_init=1e-3,
            tensorf=ttf.TensorfConfig(**TF_KW, l1_stream_min_vox=1),
        )
        m = tlocal.LocalTensorfs(cfg, device="cpu")
        ds = _dataset()
        m.attach_pool(DevicePixelPool(ds, capacity=8, device="cpu"))
        _schedule(m)
        if armed:
            for name in ("train_core", "pooled_batch"):
                real = getattr(tstep, name)

                def trapped(*args, _real=real, **kwargs):
                    with _capture_trap(trap, monkeypatch):
                        return _real(*args, **kwargs)

                monkeypatch.setattr(tstep, name, trapped)
        m.run_chunk(_batches(ds), optimize_poses=True)  # an alpha refresh after it
        m.run_chunk([ds.sample(BATCH, True, True, n_views=N_VIEWS, values=False)],
                    optimize_poses=True)  # a step that marches against it
        models.append(m)
    assert models[1].fields[-1]["alpha_volume"] is not None
    for k, v in models[0].chunk_metrics.items():
        np.testing.assert_array_equal(models[1].chunk_metrics[k], v, err_msg=k)
