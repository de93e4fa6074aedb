"""A small checkpoint written by the JAX package, for the port's loader.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/jax_checkpoint_fixture.py

rewrites tests/fixtures/jax_ckpt_12.th and tests/fixtures/jax_ckpt_12_frame.npz:
a JAX LocalTensorfs at 12^3 (f32 tables and MLP, the compositing kernel
on) over 20x16 frames trained on the JAX CPU backend through a spawn and a
slide (train_jax_model), saved with localrf_tpu.checkpoint.save_checkpoint,
and JAX's CPU render of one blended view of it (FRAME_VIEW, chunk
FRAME_CHUNK): rgb, depth. tests/test_torch_checkpoint.py checks that the
file still loads in JAX and reproduces the frame, and that the port
renders it; chip_smoke.py renders it on the card.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

W, H = 20, 16
N_FRAMES, N_INIT = 10, 4
TF_KW = dict(grid_size=(12, 12, 12), pallas_composite=True, binned_min_rows=100)
LOCAL_KW = dict(WH=(W, H), n_init_frames=N_INIT, n_views=4, batch_size=64, n_overlap=3, fov=70.0)
FRAME_CHUNK = 160

HERE = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(HERE, "fixtures", "jax_ckpt_12.th")
FRAME = os.path.join(HERE, "fixtures", "jax_ckpt_12_frame.npz")


def dataset_arrays(seed: int = 0) -> dict:
    """Random frames with depth and flow supervision."""
    rng = np.random.default_rng(seed)
    shape = (N_FRAMES, H, W)
    return dict(
        rgbs=rng.random((*shape, 3), dtype=np.float32),
        invdepths=0.1 + 0.9 * rng.random(shape, dtype=np.float32),
        fwd_flow=rng.normal(0, 1, (*shape, 2)).astype(np.float32), fwd_mask=np.ones(shape, np.float32),
        bwd_flow=rng.normal(0, 1, (*shape, 2)).astype(np.float32), bwd_mask=np.ones(shape, np.float32),
    )


def make_dataset(cls, seed: int = 0):
    """A SyntheticDataset (the JAX package's or the port's class) over
    dataset_arrays(seed), N_INIT frames active."""
    a = dataset_arrays(seed)
    rgbs = a.pop("rgbs")
    return cls(rgbs, "train", n_init_frames=N_INIT, test_frame_every=0, **a)


def ball(shape, radius: float = 0.6) -> np.ndarray:
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, n) for n in shape], indexing="ij")
    return ((xx**2 + yy**2 + zz**2) < radius**2).astype(np.float32)


def train_jax_model(tf_kw: dict | None = None, **local_kw):
    """The JAX model and dataset after 2 steps on field 0, a ball alpha
    volume on it, 3 frame appends (a step after each), a spawn over those 3
    frames, the windows slid to the new field's first frame, one more
    frame and 2 steps on field 1; then both fields' density planes scaled
    by 20, so that eval rays saturate instead of passing through nearly
    empty fields. Returns (model, dataset)."""
    import jax.numpy as jnp

    from localrf_tpu.data.dataset import SyntheticDataset
    from localrf_tpu.models.local import LocalConfig, LocalTensorfs
    from localrf_tpu.models.tensorf import TensorfConfig

    m = LocalTensorfs(LocalConfig(tensorf=TensorfConfig(**{**TF_KW, **(tf_kw or {})}),
                                  **{**LOCAL_KW, **local_kw}))
    ds = make_dataset(SyntheticDataset)

    def step():
        batch = ds.sample(m.cfg.batch_size, m.is_refining, True, n_views=m.cfg.n_views)
        if batch["train_test_poses"]:
            m.optimizer_step_poses_only(batch)
        else:
            m.optimizer_step(batch, optimize_poses=True)

    m.is_refining = True
    for _ in range(2):
        step()
    f = m.fields[0]
    f["alpha_volume"] = jnp.asarray(ball(tuple(g // 2 for g in f["cfg"].grid_size)))
    f["cfg"] = dataclasses.replace(f["cfg"], occ_m=m._occ_m(f["cfg"], True))
    for _ in range(3):
        m.append_frame()
        ds.activate_frames()
        step()
    m.append_rf(3)
    first = int(np.argmax(m.blending_weights[:, -1] > 0))
    ds.deactivate_frames(first)
    m.set_window_start(first)
    m.append_frame()
    ds.activate_frames()
    m.is_refining = True
    for _ in range(2):
        step()
    for f in m.fields:
        f["params"] = {k: v * 20 if k.startswith("density_plane") else v for k, v in f["params"].items()}
    return m, ds


def extra_of(ds) -> dict:
    """The training loop's `extra` for save_checkpoint (the dataset window)."""
    return {"iteration": 9, "n_added_frames": 1, "last_add_iter": 7,
            "active_bounds": tuple(ds.active_frames_bounds)}


def frame_view(model) -> int:
    """A view inside the cross-fade: both fields' weights nonzero."""
    bw = model.blending_weights
    return int(np.nonzero((bw > 0).all(axis=1))[0][0])


def render_view(model, view: int):
    """JAX forward_eval of every pixel of `view` at FRAME_CHUNK: (rgb, depth)
    as numpy."""
    rgb, depth, _, _ = model.forward_eval(np.arange(W * H), np.array([view]), W, H, chunk=FRAME_CHUNK)
    return np.asarray(rgb), np.asarray(depth)


def main() -> None:
    from localrf_tpu.checkpoint import save_checkpoint

    model, ds = train_jax_model()
    os.makedirs(os.path.dirname(CKPT), exist_ok=True)
    save_checkpoint(model, CKPT, extra=extra_of(ds))
    view = frame_view(model)
    rgb, depth = render_view(model, view)
    np.savez(FRAME, view=view, chunk=FRAME_CHUNK, rgb=rgb, depth=depth)
    print(f"wrote {CKPT} ({os.path.getsize(CKPT)} B) and {FRAME}: view {view}, weights"
          f" {model.blending_weights[view].tolist()}, rgb in [{rgb.min():.3f}, {rgb.max():.3f}]")


if __name__ == "__main__":
    main()
