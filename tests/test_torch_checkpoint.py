"""Checkpoints across the two packages: a file written by the JAX package
(localrf_tpu.checkpoint.save_checkpoint) loads in the port bit for bit and
trains and renders on as JAX does; a port file round-trips; the loader
imports neither JAX nor ml_dtypes nor the JAX package.

The JAX model (tests/jax_checkpoint_fixture.py::train_jax_model): 12^3, f32
tables, 20x16 frames, trained on the JAX CPU backend through a spawn and a
slide, a ball alpha volume on the retired field. After loading, both
packages take a step and a pooled chunk of 4 from the same file, JAX's
noise injected, held to tests/test_torch_local.py's tolerances (losses
rtol 1e-4 on the first step and 1e-3 after, poses 1e-5, parameters 2e-3
absolute with a median of 1e-6); an eval frame to tests/test_torch_eval.py's
(rgb and depth rtol 1e-4 / atol 1e-4). Everything the loader restores is
equal bit for bit.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_checkpoint_fixture as fx
from localrf_tpu import checkpoint as jckpt
from localrf_tpu.data import pool as jpool
from localrf_tpu.data.dataset import SyntheticDataset as JSyntheticDataset
from localrf_tpu_torch import checkpoint as tckpt
from localrf_tpu_torch.data.dataset import SyntheticDataset
from localrf_tpu_torch.data.pool import DevicePixelPool
from test_torch_local import jax_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    """(path, JAX model, dataset window) of a JAX-written checkpoint."""
    model, ds = fx.train_jax_model()
    path = str(tmp_path_factory.mktemp("ckpt") / "jax.th")
    jckpt.save_checkpoint(model, path, extra=fx.extra_of(ds))
    return path, model, tuple(ds.active_frames_bounds)


def _raw(path: str) -> dict:
    """The file as the JAX package reads it (numpy arrays, JAX classes)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def _bits(x) -> np.ndarray:
    """A tensor or array as raw bits (bf16 and f32 alike), for equality."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def assert_bits(got, want, what: str):
    a, b = _bits(got), _bits(want)
    assert a.shape == b.shape and a.dtype == b.dtype, f"{what}: {a.shape} {a.dtype} vs {b.shape} {b.dtype}"
    assert a.tobytes() == b.tobytes(), what


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def assert_model_is_file(tm, raw: dict):
    """Every array the port model holds equals the file's, bit for bit."""
    fr = raw["frames"]
    for k in ("r_all", "t_all", "exp_all", "blending_weights"):
        assert_bits(getattr(tm, k), fr[k], k)
    assert sorted(tm.pose_opt_all) == sorted(fr["pose_opt_all"])
    for k, v in fr["pose_opt_all"].items():
        assert_bits(tm.pose_opt_all[k], v, f"pose_opt_all.{k}")
    assert tm.pose_linked_rf == list(fr["pose_linked_rf"])
    assert tm.rf_iter == list(raw["rf_iter"]) and tm.win_start == raw["win_start"]
    for a, b in zip(tm.world2rf, raw["world2rf"], strict=True):
        assert_bits(a, b, "world2rf")
    assert tm.init_focal == raw["init_focal"]
    sch = raw["schedule"]
    assert (tm.is_refining, tm.lr_factor, tm.n_iters, tm.n_iters_reg) == (
        sch["is_refining"], sch["lr_factor"], sch["n_iters"], sch["n_iters_reg"])
    assert tm.N_voxel_list == sch["N_voxel_list"] and tm.update_AlphaMask_list == sch["update_AlphaMask_list"]
    assert len(tm.fields) == len(raw["fields"])
    for i, (f, entry) in enumerate(zip(tm.fields, raw["fields"])):
        last = i == len(tm.fields) - 1
        want = _flat(entry["params"])
        got = dict(f["params"].named_parameters())
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].device == (tm.device if last else torch.device("cpu")), k
            assert_bits(got[k], v, f"field {i} {k}")
        assert f["cfg"].grid_size == tuple(entry["grid_size"])
        if entry["alpha_bits"] is None:
            assert f["alpha_volume"] is None
        else:
            n = int(np.prod(entry["alpha_shape"]))
            alpha = np.unpackbits(entry["alpha_bits"])[:n].reshape(entry["alpha_shape"]).astype(np.float32)
            assert_bits(f["alpha_volume"], alpha, f"field {i} alpha")
        opt = entry["opt"]
        if opt is None:
            assert f["opt"] is None
            continue
        get = (lambda k: opt[k]) if isinstance(opt, dict) else (lambda k: getattr(opt, k))
        for part in ("m", "v"):
            for k, v in _flat(get(part)).items():
                got_m = getattr(f["opt"], part)[k]
                assert got_m.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[tm.cfg.moment_dtype]
                # a port file widens bf16 moments to f32; f32 holds bf16 exactly
                assert_bits(got_m.float(), np.asarray(v).astype(np.float32), f"field {i} {part}.{k}")
        assert_bits(f["opt"].step, get("step"), f"field {i} step")
        assert_bits(f["opt"].lr_scale, get("lr_scale"), f"field {i} lr_scale")
    intr = raw["intr"]
    for k, v in intr["params"].items():
        assert_bits(tm.intr.params[k], v, f"intr {k}")
    iopt = intr["opt"]
    iget = (lambda k: iopt[k]) if isinstance(iopt, dict) else (lambda k: getattr(iopt, k))
    for part in ("m", "v"):
        for k, v in iget(part).items():
            assert_bits(getattr(tm.intr.opt, part)[k], v, f"intr {part}.{k}")
    assert_bits(tm.intr.opt.step, iget("step"), "intr step")
    assert_bits(tm.intr.opt.lr_scale, iget("lr_scale"), "intr lr_scale")
    # the device pose window is the host history's slice
    s, n = tm.win_start, tm.win_len
    assert_bits(tm._pose_dev.t[:n], fr["t_all"][s:s + n], "window t")
    assert_bits(tm._pose_dev.r_opt.v[:n], fr["pose_opt_all"]["r_v"][s:s + n], "window r_v")


def test_jax_checkpoint_loads_bit_for_bit(jax_file):
    """A JAX-written file (two fields, a slid window, an alpha volume, moved
    poses, moments and intrinsics) loads in the port: every array equal bit
    for bit, the last field on the device with its moments, the retired one
    on the host without, the config equal to JAX's, the extra as saved."""
    path, jm, bounds = jax_file
    tm, extra = tckpt.load_checkpoint(path, return_extra=True, device="cpu")
    raw = _raw(path)
    assert type(raw["fields"][-1]["opt"]).__module__ == "localrf_tpu.optim"  # JAX's class in the file
    assert_model_is_file(tm, raw)
    assert len(tm.fields) == 2 and tm.win_start > 0 and tm.fields[0]["alpha_volume"] is not None
    assert tm.fields[0]["opt"] is None and tm.fields[1]["opt"] is not None
    assert float(tm.fields[1]["opt"].step) > 0
    want = dataclasses.asdict(jm.cfg)
    got = dataclasses.asdict(tm.cfg)
    got["tensorf"].pop("l1_stream_min_vox")  # the port's own (JAX reads an env var)
    assert got["tensorf"].pop("decomposition") == "vm"  # the port's own: JAX has the VM field only
    assert got == want
    assert [f["cfg"].occ_m for f in tm.fields] == [f["cfg"].occ_m for f in jm.fields]
    assert tuple(extra["active_bounds"]) == bounds and extra["iteration"] == 9
    # JAX reseeds PRNGKey(seed + 1); the port its generator with seed + 1
    want_gen = torch.Generator().manual_seed(tm.cfg.seed + 1)
    assert torch.equal(tm._gen.get_state(), want_gen.get_state())


def _datasets(bounds):
    """The JAX and port datasets of the fixture's frames at the file's window."""
    out = []
    for cls in (JSyntheticDataset, SyntheticDataset):
        ds = fx.make_dataset(cls)
        ds.activate_frames(bounds[1] - ds.active_frames_bounds[1])
        ds.deactivate_frames(bounds[0])
        out.append(ds)
    return out


def _params_close(tm, jm):
    jp = _flat(jax.device_get(jm.fields[-1]["params"]))
    for name, p in tm.fields[-1]["params"].named_parameters():
        err = np.abs(p.detach().numpy() - np.asarray(jp[name]))
        assert err.max() <= 2e-3 and np.median(err) <= 1e-6, name


def _poses_close(tm, jm):
    jm.sync_window_to_host()
    tm.sync_window_to_host()
    for k in ("r_all", "t_all", "exp_all"):
        np.testing.assert_allclose(getattr(tm, k), getattr(jm, k), rtol=1e-5, atol=1e-5, err_msg=k)


def test_step_and_chunk_after_loading_match_jax(jax_file):
    """From the same JAX file, JAX and the port take one step (JAX's
    optimizer_step, the port's chunk of one), then
    a pooled run_chunk of 4 steps, with JAX's noise: the losses, the pose
    window and the new field parameters agree."""
    path, _, bounds = jax_file
    jm = jckpt.load_checkpoint(path)
    tm = tckpt.load_checkpoint(path, device="cpu")
    ds_j, ds_t = _datasets(bounds)
    n_samples = tm.fields[-1]["cfg"].n_samples
    bj = ds_j.sample(64, jm.is_refining, True, n_views=4)
    bt = ds_t.sample(64, tm.is_refining, True, n_views=4)
    np.testing.assert_array_equal(bj["view_ids"], bt["view_ids"])
    assert not bt["train_test_poses"]
    _, sub = jax.random.split(jm._key)  # the key jm's step will draw
    noise = [jax_noise(sub, n_samples)]
    tm._next_noise = lambda cfg: noise.pop(0)
    jm.optimizer_step(bj, optimize_poses=True)
    tm.run_chunk([bt], optimize_poses=True)
    for k, v in jm.last_metrics.items():
        np.testing.assert_allclose(tm.last_metrics[k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    _params_close(tm, jm)
    _poses_close(tm, jm)

    jm.attach_pool(jpool.DevicePixelPool(ds_j, capacity=8))
    tm.attach_pool(DevicePixelPool(ds_t, capacity=8, device="cpu"))
    k = 4
    bj = [ds_j.sample(64, True, True, n_views=4, values=False) for _ in range(k)]
    bt = [ds_t.sample(64, True, True, n_views=4, values=False) for _ in range(k)]
    key = jm._key
    for _ in range(k):  # the keys jm.run_chunk will draw, in order
        key, sub = jax.random.split(key)
        noise.append(jax_noise(sub, n_samples))
    jm.run_chunk(bj, optimize_poses=True)
    tm.run_chunk(bt, optimize_poses=True)
    assert tm.rf_iter == jm.rf_iter
    for name, v in jm.chunk_metrics.items():
        for step in range(k):
            np.testing.assert_allclose(tm.chunk_metrics[name][step], v[step], rtol=1e-4 if step == 0 else 1e-3,
                                       atol=1e-7, err_msg=f"{name} {step}")
    _poses_close(tm, jm)
    _params_close(tm, jm)


def test_eval_frame_after_loading_matches_jax(jax_file):
    """A blended eval frame of the loaded port model equals the JAX model's
    (the one that wrote the file) to test_torch_eval's tolerances."""
    path, jm, _ = jax_file
    tm = tckpt.load_checkpoint(path, device="cpu")
    view = fx.frame_view(jm)
    ids = np.arange(fx.W * fx.H)
    rgb_j, depth_j, _, _ = jm.forward_eval(ids, np.array([view]), fx.W, fx.H, chunk=fx.FRAME_CHUNK)
    rgb, depth, _, _ = tm.forward_eval(ids, np.array([view]), fx.W, fx.H, chunk=fx.FRAME_CHUNK)
    np.testing.assert_allclose(rgb.numpy(), rgb_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(depth.numpy(), depth_j, rtol=1e-4, atol=1e-4)
    assert float(np.ptp(np.asarray(depth_j))) > 1.0  # the rays hit density
    assert "_dev_cache" in tm.fields[0]  # the retired field rendered from the host


def _state(tm) -> dict:
    """Every tensor and array of a port model's state, by name."""
    out = {k: getattr(tm, k) for k in ("r_all", "t_all", "exp_all", "blending_weights")}
    out.update({f"pose_opt.{k}": v for k, v in tm.pose_opt_all.items()})
    for i, f in enumerate(tm.fields):
        out.update({f"f{i}.{k}": v for k, v in f["params"].named_parameters()})
        if f["alpha_volume"] is not None:
            out[f"f{i}.alpha"] = f["alpha_volume"]
        if f["opt"] is not None:
            out.update({f"f{i}.m.{k}": v for k, v in f["opt"].m.items()})
            out.update({f"f{i}.v.{k}": v for k, v in f["opt"].v.items()})
            out.update({f"f{i}.step": f["opt"].step, f"f{i}.lr_scale": f["opt"].lr_scale})
    out.update({f"intr.{k}": v for k, v in tm.intr.params.items()})
    out.update({f"intr.m.{k}": v for k, v in tm.intr.opt.m.items()})
    out.update({"intr.step": tm.intr.opt.step, "intr.lr_scale": tm.intr.opt.lr_scale})
    # the live rows of the device window (padding rows are never read, and
    # a gated-off update leaves NaN there: ROADMAP "Numeric traps")
    for name, val in tm._pose_dev._asdict().items():
        vals = val if isinstance(val, tuple) else (val,)
        out.update({f"window.{name}.{j}": x[:tm.win_len] for j, x in enumerate(vals)})
    return out


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_port_file_round_trips(jax_file, tmp_path, moment_dtype):
    """Port model -> save -> load: the same state bit for bit (bf16 moments
    too), the same eval frame, and the same next step under the same noise,
    exactly (CPU)."""
    path, _, bounds = jax_file
    tm = tckpt.load_checkpoint(path, device="cpu")
    if moment_dtype == "bfloat16":
        tm.cfg = dataclasses.replace(tm.cfg, moment_dtype="bfloat16")
        opt = tm.fields[-1]["opt"]
        tm.fields[-1]["opt"] = opt._replace(m={k: v.bfloat16() for k, v in opt.m.items()},
                                            v={k: v.bfloat16() for k, v in opt.v.items()})
    _, ds = _datasets(bounds)
    tm.run_chunk([ds.sample(64, True, True, n_views=4)], optimize_poses=True)
    out = str(tmp_path / "port.th")
    tckpt.save_checkpoint(tm, out, extra={"iteration": 3})
    t2, extra = tckpt.load_checkpoint(out, return_extra=True, device="cpu")
    assert extra == {"iteration": 3}
    a, b = _state(tm), _state(t2)
    assert sorted(a) == sorted(b)
    for k in a:
        assert_bits(b[k], a[k], k)
    if moment_dtype == "bfloat16":
        assert t2.fields[-1]["opt"].m["basis_mat"].dtype == torch.bfloat16
    with open(out, "rb") as f:
        assert b"localrf_tpu" not in f.read()  # plain dicts: no class of either package
    ids = np.arange(fx.W * fx.H)
    view = fx.frame_view(tm)
    for x, y in zip(tm.forward_eval(ids, np.array([view]), fx.W, fx.H, chunk=fx.FRAME_CHUNK),
                    t2.forward_eval(ids, np.array([view]), fx.W, fx.H, chunk=fx.FRAME_CHUNK)):
        assert torch.equal(x, y)
    batch = ds.sample(64, True, True, n_views=4)
    noise = tm._next_noise(tm.fields[-1]["cfg"])
    for m in (tm, t2):
        m._next_noise = lambda cfg: noise
        m.run_chunk([batch], optimize_poses=True)
    assert tm.last_metrics == t2.last_metrics
    a, b = _state(tm), _state(t2)
    for k in a:
        assert_bits(b[k], a[k], k)


def _rewrite(path: str, out: str, edit) -> None:
    """The JAX file with edit(state) applied, pickled as JAX pickles it."""
    state = _raw(path)
    edit(state)
    with open(out, "wb") as f:
        pickle.dump(state, f, protocol=4)


def test_xla_only_flags_are_mapped(jax_file, tmp_path, capsys):
    """A JAX file whose TensorfConfig sets the XLA gather workarounds loads
    with the port's values (the same math) and says so; fast_gather=False
    is the grid-sample route, which the port has: it loads as False,
    silently; an unknown shading mode raises as in JAX (ValueError)."""
    path, _, _ = jax_file
    out = str(tmp_path / "flags.th")
    flags = dict(fused_plane_gather=True, fused_fwd_gather=2, fused_line_gather=True)
    _rewrite(path, out, lambda s: s["kwargs"]["tensorf"].update(flags, fast_gather=False))
    tm = tckpt.load_checkpoint(out, device="cpu")
    said = capsys.readouterr().out
    for k, v in flags.items():
        assert getattr(tm.cfg.tensorf, k) == tckpt.XLA_ONLY_FLAGS[k] != v
        assert f"TensorfConfig.{k}={v!r}" in said
    assert "fast_gather" not in tckpt.XLA_ONLY_FLAGS and "fast_gather" not in said
    assert tm.cfg.tensorf.fast_gather is False
    assert not any(getattr(f["cfg"], "fast_gather") for f in tm.fields)
    _rewrite(path, out, lambda s: s["kwargs"]["tensorf"].update(shading_mode="SH"))
    with pytest.raises(ValueError, match="shading mode SH"):
        tckpt.load_checkpoint(out, device="cpu")


def _mlp_fea(state: dict) -> None:
    """The committed fixture rewritten to TensoRF's published head (MLP_Fea,
    fea_pe 2, view_pe 2): each field's w1 re-shaped to that head's inputs
    (seeded values) and w3 to its hidden width alone (the viewdirs enter at
    layer 1), their Adam moments zeroed to match."""
    tf = state["kwargs"]["tensorf"]
    tf.update(shading_mode="MLP_Fea", fea_pe=2, view_pe=2)
    n_in = 2 * 2 * 3 + 2 * 2 * tf["app_dim"] + 3 + tf["app_dim"]
    rng = np.random.default_rng(0)
    for entry in state["fields"]:
        mlp = entry["params"]["mlp"]
        fc = mlp["w1"].shape[1]
        mlp["w1"] = (rng.uniform(-1, 1, (n_in, fc)) / np.sqrt(n_in)).astype(mlp["w1"].dtype)
        mlp["w3"] = mlp["w3"][:fc]
        opt = entry["opt"]
        if opt is not None:
            for part in (opt.m, opt.v):
                part["mlp"]["w1"] = np.zeros((n_in, fc), np.asarray(part["mlp"]["w1"]).dtype)
                part["mlp"]["w3"] = np.asarray(part["mlp"]["w3"])[:fc]


def test_jax_file_in_the_mlp_fea_head_loads(tmp_path):
    """The committed JAX fixture rewritten to shading_mode MLP_Fea loads bit
    for bit, and the port renders its frame as JAX does from the same file
    (rgb and depth rtol 1e-4 / atol 1e-4)."""
    out = str(tmp_path / "mlp_fea.th")
    _rewrite(fx.CKPT, out, _mlp_fea)
    tm = tckpt.load_checkpoint(out, device="cpu")
    assert tm.cfg.tensorf.shading_mode == "MLP_Fea" and tm.fields[-1]["params"]["mlp"]["w1"].shape[0] == 150
    assert_model_is_file(tm, _raw(out))
    jm = jckpt.load_checkpoint(out)
    view, ids = fx.frame_view(jm), np.arange(fx.W * fx.H)
    rgb_j, depth_j, _, _ = jm.forward_eval(ids, np.array([view]), fx.W, fx.H, chunk=fx.FRAME_CHUNK)
    rgb, depth, _, _ = tm.forward_eval(ids, np.array([view]), fx.W, fx.H, chunk=fx.FRAME_CHUNK)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(depth.numpy(), np.asarray(depth_j), rtol=1e-4, atol=1e-4)


def test_rgb_head_round_trips_with_an_empty_mlp(tmp_path):
    """A port model in the RGB head (no MLP) writes `{"mlp": {}}` into each
    field's params and moments, the tree JAX's init_tensorf makes for that
    head, and loads back bit for bit."""
    from localrf_tpu.models import tensorf as jtf
    from localrf_tpu_torch.models.local import LocalConfig, LocalTensorfs
    from localrf_tpu_torch.models.tensorf import TensorfConfig

    tf = dict(grid_size=(12, 12, 12), shading_mode="RGB", app_dim=3)
    tm = LocalTensorfs(LocalConfig(WH=(fx.W, fx.H), n_init_frames=fx.N_INIT, tensorf=TensorfConfig(**tf)),
                       device="cpu")
    out = str(tmp_path / "rgb.th")
    tckpt.save_checkpoint(tm, out)
    raw = _raw(out)
    entry = raw["fields"][-1]
    assert entry["params"]["mlp"] == {} and entry["opt"]["m"]["mlp"] == {} and entry["opt"]["v"]["mlp"] == {}
    want = jtf.init_tensorf(jax.random.PRNGKey(0), jtf.TensorfConfig(**tf))
    assert jax.tree.structure(entry["params"]) == jax.tree.structure(want)
    assert "mlp" not in raw["intr"]["opt"]["m"]
    t2 = tckpt.load_checkpoint(out, device="cpu")
    assert_model_is_file(t2, raw)
    assert not list(t2.fields[-1]["params"].mlp.parameters())


def test_loader_refuses_other_classes(tmp_path):
    """Only the classes a checkpoint holds unpickle: another class of the
    JAX package, or any other global, raises before anything runs."""
    for name, obj in (("jax_class", jpool.DevicePixelPool), ("os_system", os.system)):
        p = str(tmp_path / f"{name}.th")
        with open(p, "wb") as f:
            pickle.dump({"version": 1, "x": obj}, f, protocol=4)
        with pytest.raises(pickle.UnpicklingError):
            tckpt.read_checkpoint(p)


_BLOCKED_LOAD = r"""
import importlib.abc, sys
import numpy as np

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "localrf_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import torch
from localrf_tpu_torch.checkpoint import load_checkpoint

out = {}
for tag, path in zip(("f32", "bf16"), sys.argv[1:3]):
    m = load_checkpoint(path, device="cpu")
    opt = m.fields[-1]["opt"]
    for part in ("m", "v"):
        for k, t in getattr(opt, part).items():
            out[f"{tag}.{part}.{k}"] = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
np.savez(sys.argv[3], **out)
print(sorted({n.split(".")[0] for n in sys.modules} & {"jax", "jaxlib", "ml_dtypes", "localrf_tpu"}))
"""


def test_loads_in_a_fresh_interpreter_without_jax_or_ml_dtypes(jax_file, tmp_path):
    """In an interpreter where jax, ml_dtypes and the JAX package cannot be
    imported, the port loads the JAX file and a JAX file with bfloat16 Adam
    moments (written by JAX's save_checkpoint under --moment_dtype
    bfloat16): the moments' bits equal the file's, and none of those
    modules is in sys.modules after."""
    path, jm, _ = jax_file
    bf16_path = str(tmp_path / "bf16.th")
    f = jm.fields[-1]
    saved = jm.cfg, f["opt"]
    try:
        jm.cfg = dataclasses.replace(jm.cfg, moment_dtype="bfloat16")
        f["opt"] = f["opt"]._replace(m=jax.tree.map(lambda x: x.astype(jnp.bfloat16), f["opt"].m),
                                     v=jax.tree.map(lambda x: x.astype(jnp.bfloat16), f["opt"].v))
        jckpt.save_checkpoint(jm, bf16_path)
    finally:
        jm.cfg, f["opt"] = saved
    out = str(tmp_path / "moments.npz")
    run = subprocess.run([sys.executable, "-c", _BLOCKED_LOAD, path, bf16_path, out], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.split()[-1] == "[]", run.stdout
    got = np.load(out)
    for tag, p in (("f32", path), ("bf16", bf16_path)):
        opt = _raw(p)["fields"][-1]["opt"]
        for part in ("m", "v"):
            for k, v in _flat(getattr(opt, part)).items():
                want = np.asarray(v)
                assert want.dtype.name == ("bfloat16" if tag == "bf16" else "float32")
                assert got[f"{tag}.{part}.{k}"].tobytes() == want.tobytes(), f"{tag} {part}.{k}"


def test_committed_fixture_loads_in_jax_and_the_port():
    """tests/fixtures/jax_ckpt_12.th (written by tests/jax_checkpoint_fixture.py)
    still loads in JAX and reproduces its stored frame (rtol 1e-6, the same
    CPU computation), and the port renders it within the eval tolerances
    (chip_smoke.py renders it on the card)."""
    frame = np.load(fx.FRAME)
    view, chunk = int(frame["view"]), int(frame["chunk"])
    ids = np.arange(fx.W * fx.H)
    jm = jckpt.load_checkpoint(fx.CKPT)
    rgb_j, depth_j, _, _ = jm.forward_eval(ids, np.array([view]), fx.W, fx.H, chunk=chunk)
    np.testing.assert_allclose(np.asarray(rgb_j), frame["rgb"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(depth_j), frame["depth"], rtol=1e-6, atol=1e-6)
    tm = tckpt.load_checkpoint(fx.CKPT, device="cpu")
    assert_model_is_file(tm, _raw(fx.CKPT))
    rgb, depth, _, _ = tm.forward_eval(ids, np.array([view]), fx.W, fx.H, chunk=chunk)
    np.testing.assert_allclose(rgb.numpy(), frame["rgb"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(depth.numpy(), frame["depth"], rtol=1e-4, atol=1e-4)
    assert os.path.getsize(fx.CKPT) < 1 << 20
