"""Checkpoint save/load of the full progressive state (PyTorch port of
localrf_tpu/checkpoint.py).

The file is the JAX package's pickle: a dict with `version`, `kwargs`
(`dataclasses.asdict` of the LocalConfig), `frames` (the host pose,
exposure and pose-optimizer history, the pose links and blending
weights), `fields` (each field's params nested as in JAX, `{"mlp": {"w1":
...}}`, its grid, its alpha volume bit-packed with `np.packbits`, and its
Adam state), `world2rf`, `rf_iter`, `intr`, `init_focal`, `win_start`,
`extra` (the training loop's counters) and `schedule`. Every array is a
numpy array.

The port writes each Adam state as a plain dict (`m`, `v`, `step`,
`lr_scale`), so that reading a port file needs no class of either
package, and bfloat16 moments widened to float32 (exact; the loader
narrows them to the config's `moment_dtype` again). A JAX-written file
pickles `localrf_tpu.optim.PyTreeAdamState` and, under `--moment_dtype
bfloat16`, `ml_dtypes.bfloat16` arrays: the loader's unpickler maps the
first to a local NamedTuple of the same fields and reads the second's raw
16 bits as `torch.bfloat16`, so neither JAX nor ml_dtypes is imported.
Any other class of the JAX package, or any class outside numpy's array
reconstruction, is refused.
"""
from __future__ import annotations

import dataclasses
import importlib
import pickle
from typing import Any, NamedTuple

import numpy as np
import torch

from .models.graph import ChunkGraphs
from .models.local import LocalConfig, LocalTensorfs
from .models.step import IntrState
from .models.tensorf import TensorfConfig, TensorfField
from .optim import PyTreeAdamState, pytree_adam_init

FORMAT_VERSION = 1

# TensorfConfig options of the JAX package that only steer how XLA gathers
# on a TPU (ROADMAP, North star): the math is the same, so a checkpoint
# that set them loads with the port's value (fast_gather=False is another
# route, the grid-sample one, and loads as it is)
XLA_ONLY_FLAGS = {
    "fused_plane_gather": False,
    "fused_fwd_gather": 0,
    "fused_line_gather": False,
}


# ------------------------------------------------------------------
# save
# ------------------------------------------------------------------


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy().copy()


def _nested(named: dict[str, torch.Tensor]) -> dict:
    """{"density_plane_0": t, "mlp.w1": t} -> {"density_plane_0": a, "mlp": {"w1": a}}."""
    out: dict = {}
    for name, t in named.items():
        *parents, leaf = name.split(".")
        d = out
        for p in parents:
            d = d.setdefault(p, {})
        d[leaf] = _host(t)
    return out


def _field_tree(named: dict[str, torch.Tensor]) -> dict:
    """A field's params (or moments) nested as JAX nests them: `mlp` is there
    even when empty (the RGB head has no MLP; JAX keeps `{"mlp": {}}`)."""
    tree = _nested(named)
    tree.setdefault("mlp", {})
    return tree


def _adam_dict(opt: PyTreeAdamState, tree=_nested) -> dict:
    return {"m": tree(opt.m), "v": tree(opt.v), "step": _host(opt.step), "lr_scale": _host(opt.lr_scale)}


def save_checkpoint(model: LocalTensorfs, path: str, extra: dict | None = None) -> None:
    """Serialize a LocalTensorfs (the device pose window is synced to the
    host first). `extra` carries the training loop's state (iteration
    counters, the dataset's window) for a resume mid-run."""
    model.sync_window_to_host()
    fields = []
    for f in model.fields:
        alpha = f["alpha_volume"]
        entry = {
            "params": _field_tree(dict(f["params"].named_parameters())),
            "grid_size": tuple(f["cfg"].grid_size),
            "alpha_shape": None,
            "alpha_bits": None,
            "opt": _adam_dict(f["opt"], _field_tree) if f["opt"] is not None else None,
        }
        if alpha is not None:
            a = alpha.detach().cpu().numpy().astype(bool)
            entry["alpha_shape"] = a.shape
            entry["alpha_bits"] = np.packbits(a.reshape(-1))
        fields.append(entry)

    state = {
        "version": FORMAT_VERSION,
        "kwargs": dataclasses.asdict(model.cfg),
        "frames": {
            "r_all": model.r_all,
            "t_all": model.t_all,
            "exp_all": model.exp_all,
            "pose_opt_all": model.pose_opt_all,
            "pose_linked_rf": list(model.pose_linked_rf),
            "blending_weights": model.blending_weights,
        },
        "fields": fields,
        "world2rf": [np.asarray(w) for w in model.world2rf],
        "rf_iter": list(model.rf_iter),
        "intr": {
            "params": {k: _host(v) for k, v in model.intr.params.items()},
            "opt": _adam_dict(model.intr.opt),
        },
        "init_focal": model.init_focal,
        "win_start": model.win_start,
        "extra": dict(extra) if extra else {},
        "schedule": {
            "is_refining": model.is_refining,
            "lr_factor": model.lr_factor,
            "n_iters": model.n_iters,
            "n_iters_reg": model.n_iters_reg,
            "N_voxel_list": dict(model.N_voxel_list),
            "update_AlphaMask_list": list(model.update_AlphaMask_list),
        },
    }
    with open(path, "wb") as f:
        pickle.dump(state, f, protocol=4)


# ------------------------------------------------------------------
# load
# ------------------------------------------------------------------


class SavedAdamState(NamedTuple):
    """What a JAX file's `localrf_tpu.optim.PyTreeAdamState` unpickles to
    (its fields, holding numpy arrays)."""

    m: Any
    v: Any
    step: Any
    lr_scale: Any


class _Bf16:
    """Stands for `ml_dtypes.bfloat16` (and for the numpy dtype made from
    it) while a file is read."""

    def __setstate__(self, state):
        pass


_BF16 = _Bf16()


def _numpy_multiarray():
    """numpy 2 names its array module numpy._core.multiarray, numpy 1
    numpy.core.multiarray; a file names the one it was written under."""
    try:
        return importlib.import_module("numpy._core.multiarray")
    except ImportError:
        return importlib.import_module("numpy.core.multiarray")


class _ArrayStub:
    """What numpy's `_reconstruct` returns while a file is read: its state
    becomes an ndarray, or, for a bfloat16 array, a CPU torch.bfloat16
    tensor of the same bits."""

    value: Any = None

    def __setstate__(self, state):
        _, shape, dtype, is_fortran, raw = state
        if isinstance(dtype, _Bf16):
            bits = np.frombuffer(raw, np.int16).reshape(shape, order="F" if is_fortran else "C")
            self.value = torch.from_numpy(np.ascontiguousarray(bits)).view(torch.bfloat16)
            return
        arr = _numpy_multiarray()._reconstruct(np.ndarray, (0,), b"b")
        arr.__setstate__(state)
        self.value = arr


def _dtype(obj, align=False, copy=False):
    return _BF16 if obj is _BF16 else np.dtype(obj, align, copy)


class _Unpickler(pickle.Unpickler):
    """Resolves only the classes a checkpoint holds (see the module
    docstring); both of numpy's module paths."""

    def find_class(self, module, name):
        top = module.split(".")[0]
        if (module, name) == ("localrf_tpu.optim", "PyTreeAdamState"):
            return SavedAdamState
        if module in ("numpy._core.multiarray", "numpy.core.multiarray") and name == "_reconstruct":
            return lambda *args: _ArrayStub()
        if module == "numpy" and name == "dtype":
            return _dtype
        if module == "numpy" and name == "ndarray":
            return np.ndarray
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return _BF16
        if top == "ml_dtypes":
            raise pickle.UnpicklingError(
                f"checkpoint holds ml_dtypes.{name} arrays: only bfloat16 (--moment_dtype bfloat16) loads")
        if top == "localrf_tpu":
            raise pickle.UnpicklingError(f"checkpoint names {module}.{name}: the port maps only"
                                         " localrf_tpu.optim.PyTreeAdamState")
        raise pickle.UnpicklingError(f"checkpoint names {module}.{name}, which no checkpoint holds")


def _resolve(x):
    """The unpickled tree with every _ArrayStub replaced by its value."""
    if isinstance(x, _ArrayStub):
        return x.value
    if isinstance(x, dict):
        return {k: _resolve(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_resolve(v) for v in x]
    if isinstance(x, SavedAdamState):
        return SavedAdamState(*(_resolve(v) for v in x))
    if isinstance(x, tuple):
        return tuple(_resolve(v) for v in x)
    return x


def read_checkpoint(path: str) -> dict:
    """The checkpoint's state dict, arrays as numpy (bfloat16 ones as CPU
    torch.bfloat16 tensors), without importing JAX or ml_dtypes."""
    with open(path, "rb") as f:
        state = _resolve(_Unpickler(f).load())
    if state.get("version") != FORMAT_VERSION:
        raise ValueError(f"{path}: checkpoint version {state.get('version')}, expected {FORMAT_VERSION}")
    return state


def _tensor(x, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def _flat(tree: dict, device, dtype=None, prefix: str = "") -> dict[str, torch.Tensor]:
    """The nested JAX layout -> flat {"name" / "mlp.w1": tensor}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, device, dtype, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = _tensor(v, device, dtype)
    return out


def _adam(opt, device, moment_dtype: torch.dtype | None = None) -> PyTreeAdamState:
    """A saved Adam state (a JAX PyTreeAdamState or the port's dict)."""
    get = (lambda k: opt[k]) if isinstance(opt, dict) else (lambda k: getattr(opt, k))
    return PyTreeAdamState(
        m=_flat(get("m"), device, moment_dtype),
        v=_flat(get("v"), device, moment_dtype),
        step=_tensor(get("step"), device, torch.int32),
        lr_scale=_tensor(get("lr_scale"), device, torch.float32),
    )


def _tensorf_config(kw: dict) -> TensorfConfig:
    kw = dict(kw)
    for k in ("grid_size", "density_n_comp", "app_n_comp", "aabb_lo", "aabb_hi"):
        kw[k] = tuple(kw[k])
    for k, port_value in XLA_ONLY_FLAGS.items():
        if k in kw and kw[k] != port_value:
            print(f"load_checkpoint: TensorfConfig.{k}={kw[k]!r} only steers XLA's gathers on a TPU;"
                  f" loading with the port's {port_value!r} (the same math)")
            kw[k] = port_value
    return TensorfConfig(**kw)


def load_checkpoint(path: str, camera_prior=None, return_extra: bool = False, device="cuda"):
    """Rebuild a LocalTensorfs from a checkpoint written by this package or
    by the JAX package. The last field's params and moments go on `device`,
    the retired fields' params stay on the host (as after append_rf) and
    every alpha volume goes on `device`; the noise generator is seeded with
    cfg.seed + 1 (JAX reseeds PRNGKey(seed + 1))."""
    state = read_checkpoint(path)
    dev = torch.device(device)

    kwargs = dict(state["kwargs"])
    kwargs["tensorf"] = _tensorf_config(kwargs["tensorf"])
    kwargs["WH"] = tuple(kwargs["WH"])
    kwargs["N_voxel_list"] = {int(k): v for k, v in kwargs["N_voxel_list"].items()}
    cfg = LocalConfig(**kwargs)
    moment_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.moment_dtype]

    model = LocalTensorfs.__new__(LocalTensorfs)
    model.cfg = cfg
    model.camera_prior = camera_prior
    model.device = dev
    model.W, model.H = cfg.WH
    model._gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)

    fr = state["frames"]
    model.r_all = fr["r_all"]
    model.t_all = fr["t_all"]
    model.exp_all = fr["exp_all"]
    model.pose_opt_all = dict(fr["pose_opt_all"])
    model.pose_linked_rf = list(fr["pose_linked_rf"])
    model.blending_weights = fr["blending_weights"]

    model.fields = []
    n_fields = len(state["fields"])
    for i, entry in enumerate(state["fields"]):
        where = dev if i == n_fields - 1 else torch.device("cpu")
        tf_cfg = cfg.tensorf.with_grid(entry["grid_size"])
        alpha = None
        if entry["alpha_bits"] is not None:
            shape = tuple(entry["alpha_shape"])
            bits = np.unpackbits(entry["alpha_bits"])[: int(np.prod(shape))]
            alpha = torch.from_numpy(bits.reshape(shape).astype(np.float32)).to(dev)
        params = TensorfField(_flat(entry["params"], where))
        opt = None
        if entry["opt"] is not None:
            opt = _adam(entry["opt"], where, moment_dtype)
        elif i == n_fields - 1:
            opt = pytree_adam_init(params, cfg.moment_dtype)
        model.fields.append({
            "params": params,
            "cfg": tf_cfg,
            "alpha_volume": alpha,
            "opt": opt,
        })

    model.pool = None
    model._graphs = ChunkGraphs(dev) if dev.type == "cuda" else None
    # the per-stage occupancy-compaction size
    for f in model.fields:
        f["cfg"] = dataclasses.replace(f["cfg"], occ_m=model._occ_m(f["cfg"], f["alpha_volume"] is not None))

    model.world2rf = [np.asarray(w) for w in state["world2rf"]]
    model.rf_iter = list(state["rf_iter"])
    intr = state["intr"]
    model.intr = IntrState({k: _tensor(v, dev, torch.float32) for k, v in intr["params"].items()},
                           _adam(intr["opt"], dev))
    model.init_focal = state["init_focal"]

    sch = state["schedule"]
    model.is_refining = sch["is_refining"]
    model.lr_factor = sch["lr_factor"]
    model.n_iters = sch["n_iters"]
    model.n_iters_reg = sch["n_iters_reg"]
    model.N_voxel_list = dict(sch["N_voxel_list"])
    model.update_AlphaMask_list = list(sch["update_AlphaMask_list"])

    model.win_start = state["win_start"]
    model._wc = 64
    model._pose_dev = None
    model._build_window()
    if return_extra:
        return model, state.get("extra", {})
    return model
