"""Carry state from the JAX package to the port.

The JAX package keeps a field as a pytree of arrays ({"density_plane_0":
..., "mlp": {"w1": ...}}) and its optimizer/pose state as NamedTuples of
arrays. These functions take that state as numpy (`jax.device_get` of it)
and build the port's tensors, so both packages can compute from the same
weights.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.step import PoseState
from .models.tensorf import TensorfField
from .optim import AdamState


def _tensor(x, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, which torch cannot wrap
        return torch.from_numpy(x.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def params_from_jax(tree: dict, device="cuda") -> dict[str, torch.Tensor]:
    """Nested {name: array} pytree -> flat {"name" / "mlp.w1": tensor}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": t for kk, t in params_from_jax(v, device).items()})
        else:
            out[k] = _tensor(v, device)
    return out


def field_from_jax(tree: dict, device="cuda") -> TensorfField:
    return TensorfField(params_from_jax(tree, device))


def adam_from_jax(state, device="cuda") -> AdamState:
    """JAX optim.AdamState (m, v, step, lr) -> the port's AdamState."""
    return AdamState(*(_tensor(getattr(state, k), device) for k in AdamState._fields))


def pose_from_jax(pose, device="cuda") -> PoseState:
    """JAX step.PoseState (the pose/exposure window and its Adam states)."""
    return PoseState(
        r=_tensor(pose.r, device),
        t=_tensor(pose.t, device),
        exposure=_tensor(pose.exposure, device),
        r_opt=adam_from_jax(pose.r_opt, device),
        t_opt=adam_from_jax(pose.t_opt, device),
        e_opt=adam_from_jax(pose.e_opt, device),
    )


def lpips_params_from_jax(params: dict, device="cuda") -> dict:
    """JAX utils/lpips.py params ({"convs": [{"w", "b"}], "lins": [...]})
    -> the port's (utils/lpips.py), the same layout as tensors."""
    return {
        "convs": [{k: _tensor(v, device) for k, v in c.items()} for c in params["convs"]],
        "lins": [_tensor(v, device) for v in params["lins"]],
    }
