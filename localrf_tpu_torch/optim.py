"""Gated Adam optimizers (PyTorch port of localrf_tpu/optim.py).

Functional, not torch.optim: per-frame pose/exposure parameters live in
stacked [N, ...] tensors whose updates are gated per frame (moments, step
counts and learning rates advance only for gated frames, like N
independent Adam instances), and the field optimizer's learning rates share
one decaying `lr_scale`. Bias correction matches torch.optim.Adam
(betas=(0.9, 0.99), eps=1e-8).

The field update (`pytree_adam_update`) writes parameters, moments, the
step count and (in train_core) the lr scale in place: that keeps one copy
of the factor grids and moments on the card, and stable addresses are what
let a captured CUDA graph of the step be replayed. The step count and lr
scale are 0-d device tensors and the gate a 0-d bool tensor, as in JAX, so
no value is read back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

B1, B2, EPS = 0.9, 0.99, 1e-8


class AdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor
    step: torch.Tensor  # [] or [N] int32 — per-frame step counts
    lr: torch.Tensor  # [] or [N] float32 — current (decayed) learning rate


def adam_init(param: torch.Tensor, lr: float, per_frame: bool = False) -> AdamState:
    """per_frame=True: leading axis of `param` indexes frames; step/lr are [N]."""
    shape = (param.shape[0],) if per_frame else ()
    return AdamState(
        torch.zeros_like(param),
        torch.zeros_like(param),
        torch.zeros(shape, dtype=torch.int32, device=param.device),
        torch.full(shape, lr, dtype=torch.float32, device=param.device),
    )


def _bcast(x: torch.Tensor, target_ndim: int) -> torch.Tensor:
    """Broadcast a [N] per-frame vector against [N, ...] params."""
    return x.reshape(x.shape + (1,) * (target_ndim - x.dim()))


def adam_update(
    param: torch.Tensor, grad: torch.Tensor, state: AdamState, gate: torch.Tensor | None = None
) -> tuple[torch.Tensor, AdamState]:
    """One gated Adam step (functional). gate: None (always), or a [] / [N]
    bool tensor; where off, param/m/v/step are untouched."""
    if gate is None:
        gate = torch.ones((), dtype=torch.bool, device=param.device)
    gate_p = _bcast(gate.to(param.dtype), param.dim()) if gate.dim() else gate.to(param.dtype)
    step = state.step + gate.to(state.step.dtype)
    m = state.m + gate_p * ((1 - B1) * (grad - state.m))
    v = state.v + gate_p * ((1 - B2) * (grad**2 - state.v))
    step_f = torch.clamp(step, min=1).to(param.dtype)
    bc1 = 1.0 - B1**step_f
    bc2 = 1.0 - B2**step_f
    if state.lr.dim():
        lr = _bcast(state.lr, param.dim())
        bc1, bc2 = _bcast(bc1, param.dim()), _bcast(bc2, param.dim())
    else:
        lr = state.lr
    update = lr * (m / bc1) / (torch.sqrt(v / bc2) + EPS)
    return param - gate_p * update, AdamState(m, v, step, state.lr)


def scale_lr(state: AdamState, factor: float, gate: torch.Tensor | None = None) -> AdamState:
    """Multiply the (per-frame) lr by `factor` where gated."""
    if gate is None:
        lr = state.lr * factor
    else:
        lr = torch.where(gate, state.lr * factor, state.lr)
    return state._replace(lr=lr)


class PyTreeAdamState(NamedTuple):
    m: dict
    v: dict
    step: torch.Tensor  # [] int32
    lr_scale: torch.Tensor  # [] float32: multiplicative decay applied to every group lr


def _named(params) -> dict[str, torch.Tensor]:
    return dict(params.named_parameters()) if hasattr(params, "named_parameters") else dict(params)


def pytree_adam_init(params, moment_dtype: str | None = None) -> PyTreeAdamState:
    """params: a module or a {name: tensor} dict. moment_dtype: storage dtype
    of m/v ("bfloat16" halves optimizer memory; the math stays float32)."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[moment_dtype] if moment_dtype else None

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt or p.dtype, device=p.device)

    named = _named(params)
    dev = next(iter(named.values())).device
    return PyTreeAdamState(
        m={k: zeros(p) for k, p in named.items()},
        v={k: zeros(p) for k, p in named.items()},
        step=torch.zeros((), dtype=torch.int32, device=dev),
        lr_scale=torch.ones((), dtype=torch.float32, device=dev),
    )


@torch.no_grad()
def pytree_adam_update(
    params, grads: dict, state: PyTreeAdamState, base_lrs: dict, gate: torch.Tensor | None = None
) -> tuple[object, PyTreeAdamState]:
    """Adam over named parameters with per-name base lrs (numbers or 0-d
    tensors), all scaled by `lr_scale`, updating params, moments and the step
    IN PLACE. `gate` (0-d bool tensor) freezes all three where off: the
    update is multiplied by it, as JAX's `g_on`; without a gate the step is
    taken and nothing is multiplied."""
    g_on = None if gate is None else gate.to(torch.float32)

    def gated(x):
        return x if g_on is None else g_on * x

    state.step.add_(1 if g_on is None else g_on.to(state.step.dtype))
    step_f = torch.clamp(state.step, min=1).to(torch.float32)
    bc1 = 1.0 - B1**step_f
    bc2 = 1.0 - B2**step_f
    for name, p in _named(params).items():
        g = grads[name].to(torch.float32)
        m_s, v_s = state.m[name], state.v[name]
        m = m_s.to(torch.float32)
        v = v_s.to(torch.float32)
        m = m + gated((1 - B1) * (g - m))
        v = v + gated((1 - B2) * (g**2 - v))
        lr = base_lrs[name] * state.lr_scale
        p.sub_(gated(lr) * (m / bc1) / (torch.sqrt(v / bc2) + EPS))
        m_s.copy_(m)
        v_s.copy_(v)
    return params, state


def field_base_lrs(params, lr_spatial: float, lr_net: float) -> dict[str, float]:
    """Reference param groups: factor grids at lr_init (0.02), basis matrix
    and shading MLP at lr_basis (1e-3)."""
    return {
        name: lr_net if name == "basis_mat" or name.startswith("mlp.") else lr_spatial
        for name in _named(params)
    }
