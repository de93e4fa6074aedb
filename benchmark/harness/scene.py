"""The one generator: a cell's inputs from its seed, configuration and
traffic file. Weights and frames are drawn on the device with one
torch.Generator in a few large calls; the batches' draw and the jitter
come from seeds handed to the program's sampler and noise generator,
which the reference draws again (reference/step.py).
"""
from __future__ import annotations

import math

import numpy as np
import torch

def seeds(seed: int) -> dict:
    """Independent 32-bit seeds for each input, from the run's --seed."""
    s = np.random.SeedSequence(int(seed)).generate_state(4)
    return dict(zip(("weights", "frames", "sampler", "noise"), (int(x) for x in s)))


def widths(config: dict) -> dict:
    """The field's widths and its density activation from a configuration
    file (LocalRF / TensoRF key names; no fea2denseAct means softplus, as
    in their opt.py)."""
    return {"density": list(config["n_lamb_sigma"]), "app": list(config["n_lamb_sh"]),
            "app_dim": config["data_dim_color"], "feature_c": config["featureC"],
            "shading_mode": config["shadingMode"], "fea_pe": config["fea_pe"], "view_pe": config["view_pe"],
            "pos_pe": config["pos_pe"], "act": config.get("fea2denseAct", "softplus")}


def reference_model(field, wd: dict) -> dict:
    """What the reference renders with: the field module, the density
    activation and the shading head."""
    return {"field": field, **{k: wd[k] for k in ("act", "shading_mode", "fea_pe", "view_pe")}}


def mlp_shapes(wd: dict) -> dict:
    """The shading head's layers {name: (fan_in, fan_out)} (weights [fan_in, fan_out])."""
    mode, app = wd["shading_mode"], wd["app_dim"]
    fea, view, c = wd["fea_pe"], wd["view_pe"], wd["feature_c"]
    view_in = 2 * view * 3 + 3
    if mode == "MLP_Fea_late_view":
        return {"1": (2 * fea * app + app, c), "2": (c, c), "3": (c + view_in, 3)}
    if mode == "MLP_Fea":
        return {"1": (2 * fea * app + app + view_in, c), "2": (c, c), "3": (c, 3)}
    raise NotImplementedError(f"shading mode {mode}")


def _shapes(field, wd: dict, grid: int) -> tuple[dict, dict, dict]:
    """(factor tables {name: shape}, dense weights {name: shape}, {dense
    name: fan_in}): the field module's, then the shading head's."""
    factors, dense = field.weight_shapes(wd, grid)
    fan_in = {k: shape[0] for k, shape in dense.items()}
    dense = dict(dense)
    for k, (f, fan_out) in mlp_shapes(wd).items():
        dense[f"mlp.w{k}"], dense[f"mlp.b{k}"] = (f, fan_out), (fan_out,)
        fan_in[f"mlp.w{k}"] = fan_in[f"mlp.b{k}"] = f
    return factors, dense, fan_in


def weight_shapes(field, wd: dict, grid: int) -> dict:
    """{name: shape} of a field at grid^3 and its shading head, in the
    published layout."""
    factors, dense, _ = _shapes(field, wd, grid)
    return {**factors, **dense}


def make_weights(field, wd: dict, grid: int, seed: int, device) -> dict:
    """f32 weights: the field module's factor tables 0.1 N(0, 1) (one draw),
    its dense weights ([fan_in, fan_out]) and the MLP uniform in
    +-1/sqrt(fan_in) (one draw), the last bias 0."""
    factors, dense, fan_in = _shapes(field, wd, grid)
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = 0.1 * torch.randn(sum(math.prod(s) for s in factors.values()), generator=gen, device=device)
    uniform = torch.rand(sum(math.prod(s) for s in dense.values()), generator=gen, device=device)
    out = {}
    for flat, shapes in ((normal, factors), (uniform, dense)):
        for (k, shape), part in zip(shapes.items(), torch.split(flat, [math.prod(s) for s in shapes.values()])):
            out[k] = part.reshape(shape)
    for k in dense:
        bound = 1.0 / math.sqrt(fan_in[k])
        out[k] = out[k] * (2 * bound) - bound
    out["mlp.b3"] = torch.zeros_like(out["mlp.b3"])
    return out


def make_frames(n: int, w: int, h: int, seed: int, device) -> dict:
    """Host float32 arrays of n frames: rgb [n, h, w, 3] uniform, inverse
    depth [n, h, w] in [0.1, 1), forward and backward flow [n, h, w, 2]
    N(0, 2^2) px, masks 1. Drawn on the device, then copied to the host,
    where the program's dataset keeps its frames."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (n, h, w)
    draws = {
        "rgbs": torch.rand((*shape, 3), generator=gen, device=device),
        "invdepths": 0.1 + 0.9 * torch.rand(shape, generator=gen, device=device),
        "fwd_flow": 2.0 * torch.randn((*shape, 2), generator=gen, device=device),
        "bwd_flow": 2.0 * torch.randn((*shape, 2), generator=gen, device=device),
    }
    out = {k: v.cpu().numpy() for k, v in draws.items()}
    out["fwd_mask"] = np.ones(shape, np.float32)
    out["bwd_mask"] = np.ones(shape, np.float32)
    return out


def trajectory(n: int, seed: int) -> np.ndarray:
    """n camera-to-world poses [n, 3, 4] along a seeded path: a start within
    0.3 of the centre, a straight drift of 0.02 a frame, and a view that
    turns by 0.01 rad a frame about a fixed axis from a random start."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(-0.3, 0.3, 3)
    drift = rng.normal(size=3)
    drift *= 0.02 / np.linalg.norm(drift)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    out = np.zeros((n, 3, 4), np.float32)
    for f in range(n):
        a = 0.01 * f
        turn = np.eye(3) + math.sin(a) * k + (1 - math.cos(a)) * (k @ k)
        out[f, :, :3] = turn @ q
        out[f, :, 3] = start + f * drift
    return out
