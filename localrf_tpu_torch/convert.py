"""Carry state from the JAX package to the port.

The JAX package keeps a field as a pytree of arrays ({"density_plane_0":
..., "mlp": {"w1": ...}}) and its optimizer/pose state as NamedTuples of
arrays; its RAFT and DPT weights are pytrees in NHWC/HWIO layout. These
functions take that state as numpy (`jax.device_get` of it) and build the
port's tensors and state dicts, so both packages can compute from the
same weights.
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


def _oihw(w) -> torch.Tensor:
    """HWIO (JAX's conv layout) -> OIHW."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1))))


def _vec(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def raft_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX's RAFT pytree (preprocess/raft.py::init_raft's, or
    convert_raft_state_dict's; numpy) -> the port's RAFT state dict: the
    official names without the "module." prefix, OIHW kernels, on the CPU."""
    sd: dict[str, torch.Tensor] = {}

    def conv(name, p, key):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = _oihw(p[f"{key}_w"]), _vec(p[f"{key}_b"])

    def bn(name, p):
        sd.update({f"{name}.weight": _vec(p["scale"]), f"{name}.bias": _vec(p["bias"]),
                   f"{name}.running_mean": _vec(p["mean"]), f"{name}.running_var": _vec(p["var"]),
                   f"{name}.num_batches_tracked": torch.tensor(0)})

    for enc in ("fnet", "cnet"):
        e = tree[enc]
        conv(f"{enc}.conv1", e, "conv1")
        if "norm1" in e:
            bn(f"{enc}.norm1", e["norm1"])
        for layer in ("layer1", "layer2", "layer3"):
            for i, p in enumerate(e[layer]):
                pre = f"{enc}.{layer}.{i}"
                conv(f"{pre}.conv1", p, "conv1")
                conv(f"{pre}.conv2", p, "conv2")
                if "down_w" in p:
                    conv(f"{pre}.downsample.0", p, "down")
                for n in ("norm1", "norm2", "norm3"):
                    if n in p:
                        bn(f"{pre}.{n}", p[n])
        conv(f"{enc}.conv2", e, "conv2")
    up = tree["update"]
    for key in ("convc1", "convc2", "convf1", "convf2", "conv"):
        conv(f"update_block.encoder.{key}", up["encoder"], key)
    for g in ("z", "r", "q"):
        for i in ("1", "2"):
            conv(f"update_block.gru.conv{g}{i}", up["gru"], f"conv{g}{i}")
    conv("update_block.flow_head.conv1", up["flow_head"], "conv1")
    conv("update_block.flow_head.conv2", up["flow_head"], "conv2")
    conv("update_block.mask.0", up["mask"], "conv1")
    conv("update_block.mask.2", up["mask"], "conv2")
    return sd


def dpt_from_jax(tree: dict, cfg) -> dict[str, torch.Tensor]:
    """JAX's DPT pytree (preprocess/dpt.py::convert_dpt_state_dict's; numpy)
    -> the port's DPT state dict, Hugging Face's names, on the CPU: the
    inverse of convert_dpt_state_dict. `cfg` is the port's DPTConfig. JAX
    drops the ViT's final `dpt.layernorm` (the depth head never reads it):
    it comes back as the identity."""
    sd: dict[str, torch.Tensor] = {
        "dpt.embeddings.cls_token": _vec(tree["cls_token"]),
        "dpt.embeddings.position_embeddings": _vec(tree["pos_embed"]),
        "dpt.layernorm.weight": torch.ones(cfg.hidden_size),
        "dpt.layernorm.bias": torch.zeros(cfg.hidden_size),
    }

    def lin(name, w, b):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = _vec(np.asarray(w).T), _vec(b)

    def conv(name, w, b=None):
        sd[f"{name}.weight"] = _oihw(w)
        if b is not None:
            sd[f"{name}.bias"] = _vec(b)

    conv("dpt.embeddings.patch_embeddings.projection", tree["patch_w"], tree["patch_b"])
    for i, p in enumerate(tree["layers"]):
        pre = f"dpt.encoder.layer.{i}"
        for ln, key in (("layernorm_before", "ln1"), ("layernorm_after", "ln2")):
            sd[f"{pre}.{ln}.weight"], sd[f"{pre}.{ln}.bias"] = _vec(p[f"{key}_w"]), _vec(p[f"{key}_b"])
        for name, key in (("attention.attention.query", "q"), ("attention.attention.key", "k"),
                          ("attention.attention.value", "v"), ("attention.output.dense", "o"),
                          ("intermediate.dense", "fc1"), ("output.dense", "fc2")):
            lin(f"{pre}.{name}", p[f"{key}_w"], p[f"{key}_b"])
    for i, (rp, rl) in enumerate(zip(tree["readout"], tree["reassemble"])):
        lin(f"neck.reassemble_stage.readout_projects.{i}.0", rp["w"], rp["b"])
        pre = f"neck.reassemble_stage.layers.{i}"
        conv(f"{pre}.projection", rl["proj_w"], rl["proj_b"])
        if "up_w" in rl:  # ConvTranspose2d's [in, out, k, k], kept as is by JAX
            sd[f"{pre}.resize.weight"], sd[f"{pre}.resize.bias"] = _vec(rl["up_w"]), _vec(rl["up_b"])
        elif "down_w" in rl:
            conv(f"{pre}.resize", rl["down_w"], rl["down_b"])
    for i, w in enumerate(tree["neck_convs"]):
        conv(f"neck.convs.{i}", w)
    for i, fp in enumerate(tree["fusion"]):
        pre = f"neck.fusion_stage.layers.{i}"
        conv(f"{pre}.projection", fp["proj_w"], fp["proj_b"])
        for r, name in (("res1", "residual_layer1"), ("res2", "residual_layer2")):
            conv(f"{pre}.{name}.convolution1", fp[r]["c1_w"], fp[r]["c1_b"])
            conv(f"{pre}.{name}.convolution2", fp[r]["c2_w"], fp[r]["c2_b"])
    for i, key in ((0, "c1"), (2, "c2"), (4, "c3")):
        conv(f"head.head.{i}", tree["head"][f"{key}_w"], tree["head"][f"{key}_b"])
    return sd
