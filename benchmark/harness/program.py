"""The system under test, built from a configuration and a traffic file as
train.py builds it, and given the benchmark's inputs: its weights, its
occupancy ball, the seeds of its jitter, and the schedule state of steady
refinement at the final grid."""
from __future__ import annotations

import dataclasses

import torch

from reference.render import ball_volume, compacted_samples

from . import scene

# Every published key a configuration file may hold: the TensorfConfig
# ("tensorf") or LocalConfig ("local") field it sets, or None where the
# harness reads it itself (N_voxel_final: checked against the traffic's
# grid in build; n_max_frames: the pool's slots, entries/train.py). A list
# becomes a tuple. A key left out keeps the dataclass's default.
KEYS = {
    "n_lamb_sigma": ("tensorf", "density_n_comp"),
    "n_lamb_sh": ("tensorf", "app_n_comp"),
    "data_dim_color": ("tensorf", "app_dim"),
    "featureC": ("tensorf", "feature_c"),
    "shadingMode": ("tensorf", "shading_mode"),
    "fea2denseAct": ("tensorf", "fea2dense_act"),
    "pos_pe": ("tensorf", "pos_pe"),
    "view_pe": ("tensorf", "view_pe"),
    "fea_pe": ("tensorf", "fea_pe"),
    "gather_dtype": ("tensorf", "gather_dtype"),
    "mlp_dtype": ("tensorf", "mlp_dtype"),
    "fov": ("local", "fov"),
    "n_overlap": ("local", "n_overlap"),
    "n_iters_per_frame": ("local", "n_iters_per_frame"),
    "n_iters_reg": ("local", "n_iters_reg"),
    "lr_R_init": ("local", "lr_R_init"),
    "lr_t_init": ("local", "lr_t_init"),
    "lr_i_init": ("local", "lr_i_init"),
    "lr_exposure_init": ("local", "lr_exposure_init"),
    "lr_init": ("local", "rf_lr_init"),
    "lr_basis": ("local", "rf_lr_basis"),
    "lr_decay_target_ratio": ("local", "lr_decay_target_ratio"),
    "loss_flow_weight_inital": ("local", "loss_flow_weight"),
    "loss_depth_weight_inital": ("local", "loss_depth_weight"),
    "TV_weight_density": ("local", "tv_weight_density"),
    "TV_weight_app": ("local", "tv_weight_app"),
    "L1_weight": ("local", "l1_weight"),
    "n_views": ("local", "n_views"),
    "batch_size": ("local", "batch_size"),
    "moment_dtype": ("local", "moment_dtype"),
    "N_voxel_final": None,
    "n_max_frames": None,
}
# keys that describe the configuration, or that the harness reads beside
# the table: "field" names the reference field module (harness/manifest.py),
# "program" holds TensorfConfig fields passed to the program verbatim
DESCRIPTIVE = frozenset({"source", "about", "reduced", "assumed", "field", "program"})


def local_config(config: dict, traffic: dict, n_frames: int):
    """LocalConfig / TensorfConfig at the traffic's grid: each key of the
    configuration through KEYS, then its "program" fields. Raises on a key
    that is neither in KEYS nor in DESCRIPTIVE."""
    from localrf_tpu_torch.models.local import LocalConfig
    from localrf_tpu_torch.models.tensorf import TensorfConfig

    unknown = sorted(set(config) - set(KEYS) - DESCRIPTIVE)
    if unknown:
        raise ValueError(f"configuration keys the harness does not map: {', '.join(unknown)}")
    fields = {"tensorf": {}, "local": {}}
    for key, value in config.items():
        if KEYS.get(key) is not None:
            kind, name = KEYS[key]
            fields[kind][name] = tuple(value) if isinstance(value, list) else value
    g = traffic["grid"]
    tf = TensorfConfig(grid_size=(g, g, g), pallas_composite=True, **fields["tensorf"])
    tf = dataclasses.replace(tf, **config.get("program", {}))
    return LocalConfig(n_init_frames=n_frames, WH=tuple(traffic["wh"]), occ_min=traffic["occ_min"], tensorf=tf,
                       **fields["local"])


def build(field, config: dict, traffic: dict, sd: dict, device):
    """A LocalTensorfs over traffic["frames"] frames whose field holds the
    benchmark's weights (returned too, f32; shaped by the field module
    `field`) and its ball occupancy volume,
    compacted to the traffic's occ_m samples a ray, its jitter drawn from
    sd["noise"], in steady refinement: the schedule past the rescale at
    rf_iter 1 with every frame training (n_iters and n_iters_reg scaled by
    the frame count, lr_factor its per-step decay), at rf_iter traffic["rf_iter"]."""
    from localrf_tpu_torch.models.local import LocalTensorfs

    n = traffic["frames"]
    grid = traffic["grid"]
    if grid**3 != config["N_voxel_final"]:
        raise ValueError(f"traffic grid {grid}^3 is not the configuration's final grid")
    model = LocalTensorfs(local_config(config, traffic, n), device=device)
    weights = scene.make_weights(field, scene.widths(config), grid, sd["weights"], device)
    f = model.fields[-1]
    named = dict(f["params"].named_parameters())
    if {k: tuple(p.shape) for k, p in named.items()} != {k: tuple(v.shape) for k, v in weights.items()}:
        raise ValueError("the program's field has other parameters than the configuration's")
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(weights[k])
    f["alpha_volume"] = ball_volume(grid // 2, traffic["ball_radius"], device)
    f["cfg"] = dataclasses.replace(f["cfg"], occ_m=model._occ_m(f["cfg"], True))
    want = compacted_samples(grid, occ_min=traffic["occ_min"])
    if not f["cfg"].occ_m == want == traffic["occ_m"]:
        raise ValueError(f"occ_m: program {f['cfg'].occ_m}, reference {want}, traffic {traffic['occ_m']}")
    model.is_refining = True
    model.rf_iter[-1] = traffic["rf_iter"]
    model.n_iters = config["n_iters_per_frame"] * n
    model.n_iters_reg = config["n_iters_reg"] * n
    model.lr_factor = config["lr_decay_target_ratio"] ** (1 / model.n_iters)
    model._gen.manual_seed(sd["noise"])
    return model, weights
