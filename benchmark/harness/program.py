"""The system under test, built from a configuration and a traffic file as
train.py builds it, and given the benchmark's inputs: its weights, its
occupancy ball, the seeds of its jitter, and the schedule state of steady
refinement at the final grid."""
from __future__ import annotations

import dataclasses

import torch

from reference.render import ball_volume, compacted_samples

from . import scene


def local_config(config: dict, traffic: dict, n_frames: int):
    """LocalConfig / TensorfConfig at the traffic's grid, with train.py's
    defaults for every flag the configuration leaves out."""
    from localrf_tpu_torch.models.local import LocalConfig
    from localrf_tpu_torch.models.tensorf import TensorfConfig

    g = traffic["grid"]
    wd = scene.widths(config)
    tf = TensorfConfig(
        grid_size=(g, g, g), density_n_comp=tuple(wd["density"]), app_n_comp=tuple(wd["app"]),
        app_dim=wd["app_dim"], feature_c=wd["feature_c"], shading_mode=wd["shading_mode"],
        fea_pe=wd["fea_pe"], view_pe=wd["view_pe"], pos_pe=wd["pos_pe"],
        gather_dtype=config["gather_dtype"], mlp_dtype=config["mlp_dtype"], pallas_composite=True,
    )
    return LocalConfig(
        fov=config["fov"], n_init_frames=n_frames, n_overlap=config["n_overlap"], WH=tuple(traffic["wh"]),
        n_iters_per_frame=config["n_iters_per_frame"], n_iters_reg=config["n_iters_reg"],
        lr_R_init=config["lr_R_init"], lr_t_init=config["lr_t_init"], lr_i_init=config["lr_i_init"],
        lr_exposure_init=config["lr_exposure_init"], rf_lr_init=config["lr_init"],
        rf_lr_basis=config["lr_basis"], lr_decay_target_ratio=config["lr_decay_target_ratio"],
        loss_flow_weight=config["loss_flow_weight_inital"], loss_depth_weight=config["loss_depth_weight_inital"],
        tv_weight_density=config["TV_weight_density"], tv_weight_app=config["TV_weight_app"],
        l1_weight=config["L1_weight"], n_views=config["n_views"], batch_size=config["batch_size"],
        occ_min=traffic["occ_min"], moment_dtype=config["moment_dtype"], tensorf=tf,
    )


def build(config: dict, traffic: dict, sd: dict, device):
    """A LocalTensorfs over traffic["frames"] frames whose field holds the
    benchmark's weights (returned too, f32) and its ball occupancy volume,
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
    weights = scene.make_weights(scene.widths(config), grid, sd["weights"], device)
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
