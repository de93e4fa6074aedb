"""Training cells: steady refinement through the program's chunk path,
LocalTensorfs.plan_chunk -> run_chunk over a DevicePixelPool, every step a
replay of a captured CUDA graph.

Set-up: the traffic's frames from the seed into the program's dataset
(SyntheticDataset keeps host arrays), a pool of train.py's capacity
(n_max_frames + n_overlap + 16 slots), the model (harness/program.py);
the first `check_steps` steps through plan_chunk -> run_chunk as a chunk of
one step (its graph is captured there) and one of the rest, the state read
after each for the check; then one chunk of `chunk` steps (no capture).
Window: chunks of `chunk` steps until the first that ends after the run's
seconds (run_chunk reads its losses back at its end, so each chunk ends
when the card has finished it). With a trace, the first `trace_units`
chunks of the window run under torch.profiler.
After the window and the memory peak are read and the program is freed,
the reference takes the same first steps and the numbers are compared.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from harness import check, program, scene
from reference.step import B1, POSE_LEAVES, noise_draws, sampled_batches, train_steps
from reference.render import n_samples


def reference_cell(field, config: dict, traffic: dict) -> dict:
    """What the reference reads of the field module, the configuration and
    the traffic."""
    return {
        "w": traffic["wh"][0], "h": traffic["wh"][1], "n_frames": traffic["frames"], "grid": traffic["grid"],
        "model": scene.reference_model(field, scene.widths(config)),
        "ball_radius": traffic["ball_radius"], "occ_min": traffic["occ_min"], "rf_iter": traffic["rf_iter"],
        "flow_weight": config["loss_flow_weight_inital"], "depth_weight": config["loss_depth_weight_inital"],
        "l1_weight": config["L1_weight"], "lr_spatial": config["lr_init"], "lr_basis": config["lr_basis"],
        "lr_r": config["lr_R_init"], "lr_t": config["lr_t_init"], "lr_exposure": config["lr_exposure_init"],
        "lr_decay_target_ratio": config["lr_decay_target_ratio"],
        "n_iters_per_frame": config["n_iters_per_frame"],
    }


def _state(model, n: int, moments: bool = False) -> dict:
    """Host copies of the field's parameters (or Adam's first moments) and
    of the first n rows of the pose window's rotations, translations and
    exposures (or their moments)."""
    f, p = model.fields[-1], model._pose_dev
    if moments:
        tree, pose = dict(f["opt"].m), (p.r_opt.m, p.t_opt.m, p.e_opt.m)
    else:
        tree, pose = dict(f["params"].named_parameters()), (p.r, p.t, p.exposure)
    out = {k: v.detach().float().cpu().clone() for k, v in tree.items()}
    out.update({k: v[:n].detach().float().cpu().clone() for k, v in zip(POSE_LEAVES, pose)})
    return out


def _losses(model) -> list[dict]:
    m = model.chunk_metrics
    return [{k: float(v[i]) for k, v in m.items()} for i in range(len(m["total_loss"]))]


def _batch_data(frames: dict, views: np.ndarray, px: np.ndarray, device) -> dict:
    """A batch's pixels from the benchmark's frames, for the reference."""
    out = {"views": torch.from_numpy(views).to(device), "px": torch.from_numpy(px).to(device)}
    for k, a in frames.items():
        flat = a.reshape(a.shape[0], -1, *a.shape[3:])
        out[k] = torch.from_numpy(np.ascontiguousarray(flat[views[:, None], px])).to(device)
    return out


def setup(spec: dict, run) -> dict:
    from localrf_tpu_torch.data.dataset import SyntheticDataset
    from localrf_tpu_torch.data.pool import DevicePixelPool

    config, traffic = spec["config"], spec["traffic"]
    dev = run.device
    sd = scene.seeds(run.seed)
    n, (w, h) = traffic["frames"], traffic["wh"]
    frames = scene.make_frames(n, w, h, sd["frames"], dev)
    run.mark("frames")
    ds = SyntheticDataset(frames["rgbs"], "train", invdepths=frames["invdepths"],
                          fwd_flow=frames["fwd_flow"], fwd_mask=frames["fwd_mask"],
                          bwd_flow=frames["bwd_flow"], bwd_mask=frames["bwd_mask"],
                          n_init_frames=n, test_frame_every=0, frames_chunk=n)
    ds._rng = np.random.default_rng(sd["sampler"])
    run.mark("dataset")
    model, weights = program.build(spec["field"], config, traffic, sd, dev)
    slots = config["n_max_frames"] + config["n_overlap"] + 16
    if slots != traffic["pool_slots"]:
        raise ValueError(f"pool of {slots} slots, traffic says {traffic['pool_slots']}")
    model.attach_pool(DevicePixelPool(ds, slots, device=dev))
    run.mark("model and pool")

    k = traffic["check_steps"]
    plans, losses = [], []
    for i, size in enumerate((1, k - 1)):
        batches = model.plan_chunk(ds, True, size)
        model.run_chunk(batches, optimize_poses=True)
        plans += batches
        losses += _losses(model)
        if i == 0:
            moments = _state(model, n, moments=True)
    after = _state(model, n)
    run.mark("first steps (capture)")
    model.run_chunk(model.plan_chunk(ds, True, traffic["chunk"]), optimize_poses=True)
    run.mark("warm-up chunk")
    weights = {k: v.cpu() for k, v in weights.items()}
    return {"model": model, "ds": ds, "frames": frames, "weights": weights, "sd": sd, "plans": plans,
            "prog": {"losses": losses, "moments": moments, "after": after}}


def window(state: dict, spec: dict, run) -> dict:
    """Chunks until `run.seconds` have passed; the first trace_units under
    the profiler when tracing. Returns the counts."""
    model, ds = state["model"], state["ds"]
    traffic = spec["traffic"]
    batch = spec["config"]["batch_size"]
    chunks = []
    t0 = time.perf_counter()
    while True:
        traced = run.trace and len(chunks) < traffic["trace_units"]
        if traced and not chunks:
            run.start_trace()
        c0 = time.perf_counter()
        with run.spans("plan_chunk"):
            batches = model.plan_chunk(ds, True, traffic["chunk"])
        c1 = time.perf_counter()
        with run.spans("run_chunk"):
            model.run_chunk(batches, optimize_poses=True)
        total = model.chunk_metrics["total_loss"]
        chunks.append({"steps": len(batches), "plan_s": c1 - c0, "traced": traced,
                       "bad": int((~np.isfinite(total)).sum())})
        if traced and len(chunks) == traffic["trace_units"]:
            run.stop_trace()
        if time.perf_counter() - t0 >= run.seconds:
            break
    seconds = time.perf_counter() - t0
    if run.trace and len(chunks) < traffic["trace_units"]:
        run.stop_trace()
    steps = sum(c["steps"] for c in chunks)
    traced = [c for c in chunks if c["traced"]]
    return {
        "seconds": seconds, "attempted": steps, "failed": sum(c["bad"] for c in chunks),
        "e2e": {"train_rays_per_s": steps * batch / seconds},
        "traced": {"steps": sum(c["steps"] for c in traced), "plan_s": sum(c["plan_s"] for c in traced),
                   "rays": batch * sum(c["steps"] for c in traced)},
    }


def program_side(prog: dict, weights: dict, n: int) -> dict:
    """The program's numbers in the reference's form: its losses, the norm
    of its first gradient (Adam's first moment after one step over 1 -
    beta1) and of its change over the steps, by leaf."""
    start = {k: v.detach().float().cpu() for k, v in weights.items()}
    eye = torch.eye(3)
    start.update(pose_r=eye[:, :2].expand(n, 3, 2), pose_t=torch.zeros((n, 3)), exposure=eye.expand(n, 3, 3))
    grad1 = {k: v.double() / (1 - B1) for k, v in prog["moments"].items()}
    return {
        "losses": prog["losses"],
        "grad1": {k: float(v.norm()) for k, v in grad1.items()},
        "grad1_tensors": grad1,
        "update": {k: float((prog["after"][k].double() - start[k].double()).norm()) for k in prog["after"]},
    }


def reference_side(spec: dict, sd: dict, frames: dict, weights: dict, device, plans=None,
                   precision: str = "f32", fault: str | None = None) -> dict:
    """The reference's first steps on the same inputs; raises if the
    program's plan (when given) drew other batches than the reference's
    sampler."""
    config, traffic = spec["config"], spec["traffic"]
    cell = reference_cell(spec["field"], config, traffic)
    k, (w, h) = traffic["check_steps"], traffic["wh"]
    drawn = sampled_batches(sd["sampler"], k, traffic["frames"], w * h, config["n_views"], config["batch_size"])
    if plans is not None:
        for (views, px), b in zip(drawn, plans):
            if b["train_test_poses"] or not np.array_equal(views, b["view_ids"]) or not np.array_equal(
                    (px + views[:, None] * w * h).reshape(-1), b["idx"]):
                raise AssertionError("the program's plan drew other batches than LocalRF's sampler")
    batches = [_batch_data(frames, views, px, device) for views, px in drawn]
    weights = {key: v.to(device) for key, v in weights.items()}
    noises = noise_draws(sd["noise"], k, n_samples(traffic["grid"]), device)
    return train_steps(weights, batches, noises, cell, precision, fault)


def run(spec: dict, run) -> dict:
    state = setup(spec, run)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.setup_done = time.perf_counter()
    out = window(state, spec, run)
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    run.close_window()
    n = spec["traffic"]["frames"]
    prog = program_side(state["prog"], state["weights"], n)
    keep = {k: state[k] for k in ("sd", "frames", "weights", "plans")}
    state.clear()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_side(spec, keep["sd"], keep["frames"], keep["weights"], run.device, keep["plans"])
    out["numbers"] = check.train_numbers(prog, ref)
    return out
