"""Eval cells: whole frames of one field through LocalTensorfs.forward_eval
at the chunk renderer.render uses (the configuration's batch size), each
from the next camera of a seeded trajectory, copied to the host as a user's
render loop does (a frame ends when its pixels are on the host).

The cameras are one fixed path (scene.trajectory from PATH_SEED): the
views decide the gathers' memory locality, and so a frame's time, so
every seed renders the same views; the seed draws the weights. Set-up:
the model (harness/program.py) and one frame from the path's first
camera, which warms every shape a frame uses. Window: frames until
the first that ends after the run's seconds; with a trace, the first
`trace_units` frames under torch.profiler. After the window the program
is freed and the reference renders frames drawn from the seed among the
window's and the numbers are compared.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from harness import check, program, scene
from reference.render import ball_volume, render_frame

# cameras on the path; a window longer than the path starts it again
TRAJECTORY = 1000
# LocalRF's default seed
PATH_SEED = 20211202


def _frame(model, traj: np.ndarray, k: int, n_frames: int, w: int, h: int, chunk: int) -> torch.Tensor:
    k %= len(traj)
    rgb, _, _, _ = model.forward_eval(np.arange(w * h), np.array([k % n_frames]), w, h,
                                      cam2world=traj[k:k + 1], chunk=chunk)
    return rgb.cpu()


def reference_frames(spec: dict, weights: dict, traj: np.ndarray, ks: list, device,
                     precision: str = "f32") -> list:
    config, traffic = spec["config"], spec["traffic"]
    model = scene.reference_model(spec["field"], scene.widths(config))
    (w, h), grid = traffic["wh"], traffic["grid"]
    alpha = ball_volume(grid // 2, traffic["ball_radius"], device)
    weights = {k: v.to(device) for k, v in weights.items()}
    c2w = torch.from_numpy(traj).to(device)
    return [render_frame(weights, model, c2w[k], w, h, grid, alpha, precision, config["batch_size"],
                         occ_min=traffic["occ_min"]).cpu() for k in ks]


def program_frames(spec: dict, run, ks: list) -> tuple[list, dict, np.ndarray]:
    """Frames `ks` of the seed's trajectory through a fresh program, with no
    window (calibration); returns (frames, host weights, trajectory)."""
    config, traffic = spec["config"], spec["traffic"]
    sd = scene.seeds(run.seed)
    (w, h), n = traffic["wh"], traffic["frames"]
    model, weights = program.build(spec["field"], config, traffic, sd, run.device)
    traj = scene.trajectory(TRAJECTORY, PATH_SEED)
    frames = [_frame(model, traj, k, n, w, h, config["batch_size"]) for k in ks]
    return frames, {k: v.cpu() for k, v in weights.items()}, traj


def checked_frames(seed: int, n_rendered: int, n_check: int) -> list:
    """The window's frames the reference renders: n_check drawn from the seed."""
    rng = np.random.default_rng(seed)
    return sorted(rng.choice(n_rendered, size=min(n_check, n_rendered), replace=False).tolist())


def run(spec: dict, run) -> dict:
    config, traffic = spec["config"], spec["traffic"]
    dev = run.device
    sd = scene.seeds(run.seed)
    (w, h), n = traffic["wh"], traffic["frames"]
    chunk = config["batch_size"]
    model, weights = program.build(spec["field"], config, traffic, sd, dev)
    weights = {k: v.cpu() for k, v in weights.items()}
    traj = scene.trajectory(TRAJECTORY, PATH_SEED)
    run.mark("model")
    _frame(model, traj, 0, n, w, h, chunk)
    run.mark("warm-up frame")
    run.setup_done = time.perf_counter()

    frames, bad = [], 0
    t0 = time.perf_counter()
    while True:
        traced = run.trace and len(frames) < traffic["trace_units"]
        if traced and not frames:
            run.start_trace()
        with run.spans("forward_eval"):
            rgb = _frame(model, traj, len(frames) + 1, n, w, h, chunk)
        frames.append(rgb)
        bad += int(not torch.isfinite(rgb).all())
        if traced and len(frames) == traffic["trace_units"]:
            run.stop_trace()
        if time.perf_counter() - t0 >= run.seconds:
            break
    seconds = time.perf_counter() - t0
    if run.trace and len(frames) < traffic["trace_units"]:
        run.stop_trace()
    n_traced = min(len(frames), traffic["trace_units"]) if run.trace else 0
    out = {
        "seconds": seconds, "attempted": len(frames), "failed": bad,
        "e2e": {"eval_ms_per_frame": seconds * 1e3 / len(frames)},
        "traced": {"frames": n_traced, "pixels": n_traced * w * h},
        "memory_peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
    }
    run.close_window()
    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ks = checked_frames(sd["sampler"], len(frames), traffic["check_frames"])
    refs = reference_frames(spec, weights, traj, [(k + 1) % len(traj) for k in ks], dev)
    out["numbers"] = check.eval_numbers([frames[k] for k in ks], refs)
    return out
