"""The training step's share of the card's dense bf16 peak: the model's
operations a step (harness/flops.py: every kept sample of every ray
forward and backward, the density L1 over the whole grid, Adam; counted
from the configuration's widths and its field module, not from the
kernels that run) times the traced steps, over the traced window's
seconds and 989 TFLOP/s."""
from harness import flops, scene


def read(ctx: dict):
    trace, traced = ctx["trace"], ctx["traced"]
    if trace is None or not traced.get("steps"):
        return None
    spec = ctx["spec"]
    traffic, batch = spec["traffic"], spec["config"]["batch_size"]
    wd = scene.widths(spec["config"])
    per_step = flops.train_step(spec["field"], wd, traffic["grid"], batch, traffic["occ_m"])
    return 100.0 * per_step * traced["steps"] / (trace["window_s"] * flops.PEAK_BF16_FLOP_S)
