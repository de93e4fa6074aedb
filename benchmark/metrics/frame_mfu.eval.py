"""An eval frame's share of the card's dense bf16 peak: the model's forward
operations at every kept sample of every pixel (harness/flops.py, counted
from the configuration's widths and its field module) times the traced
frames, over the traced window's seconds and 989 TFLOP/s."""
from harness import flops, scene


def read(ctx: dict):
    trace, traced = ctx["trace"], ctx["traced"]
    if trace is None or not traced.get("frames"):
        return None
    spec = ctx["spec"]
    per_px = flops.eval_frame(spec["field"], scene.widths(spec["config"]), 1, spec["traffic"]["occ_m"])
    return 100.0 * per_px * traced["pixels"] / (trace["window_s"] * flops.PEAK_BF16_FLOP_S)
