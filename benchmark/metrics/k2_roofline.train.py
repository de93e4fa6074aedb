"""K2's share of its roofline in the training step: the least time of the
step's three plane sums (harness/flops.py k2_bytes: bf16 payload and int64
row ids read once, the bf16 gradient table written once, over 3.35 TB/s)
times the traced steps, over the device time of the kernels of
localrf_tpu_torch/csrc/segment_sum.cu in the trace."""
import re

from harness import flops, scene

K2 = re.compile(r"\bsegment_sum_(bin_count|bin_scan|bin_scatter|zero|tile)_kernel\b")


def read(ctx: dict):
    trace, traced = ctx["trace"], ctx["traced"]
    if trace is None or not traced.get("steps"):
        return None
    seconds = sum(s for name, s in trace["ops"].items() if K2.search(name))
    if seconds <= 0:
        return None
    spec = ctx["spec"]
    traffic, batch = spec["traffic"], spec["config"]["batch_size"]
    need = flops.k2_bytes(scene.widths(spec["config"]), traffic["grid"], batch, traffic["occ_m"])
    return 100.0 * need * traced["steps"] / flops.HBM_BYTES_S / seconds
