"""K2's share of its roofline in the training step: the least time of the
step's plane sums (harness/flops.py k2_bytes, the field module's
plane_sum_bytes: for TensoRF-VM three sums, each reading its bf16 payload
and int64 row ids once and writing the bf16 gradient table once, over
3.35 TB/s) times the traced steps, over the device time of the kernels of
localrf_tpu_torch/csrc/segment_sum.cu in the trace. None for a field with
no plane sums."""
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
    wd = scene.widths(spec["config"])
    need = flops.k2_bytes(spec["field"], wd, traffic["grid"], batch, traffic["occ_m"])
    if need is None:
        return None
    return 100.0 * need * traced["steps"] / flops.HBM_BYTES_S / seconds
