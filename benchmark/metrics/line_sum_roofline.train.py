"""K3's share of its roofline in the training step: the least time of the
step's line sums (the field module's line_sum_bytes: for TensoRF-CP three
sums, each reading its bf16 cotangent rows and int64 row ids once and
writing the f32 gradient table once, over 3.35 TB/s) times the traced
steps, over the device time of the kernels of
localrf_tpu_torch/csrc/segsum_small.cu in the trace. None where the trace
holds no such kernel, or for a field with no line_sum_bytes."""
import re

from harness import flops, scene

K3 = re.compile(r"\bsegsum_small_(reduce_)?kernel\b")
# the occupancy probe's group of samples (reference/render.py `render`)
PROBE = 4


def read(ctx: dict):
    trace, traced = ctx["trace"], ctx["traced"]
    if trace is None or not traced.get("steps"):
        return None
    spec = ctx["spec"]
    line_sum_bytes = getattr(spec["field"], "line_sum_bytes", None)
    if line_sum_bytes is None:
        return None
    seconds = sum(s for name, s in trace["ops"].items() if K3.search(name))
    if seconds <= 0:
        return None
    traffic, batch = spec["traffic"], spec["config"]["batch_size"]
    # a ray keeps its occ_m compacted samples in the probe's groups of
    # PROBE (reference/render.py): occ_m rounded down to whole groups
    samples = traffic["occ_m"] // PROBE * PROBE
    need = line_sum_bytes(scene.widths(spec["config"]), traffic["grid"], batch, samples)
    return 100.0 * need * traced["steps"] / flops.HBM_BYTES_S / seconds
