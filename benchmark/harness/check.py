"""The numbers that decide `correct`, each against its limit.

Training (the first steps of the run, followed by the reference):
- loss_gap: the widest relative gap of a loss (rgb, flow, depth, L1,
  total) of the first step. Later steps' losses are no measure: Adam's
  first steps move each pose by about its learning rate times the sign of
  its gradient, so a pose gradient near 0 whose sign rounds the other way
  moves the flow loss of the next steps by percents in sound runs;
- grad_gap: over the leaves (each factor grid, the basis, each MLP tensor,
  the poses' rotations and translations, the exposures), the widest gap
  between the norms of the first step's gradient, |prog| - |ref|, against
  the larger of the reference leaf's norm and the median leaf's;
- update_gap: the same for the change of each leaf over the steps, leaving
  out leaves whose reference gradient is under a thousandth of the median
  leaf's (their change is Adam's round-off);
- grad_elem_gap: over the leaves, the 75th percentile of each leaf's
  median relative error of the first step's gradient over its larger
  elements (|ref| at least the median of its non-zero |ref|). A gap of
  norms is second order in unbiased rounding errors and its first-order
  part is a random projection, so the gaps above cannot tell a lower
  precision from the configuration's (PERF.md); a median over elements
  can, and the depth loss's per-view median and quantiles, which move
  part of the gradient between a few rays when a depth moves by
  round-off, do not move it. The leaves fall in two groups (the density
  planes, whose gradient is mostly the f32 L1 term's, read ~1e-7; the
  others 1e-3 to 1e-1): the median leaf sits on the edge between them and
  jumps from seed to seed, the 75th percentile sits inside the upper one.
Eval: rgb_max_gap and rgb_mean_gap, the widest and the mean absolute gap of
an rgb value over the sampled frames.
"""
from __future__ import annotations

import math
import statistics

LOSSES = ("rgb_loss", "flow_loss", "depth_loss", "l1_loss", "total_loss")
TINY_GRAD = 1e-3


def _leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys}


def train_detail(prog: dict, ref: dict) -> dict:
    """Every gap behind the numbers: {"loss": {"<name> step <i>": gap},
    "grad", "update", "grad_elem": {leaf: gap}} of the program's (or the
    control's) `prog` against the reference's `ref`, each {"losses":
    [{name: float}] a step, "grad1": {leaf: norm}, "grad1_tensors": {leaf:
    tensor}, "update": {leaf: norm}}."""
    loss = {f"{k} step {i + 1}": abs(p[k] - r[k]) / max(abs(r[k]), 1e-30)
            for i, (p, r) in enumerate(zip(prog["losses"], ref["losses"])) for k in LOSSES}
    if len(prog["losses"]) != len(ref["losses"]):
        loss["step count"] = math.inf
    med = statistics.median(ref["grad1"].values())
    moved = [k for k in ref["update"] if ref["grad1"][k] >= TINY_GRAD * med]
    elem = {}
    for k in ref["grad1"]:
        g = ref["grad1_tensors"][k].double().reshape(-1)
        err = (prog["grad1_tensors"][k].double().reshape(-1) - g).abs()
        mag = g.abs()
        nonzero = mag[mag > 0]
        big = mag >= (nonzero.median() if nonzero.numel() else math.inf)
        elem[k] = float((err[big] / mag[big]).median()) if big.any() else 0.0
    return {"loss": loss, "grad": _leaf_gaps(prog["grad1"], ref["grad1"], ref["grad1"]),
            "update": _leaf_gaps(prog["update"], ref["update"], moved), "grad_elem": elem}


def _worst(gaps: dict) -> tuple[float, str]:
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def train_numbers(prog: dict, ref: dict) -> dict:
    """{name: (value, where)}: train_detail's widest gap of the first
    step's losses, of the gradient and of the change, and grad_elem's 75th
    percentile leaf."""
    d = train_detail(prog, ref)
    first = {k: v for k, v in d["loss"].items() if k.endswith(" step 1") or k == "step count"}
    ranked = sorted(d["grad_elem"].items(), key=lambda kv: kv[1])
    leaf, value = ranked[round(0.75 * (len(ranked) - 1))]
    return {"loss_gap": _worst(first), "grad_gap": _worst(d["grad"]), "update_gap": _worst(d["update"]),
            "grad_elem_gap": (value, leaf)}


def eval_numbers(frames: list, refs: list) -> dict:
    """rgb [N, 3] of the program's frames against the reference's."""
    worst, total, count = 0.0, 0.0, 0
    for got, want in zip(frames, refs):
        err = (got.float() - want.float()).abs()
        err = err.nan_to_num(nan=math.inf)
        worst = max(worst, float(err.max()))
        total += float(err.double().sum())
        count += err.numel()
    return {"rgb_max_gap": (worst, f"{len(frames)} frames"), "rgb_mean_gap": (total / max(count, 1), "")}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(all within their limits, {name: {"value", "limit"}}). A number
    that is not finite, or that has no limit, fails."""
    table = {k: {"value": v, "limit": limits.get(k)} for k, (v, _) in numbers.items()}
    ok = all(row["limit"] is not None and math.isfinite(row["value"]) and row["value"] <= row["limit"]
             for row in table.values())
    return ok, table
