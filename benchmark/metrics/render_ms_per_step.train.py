"""Device ms a training step spends in the render outside the field features
(models/render.py: the pooled gather, rays, sampling and culling, density,
K1, the MLP head; models/step.py: the losses; forward and backward), from
the card's stamps inside each captured step
(localrf_tpu_torch/utils/profiling.py: each stamp opens an interval of one
group, so the four groups sum to the step's span), over the traced steps.
None where the program records no stamps."""


def read(ctx: dict):
    if not ctx["traced"].get("steps"):
        return None
    try:
        from localrf_tpu_torch.utils import profiling
    except ImportError:
        return None
    summary = getattr(profiling, "summary", None)
    train = summary().get("train") if summary is not None else None
    if not train or not train["steps"]:
        return None
    return train["groups_ns"]["render"] / train["steps"] / 1e6
