"""Device ms a training step spends in the regularizers (models/tensorf.py
density_l1, tv_loss_*; forward and backward), from the card's stamps inside
each captured step (localrf_tpu_torch/utils/profiling.py: each stamp opens
an interval of one group, so the four groups sum to the step's span), over
the traced steps. None where the program records no stamps."""


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
    return train["groups_ns"]["regularizer"] / train["steps"] / 1e6
