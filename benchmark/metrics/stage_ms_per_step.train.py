"""Host ms a training step spends in run_chunk before its first replay
(models/local.py: the spans pool_sync, schedule and upload inside
run_chunk, recorded by localrf_tpu_torch/utils/profiling.py), over the
traced steps. None where the program records no spans."""


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
    return train["stage_ns"] / train["steps"] / 1e6
