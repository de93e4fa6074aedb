"""Device ms an eval frame spends in the field features (models/tensorf.py:
gathers, lerps, products; the frame's quad tables are built before its
first chunk), from the stamps forward_eval has the card write while the
tracer records (localrf_tpu_torch/utils/profiling.py: each chunk's
features start and end), over the traced frames. None where the program
records no stamps."""


def read(ctx: dict):
    if not ctx["traced"].get("frames"):
        return None
    try:
        from localrf_tpu_torch.utils import profiling
    except ImportError:
        return None
    summary = getattr(profiling, "summary", None)
    frames = summary().get("eval") if summary is not None else None
    if not frames or not frames["frames"]:
        return None
    return frames["features_ns"] / frames["frames"] / 1e6
