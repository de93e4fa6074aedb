"""Device ms between two eval frames: the card's time from one frame's last
chunk end to the next frame's first chunk start (the caller's read-back
and loop, forward_eval's prologue: window and camera read-backs, uploads,
the quad tables), from the stamps forward_eval has the card write while the
tracer records (localrf_tpu_torch/utils/profiling.py), averaged over the
traced frame boundaries. None without two consecutive traced frames."""


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
    gaps = frames["frame_gaps_ns"]
    if not gaps:
        return None
    return sum(gaps) / len(gaps) / 1e6
