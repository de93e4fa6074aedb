"""Device ms an eval frame spends in its chunks outside the field features
(rays, sampling and culling, density, K1, the MLP head, blending), from
the stamps forward_eval has the card write while the tracer records
(localrf_tpu_torch/utils/profiling.py: each chunk's start and end less its
features), over the traced frames. None where the program records no
stamps."""


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
    return (frames["chunks_ns"] - frames["features_ns"]) / frames["frames"] / 1e6
