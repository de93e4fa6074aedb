"""Device ms between two chunks, per step: the card's time from one chunk's
last step-end stamp to the next chunk's first step-start stamp
(localrf_tpu_torch/utils/profiling.py; the host's read-back, events,
plan_chunk and run_chunk's staging, and the first step's input copy lie in
it), averaged over the traced chunk boundaries, over the steps of a chunk.
None without two consecutive traced chunks."""


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
    gaps = train["chunk_gaps_ns"]
    if not gaps:
        return None
    return sum(gaps) / len(gaps) / (train["steps"] / train["chunks"]) / 1e6
