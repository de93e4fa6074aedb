"""Share of the traced training window in which no kernel, copy or set ran
on the card: 1 - (union of the device's busy intervals) / window, from
torch.profiler."""


def read(ctx: dict):
    trace = ctx["trace"]
    if trace is None or not ctx["traced"].get("steps"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
