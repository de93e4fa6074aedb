"""Host ms a training step spends in LocalTensorfs.plan_chunk (models/local.py),
the benchmark's span around each call over the traced chunks, per step."""


def read(ctx: dict):
    traced = ctx["traced"]
    if not traced.get("steps"):
        return None
    return traced["plan_s"] / traced["steps"] * 1e3
