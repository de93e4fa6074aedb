"""The per-layer metrics read from the program's own record
(localrf_tpu_torch/utils/profiling.py: host spans, and the stamps the
device writes inside each training step and eval chunk), on the tiny CPU
cells of conftest.py: reported by a traced run, consistent with the record,
absent from an untraced one, and leaving the profiler-trace metrics as
they are (the program opens no profiler range)."""
from __future__ import annotations

import json

from conftest import make_tiny, run_tiny

TRAIN = ("features_ms_per_step.train", "render_ms_per_step.train", "regularizer_ms_per_step.train",
         "adam_ms_per_step.train", "chunk_gap_ms_per_step.train", "stage_ms_per_step.train")
EVAL = ("features_ms_per_frame.eval", "render_ms_per_frame.eval", "frame_gap_ms.eval")
PROGRAM_SPANS = {"plan_chunk", "run_chunk", "pool_sync", "schedule", "upload", "replay", "readback", "stamps",
                 "events", "graph.capture", "forward_eval", "prologue", "chunks", "epilogue"}


class Units:
    """A window length of `n` units whatever their time: the entries end
    the window after the first unit with `elapsed >= seconds`, which asks
    this object (float's comparison defers to it) once a unit."""

    def __init__(self, n: int):
        self.n = n

    def __le__(self, elapsed) -> bool:
        self.n -= 1
        return self.n <= 0


def _tiny_two_frames(tmp_path):
    """The tiny copy with two traced eval frames (one gap between them)."""
    bench = make_tiny(tmp_path)
    path = bench / "traffic" / "tiny-eval.json"
    traffic = json.loads(path.read_text())
    traffic["trace_units"] = 2
    path.write_text(json.dumps(traffic))
    return bench


def test_traced_runs_report_the_program_span_metrics(tmp_path):
    """A traced train run reports the six train metrics, an eval run the
    three eval metrics, each > 0; the four train groups sum to the steps'
    mean span; the record holds the traced steps and frames."""
    from localrf_tpu_torch.utils import profiling

    bench = _tiny_two_frames(tmp_path)
    out = run_tiny(bench, "tiny.tiny-train", seconds=Units(2), trace=True)
    assert out["correct"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    for name in TRAIN:
        assert got[name] > 0 and out["metrics"][name]["unit"] == "ms", name
    train = profiling.summary()["train"]
    assert train["steps"] == 8 and train["chunks"] == 2 and len(train["chunk_gaps_ns"]) == 1
    groups = sum(got[n] for n in TRAIN[:4])
    assert abs(groups - train["step_span_ns"] / train["steps"] / 1e6) <= 1e-9 * groups
    assert not set(EVAL) & set(got)

    out = run_tiny(bench, "tiny.tiny-eval", seconds=Units(2), trace=True)
    assert out["correct"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    for name in EVAL:
        assert got[name] > 0 and out["metrics"][name]["unit"] == "ms", name
    frames = profiling.summary()["eval"]
    assert frames["frames"] == 2 and len(frames["frame_gaps_ns"]) == 1
    assert not set(TRAIN) & set(got)


def test_an_untraced_run_records_nothing(tiny):
    from localrf_tpu_torch.utils import profiling

    profiling.RECORDER.reset()
    for cell in ("tiny.tiny-train", "tiny.tiny-eval"):
        out = run_tiny(tiny, cell)
        assert set(out["metrics"]) <= {"train_rays_per_s", "eval_ms_per_frame", "setup_s"}
    rec = profiling.RECORDER
    assert (rec.spans, rec.counters, rec.device, rec.pending) == ([], [], [], [])


def test_the_program_record_leaves_the_trace_metrics_alone(tiny, monkeypatch):
    """The profiler's events hold no program span, so idle_share, step_mfu
    and breakdown read the same events with the program's recording on as
    with it off. On the CPU the trace has no device events: here every
    aten op stands in for a kernel, so that the reduction runs."""
    import run as runner
    from harness import trace

    from localrf_tpu_torch.utils import profiling

    seen = []

    def cpu_ops_as_kernels(prof):
        events = [(e.name(), e.start_ns(), e.end_ns(), e.name().startswith("aten::"))
                  for e in prof.profiler.kineto_results.events()]
        seen.append({e[0] for e in events})
        return trace.reduce_events(events)

    monkeypatch.setattr(runner, "reduce_trace", cpu_ops_as_kernels)
    results = []
    for on in (True, False):
        with monkeypatch.context() as mp:
            if not on:
                mp.setattr(profiling, "_profiler_on", lambda: False)
            results.append(run_tiny(tiny, "tiny.tiny-train", seconds=Units(2), trace=True))
    (with_record, without), (names_on, names_off) = results, seen
    assert set(with_record["metrics"]) == set(without["metrics"]) | set(TRAIN)
    for out in (with_record, without):
        assert {"idle_share.train", "step_mfu.train"} <= set(out["metrics"])
        ops = {name for name, _ in out["breakdown"]["device_ops"]}
        gaps = {label for label, _ in out["breakdown"]["idle_gaps"]}
        assert not ops & PROGRAM_SPANS and gaps <= {"plan_chunk", "run_chunk", "between spans"}
    assert not names_on & PROGRAM_SPANS and not names_off & PROGRAM_SPANS
    # the same profiler event names, but for the host ops of the record's
    # ring writes and its marks' autograd functions (host events, no range)
    extra = names_on - names_off
    assert all(n.startswith("aten::") or "_Mark" in n for n in extra), extra
