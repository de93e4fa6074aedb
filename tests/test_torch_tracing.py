"""The port's tracer (localrf_tpu_torch/utils/profiling.py): host spans and
counters inside the program, the device stamps of a training step and of
an eval frame, and the numbers read from them.

On the CPU a stamp is time.time_ns() (ops run synchronously there), so a
step's stamps, its groups and the backward order can be checked here; the
card's kernel (csrc/stamp.cu), its ring in a replayed CUDA graph and the
mapping of its clock onto the profiler's are checked by the `gpu` tests,
which skip without a card: `python -m pytest tests/test_torch_tracing.py
-q --noconftest -m gpu` on one. This file imports no jax.
"""
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from localrf_tpu_torch.data.dataset import SyntheticDataset
from localrf_tpu_torch.data.pool import DevicePixelPool
from localrf_tpu_torch.models import local as tlocal
from localrf_tpu_torch.models import step as tstep
from localrf_tpu_torch.models import tensorf as ttf
from localrf_tpu_torch.utils import profiling

W, H, N_FRAMES, N_VIEWS, BATCH = 40, 30, 6, 4, 128
TF_KW = dict(grid_size=(24, 24, 24), pallas_composite=True, binned_min_rows=100)
PROGRAM_NAMES = {"plan_chunk", "run_chunk", "pool_sync", "schedule", "upload", "replay", "readback", "stamps",
                 "events", "graph.capture", "forward_eval", "prologue", "chunks", "epilogue"}


def _dataset():
    rng = np.random.default_rng(0)
    shape = (N_FRAMES, H, W)
    return SyntheticDataset(
        rng.random((*shape, 3), dtype=np.float32), "train",
        invdepths=0.1 + 0.9 * rng.random(shape, dtype=np.float32),
        fwd_flow=rng.normal(0, 1, (*shape, 2)).astype(np.float32), fwd_mask=np.ones(shape, np.float32),
        bwd_flow=rng.normal(0, 1, (*shape, 2)).astype(np.float32), bwd_mask=np.ones(shape, np.float32),
        n_init_frames=N_FRAMES, test_frame_every=3,
    )


def _model(device="cpu", pool=True, n_iters_reg=40):
    """A refining model at rf_iter 2 (the L1 term on while rf_iter < n_iters_reg)."""
    cfg = tlocal.LocalConfig(WH=(W, H), n_init_frames=N_FRAMES, n_views=N_VIEWS, batch_size=BATCH,
                             tensorf=ttf.TensorfConfig(**TF_KW))
    m = tlocal.LocalTensorfs(cfg, device=device)
    m.is_refining = True
    m.rf_iter[-1] = 2
    m.n_iters_reg = n_iters_reg
    ds = _dataset()
    if pool:
        m.attach_pool(DevicePixelPool(ds, capacity=8, device=device))
    return m, ds


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _step_rows(record: dict) -> list[dict]:
    return [dict(zip(record["names"], map(int, row))) for row in record["stamps"]]


def test_nothing_is_recorded_without_a_profiler():
    """Outside a profiler session spans, counters and stamps record nothing:
    no span, no counter, no device record, no pending eval ring."""
    profiling.RECORDER.reset()
    m, ds = _model()
    m.run_chunk(m.plan_chunk(ds, True, 2), optimize_poses=True)
    m.forward_eval(np.arange(W * H), np.array([1]), W, H, chunk=512)
    rec = profiling.RECORDER
    assert not profiling.recording()
    assert (rec.spans, rec.counters, rec.device, rec.pending, rec.units) == ([], [], [], [], {})
    assert profiling.summary() == {"counters": {}, "dropped": 0}


def test_spans_nest_with_parents_and_units(monkeypatch):
    """Under a profiler: plan_chunk and run_chunk share a chunk unit, each
    chunk a new one; run_chunk's parts are its children in order; an eval
    frame is a unit with prologue, chunks and epilogue; the record stays
    after the session, and a new session (once the profiler was seen off)
    starts a fresh one; no span is a range of the profiler's own; records
    past the bound are counted as dropped."""
    m, ds = _model()
    m.run_chunk(m.plan_chunk(ds, True, 2), optimize_poses=True)  # before: not recorded
    with _cpu_profile() as prof:
        for _ in range(2):
            m.run_chunk(m.plan_chunk(ds, True, 2), optimize_poses=True)
        m.forward_eval(np.arange(W * H), np.array([1]), W, H, chunk=512)
    spans = profiling.RECORDER.spans
    names = [s[0] for s in spans]
    top = [(s[0], s[4]) for s in spans if s[3] == -1]
    assert top == [("plan_chunk", 1), ("run_chunk", 1), ("plan_chunk", 2), ("run_chunk", 2), ("forward_eval", 3)]
    for i, s in enumerate(spans):
        assert s[1] <= s[2], s
        if s[3] >= 0:
            parent = spans[s[3]]
            assert parent[1] <= s[1] <= s[2] <= parent[2] and parent[4] == s[4], (s, parent)
    runs = [i for i, n in enumerate(names) if n == "run_chunk"]
    for r in runs:
        assert [s[0] for s in spans if s[3] == r] == ["pool_sync", "schedule", "upload", "replay", "readback",
                                                     "stamps", "events"]
    frame = names.index("forward_eval")
    assert [s[0] for s in spans if s[3] == frame] == ["prologue", "chunks", "epilogue"]
    assert profiling.RECORDER.units[3]["kind"] == "frame"
    kineto = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not kineto & PROGRAM_NAMES
    m.run_chunk(m.plan_chunk(ds, True, 1), optimize_poses=True)  # seen off: the next session starts afresh
    assert len(profiling.RECORDER.spans) == len(spans)
    with _cpu_profile():
        m.run_chunk(m.plan_chunk(ds, True, 1), optimize_poses=True)
    assert [s[0] for s in profiling.RECORDER.spans if s[3] == -1] == ["plan_chunk", "run_chunk"]
    # bounded: what does not fit is counted
    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)
    assert not profiling.recording()
    with _cpu_profile():
        m.run_chunk(m.plan_chunk(ds, True, 1), optimize_poses=True)
    rec = profiling.RECORDER
    assert len(rec.spans) + len(rec.counters) == 3 and rec.dropped > 0
    assert [s[0] for s in rec.spans] == ["plan_chunk", "run_chunk", "pool_sync"]


def _record_backward(monkeypatch, log: list):
    """Log, in the order autograd runs them, every node of the step's
    backward (by its forward sequence number) and every stamp."""
    grad = torch.autograd.grad

    def logged_grad(outputs, inputs, **kw):
        seen, todo = set(), [outputs.grad_fn]
        while todo:
            node = todo.pop()
            if node is None or node in seen:
                continue
            seen.add(node)
            node.register_prehook(lambda grads, node=node: log.append(node))
            todo += [n for n, _ in node.next_functions]
        return grad(outputs, inputs, **kw)

    stamp = profiling._stamp_kernel.stamp

    def logged_stamp(ring, step, row, slot):
        log.append(profiling.TRAIN_SLOTS[slot])
        stamp(ring, step, row, slot)

    monkeypatch.setattr(torch.autograd, "grad", logged_grad)
    monkeypatch.setattr(profiling._stamp_kernel, "stamp", logged_stamp)


@pytest.mark.parametrize("l1", [True, False], ids=["l1", "no-regularizer"])
def test_train_step_stamps_partition_the_step(l1, monkeypatch):
    """One CPU step of the chunk path while recording: its stamps come in
    TRAIN_SLOTS' order (the regularizer's four in place, empty, without a
    regularizer branch), the four groups sum to the step's span, and in the
    backward pass each group's nodes run as one block between its stamps:
    the nodes made between the features' marks in the forward pass run
    between "features.bwd" and "features.bwd_end", the regularizer's
    between its two, every other node outside both."""
    m, ds = _model(n_iters_reg=40 if l1 else 0)
    batches = m.plan_chunk(ds, True, 1)
    assert not batches[0]["train_test_poses"]
    log = []
    _record_backward(monkeypatch, log)
    with _cpu_profile():
        m.run_chunk(batches, optimize_poses=True)
    assert (m.chunk_metrics["l1_loss"][0] > 0) == l1
    (record,) = profiling.RECORDER.device
    (row,) = _step_rows(record)
    times = [row[n] for n in profiling.TRAIN_SLOTS]
    assert times == sorted(times) and times[0] > 0
    ivals = profiling.step_intervals(record["stamps"][0], record["names"])
    assert [g for g, _, _ in ivals] == [profiling.TRAIN_OPENS[n] for n in profiling.TRAIN_SLOTS[:-1]]
    groups = profiling.summary()["train"]["groups_ns"]
    assert sum(groups.values()) == row["end"] - row["start"]
    assert groups["features"] > 0 and groups["render"] > 0 and groups["adam"] > 0
    assert groups["regularizer"] > 0

    marks = sorted(n._sequence_nr() for n in log if not isinstance(n, str) and type(n).__name__ == "_MarkBackward")
    assert len(marks) == (4 if l1 else 2)

    def made_in(seq):
        if marks[0] < seq < marks[1]:
            return "features"
        if l1 and marks[2] < seq < marks[3]:
            return "regularizer"
        return "render"

    where = "render"
    opens = {"features.bwd": "features", "features.bwd_end": "render", "regularizer.bwd": "regularizer",
             "regularizer.bwd_end": "render"}
    regs = [log.index(n) for n in ("regularizer", "regularizer.end", "regularizer.bwd", "regularizer.bwd_end")]
    if not l1:  # the four at once in the forward pass: nothing runs between them
        assert regs == list(range(regs[0], regs[0] + 4))
    backward = log[log.index("regularizer.end") + 1:]
    assert backward[-2:] == ["adam", "end"]
    n_nodes = dict.fromkeys(("features", "render", "regularizer"), 0)
    for entry in backward[:-2]:
        if isinstance(entry, str):
            where = opens[entry]
        elif type(entry).__name__ != "_MarkBackward":
            assert made_in(entry._sequence_nr()) == where, (entry, where)
            n_nodes[where] += 1
    assert n_nodes["features"] > 10 and n_nodes["render"] > 10 and (n_nodes["regularizer"] > 0) == l1


def test_stamps_change_no_number():
    """A chunk stepped with the stamps and marks on (recording) equals the
    same chunk without them bit for bit: losses, field, Adam state, poses."""
    out = []
    for record in (False, True):
        m, ds = _model()
        batches = m.plan_chunk(ds, True, 3)
        if record:
            with _cpu_profile():
                m.run_chunk(batches, optimize_poses=True)
            assert len(profiling.RECORDER.device) == 1
        else:
            m.run_chunk(batches, optimize_poses=True)
        f = m.fields[-1]
        state = {k: v.detach().clone() for k, v in f["params"].named_parameters()}
        state.update({f"m.{k}": v.clone() for k, v in f["opt"].m.items()})
        state.update(r=m._pose_dev.r.clone(), t=m._pose_dev.t.clone(), e=m._pose_dev.exposure.clone())
        out.append((state, m.chunk_metrics))
    (s0, m0), (s1, m1) = out
    for k in m0:
        np.testing.assert_array_equal(m0[k], m1[k], err_msg=k)
    for k in s0:
        np.testing.assert_array_equal(s0[k].numpy(), s1[k].numpy(), err_msg=k)


def _chunk_record(unit: int, t0: int, steps: list[list[int]]) -> dict:
    """A hand-made chunk record: steps given as each step's 11 stamp offsets from t0."""
    stamps = np.asarray([[t0 + x for x in s] for s in steps], np.int64)
    return {"unit": unit, "kind": "chunk", "names": profiling.TRAIN_SLOTS, "stamps": stamps, "cal_ns": None}


def test_chunk_and_frame_gap_arithmetic():
    """The record's numbers on hand-made stamps: groups by the interval a
    stamp opens, gaps between steps, between consecutive chunks (not across
    a unit that is missing), between frames, and eval features and rest."""
    rec = profiling.RECORDER
    rec.reset()
    #         start feat  f.end reg  r.end r.bwd r.be  f.bwd f.be  adam  end
    step_a = [0, 10, 30, 31, 35, 40, 47, 50, 80, 90, 100]
    step_b = [0, 5, 25, 25, 25, 25, 25, 30, 60, 61, 71]  # no regularizer: four stamps at once
    rec.device = [_chunk_record(1, 1000, [step_a, [x + 104 for x in step_b]]),
                  _chunk_record(2, 1500, [step_a]),
                  _chunk_record(4, 2000, [step_b])]  # unit 3 missing: no gap to it
    t = profiling.summary()["train"]
    assert t["steps"] == 4 and t["chunks"] == 3
    assert t["groups_ns"] == {"features": 2 * (20 + 30) + 2 * (20 + 30), "render": 2 * (10 + 1 + 5 + 3 + 10) + 2 * (5 + 0 + 0 + 5 + 1),
                              "regularizer": 2 * (4 + 7) + 0, "adam": 2 * 10 + 2 * 10}
    assert t["step_span_ns"] == 2 * 100 + 2 * 71
    assert t["step_gaps_ns"] == [4]
    assert t["chunk_gaps_ns"] == [1500 - (1000 + 104 + 71)]
    # eval: row 0 the frame, then one row a chunk (start, features, features.end, end)
    f1 = np.asarray([[0, 0, 0, 95], [5, 10, 30, 40], [45, 50, 80, 90]], np.int64)
    f2 = f1 + 200
    rec.device = [{"unit": 7, "kind": "frame", "names": profiling.EVAL_SLOTS, "stamps": f, "cal_ns": None}
                  for f in (f1, f2)]
    rec.device[1]["unit"] = 8
    e = profiling.summary()["eval"]
    assert (e["frames"], e["chunks"]) == (2, 4)
    assert e["features_ns"] == 2 * (20 + 30) and e["chunks_ns"] == 2 * (35 + 45)
    assert e["frame_gaps_ns"] == [205 - 90] and e["frame_ns"] == 2 * 95
    names = [ev[0] for ev in profiling.device_events()]
    assert names.count("frame_gap") == 1 and names.count("features") == 4
    # card records: every stamp moves by the largest calibration (the quickest launch)
    rec.device[0]["cal_ns"], rec.device[1]["cal_ns"] = 1000, 1007
    gap = [ev for ev in profiling.device_events() if ev[0] == "frame_gap"]
    assert gap == [("frame_gap", 90 + 1007, 205 + 1007, {"unit": 8})]
    rec.reset()


class _Executor:
    """A stand-in for ChunkGraphs on the CPU: steps eagerly into its own
    ring and counts a capture for a new key, a replay otherwise."""

    def __init__(self):
        self.captures = self.replays = 0
        self.keys = set()
        self.ring = profiling.train_ring(1, "cpu")

    def run(self, field, pose, intr, statics, alpha_volume, batch_of, bound, inputs_seq, scalars_seq, noise_seq,
            branches_seq, n_steps, mesh=None):
        for b in branches_seq:
            new = (statics, b) not in self.keys
            self.keys.add((statics, b))
            self.captures += new
            self.replays += not new
        return tstep._run_chunk(field, pose, intr, batch_of, inputs_seq, scalars_seq, statics, noise_seq, n_steps,
                                alpha_volume, branches_seq, None, mesh, stamps=self.ring)


def test_counters_of_captures_replays_pool_uploads_and_staging():
    """Captures and replays come from the chunk executor's own counts;
    the pool counts the frames and bytes it uploads, run_chunk the staged
    host-to-device copies (its index streams and the three scalar arrays)
    and their bytes; the executor's ring rows become the chunk's record."""
    m, ds = _model(pool=False)
    m._graphs = _Executor()
    with _cpu_profile():
        m.attach_pool(DevicePixelPool(ds, capacity=8, device="cpu"))
        m.run_chunk(m.plan_chunk(ds, True, 2), optimize_poses=True)  # sync uploads the 6 frames
        b = m.plan_chunk(ds, True, 3)
        m.run_chunk(b, optimize_poses=True)
    c = profiling.counters()
    n_px = W * H
    assert c["pool.upload_frames"] == N_FRAMES
    assert c["pool.upload_bytes"] == N_FRAMES * n_px * 4 * (3 + 1 + 1 + 2 + 2 + 1 + 1)
    # per chunk: px, slots, view_ids, gate (int64 / bool) and 3 scalar arrays
    wc = m._pose_dev.r.shape[0]
    n_scalars = len([k for k in m._scalars_py() if k not in ("world2rf", "n_valid")])

    def staged(k):
        return k * (8 * BATCH + 8 * N_VIEWS * 2 + wc) + k * (4 * n_scalars + 4 * 3 + 8)

    assert c["h2d.copies"] == 2 * (4 + 3)
    assert c["h2d.bytes"] == staged(2) + staged(3)
    assert c["graph.captures"] + c["graph.replays"] == 5 and c["graph.captures"] >= 1
    rows = [len(d["stamps"]) for d in profiling.RECORDER.device]
    assert rows == [2, 3]
    assert all(np.all(np.diff(d["stamps"], axis=1) >= 0) for d in profiling.RECORDER.device)


def test_trace_writes_program_spans_on_the_trace_clock(tmp_path):
    """profiling.trace(dir) writes one Chrome trace holding the program's
    record on its clock: a span brackets the CPU op it wraps, a chunk's
    step groups lie inside its replay span, counters are counter events."""
    m, ds = _model()
    with profiling.trace(str(tmp_path)):
        with profiling.span("cumsum"):
            torch.ones(4096).cumsum(0)
        m.run_chunk(m.plan_chunk(ds, True, 2), optimize_poses=True)
    (path,) = [p for p in os.listdir(tmp_path) if p.endswith(".pt.trace.json")]
    events = json.loads((tmp_path / path).read_text())["traceEvents"]
    mine = [e for e in events if e.get("cat") == "program" and e["ph"] == "X"]
    span = next(e for e in mine if e["name"] == "cumsum")
    op = next(e for e in events if e.get("name") == "aten::cumsum")
    assert span["ts"] <= op["ts"] and op["ts"] + op["dur"] <= span["ts"] + span["dur"]
    replay = next(e for e in mine if e["name"] == "replay")
    steps = [e for e in events if e.get("cat") == "program_device"]
    assert {e["name"] for e in steps} == {"features", "render", "regularizer", "adam"}
    for e in steps:
        assert replay["ts"] <= e["ts"] and e["ts"] + e["dur"] <= replay["ts"] + replay["dur"] + 1e-3
    assert any(e["ph"] == "C" and e["name"] == "pool.upload_frames" for e in events)
    with profiling.trace(None) as prof:
        torch.ones(2).sum()
    assert prof is None


# ------------------------------ on a card ------------------------------


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stamp kernel runs only there")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_replayed_chunk_fills_one_ring_row_per_step(cuda_device):
    """Chunks of captured graphs while recording: each step's row of the
    executor's ring is written at every replay (not only at capture), its
    stamps in TRAIN_SLOTS' order, each step after the one before, and the
    groups sum to the step's span."""
    m, ds = _model(cuda_device)
    m.run_chunk(m.plan_chunk(ds, True, 4), optimize_poses=True)  # captures
    with _cpu_profile():
        for _ in range(2):
            m.run_chunk(m.plan_chunk(ds, True, 4), optimize_poses=True)
    assert m._graphs.replays > 0
    records = profiling.RECORDER.device
    assert [len(d["stamps"]) for d in records] == [4, 4]
    last_end = 0
    for d in records:
        for row in _step_rows(d):
            times = [row[n] for n in profiling.TRAIN_SLOTS]
            assert times == sorted(times) and times[0] > last_end, times
            last_end = row["end"]
    t = profiling.summary()["train"]
    assert sum(t["groups_ns"].values()) == t["step_span_ns"] and len(t["chunk_gaps_ns"]) == 1
    assert profiling.counters()["graph.replays"] > 0


@pytest.mark.gpu
def test_mapped_device_intervals_meet_the_profilers_kernels(cuda_device, tmp_path):
    """In profiling.trace's timeline the device intervals mapped from the
    card's stamps start and end within 100 us of the stamp kernels the
    profiler saw on the card (CUPTI, host clock), for replayed steps and
    for an eval frame's chunks."""
    m, ds = _model(cuda_device)
    m.run_chunk(m.plan_chunk(ds, True, 4), optimize_poses=True)
    with profiling.trace(str(tmp_path)):
        for _ in range(2):
            m.run_chunk(m.plan_chunk(ds, True, 4), optimize_poses=True)
        for v in range(2):
            m.forward_eval(np.arange(W * H), np.array([v]), W, H, chunk=512)[0].cpu()
    (path,) = [p for p in os.listdir(tmp_path) if p.endswith(".pt.trace.json")]
    events = json.loads((tmp_path / path).read_text())["traceEvents"]
    kernels = np.sort(np.asarray([e["ts"] for e in events if e.get("cat") == "kernel" and "stamp_kernel" in e["name"]]))
    mapped = [e for e in events if e.get("cat") == "program_device"]
    assert len(kernels) > 0 and {e["name"] for e in mapped} >= {"features", "render", "adam", "frame_gap"}
    edges = np.asarray([t for e in mapped for t in (e["ts"], e["ts"] + e["dur"])])
    pos = np.clip(np.searchsorted(kernels, edges), 1, len(kernels) - 1)
    nearest = np.where(np.abs(kernels[pos] - edges) < np.abs(kernels[pos - 1] - edges), kernels[pos], kernels[pos - 1])
    off = edges - nearest  # us, signed
    assert np.abs(off).max() <= 100.0, (np.percentile(off, [0, 5, 50, 95, 100]).tolist(), len(off))


@pytest.mark.gpu
def test_recording_chunk_matches_eager_steps_bit_for_bit_on_card(cuda_device, monkeypatch):
    """With every sum in a fixed order, a chunk of captured graphs (their
    stamps inside) replayed while the tracer records equals the same steps
    taken eagerly (chunks of one under eager_chunks.eager_steps), bit for
    bit: the stamps and marks change no number."""
    from eager_chunks import eager_steps
    from localrf_tpu_torch.ops.kernels import binned_scatter as k2

    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(k2, "segment_sum", k2.binned_segment_sum_merged)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (mg, dsg), (me, dse) = _model(cuda_device), _model(cuda_device, pool=False)
        bg, be = mg.plan_chunk(dsg, True, 6), me.plan_chunk(dse, True, 6)
        mg.run_chunk(bg[:1], optimize_poses=True)  # the first key captured outside the session
        with _cpu_profile():
            mg.run_chunk(bg[1:], optimize_poses=True)
        assert len(profiling.RECORDER.device) == 1
        for b in be:
            with eager_steps(me):
                me.run_chunk([b], optimize_poses=True)
        for k, v in me.last_metrics.items():
            assert float(mg.chunk_metrics[k][-1]) == v, k
        for (k, p), (_, q) in zip(mg.fields[-1]["params"].named_parameters(),
                                  me.fields[-1]["params"].named_parameters()):
            assert torch.equal(p, q), k
    finally:
        torch.use_deterministic_algorithms(prev)
