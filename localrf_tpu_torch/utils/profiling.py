"""The port's tracer: host spans and counters recorded inside the program,
device stamps written by the card inside the captured training step, and
the per-layer numbers read from them (PyTorch counterpart of
localrf_tpu/utils/profiling.py, which has a trace context and a rays/sec
counter; the reference has an it/s print, ref: train.py:540-544).

Recording is on only while a torch.profiler session records (the
benchmark's `--trace 1` window, or `trace(logdir)`); otherwise a span or a
counter costs one flag read. The first span, counter or stamp read of a
new session (after a look that saw the profiler off, or at `trace`'s
start) starts a fresh record. Nothing here opens a torch.profiler
range: the profiler's own events stay the program's kernels and copies.

- Spans (`span`): name, start and end ns on `time.time_ns()` (the clock of
  the profiler's host events), the enclosing span, and the id of the unit
  they belong to: a training chunk (`plan_chunk` then `run_chunk`) or an
  eval frame (`forward_eval`). Counters (`count`) go in the same record,
  with their unit. Both are bounded (`MAX_RECORDS`); what does not fit is
  counted in `Recorder.dropped`.
- Device stamps (`StampRing`, `stamp`, `mark`): ops/kernels/stamp.py
  writes the card's clock into ring[row, slot] in stream order. A captured
  step (models/graph.py) always holds its stamps, so every replay writes
  one ring row; `run_chunk` reads the rows after its own read-back while
  recording. Eval frames stamp eagerly, only while recording, and are read
  at the next frame or when the record is read. `mark` is an identity that
  stamps in the forward pass and, through autograd, where the gradient of
  the marked tensors is complete in the backward pass.
- Mapping: one calibration stamp per unit, into the ring's row after the
  unit's, launched on the idle card right after the unit's read-back with
  `time.time_ns()` read just before, and read back with the unit's rows.
  Each gives the host-minus-card offset less that launch's latency; the
  largest of a record's (the quickest launch) maps all its device stamps
  onto the host's clock (CPU stamps are host times already).

Training groups: each stamp opens the interval to the next one, and
`TRAIN_OPENS` gives that interval's group, so the four groups sum to the
step's span (its "start" to its "end"):
- features: the density and appearance features (models/tensorf.py: quad
  tables, gathers, lerps, products, K2), forward and backward;
- render: the pooled gather, rays, sampling and culling, density, K1, the
  MLP head, the losses, forward and backward;
- regularizer: `density_l1`, `tv_loss_*`, forward and backward;
- adam: the pose, field, exposure and intrinsics updates and the step's
  tail (pose copy-back, metrics).
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import socket
import time

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

from ..ops.kernels import stamp as _stamp_kernel

# the stamps of one training step, in the order the card writes them
TRAIN_SLOTS = (
    "start", "features", "features.end", "regularizer", "regularizer.end", "regularizer.bwd",
    "regularizer.bwd_end", "features.bwd", "features.bwd_end", "adam", "end",
)
# the group of the interval each stamp opens ("end" closes the step)
TRAIN_OPENS = {
    "start": "render", "features": "features", "features.end": "render", "regularizer": "regularizer",
    "regularizer.end": "render", "regularizer.bwd": "regularizer", "regularizer.bwd_end": "render",
    "features.bwd": "features", "features.bwd_end": "render", "adam": "adam",
}
GROUPS = ("features", "render", "regularizer", "adam")
# an eval frame: row 0 the frame (entry, end after exposure and clamp), one
# row a chunk and field (start, its features, end)
EVAL_SLOTS = ("start", "features", "features.end", "end")
# run_chunk's children before its first replay
STAGE_SPANS = ("pool_sync", "schedule", "upload")
# rows of a captured chunk's ring; a longer chunk makes a ring of its length
# and one row to calibrate
RING_ROWS = 64


# spans and counters a record holds; more are counted as dropped
MAX_RECORDS = 1 << 16


def _profiler_on() -> bool:
    return _autograd_profiler._is_profiler_enabled


class Recorder:
    """Spans, counters and device stamps of one profiler session, in
    memory. Not thread-safe: the program records from its host thread
    (autograd's backward threads only write device stamps)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.spans: list[list] = []  # [name, start_ns, end_ns, parent index or -1, unit]
        self.counters: list[tuple] = []  # (name, value, unit, t_ns)
        self.units: dict[int, dict] = {}  # id -> {"kind", "names"}
        # {"unit", "kind", "names", "stamps" [rows, slots], "cal_ns": host - card at the
        # calibration stamp, None on the CPU}
        self.device: list[dict] = []
        self.pending: list[tuple] = []  # (unit, kind, StampRing) not read back yet
        self.dropped = 0
        self._stack: list[int] = []
        self._unit = 0

    def _room(self) -> bool:
        if len(self.spans) + len(self.counters) < MAX_RECORDS:
            return True
        self.dropped += 1
        return False

    def enter_unit(self, kind: str, name: str) -> None:
        """The current unit, or a new one of `kind` where the current is of
        another kind or already holds a span called `name`."""
        u = self.units.get(self._unit)
        if u is None or u["kind"] != kind or name in u["names"]:
            self._unit = max(self.units, default=0) + 1
            u = self.units[self._unit] = {"kind": kind, "names": set()}
        u["names"].add(name)

    def flush(self) -> None:
        """Read back the rings of eval frames still on the card."""
        pending, self.pending = self.pending, []
        for unit, kind, ring in pending:
            self.add_device(unit, kind, ring, ring.ring.shape[0] - 1)

    def add_device(self, unit: int, kind: str, ring: "StampRing", n_rows: int) -> None:
        """Rows [0, n_rows) of `ring`, read with the calibration stamp this
        launches into row n_rows (the card idle: after the unit's read-back)."""
        cal = None
        if ring.ring.device.type != "cpu":
            cal = time.time_ns()
            _stamp_kernel.stamp(ring.ring, None, n_rows, 0)
        rows = ring.ring[:n_rows + 1].cpu().numpy()
        self.device.append({"unit": unit, "kind": kind, "names": ring.names, "stamps": rows[:n_rows].copy(),
                            "cal_ns": None if cal is None else cal - int(rows[n_rows, 0])})

    def offset_ns(self) -> int:
        """ns to add to the card's stamps to put them on the host's clock: the
        largest calibration (the quickest launch); 0 with CPU stamps."""
        return max((d["cal_ns"] for d in self.device if d["cal_ns"] is not None), default=0)


RECORDER = Recorder()
_seen_on = False  # whether the profiler recorded at the last look
_ring: "StampRing | None" = None  # the ring stamps go to (models/graph.py, forward_eval)


def recording() -> bool:
    """Whether a torch.profiler session records now; the first look after
    one that saw the profiler off starts a fresh record (two sessions with
    no look between them share one)."""
    global _seen_on
    on = _profiler_on()
    if on != _seen_on:
        if on:
            RECORDER.reset()
        _seen_on = on
    return on


class _Span:
    __slots__ = ("name", "unit", "item")

    def __init__(self, name: str, unit: str | None):
        self.name, self.unit, self.item = name, unit, None

    def __enter__(self):
        rec = RECORDER
        if self.unit is not None:
            rec.enter_unit(self.unit, self.name)
        idx = -1
        if rec._room():
            idx = len(rec.spans)
            self.item = [self.name, time.time_ns(), 0, rec._stack[-1] if rec._stack else -1, rec._unit]
            rec.spans.append(self.item)
        rec._stack.append(idx)
        return self

    def __exit__(self, *exc):
        if self.item is not None:
            self.item[2] = time.time_ns()
        if RECORDER._stack:
            RECORDER._stack.pop()
        return False


_NO_SPAN = contextlib.nullcontext()


def span(name: str, unit: str | None = None):
    """A host span around the enclosed work while recording. `unit` ("chunk"
    or "frame") starts a new unit unless the current one is of that kind
    and has no span called `name` yet (so `run_chunk` joins the chunk its
    `plan_chunk` opened)."""
    if not recording():
        return _NO_SPAN
    return _Span(name, unit)


# the counters of the step being captured (`tallied`), or None
_tally: "collections.Counter | None" = None


def count(name: str, value: int = 1) -> None:
    """Add `value` to counter `name` of the current unit while recording.
    Inside `tallied` (a graph capture, which runs nothing) the count goes
    to the capture's tally instead, whether recording or not."""
    if _tally is not None:
        _tally[name] += int(value)
    elif recording() and RECORDER._room():
        RECORDER.counters.append((name, int(value), RECORDER._unit, time.time_ns()))


@contextlib.contextmanager
def tallied():
    """Collect the counts of the enclosed block into a Counter (yielded)
    instead of recording them: a captured step's counts, which each of its
    replays records again (`count_all`)."""
    global _tally
    saved, _tally = _tally, collections.Counter()
    try:
        yield _tally
    finally:
        _tally = saved


def count_all(tally: dict) -> None:
    """Record every counter of `tally` (a replay of a captured step)."""
    if tally and recording():
        for name, value in tally.items():
            count(name, value)


def counters() -> dict:
    """The recorded counters' totals."""
    out = collections.Counter()
    for name, value, _, _ in RECORDER.counters:
        out[name] += value
    return dict(out)


# ------------------------------ device stamps ------------------------------


class StampRing:
    """An int64 [rows, len(names)] ring on `device` that stamps write by
    name: ring[row + step, slot]. `step` is an int64 device scalar (a
    captured step's row, one of its static inputs) or None; `row` a host
    row cursor for eager callers."""

    def __init__(self, names: tuple, rows: int, device):
        self.names = tuple(names)
        self.slot = {n: i for i, n in enumerate(self.names)}
        self.ring = torch.zeros((rows, len(self.names)), dtype=torch.int64, device=device)
        self.step: torch.Tensor | None = None
        self.row = 0

    def stamp(self, name: str) -> None:
        slot = self.slot.get(name)
        if slot is not None:
            _stamp_kernel.stamp(self.ring, self.step, self.row, slot)


@contextlib.contextmanager
def stamping(ring: StampRing | None):
    """Send `stamp` and `mark` to `ring` (None: to nowhere) inside the block."""
    global _ring
    prev, _ring = _ring, ring
    try:
        yield ring
    finally:
        _ring = prev


def active_ring() -> StampRing | None:
    return _ring


def stamp(name: str) -> None:
    """Stamp `name` into the active ring, if any."""
    ring = _ring
    if ring is not None:
        ring.stamp(name)


class _Mark(torch.autograd.Function):
    """Identity; its backward stamps `name` once every marked tensor's gradient is in."""

    @staticmethod
    def forward(ctx, ring, name, *xs):
        ctx.ring, ctx.name = ring, name
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.ring.stamp(ctx.name)
        return (None, None, *grads)


def mark(fwd: str, bwd: str, *tensors):
    """Stamp `fwd` now and `bwd` in the backward pass where the gradients of
    `tensors` (None entries pass through) are complete; returns the tensors
    (new views where the backward stamp is hooked). Without an active ring
    the tensors themselves."""
    ring = _ring
    if ring is None:
        return tensors
    ring.stamp(fwd)
    idx = [i for i, t in enumerate(tensors) if t is not None]
    if not torch.is_grad_enabled() or not any(tensors[i].requires_grad for i in idx):
        return tensors
    out = list(tensors)
    for i, t in zip(idx, _Mark.apply(ring, bwd, *(tensors[i] for i in idx))):
        out[i] = t
    return tuple(out)


def train_ring(n_steps: int, device, step: torch.Tensor | None = None) -> StampRing:
    """A training chunk's ring: RING_ROWS rows or one a step and one to
    calibrate, whichever is more."""
    ring = StampRing(TRAIN_SLOTS, max(RING_ROWS, n_steps + 1), device)
    ring.step = step
    return ring


def record_steps(ring: StampRing, n_steps: int) -> None:
    """A chunk's rows 0..n_steps-1 into the record (after its read-back)."""
    RECORDER.add_device(RECORDER._unit, "chunk", ring, n_steps)


def eval_ring(n_rows: int, device) -> StampRing | None:
    """While recording, a frame's ring of 1 + n_rows rows (the frame and one
    row a chunk and field) and one to calibrate, left pending until read;
    the rings of earlier frames are read first (the card is idle at a
    frame's start). None when not recording."""
    if not recording():
        return None
    RECORDER.flush()
    ring = StampRing(EVAL_SLOTS, 1 + n_rows + 1, device)
    RECORDER.pending.append((RECORDER._unit, "frame", ring))
    return ring


# ------------------------------ reading the record ------------------------------


def step_intervals(row: np.ndarray, names: tuple) -> list[tuple[str, int, int]]:
    """(group, start ns, end ns) of one step's stamps, in time order; each
    stamp opens the interval to the next (ties keep the slot order)."""
    order = sorted(range(len(names)), key=lambda i: (int(row[i]), i))
    return [(TRAIN_OPENS[names[a]], int(row[a]), int(row[b])) for a, b in zip(order, order[1:])
            if names[a] in TRAIN_OPENS]


def _consecutive(records: list[dict]):
    """Pairs of records of consecutive units."""
    return [(a, b) for a, b in zip(records, records[1:]) if b["unit"] == a["unit"] + 1]


def summary() -> dict:
    """The record's numbers (device ns on the card's clock, host ns on the
    host's): "train" (steps, chunks, ns by group, the steps' span, gaps
    between steps and between chunks, the host's staging), "eval"
    (frames, chunks' features and whole ns, the gaps between frames),
    "counters" and "dropped". A part with nothing recorded is left out."""
    rec = RECORDER
    rec.flush()
    out = {"counters": counters(), "dropped": rec.dropped}
    chunks = [d for d in rec.device if d["kind"] == "chunk"]
    if chunks:
        groups = dict.fromkeys(GROUPS, 0)
        span_ns, step_gaps = 0, []
        for d in chunks:
            i0, i1 = d["names"].index("start"), d["names"].index("end")
            for row in d["stamps"]:
                for g, a, b in step_intervals(row, d["names"]):
                    groups[g] += b - a
                span_ns += int(row[i1] - row[i0])
            step_gaps += [int(b - a) for a, b in zip(d["stamps"][:-1, i1], d["stamps"][1:, i0])]
        gaps = [int(b["stamps"][0, b["names"].index("start")] - a["stamps"][-1, a["names"].index("end")])
                for a, b in _consecutive(chunks)]
        runs = {i for i, s in enumerate(rec.spans) if s[0] == "run_chunk"}
        stage = sum(s[2] - s[1] for s in rec.spans if s[0] in STAGE_SPANS and s[3] in runs)
        out["train"] = {"steps": sum(len(d["stamps"]) for d in chunks), "chunks": len(chunks),
                        "groups_ns": groups, "step_span_ns": span_ns, "step_gaps_ns": step_gaps,
                        "chunk_gaps_ns": gaps, "stage_ns": stage}
    frames = [d for d in rec.device if d["kind"] == "frame"]
    if frames:
        s = {n: i for i, n in enumerate(EVAL_SLOTS)}
        feat = sum(int((d["stamps"][1:, s["features.end"]] - d["stamps"][1:, s["features"]]).sum()) for d in frames)
        whole = sum(int((d["stamps"][1:, s["end"]] - d["stamps"][1:, s["start"]]).sum()) for d in frames)
        gaps = [int(b["stamps"][1:, s["start"]].min() - a["stamps"][1:, s["end"]].max())
                for a, b in _consecutive(frames)]
        out["eval"] = {"frames": len(frames), "chunks": sum(len(d["stamps"]) - 1 for d in frames),
                       "features_ns": feat, "chunks_ns": whole, "frame_gaps_ns": gaps,
                       "frame_ns": sum(int(d["stamps"][0, s["end"]] - d["stamps"][0, s["start"]]) for d in frames)}
    return out


def device_events() -> list[tuple[str, int, int, dict]]:
    """The record's device intervals on the host's clock: (name, start ns,
    end ns, args): each training step's groups and the gaps between chunks,
    each eval chunk's features and the rest, the gaps between frames."""
    RECORDER.flush()
    off = RECORDER.offset_ns()
    out = []
    chunks = [d for d in RECORDER.device if d["kind"] == "chunk"]
    for d in chunks:
        for k, row in enumerate(d["stamps"]):
            out += [(g, a + off, b + off, {"unit": d["unit"], "step": k})
                    for g, a, b in step_intervals(row, d["names"]) if b > a]
    for a, b in _consecutive(chunks):
        t0 = int(a["stamps"][-1, a["names"].index("end")]) + off
        t1 = int(b["stamps"][0, b["names"].index("start")]) + off
        out.append(("chunk_gap", t0, t1, {"unit": b["unit"]}))
    frames = [d for d in RECORDER.device if d["kind"] == "frame"]
    s = {n: i for i, n in enumerate(EVAL_SLOTS)}
    for d in frames:
        for c, row in enumerate(d["stamps"][1:]):
            cuts = [int(row[s[n]]) + off for n in EVAL_SLOTS]
            for name, a, b in zip(("render", "features", "render"), cuts, cuts[1:]):
                out.append((name, a, b, {"unit": d["unit"], "chunk": c}))
    for a, b in _consecutive(frames):
        out.append(("frame_gap", int(a["stamps"][1:, s["end"]].max()) + off,
                    int(b["stamps"][1:, s["start"]].min()) + off, {"unit": b["unit"]}))
    return out


# ------------------------------ the trace ------------------------------

_TID_SPANS, _PID_DEVICE = 0x10CA1, 0x10CA2


def program_trace_events(base_ns: int = 0) -> list[dict]:
    """The record as Chrome trace events on a trace's clock (ts in us from
    `base_ns`): host spans and counters in this process under a thread of
    their own, device intervals in a process of their own."""
    pid = os.getpid()
    us = lambda t: (t - base_ns) / 1e3  # noqa: E731
    ev = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": _TID_SPANS,
           "args": {"name": "localrf_tpu_torch spans"}},
          {"ph": "M", "name": "process_name", "pid": _PID_DEVICE, "tid": 0,
           "args": {"name": "localrf_tpu_torch device stamps"}}]
    names = [s[0] for s in RECORDER.spans]
    for name, a, b, parent, unit in RECORDER.spans:
        if b >= a:
            ev.append({"ph": "X", "cat": "program", "name": name, "pid": pid, "tid": _TID_SPANS, "ts": us(a),
                       "dur": (b - a) / 1e3,
                       "args": {"unit": unit, "parent": names[parent] if parent >= 0 else None}})
    totals = collections.Counter()
    for name, value, unit, t in RECORDER.counters:
        totals[name] += value
        ev.append({"ph": "C", "cat": "program", "name": name, "pid": pid, "ts": us(t), "args": {name: totals[name]}})
    for name, a, b, args in device_events():
        ev.append({"ph": "X", "cat": "program_device", "name": name, "pid": _PID_DEVICE, "tid": 0, "ts": us(a),
                   "dur": (b - a) / 1e3, "args": args})
    return ev


def add_to_chrome_trace(path: str) -> None:
    """Append the record's events to the Chrome trace at `path`, on its
    clock (its baseTimeNanoseconds)."""
    with open(path) as f:
        data = json.load(f)
    data["traceEvents"] += program_trace_events(int(data.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(data, f)


@contextlib.contextmanager
def trace(logdir: str | None):
    """Trace the enclosed work with torch.profiler (the CPU, and the card
    when one is present) into `logdir` as one Chrome trace,
    `<host>_<pid>.<ns>.pt.trace.json` (TensorBoard's profile plugin reads
    it), which also holds the program's record of the same work: host
    spans and counters, and the device intervals of its stamps mapped onto
    the trace's clock. Yields the profiler. A no-op yielding None when
    logdir is None."""
    global _seen_on
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)

    def ready(prof):
        path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        add_to_chrome_trace(path)

    with profile(activities=activities, on_trace_ready=ready) as prof:
        RECORDER.reset()
        _seen_on = True
        yield prof
