"""Host spans around the calls into the program, and the reduction of a
torch.profiler trace of the traced span to what the per-layer readers use.

busy: the union of the intervals in which a kernel, copy or set ran on
the card (not the device-side mirror of the benchmark's own spans);
device ops: the device time by name; idle gaps: the times between busy
intervals inside the traced window, each part of a gap given to the
benchmark span the host was in then (the spans follow one another).
"""
from __future__ import annotations

import collections
import contextlib


class Spans:
    """The benchmark's spans around calls into the program: with a profiler
    on, each is a record_function range named "bench.<name>" in its trace."""

    def __init__(self):
        self.tracing = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        import torch

        if not self.tracing:
            yield
            return
        with torch.profiler.record_function(f"bench.{name}"):
            yield


def _union(intervals: list) -> tuple[int, list]:
    """(total covered ns, merged intervals) of [(start, end)]."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def reduce_trace(prof) -> dict | None:
    """reduce_events over a finished torch.profiler.profile's events."""
    from torch.autograd import DeviceType

    return reduce_events((e.name(), e.start_ns(), e.end_ns(), e.device_type() == DeviceType.CUDA)
                         for e in prof.profiler.kineto_results.events())


def reduce_events(events) -> dict | None:
    """From (name, start ns, end ns, on the device) events: the traced
    window (the benchmark's first span start to its last span end on the
    host), busy_s inside it, device ops {name: seconds}, idle gaps {host
    span: seconds} and the count of device events. A span's mirror on the
    device's timeline is no device work; the spans must not overlap. None
    without device events."""
    dev, spans = [], []
    ops = collections.Counter()
    for name, a, b, on_device in events:
        if name.startswith("bench."):
            if not on_device:
                spans.append((a, b, name[len("bench."):]))
        elif on_device and b > a:
            dev.append((a, b))
            ops[name] += (b - a) / 1e9
    if not dev:
        return None
    lo = min(s[0] for s in spans) if spans else min(a for a, _ in dev)
    hi = max(s[1] for s in spans) if spans else max(b for _, b in dev)
    busy, merged = _union([(max(a, lo), min(b, hi)) for a, b in dev if b > lo and a < hi])
    gaps = collections.Counter()
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        covered = 0
        for s0, s1, label in spans:
            overlap = min(b, s1) - max(a, s0)
            if overlap > 0:
                gaps[label] += overlap / 1e9
                covered += overlap
        if b - a > covered:
            gaps["between spans"] += (b - a - covered) / 1e9
    return {"busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9, "ops": ops, "gaps": gaps, "n_events": len(dev)}


def breakdown(trace: dict, n: int = 10) -> dict:
    """The longest device ops and idle gaps, at most n of each."""
    def top(counter):
        return [[name.removeprefix("void ")[:160], sec] for name, sec in counter.most_common(n)]

    return {"device_ops": top(trace["ops"]), "idle_gaps": top(trace["gaps"])}
