"""Profiling hooks (PyTorch port of localrf_tpu/utils/profiling.py): a
torch.profiler trace context and a rays/sec counter. The reference has
nothing beyond an it/s print (ref: train.py:540-544)."""
from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def trace(logdir: str | None):
    """Trace the enclosed work with torch.profiler (the CPU, and the card
    when one is present) into `logdir` as a Chrome trace (TensorBoard's
    profile plugin reads it); yields the profiler. A no-op yielding None
    when logdir is None."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


class Throughput:
    """Sliding rays/sec + it/s counter."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._steps = 0

    def add(self, n_steps: int = 1):
        self._steps += n_steps

    @property
    def it_per_sec(self) -> float:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return self._steps / dt

    @property
    def rays_per_sec(self) -> float:
        return self.it_per_sec * self.batch_size
