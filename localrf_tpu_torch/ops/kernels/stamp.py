"""Device timestamps for the tracer (utils/profiling.py).

`stamp(ring, step, row, slot)` writes the time into ring[row + step, slot]
of an int64 [rows, n_slots] ring: on a card the CUDA kernel of
csrc/stamp.cu (the card's %globaltimer, in stream order, so it also runs
inside a captured CUDA graph, reading the row offset `step` from device
memory at each replay); on the CPU `stamp_plain`, which writes
time.time_ns() (exact there: CPU ops run synchronously). Replaces no TPU
kernel.
"""
from __future__ import annotations

import time

import torch

from . import _build

LAUNCHES = {"stamp": 0}


def _check(ring: torch.Tensor, step: torch.Tensor | None) -> None:
    if ring.dtype != torch.int64 or ring.dim() != 2 or not ring.is_contiguous():
        raise ValueError(f"stamp ring must be a contiguous int64 [rows, slots], got {ring.dtype} {list(ring.shape)}")
    if step is not None and (step.dtype != torch.int64 or step.numel() != 1 or step.device != ring.device):
        raise ValueError("stamp step must be one int64 on the ring's device")


def stamp_plain(ring: torch.Tensor, step: torch.Tensor | None, row: int, slot: int) -> None:
    """ring[row + step, slot] = time.time_ns() (a CPU ring)."""
    r = row + (int(step) if step is not None else 0)
    ring[r, slot] = time.time_ns()


def stamp(ring: torch.Tensor, step: torch.Tensor | None, row: int, slot: int) -> None:
    """The time into ring[row + step, slot]; `step` an int64 device scalar or None."""
    _check(ring, step)
    if ring.device.type == "cpu":
        stamp_plain(ring, step, row, slot)
        return
    if ring.device.type != "cuda":
        raise ValueError(f"stamp: no kernel for device {ring.device}")
    _build.launch("lrf_stamp", ring.data_ptr(), None if step is None else step.data_ptr(), int(row),
                  ring.shape[1], int(slot), _build.stream_ptr(ring.device))
    LAUNCHES["stamp"] += 1
