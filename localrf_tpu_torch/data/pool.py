"""Device-resident pixel pool (PyTorch port of localrf_tpu/data/pool.py).

The active window's flat per-pixel supervision (rgb, loss weights,
invdepth, flows, masks) is mirrored into fixed-capacity arrays on `device`
at frame granularity, so a training chunk ships only int64 indices per step
and gathers the pixel values on the device (models/step.py
`train_chunk_pooled`). Slots are recycled as the window slides.

Uploads write into the preallocated arrays in place (`copy_` into a slice
of one slot): the arrays keep their addresses for the pool's lifetime,
which a captured CUDA graph of the training step relies on.
"""
from __future__ import annotations

import numpy as np
import torch


class DevicePixelPool:
    def __init__(self, dataset, capacity: int, device="cuda"):
        self.ds = dataset
        self.capacity = capacity
        self.device = torch.device(device)
        self.n_px = dataset.n_px_per_frame
        self.slot_of_frame: dict[int, int] = {}
        self._free = list(range(capacity))

        n = capacity * self.n_px
        shapes = {"rgbs": (n, 3), "loss_weights": (n,)}
        if dataset.load_depth:
            shapes["invdepths"] = (n,)
        if dataset.load_flow:
            shapes.update(fwd_flow=(n, 2), bwd_flow=(n, 2), fwd_mask=(n,), bwd_mask=(n,))
        self.arrays = {
            k: torch.zeros(shape, dtype=torch.float32, device=self.device) for k, shape in shapes.items()
        }

    def sync(self):
        """Mirror the dataset's active window into pool slots."""
        b0, b1 = self.ds.active_frames_bounds
        for f in list(self.slot_of_frame):
            if f < b0 or f >= b1:
                self._free.append(self.slot_of_frame.pop(f))
        for f in range(b0, b1):
            if f not in self.slot_of_frame:
                self._upload(f)

    def _upload(self, frame: int):
        b0 = self.ds.active_frames_bounds[0]
        sl = slice((frame - b0) * self.n_px, (frame - b0 + 1) * self.n_px)
        if not self._free:
            raise RuntimeError("pixel pool capacity exhausted")
        slot = self._free.pop()
        dst = slice(slot * self.n_px, (slot + 1) * self.n_px)
        host = {"rgbs": self.ds.all_rgbs, "loss_weights": self.ds.all_loss_weights}
        if self.ds.load_depth:
            host["invdepths"] = self.ds.all_invdepths
        if self.ds.load_flow:
            host.update(fwd_flow=self.ds.all_fwd_flow, bwd_flow=self.ds.all_bwd_flow,
                        fwd_mask=self.ds.all_fwd_mask, bwd_mask=self.ds.all_bwd_mask)
        for name, src in host.items():
            arr = self.arrays[name]
            part = np.asarray(src[sl], np.float32).reshape((-1, *arr.shape[1:]))
            arr[dst].copy_(torch.from_numpy(np.ascontiguousarray(part)))
        self.slot_of_frame[frame] = slot

    def slots_for(self, view_ids) -> np.ndarray:
        return np.asarray([self.slot_of_frame[int(v)] for v in np.asarray(view_ids)], np.int64)
