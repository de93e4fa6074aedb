"""Ray-batch data parallelism over NCCL across cards: chip_smoke's phase 10
(d) alone, for a machine with two or more cards.

    python3 localrf_tpu_torch/scripts/dp_cards.py

Builds the kernels, then runs chip_smoke.nccl_cards: two spawned ranks, one
a card, train the 640^3 default pooled chunk (full width, 16 steps, the
146-slot pool) under an NCCL "data" mesh, the gradient all-reduce captured
in each step's CUDA graph; their losses against the same chunk in one
process on card 0 (chip_smoke.CHUNK_TOL), both ranks' state bit for bit,
NCCL kernels in every replayed step of a profiled chunk, ms/step on two
cards and on one (median of 3 chunks). Prints the card and one JSON line.
"""
from __future__ import annotations

import json
import os
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]


def main() -> None:
    # the H100's default cuBLAS workspace, as chip_smoke names it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    torch = cs._require_cuda()
    from localrf_tpu_torch.data.pool import DevicePixelPool
    from localrf_tpu_torch.ops.kernels import _build

    print(cs._gpu_line(), f"x {torch.cuda.device_count()}")
    _build.library()
    dev = torch.device("cuda", 0)
    pool = DevicePixelPool(cs.make_dataset(cs.W, cs.H, cs.N_FRAMES), capacity=cs.POOL_SLOTS, device=dev)
    out = cs.nccl_cards(dev, pool)
    if out is None:
        sys.exit(1)
    print(json.dumps({"dp_cards": out}))


if __name__ == "__main__":
    main()
