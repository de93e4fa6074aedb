"""Load the official RAFT checkpoint (`raft-things.pth`) into the port's
RAFT (the port of localrf_tpu/preprocess/convert.py's RAFT half; DPT's
loader is `preprocess/dpt.py::load_dpt_checkpoint`).

The port's module keeps the official names and the torch layout (OIHW), so
the file loads as it is: the DataParallel "module." prefix is stripped and
`load_state_dict(strict=True)` checks every key and shape.
"""
from __future__ import annotations

import torch

from .raft import RAFT


def load_raft_checkpoint(path: str, device="cuda") -> RAFT:
    """raft-things.pth (torch, "module." prefix) -> RAFT on `device`. A
    file that also lists each strided batch-norm shortcut as
    `downsample.1` (the official module registers norm3 twice) loads too:
    those entries must equal norm3's and are dropped."""
    sd = {k.removeprefix("module."): v for k, v in torch.load(path, map_location="cpu").items()}
    for k in [k for k in sd if ".downsample.1." in k]:
        twin = sd.pop(k)
        if not torch.equal(twin, sd[k.replace(".downsample.1.", ".norm3.")]):
            raise ValueError(f"{path}: {k} differs from its norm3 entry")
    model = RAFT()
    model.load_state_dict(sd, strict=True)
    return model.to(device)
