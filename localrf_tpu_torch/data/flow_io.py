"""uint16 PNG flow decoding (the port's copy of localrf_tpu/data/flow_io.py's
`decode_flow`; ref: utils/utils.py:61-71).

Flow values are stored as uint16 with a 2^15 offset and 2^8 fixed-point
scale; channel 2 holds the validity mask."""
from __future__ import annotations

import numpy as np


def decode_flow(encoded_flow: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    flow = encoded_flow[..., :2].astype(np.float32)
    flow -= 2**15
    flow /= 2**8
    return flow, (encoded_flow[..., 2] > 2**15).astype(np.float32)
