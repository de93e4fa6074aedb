"""The host-side datasets, shared with the JAX package.

`localrf_tpu.data.dataset` is numpy-only (it imports no jax), so the port
imports it instead of keeping a copy: both packages sample identical
batches from the same seed."""
from localrf_tpu.data.dataset import BaseDataset, LocalRFDataset, SyntheticDataset

__all__ = ["BaseDataset", "LocalRFDataset", "SyntheticDataset"]
