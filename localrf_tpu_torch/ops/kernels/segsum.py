"""Row gather for the small line tables (port of
localrf_tpu/ops/pallas/segsum.py `take_rows_onehot`).

In JAX this is pure XLA (a one-hot matmul backward), not Pallas, so here it
is plain PyTorch: an `index_select` whose backward is an f32 `index_add_`
cast to the table dtype. Accumulating in f32 keeps JAX's numerics: a bf16
index_add would round every partial sum of the ~2000 points per line row.
"""
from __future__ import annotations

import torch

from .binned_scatter import segment_sum_plain


class _TakeRowsOnehot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows, ctx.dtype = table.shape[0], table.dtype
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None
        return segment_sum_plain(idx, g, ctx.n_rows, ctx.dtype), None


def take_rows_onehot(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather with an f32-accumulated scatter-add backward."""
    return _TakeRowsOnehot.apply(table, idx)
