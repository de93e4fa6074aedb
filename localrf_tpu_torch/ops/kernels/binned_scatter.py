"""K2: the segment sum behind every plane-table row gather.

`segment_sum` launches the CUDA kernels in csrc/segment_sum.cu (f32 atomic
adds into a zeroed staging table, then a cast; see the note there for what
bounds them on the card), replacing the Pallas TPU kernel
localrf_tpu/ops/pallas/binned_scatter.py `binned_segment_sum`.
`take_rows_binned` is a plain row gather whose backward is that segment
sum. `segment_sum_plain` (an f32 `index_add_` and the cast) is the CPU path
and the on-card reference.

The atomic adds run in no fixed order: against the plain version the f32
result agrees to rtol 1e-4 / atol 1e-4, and a bf16 result to one bf16 ulp.
"""
from __future__ import annotations

import torch

from . import _build

LAUNCHES = {"segment_sum": 0}
_PAYLOAD_DTYPES = (torch.float32, torch.bfloat16)


def segment_sum_plain(idx: torch.Tensor, g: torch.Tensor, n_rows: int, out_dtype=torch.float32):
    """out[n_rows, C] = sum_{p: idx_p == r} g_p, accumulated in f32."""
    out = torch.zeros((n_rows, g.shape[1]), dtype=torch.float32, device=g.device)
    out.index_add_(0, idx, g.to(torch.float32))
    return out.to(out_dtype)


def _segment_sum_cuda(idx, g, n_rows: int, out_dtype) -> torch.Tensor:
    if idx.dim() != 1 or g.dim() != 2 or idx.shape[0] != g.shape[0]:
        raise ValueError(f"idx [P] and g [P, C] expected, got {list(idx.shape)}, {list(g.shape)}")
    if idx.dtype != torch.int64:
        raise TypeError(f"idx must be int64, got {idx.dtype}")
    if g.dtype not in _PAYLOAD_DTYPES or out_dtype not in _PAYLOAD_DTYPES:
        raise TypeError(f"segment_sum supports float32/bfloat16, got {g.dtype} -> {out_dtype}")
    if idx.device != g.device:
        raise ValueError("idx and g must be on the same device")
    idx, g = idx.contiguous(), g.contiguous()
    p, c = g.shape
    staging = torch.zeros((n_rows, c), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        stream = _build.stream_ptr(g.device)
        if p:
            _build.launch(
                "lrf_segment_sum", idx.data_ptr(), g.data_ptr(), int(g.dtype == torch.bfloat16),
                staging.data_ptr(), p, c, n_rows, stream,
            )
            LAUNCHES["segment_sum"] += 1
        if out_dtype == torch.float32:
            return staging
        out = torch.empty((n_rows, c), dtype=torch.bfloat16, device=g.device)
        if staging.numel():
            _build.launch("lrf_cast_f32_bf16", staging.data_ptr(), out.data_ptr(), staging.numel(), stream)
        return out


def segment_sum(idx: torch.Tensor, g: torch.Tensor, n_rows: int, out_dtype=torch.float32):
    """out[n_rows, C] = sum_{p: idx_p == r} g_p (f32 accumulation, returned in
    `out_dtype`). CPU tensors take `segment_sum_plain`; CUDA tensors launch
    the kernel."""
    if g.device.type == "cpu":
        return segment_sum_plain(idx, g, n_rows, out_dtype)
    if g.device.type != "cuda":
        raise ValueError(f"segment_sum: no kernel for device {g.device}")
    return _segment_sum_cuda(idx, g, n_rows, out_dtype)


class _TakeRowsBinned(torch.autograd.Function):
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
        return segment_sum(idx, g, ctx.n_rows, out_dtype=ctx.dtype), None


def take_rows_binned(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather whose backward is the segment-sum kernel (gradient in the
    table's dtype, accumulated in f32)."""
    return _TakeRowsBinned.apply(table, idx)
