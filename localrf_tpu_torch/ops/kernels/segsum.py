"""Row gathers for the small line tables.

K3: `segment_sum_small` launches the CUDA kernels in csrc/segsum_small.cu
(an f32 segment sum whose output tile stays in shared memory; see the note
there for what bounds it on the card), replacing the Pallas TPU kernel
localrf_tpu/ops/pallas/segsum.py `segment_sum_matmul`. `take_rows` is the
row gather whose backward is that segment sum (`--line_bwd segsum`);
`segment_sum_small_plain` (an f32 `index_add_`) is the CPU path.

The kernel sums in an order that the shapes alone fix (`segsum_plan`):
point range by point range, each row's points in point order from 0, then
the ranges' partial tables in range order from 0, every add an f32 add.
`segment_sum_small_ordered` sums in that same order in plain PyTorch, so
the kernel equals it bit for bit, and two launches equal each other; it
is the reference of the tests and of chip_smoke, never a path of the step.
Against `segment_sum_small_plain`, whose adds run in index order, the sum
agrees to rtol 1e-4 / atol 1e-5 of its largest entry (thousands of points
sum into each line row).

JAX's K3 returns an f32 gradient even for a bf16 table, where PyTorch's
autograd would cast a Function's gradient to its input's dtype. So
`take_rows` takes the f32 table and rounds the gathered rows to `dtype`:
the same values as gathering from the rounded table, with the gradient
kept in f32 up to the f32 master line.

`take_rows_onehot` ports the default line mode (`take_rows_onehot`, pure
XLA in JAX, not Pallas): an `index_select` whose backward is an f32
`index_add_` cast to the table dtype. Accumulating in f32 keeps JAX's
numerics: a bf16 index_add would round every partial sum of the ~2000
points per line row.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from .binned_scatter import row_ordered_sum, segment_sum_plain

LAUNCHES = {"segment_sum_small": 0}
MAX_C = 64  # the kernel's payload width (csrc/segsum_small.cu kMaxC): a quad line row
_PAYLOAD_DTYPES = (torch.float32, torch.bfloat16)

# K3's plan: an f32 accumulator of at most ACC_FLOATS values (160 KB, one
# [640, 64] line table) per block; at most BLOCKS blocks (one per SM of an
# H100, fixed here so that the order never depends on the card), ranges of
# at least MIN_RANGE points, in multiples of RANGE_ALIGN (so that every
# stage's indices and payload rows start on a 16-byte boundary for the
# kernel's bulk copies), and at most SCRATCH_FLOATS (32 MB) of partial
# tables
ACC_FLOATS = 40_960
BLOCKS = 132
MIN_RANGE = 1024
RANGE_ALIGN = 32
SCRATCH_FLOATS = 8 * 2**20


class SegsumPlan(NamedTuple):
    """K3's schedule, from (P, n_rows, C) alone: row tiles of `tile_rows`
    rows (`n_tiles`), point ranges [k * range_len, (k + 1) * range_len)
    (`n_ranges`, none empty). Only the ranges set the summation order."""

    tile_rows: int
    n_tiles: int
    n_ranges: int
    range_len: int


def segsum_plan(p: int, n_rows: int, c: int) -> SegsumPlan:
    c = max(c, 1)
    tile_rows = max(1, min(n_rows, ACC_FLOATS // c))
    n_tiles = -(-n_rows // tile_rows)
    n_ranges = max(1, min(-(-p // MIN_RANGE), BLOCKS // max(n_tiles, 1),
                          SCRATCH_FLOATS // max(n_rows * c, 1)))
    per_range = -(-p // n_ranges)
    range_len = max(1, -(-per_range // RANGE_ALIGN)) * RANGE_ALIGN
    return SegsumPlan(tile_rows, n_tiles, max(1, -(-p // range_len)), range_len)


def segment_sum_small_plain(idx: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """out[n_rows, C] f32 = sum_{p: idx_p == r} g_p, accumulated in f32."""
    return segment_sum_plain(idx, g, n_rows, torch.float32)


def segment_sum_small_ordered(idx: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """K3's function summed in the kernel's order (`segsum_plan`'s ranges,
    each row's points in point order, then the ranges in order), so equal
    to the kernel bit for bit. A reference, slow: one step per rank of a
    point within its row and range."""
    p, c = g.shape
    out = torch.zeros((n_rows, c), dtype=torch.float32, device=g.device)
    if not (p and n_rows and c):
        return out
    plan = segsum_plan(p, n_rows, c)
    g32 = g.to(torch.float32)
    for k in range(plan.n_ranges):
        lo, hi = k * plan.range_len, min((k + 1) * plan.range_len, p)
        out += row_ordered_sum(idx[lo:hi], g32[lo:hi], n_rows)
    return out


def _segment_sum_small_cuda(idx, g, n_rows: int) -> torch.Tensor:
    if idx.dim() != 1 or g.dim() != 2 or idx.shape[0] != g.shape[0]:
        raise ValueError(f"idx [P] and g [P, C] expected, got {list(idx.shape)}, {list(g.shape)}")
    if idx.dtype != torch.int64:
        raise TypeError(f"idx must be int64, got {idx.dtype}")
    if g.dtype not in _PAYLOAD_DTYPES:
        raise TypeError(f"segment_sum_small supports float32/bfloat16 payloads, got {g.dtype}")
    if idx.device != g.device:
        raise ValueError("idx and g must be on the same device")
    if g.shape[1] > MAX_C:
        raise ValueError(f"segment_sum_small takes rows of at most {MAX_C} values, got {g.shape[1]}")
    idx, g = idx.contiguous(), g.contiguous()
    p, c = g.shape
    if not (p and n_rows and c):
        return torch.zeros((n_rows, c), dtype=torch.float32, device=g.device)
    # the kernel's bulk copies start on 16-byte boundaries
    idx = idx.clone() if idx.data_ptr() % 16 else idx
    g = g.clone() if g.data_ptr() % 16 else g
    plan = segsum_plan(p, n_rows, c)
    out = torch.empty((n_rows, c), dtype=torch.float32, device=g.device)
    partials = out if plan.n_ranges == 1 else torch.empty(
        (plan.n_ranges, n_rows, c), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        _build.launch(
            "lrf_segsum_small", idx.data_ptr(), g.data_ptr(), int(g.dtype == torch.bfloat16),
            partials.data_ptr(), out.data_ptr(), p, c, n_rows, plan.tile_rows, plan.n_ranges,
            plan.range_len, _build.stream_ptr(g.device),
        )
    LAUNCHES["segment_sum_small"] += 1
    return out


def segment_sum_small(idx: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """out[n_rows, C] f32 = sum_{p: idx_p == r} g_p. CPU tensors take
    `segment_sum_small_plain`; CUDA tensors launch the kernel."""
    if g.device.type == "cpu":
        return segment_sum_small_plain(idx, g, n_rows)
    if g.device.type != "cuda":
        raise ValueError(f"segment_sum_small: no kernel for device {g.device}")
    return _segment_sum_small_cuda(idx, g, n_rows)


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, dtype):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table.index_select(0, idx).to(dtype)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None
        return segment_sum_small(idx, g, ctx.n_rows), None, None


def take_rows(table: torch.Tensor, idx: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """table[idx] rounded to `dtype` (default: the table's), whose backward is
    K3: an f32 segment sum, returned to the table unrounded."""
    if table.dtype != torch.float32:
        raise TypeError(f"take_rows takes the f32 table (got {table.dtype}); pass the gather dtype")
    return _TakeRows.apply(table, idx, dtype or table.dtype)


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
