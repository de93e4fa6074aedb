"""K2: the segment sum behind every plane-table row gather, and K5, the
same function as a sorted segmented reduction.

`segment_sum` launches the CUDA kernels in csrc/segment_sum.cu, replacing
the Pallas TPU kernel localrf_tpu/ops/pallas/binned_scatter.py
`binned_segment_sum`: the points are binned by tile of output rows (a
counting sort on tile ids: count, scan, scatter) and each tile is summed in
shared memory and written once in the out dtype; a tile with more than
`CHUNK` points is split over several blocks whose f32 partials the last one
sums (see the note in the .cu for what bounds it on the card).
`tile_plan` sizes the tiles and every buffer from the shapes alone, so the
call is capturable in a CUDA graph; `tile_bins_plain` is the bin schedule in
plain PyTorch (the kernels' on-card reference). `take_rows_binned` is a
plain row gather whose backward is that segment sum. `segment_sum_plain`
(an f32 `index_add_` and the cast) is the CPU path and the on-card
reference.

The adds within a tile run in no fixed order: against the plain version the
f32 result agrees to rtol 1e-4 / atol 1e-4, and a bf16 result to one bf16
ulp.

K5: `binned_segment_sum_merged` launches the CUDA kernel in
csrc/segment_sum_merged.cu, replacing the Pallas TPU kernel
`binned_segment_sum_merged` (the merged-split v2 of the same file): the
indices are sorted (stable) and the payload put in sorted order here, as
the JAX wrapper does, then one block per tile of output rows sums its
sorted range in order and writes every row once in the out dtype. No
training path calls it (none does in the JAX package either); it is K2's
function with a fixed summation order, so it is deterministic.
`binned_segment_sum_merged_plain` (the same sort, an f32 `index_add_` and
a cast) is the CPU path and the on-card reference; on the CPU it sums in
the kernel's order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build

LAUNCHES = {"segment_sum": 0, "segment_sum_merged": 0}
_PAYLOAD_DTYPES = (torch.float32, torch.bfloat16)

# K2's tiles: an f32 tile of TILE_FLOATS values (32 KB) in shared memory,
# so tile_rows = 64 for rows of 128; a block sums at most CHUNK binned
# points, and a tile with more is split over several blocks
TILE_FLOATS = 8192
CHUNK = 2048


def segment_sum_plain(idx: torch.Tensor, g: torch.Tensor, n_rows: int, out_dtype=torch.float32):
    """out[n_rows, C] = sum_{p: idx_p == r} g_p, accumulated in f32."""
    out = torch.zeros((n_rows, g.shape[1]), dtype=torch.float32, device=g.device)
    out.index_add_(0, idx, g.to(torch.float32))
    return out.to(out_dtype)


class TilePlan(NamedTuple):
    """K2's schedule sizes, from the shapes alone: tiles of `tile_rows`
    output rows; at most `n_items` work items (ceil(count / chunk) for each
    tile with points) and `n_slots` f32 partial tiles of split tiles."""

    tile_rows: int
    n_tiles: int
    chunk: int
    n_items: int
    n_slots: int


def tile_plan(p: int, c: int, n_rows: int) -> TilePlan:
    tile_rows = max(1, TILE_FLOATS // max(c, 1))
    n_tiles = -(-n_rows // tile_rows)
    # a split tile holds > CHUNK points and ceil(count / CHUNK) items, so the
    # split tiles' items number at most 2 * (p // CHUNK)
    return TilePlan(tile_rows, n_tiles, CHUNK, n_tiles + p // CHUNK, 2 * (p // CHUNK))


def tile_bins_plain(idx: torch.Tensor, n_rows: int, plan: TilePlan) -> dict:
    """The bin schedule of K2 in plain PyTorch: counts [n_tiles] of the
    in-range points per tile, starts [n_tiles + 1], slot_base [n_tiles],
    items [n_items, 2] (tile, part) of the tiles with points, empty
    [n_empty] (the tiles without), and bin_pt / bin_row [binned]: each
    in-range point's id and its row within its tile, in tile order (points
    of one tile in increasing id here; the kernel's order within a tile is
    arbitrary)."""
    idx = idx.to(torch.int64)
    keep = (idx >= 0) & (idx < n_rows)
    pts = torch.nonzero(keep).flatten()
    tiles = idx[pts] // plan.tile_rows
    counts = torch.bincount(tiles, minlength=plan.n_tiles)[: plan.n_tiles]
    order = torch.sort(tiles, stable=True).indices
    parts = -(-counts // plan.chunk)
    zero = torch.zeros(1, dtype=torch.int64, device=idx.device)
    starts = torch.cat([zero, torch.cumsum(counts, 0)])
    slots = torch.where(parts > 1, parts, torch.zeros_like(parts))
    slot_base = torch.cat([zero, torch.cumsum(slots, 0)])[:-1]
    item_tile = torch.repeat_interleave(torch.arange(plan.n_tiles, device=idx.device), parts)
    item_base = torch.cat([zero, torch.cumsum(parts, 0)])[:-1]
    item_part = torch.arange(item_tile.shape[0], device=idx.device) - item_base[item_tile]
    bin_pt = pts[order]
    return dict(counts=counts, starts=starts, slot_base=slot_base,
                items=torch.stack([item_tile, item_part], 1),
                empty=torch.nonzero(counts == 0).flatten(), bin_pt=bin_pt,
                bin_row=idx[bin_pt] - tiles[order] * plan.tile_rows)


def _bin_cuda(idx: torch.Tensor, n_rows: int, plan: TilePlan) -> dict:
    """K2's bin kernels (count, scan, scatter) on the current stream: the
    int32 buffers of the schedule (tile_bins_plain's names; items [n_items,
    2] and empty [n_tiles] of which the first totals[0] and totals[1] are
    live; bin [P, 2] = (bin_pt, bin_row)) and `done`, the zeroed per-tile
    counters of the reduce."""
    p = idx.shape[0]
    zeros = torch.zeros((2, plan.n_tiles), dtype=torch.int32, device=idx.device)
    # the int2 arrays first: they need 8-byte alignment
    sizes = {"items": 2 * plan.n_items, "bin": 2 * p, "totals": 2, "starts": plan.n_tiles + 1,
             "cursor": plan.n_tiles, "slot_base": plan.n_tiles, "empty": plan.n_tiles}
    ints = torch.empty(sum(sizes.values()), dtype=torch.int32, device=idx.device)
    sched = dict(zip(sizes, torch.split(ints, list(sizes.values()))))
    sched.update(counts=zeros[0], done=zeros[1])
    _build.launch(
        "lrf_segment_sum_bin", idx.data_ptr(), p, n_rows, plan.tile_rows, plan.n_tiles, plan.chunk,
        *(sched[k].data_ptr() for k in ("counts", "starts", "cursor", "slot_base", "items", "empty",
                                         "totals", "bin")),
        _build.stream_ptr(idx.device),
    )
    sched["items"] = sched["items"].view(plan.n_items, 2)
    sched["bin"] = sched["bin"].view(p, 2)
    sched.update(bin_pt=sched["bin"][:, 0], bin_row=sched["bin"][:, 1])
    return sched


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
    if p >= 2**31:
        raise ValueError(f"segment_sum bins point ids as int32: P = {p} is too many")
    out = torch.empty((n_rows, c), dtype=out_dtype, device=g.device)
    if not out.numel():
        return out
    plan = tile_plan(p, c, n_rows)
    per_load = 16 // g.element_size()  # payload elements in one 16-byte load
    vec = per_load if c % per_load == 0 and g.data_ptr() % 16 == 0 else 1
    with torch.cuda.device(g.device):
        sched = _bin_cuda(idx, n_rows, plan)
        partials = torch.empty(max(plan.n_slots, 1) * plan.tile_rows * c, dtype=torch.float32,
                               device=g.device)
        _build.launch(
            "lrf_segment_sum_reduce", g.data_ptr(), int(g.dtype == torch.bfloat16), vec,
            *(sched[k].data_ptr() for k in ("bin", "starts", "slot_base", "items", "empty", "totals",
                                             "done")),
            partials.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16), c, n_rows,
            plan.tile_rows, plan.n_tiles, plan.chunk, plan.n_items, _build.stream_ptr(g.device),
        )
        LAUNCHES["segment_sum"] += 1
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


# K5 sizes its tiles to about this many sorted points: each block walks its
# tile's points in order, so a tile must be short enough that the blocks
# fill the card and long enough to amortise the block's start
MERGED_POINTS_PER_TILE = 256
MERGED_MAX_TILE_ROWS = 1024


def merged_schedule(idx: torch.Tensor, n_rows: int):
    """K5's schedule: (sorted idx int64, order, starts int64 [n_tiles + 1],
    tile_rows). Tile t holds rows [t * tile_rows, (t + 1) * tile_rows) and
    the sorted points starts[t] <= p < starts[t + 1]; indices outside
    [0, n_rows) fall outside every tile."""
    p = idx.shape[0]
    tile_rows = max(1, min(MERGED_MAX_TILE_ROWS, MERGED_POINTS_PER_TILE * n_rows // max(p, 1)))
    sorted_idx, order = torch.sort(idx.to(torch.int64), stable=True)
    n_tiles = -(-n_rows // tile_rows)
    bounds = torch.clamp(
        torch.arange(n_tiles + 1, dtype=torch.int64, device=idx.device) * tile_rows, max=n_rows
    )
    return sorted_idx, order, torch.searchsorted(sorted_idx, bounds), tile_rows


def binned_segment_sum_merged_plain(idx: torch.Tensor, g: torch.Tensor, n_rows: int,
                                    out_dtype=torch.float32) -> torch.Tensor:
    """K5's function in plain PyTorch: the stable sort, the payload in sorted
    order, an f32 `index_add_` and one cast. idx int32/int64 in [0, n_rows)."""
    sorted_idx, order = torch.sort(idx.to(torch.int64), stable=True)
    return segment_sum_plain(sorted_idx, g.index_select(0, order), n_rows, out_dtype)


def _launch_merged(sorted_idx, g_sorted, starts, tile_rows: int, n_rows: int, out_dtype):
    """The K5 kernel on a schedule from `merged_schedule`."""
    c = g_sorted.shape[1]
    out = torch.empty((n_rows, c), dtype=out_dtype, device=g_sorted.device)
    if n_rows and c:
        with torch.cuda.device(g_sorted.device):
            _build.launch(
                "lrf_segment_sum_merged", sorted_idx.data_ptr(), g_sorted.data_ptr(),
                int(g_sorted.dtype == torch.bfloat16), starts.data_ptr(), out.data_ptr(),
                int(out_dtype == torch.bfloat16), c, n_rows, tile_rows, starts.shape[0] - 1,
                _build.stream_ptr(g_sorted.device),
            )
        LAUNCHES["segment_sum_merged"] += 1
    return out


def binned_segment_sum_merged(idx: torch.Tensor, g: torch.Tensor, n_rows: int,
                              out_dtype=torch.float32) -> torch.Tensor:
    """out[n_rows, C] = sum_{p: idx_p == r} g_p, accumulated in f32 and written
    once in `out_dtype` (float32 or bfloat16), in a fixed order. CPU tensors
    take `binned_segment_sum_merged_plain`; CUDA tensors launch K5."""
    if g.device.type == "cpu":
        return binned_segment_sum_merged_plain(idx, g, n_rows, out_dtype)
    if g.device.type != "cuda":
        raise ValueError(f"binned_segment_sum_merged: no kernel for device {g.device}")
    if idx.dim() != 1 or g.dim() != 2 or idx.shape[0] != g.shape[0]:
        raise ValueError(f"idx [P] and g [P, C] expected, got {list(idx.shape)}, {list(g.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")
    if g.dtype not in _PAYLOAD_DTYPES or out_dtype not in _PAYLOAD_DTYPES:
        raise TypeError(f"binned_segment_sum_merged supports float32/bfloat16, got {g.dtype} -> {out_dtype}")
    if idx.device != g.device:
        raise ValueError("idx and g must be on the same device")
    sorted_idx, order, starts, tile_rows = merged_schedule(idx, n_rows)
    g_sorted = g.index_select(0, order).contiguous()
    return _launch_merged(sorted_idx, g_sorted, starts, tile_rows, n_rows, out_dtype)


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
