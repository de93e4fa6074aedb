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

K5: `binned_segment_sum_merged` launches the CUDA kernels in
csrc/segment_sum_merged.cu, replacing the Pallas TPU kernel
`binned_segment_sum_merged` (the merged-split v2 of the same file): K2's
function in one fixed order, each row's points added in increasing point
id from 0.0 in f32 and the row written once in the out dtype, so it is
deterministic. The card sorts the point ids by hand (a stable counting
sort by tile of output rows, then by row within a tile's block) and reads
the payload once, in place, by id; a warp sums each row (see the note in
the .cu for what bounds it). A table may have at most 58,112 tiles (3.7M
rows of 128 in tiles of 64: a count block keeps a counter per tile in
shared memory), and the [tiles, ranges] count matrix that every call
zeroes and scans grows with n_rows x P (17 MB at the 640^3 plane, ~0.95
GB near that limit). `merged_plan` sizes every buffer from the
shapes alone, so the call is capturable in a CUDA graph; `merged_bins_plain`
is the two sort levels in plain PyTorch (the kernels' on-card reference).
`binned_segment_sum_merged_ordered` sums in K5's order in plain PyTorch on
any device: the kernel equals it bit for bit.
`binned_segment_sum_merged_plain` (a stable sort, an f32 `index_add_` and a
cast) is the CPU path; on the CPU it equals the ordered version bit for
bit. No training path calls K5 (none does in the JAX package either);
fixed-order training sends the plane gathers' VJP through it.
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


# K5's plan: tiles of at most MERGED_MAX_ROWS rows (a power of two, K2's
# tile_rows where that is smaller: 64 for rows of 128); level-1 ranges of
# MERGED_RANGE points, longer where P would make more than MERGED_RANGES of
# them; a tile segment of at most MERGED_SEG_CAP points sorted by row in
# shared memory (longer ones in a global scratch). The kernels' own limits
# (the scan's chunk, the most tiles a block can count) stay in the .cu:
# `lrf_segment_sum_merged_workspace` applies them.
MERGED_MAX_ROWS = 256
MERGED_RANGE = 2048
MERGED_RANGES = 4096
MERGED_SEG_CAP = 8192


class MergedPlan(NamedTuple):
    """K5's schedule sizes, from the shapes alone: tiles of 2**shift rows
    (`n_tiles`) and point ranges [k * range_len, (k + 1) * range_len)
    (`n_ranges`). The order of the sum does not depend on it."""

    tile_rows: int
    shift: int
    n_tiles: int
    range_len: int
    n_ranges: int


def merged_plan(p: int, c: int, n_rows: int) -> MergedPlan:
    rows = min(tile_plan(p, c, n_rows).tile_rows, MERGED_MAX_ROWS)
    shift = rows.bit_length() - 1
    n_tiles = max(1, -(-n_rows >> shift))
    range_len = max(MERGED_RANGE, 256 * -(-p // (256 * MERGED_RANGES)))
    return MergedPlan(1 << shift, shift, n_tiles, range_len, max(1, -(-p // range_len)))


def _merged_workspace(plan: MergedPlan) -> int:
    """Ints of K5's workspace (its count matrix and scan sums) for `plan`,
    or -1 where the table has more tiles than the kernels can count."""
    return _build.library().lrf_segment_sum_merged_workspace(plan.n_tiles, plan.n_ranges)


def row_ordered_sum(idx: torch.Tensor, g32: torch.Tensor, n_rows: int) -> torch.Tensor:
    """[n_rows, C] f32: each row's points summed in point order from 0.0
    (indices outside [0, n_rows) skipped). The k-th points of all rows are
    added in one step (their rows are distinct, so each add is exact), one
    step per rank of a point within its row: a reference, slow."""
    part = torch.zeros((n_rows, g32.shape[1]), dtype=torch.float32, device=g32.device)
    pts = torch.nonzero((idx >= 0) & (idx < n_rows)).flatten()
    if not pts.numel():
        return part
    rows, order = torch.sort(idx[pts].to(torch.int64), stable=True)
    pts = pts[order]  # grouped by row, each row's points in point order
    counts = torch.bincount(rows, minlength=n_rows)
    rank = torch.arange(rows.numel(), device=g32.device) - (torch.cumsum(counts, 0) - counts)[rows]
    rank, by_rank = torch.sort(rank, stable=True)
    for sel in torch.split(by_rank, torch.bincount(rank).tolist()):
        part[rows[sel]] += g32[pts[sel]]
    return part


def binned_segment_sum_merged_plain(idx: torch.Tensor, g: torch.Tensor, n_rows: int,
                                    out_dtype=torch.float32) -> torch.Tensor:
    """K5's function in plain PyTorch: a stable sort of the indices (those
    outside [0, n_rows) sent to a spare row n_rows, dropped at the end), an
    f32 `index_add_` and one cast; no host sync. On the CPU index_add_ adds
    in index order, so this is K5's order."""
    idx = idx.to(torch.int64)
    spare = torch.full_like(idx, n_rows)
    sorted_idx, order = torch.sort(torch.where((idx >= 0) & (idx < n_rows), idx, spare), stable=True)
    return segment_sum_plain(sorted_idx, g.index_select(0, order), n_rows + 1, out_dtype)[:n_rows]


def binned_segment_sum_merged_ordered(idx: torch.Tensor, g: torch.Tensor, n_rows: int,
                                      out_dtype=torch.float32) -> torch.Tensor:
    """K5's function summed in K5's order on any device (`row_ordered_sum`),
    then cast once: the kernel's bit-for-bit reference on the card."""
    return row_ordered_sum(idx, g.to(torch.float32), n_rows).to(out_dtype)


def merged_bins_plain(idx: torch.Tensor, n_rows: int, plan: MergedPlan) -> dict:
    """K5's two sort levels in plain PyTorch: starts int64 [n_tiles + 1]
    (tile t's segment is [starts[t], starts[t + 1])); by_point [binned]
    (each tile's in-range point ids in increasing id, tiles in order) and
    by_point_row (their rows within the tile); by_row [binned] (each tile's
    ids by row, each row's in increasing id)."""
    idx = idx.to(torch.int64)
    pts = torch.nonzero((idx >= 0) & (idx < n_rows)).flatten()
    rows = idx[pts]
    tiles = rows >> plan.shift
    by_point = pts[torch.sort(tiles, stable=True).indices]
    counts = torch.bincount(tiles, minlength=plan.n_tiles)[: plan.n_tiles]
    zero = torch.zeros(1, dtype=torch.int64, device=idx.device)
    return dict(starts=torch.cat([zero, torch.cumsum(counts, 0)]), by_point=by_point,
                by_point_row=idx[by_point] & (plan.tile_rows - 1),
                by_row=pts[torch.sort(rows, stable=True).indices])


def _merged_cuda(idx, g, n_rows: int, out_dtype, seg_cap: int = MERGED_SEG_CAP) -> tuple[torch.Tensor, dict]:
    """K5 on the current stream: (out, the schedule's int32 buffers:
    tile_start [n_tiles + 1], bins [P, 2] = (id, row within the tile) of
    which the first tile_start[-1] are live, scratch [P]: a tile segment's
    ids by row where it is longer than `seg_cap`). Only the card tests and
    chip_smoke set `seg_cap` (0 sends every segment through the scratch,
    which they read); every other call takes MERGED_SEG_CAP."""
    if idx.dim() != 1 or g.dim() != 2 or idx.shape[0] != g.shape[0]:
        raise ValueError(f"idx [P] and g [P, C] expected, got {list(idx.shape)}, {list(g.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")
    if g.dtype not in _PAYLOAD_DTYPES or out_dtype not in _PAYLOAD_DTYPES:
        raise TypeError(f"binned_segment_sum_merged supports float32/bfloat16, got {g.dtype} -> {out_dtype}")
    if idx.device != g.device:
        raise ValueError("idx and g must be on the same device")
    idx, g = idx.contiguous(), g.contiguous()
    p, c = g.shape
    if p >= 2**31:
        raise ValueError(f"binned_segment_sum_merged bins point ids as int32: P = {p} is too many")
    plan = merged_plan(p, c, n_rows)
    n_ws = _merged_workspace(plan)
    if n_ws < 0:
        raise ValueError(f"binned_segment_sum_merged: {n_rows} rows make {plan.n_tiles} tiles of"
                         f" {plan.tile_rows}, more than its count kernel holds in shared memory")
    out = torch.empty((n_rows, c), dtype=out_dtype, device=g.device)
    # the workspace first (the scan reads it 16 bytes at a time), in whole
    # 16 bytes (the int2 bins follow it)
    sizes = {"workspace": -(-n_ws // 4) * 4, "bins": 2 * p, "tile_start": plan.n_tiles + 1, "scratch": p}
    ints = torch.empty(sum(sizes.values()), dtype=torch.int32, device=g.device)
    sched = dict(zip(sizes, torch.split(ints, list(sizes.values()))))
    if not out.numel():
        return out, sched
    elem = g.element_size()
    vec = 4 if c % 4 == 0 and g.data_ptr() % (4 * elem) == 0 else 1
    with torch.cuda.device(g.device):
        _build.launch(
            "lrf_segment_sum_merged", idx.data_ptr(), int(idx.dtype == torch.int64), g.data_ptr(),
            int(g.dtype == torch.bfloat16), vec, out.data_ptr(), int(out_dtype == torch.bfloat16), p, c,
            n_rows, plan.shift, plan.n_tiles, plan.range_len, plan.n_ranges, sched["workspace"].data_ptr(),
            sizes["workspace"], *(sched[k].data_ptr() for k in ("tile_start", "bins", "scratch")),
            seg_cap, _build.stream_ptr(g.device),
        )
    LAUNCHES["segment_sum_merged"] += 1
    sched["bins"] = sched["bins"].view(p, 2)
    return out, sched


def binned_segment_sum_merged(idx: torch.Tensor, g: torch.Tensor, n_rows: int,
                              out_dtype=torch.float32) -> torch.Tensor:
    """out[n_rows, C] = sum_{p: idx_p == r} g_p, accumulated in f32 in point
    order within each row and written once in `out_dtype` (float32 or
    bfloat16); indices outside [0, n_rows) are skipped. CPU tensors take
    `binned_segment_sum_merged_plain`; CUDA tensors launch K5."""
    if g.device.type == "cpu":
        return binned_segment_sum_merged_plain(idx, g, n_rows, out_dtype)
    if g.device.type != "cuda":
        raise ValueError(f"binned_segment_sum_merged: no kernel for device {g.device}")
    return _merged_cuda(idx, g, n_rows, out_dtype)[0]


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
