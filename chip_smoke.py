"""Smoke test of the PyTorch/CUDA port on one GPU: build, check, train.

    python3 chip_smoke.py

1. Needs a CUDA card (exits 1 otherwise). Prints the card's name and power
   limit, builds the kernels from localrf_tpu_torch/csrc/ and prints the
   build time, and checks with `cuobjdump -sass` that the bf16 K4 MLP
   kernels hold tensor-core instructions (HMMA or HGMMA).
2. Checks each hand-written kernel against its plain PyTorch version on the
   card at the shapes of the training step, and times both (a captured
   CUDA graph of 20 calls, replayed; CUDA events), beside its bound (bytes over the card's memory rate or operations over
   its peak rate, whichever is larger) and, where one PyTorch call computes
   the same function, that call (index_add_ for the segment sums):
   K1 (compositing weights; also on near-opaque samples, and the forward
   timed at a blended eval chunk's [2048, 332]), K2 (plane
   segment sum; on uniform indices and on the plane indices of a real step
   at 64^3 and 640^3, its bin schedule against tile_bins_plain, with
   indices out of range and with P = 0), K3 (line segment sum; on uniform
   indices and on the line indices of a real 640^3 segsum step, bit for
   bit against its ordered plain version and against a second launch), K4
   (fused march core, forward and backward; K4-bwd also by its kernels' device
   us from one profiled call), and K5 (the plane segment sum in a fixed
   order; on K2's uniform and real-step inputs, indices out of range and
   P = 0: bit for bit against its ordered plain version and a second
   launch, its two sort levels against merged_bins_plain; timed beside K2,
   with its kernels' device us from one profiled call).
3. One small training step card vs CPU (32^3, f32) for the default path,
   the fused march (--fused_march 1) and the segsum lines (--line_bwd
   segsum); and a small spawn card vs CPU: a 32^3 f32 model spawns a field,
   slides, takes one step on it and renders one 40x30 blended frame.
4. Eager steps: trains the full-width TensoRF-VM model through the port's
   entry points (LocalTensorfs.optimizer_step on SyntheticDataset batches
   of 4096 rays over 960x540 frames): 5 steps from 64^3 (alpha refresh,
   dense cull, upsample to 101^3), then 3 steps at 640^3 with a 320^3 ball
   alpha volume (coarse probe + compaction to 332 samples per ray) for each
   of the default path, the fused march and the segsum lines.
5. Chunks (the JAX package's default --scan_chunk 16 --pixel_pool 1): a
   DevicePixelPool of train.py's default capacity (146 frame slots of
   960x540) is attached and LocalTensorfs.plan_chunk / run_chunk train
   chunks of 16 steps, every step a replay of a captured CUDA graph: at
   64^3 (ending in an alpha refresh, which drops the graphs, and one chunk
   captured again after it), and at 640^3 on the default, the fused march
   and the segsum-lines paths. The 64^3, 640^3 default and segsum phases
   first train a chunk with every sum in a fixed order (torch's
   deterministic algorithms, the plane VJP through K5, captured in the
   chunk's graphs; K3 sums in a fixed order of its own) and hold it bit for
   bit against the same 16 steps taken eagerly by a twin model from the
   same state (not the fused march, whose K4-bwd adds the line gradient
   atomically); K5's launch count comes from these chunks, reset just
   before each and read after it. Then, on the path as it runs: the first chunk
   against a twin's eager steps (tolerances at CHUNK_TOL; the chunk's launch
   counts are read before the twin runs), 3 chunks timed, one traced with
   torch.profiler, which must show one graph launch per step whose replays
   ran the path's kernels, and none of them outside a replay (the launch
   counters count at capture, not at replay, and must not move in a chunk
   of replays).
6. After each training phase: every loss finite, parameters changed, and the
   kernels of that phase's path launched while the others were not (launch
   counts reset just before).
7. Spawn and eval: a dataset of 12 frames, 5 active, a 146-slot pool.
   Field 0 is at 640^3 with the ball alpha volume (as model_640); it trains
   a chunk, then 4 frames are appended one at a time, a chunk after each.
   LocalTensorfs.append_rf(4) spawns field 1 (a fresh 64^3 field), the
   dataset's and the model's windows slide to its first frame, 2 frames are
   appended (linked to field 1, the pose gate on for them only). Checked:
   field 0's params on the host (unchanged through what follows) and its
   optimizer gone, its bytes freed on the card, the graphs dropped and
   their pool released (empty_cache, cuBLAS's workspaces cleared), graphs
   captured again after the spawn. Field 1 trains on the chunk path of 5
   (run_chunks: bit for bit under fixed-order sums, so K5 runs; against a
   twin's eager steps; 3 timed, 1 profiled), twins cloned from the
   post-spawn state. Then 960x540 eval frames through forward_eval (chunk
   4096), each timed: one in the cross-fade (both fields at weight 0.5),
   against the plain compositing (pallas_composite off) and against the
   sum over fields of w_k * render_frame_k; one of field 0 alone (also
   profiled: idle share); render_chunk over 2 views against those frames;
   one of field 1 alone with floater_thresh 0.5 (no K1); PSNR and SSIM on
   the card against the (random) dataset frames; card memory before and
   after clear_eval_cache; K1-fwd launches counted per frame (one per chunk
   and field). Last, one 960x540 frame of model_640 on the fused march
   (K4-fwd and K1-fwd a chunk) against the same frame unfused.
8. The CLI: a seeded scene of 8 frames of 960x540 (images/, depth/,
   flow_ds/) is written to a temp dir and train.reconstruction runs on it
   through config_parser at the default widths and flags, with the frame
   count, the iterations per frame and the final grid cut (CLI_CUTS,
   printed): frame appends, upsamples, alpha refreshes, a spawn, mid-run
   evals with checkpoints_tmp.th, the final checkpoint, transforms.json,
   test renders and the smoothed path with its videos. Printed: ms/step
   (median of the chunks of 16 that captured no graph), eval ms/frame,
   checkpoint bytes with save and load seconds, peak memory, the run's
   launch counts (K1, K2; counted at capture). Then: the last
   checkpoints_tmp.th loaded and one chunk from it under fixed-order sums
   (K5) bit for bit against a twin of the saved model (cloned when the file
   was written, its generator reseeded as the loader does); render_test's
   PNGs byte-equal to the run's own; the JAX package's fixture
   (tests/fixtures/jax_ckpt_12.th) rendered within FIXTURE_TOL of JAX's CPU
   frame.
9. Preprocessing: a seeded scene of 8 frames of 960x540 images/ goes
   through run_flow.main at its defaults (scale 0.5: 480x270 padded to
   480x272, 30 iterations, a module.-prefixed random raft-things.pth from
   init_raft) into 14 flow_ds/ PNGs (decoded: finite) and flow_vis/, and
   through run_depth's default backend (the port's DPT-Large from a seeded
   init_dpt state dict, no transformers, --size 384) into depth/; the
   port's LocalRFDataset reads the scene back with its depth and flows.
   RAFT (one pair at 480x272, 30 iterations) and DPT-Large (one 384x384
   image) on the card against the port on the CPU (RAFT_TOL, DPT_TOL),
   rgb_ssim and rgb_lpips on CUDA tensors against the CPU (METRIC_TOL),
   all under torch's default flags (cuDNN may use TF32; each of these
   scopes itself to full f32); ms a pair and an image; the mesh
   (export_density_ply at 128^3) of the CLI run's last field at level 0.5
   and at its 99th alpha percentile (which must give faces); peak memory
   and the phase's seconds. Nothing in this script sets a TF32 flag: every
   phase runs with the settings a user gets.
10. Data parallelism (parallel/): (a) an NCCL process group of this one
   rank: the 640^3 default pooled chunk of 16 steps with the "data" mesh
   set, its gradient all-reduces captured in the chunk's graphs (run_chunks:
   bit for bit under fixed-order sums against a twin with no mesh, within
   CHUNK_TOL as it runs, timed, profiled), a fresh capture counting its
   collectives (none at replay), NCCL's device work per replayed step, and
   ms/step with and without the mesh in turns; (b) two spawned gloo ranks
   on this card (NCCL refuses two ranks on one card): a 64^3 chunk of 16
   eager steps (gloo is not captured) against the same chunk in this
   process, both ranks' state bit for bit, K1 and K2 launched on each rank,
   a 960x540 frame split over the ranks against the same rank alone; (c)
   render_rays_sp over a sample group of 2 (gloo), 4096 rays through the
   640^3 field with the ball alpha volume, against render_rays in eval; (d)
   NCCL across two cards where there are two (else a line saying why not).

Prints a {"kernels": [...]} line, then the last line
{"ok": true, "device": {...}}. Any failure raises before that line.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

# kernel tolerances (see the kernel modules): K1 forward/backward against the
# cumprod reference, which multiplies in another order on the card
K1_TOL = {"fwd": (1e-4, 1e-6), "bwd": (1e-3, 1e-5)}
K2_TOL_F32 = (1e-4, 1e-4)
# K2 in bf16 out: one bf16 ulp. Where hundreds of signed terms land on one
# row (a real step's rows, ~72 points a row at 64^3 and more in the ball),
# a sum that cancels to near 0 moves by more than one bf16 ulp of itself
# with the order of the f32 adds (the plain index_add_'s own atomics
# included); sums of non-negative terms stay within one ulp in any order.
# So bf16 out is checked on |g| except on uniform indices, as before.
# K3 equals its ordered plain version bit for bit (the order is fixed by
# the shapes); against the plain index_add_, which adds in another order,
# over ~2,000-4,600 points per line row: rtol 1e-4, atol 1e-5 of the
# largest entry (the rounding of a reordered sum scales with the row's
# partial sums)
K3_TOL = (1e-4, 1e-5)
# K4 against march_core_plain, bf16 tables and MLP: an f32 sum taken in
# another order (atomics, the MLP dots) can flip a bf16 rounding, which
# moves a hidden activation by one bf16 ulp: out to atol 1e-2, gradients to
# 2e-2 of their largest entry (a kernel fault is off by O(1))
K4_TOL = {"out": 1e-2, "grad": 2e-2}
# (table rows, points) of the main path: line tables of 64 rows with
# 4096 x 72 samples at 64^3, 640 rows with 4096 x 332 at 640^3; K3's payload
# rows are 64 bf16 (2C), K4 runs bf16 tables and MLP
K3_CASES = ((64, 4096 * 72), (640, 4096 * 332))
# K1-fwd in an eval chunk of a blended 960x540 frame: 4096 rays shared by
# two fields, 2048 each, 332 compacted samples at 640^3
EVAL_K1_SHAPE = "eval [2048,332], dists [2048,332]"
K4_CASES = ((64, 4096 * 72), (640, 4096 * 332))

# K5 equals its ordered plain version (binned_segment_sum_merged_ordered) bit for bit
# the chunk path: train.py's --scan_chunk default, and its pixel-pool
# capacity n_max_frames + n_overlap + 16 at the defaults (100, 30)
CHUNK = 16
POOL_SLOTS = 100 + 30 + 16
# A captured chunk against the same steps taken eagerly from the same
# state. With every sum in a fixed order (deterministic_sums) the two are
# equal bit for bit (chunk_bit_exact). On the path as it runs, K2's and
# index_add_'s atomic adds reorder f32 gradient sums, and 16 steps of
# training amplify that: on an H100 two eager runs and two graph runs
# drift as far apart as graph and eager (rgb_loss up to 3.2e-6, flow loss
# up to 7.7e-3 at 64^3 and 9.8e-4 at 640^3 by step 15; 1.4e-2 in one
# earlier graph-vs-eager run), while a graph that drops the pose window's
# copy-back between steps is off by 0.25-0.73 in the flow loss on every
# step after the first. So: every loss to rtol 1e-5 on the first step,
# rgb_loss to 1e-4 (a wrong batch moves it by ~1e-2), the others to 5e-2
CHUNK_TOL = {"rgb": 1e-4, "first": 1e-5, "other": 5e-2}
# chunks timed per chunk phase
N_TIMED = 3

W, H = 960, 540
BATCH, N_VIEWS, N_FRAMES = 4096, 16, 8


def _require_cuda():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    return torch


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 20, eager: bool = False) -> float:
    """Device ms per call of fn: `reps` calls captured in one CUDA graph (as
    a captured training step launches them, so no host launch time), the
    graph replayed three times after a warm-up call and one replay. With
    `eager`, for a function that waits on the host and so cannot be
    captured: CUDA events around `reps` eager calls after a warm-up."""
    import torch

    if eager:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def _close(got, ref, rtol: float, atol: float) -> float:
    """max |got - ref|; raises unless |got - ref| <= atol + rtol |ref| everywhere."""
    import torch

    got, ref = got.detach().float(), ref.detach().float()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bad.any():
        raise AssertionError(
            f"{int(bad.sum())} elements off (max abs err {float(err.max()):.3e})"
        )
    return float(err.max())


def _within_one_bf16_ulp(got, ref) -> float:
    """got, ref bf16: |got - ref| <= one bf16 ulp of max(|got|, |ref|)."""
    import torch

    g, r = got.float(), ref.float()
    mag = torch.maximum(g.abs(), r.abs())
    ulp = torch.where(
        mag > 0, torch.exp2(torch.floor(torch.log2(mag)) - 7), torch.zeros_like(mag)
    )
    ulp = torch.clamp(ulp, min=2.0**-133)  # smallest bf16 subnormal step
    err = (g - r).abs()
    bad = err > ulp
    if bad.any():
        raise AssertionError(f"{int(bad.sum())} bf16 elements differ by more than one ulp")
    return float(err.max())


# the least time of a kernel (bound_ms): the larger of its bytes (each
# input read once, each output written once) over the card's memory rate
# and its operations over the peak rate for their type (H100 SXM, NVIDIA's
# data sheet: 3.35 TB/s of HBM, 989 TFLOP/s dense bf16)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(n_bytes: int, n_flop: float = 0.0) -> dict:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flop / BF16_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=n_bytes, bound_flop=n_flop)


def _index_add_ms(idx, g, n_rows: int) -> float:
    """The library call for a segment sum: index_add_ of an f32 payload into
    a zeroed f32 table (the payload cast to f32 beforehand, not timed)."""
    import torch

    g32 = g.float()
    return _time_ms(lambda: torch.zeros((n_rows, g.shape[1]), dtype=torch.float32,
                                        device=g.device).index_add_(0, idx, g32))


# the tensor-core K4 kernels (bf16 tables and MLP) and the CUDA-core ones
# (any f32 table or MLP), as the built library's SASS names them
MMA_KERNELS = ("march_fwd_mma_kernel", "march_bwd_mlp_mma_kernel")
CORE_KERNELS = ("march_fwd_kernel", "march_bwd_mlp_kernel")


def check_sass(lib: str) -> dict:
    """`cuobjdump -sass` of the built library: each tensor-core K4 kernel
    holds tensor-core instructions (HMMA or HGMMA); the count of those in
    every K4 MLP kernel, by name."""
    import re

    from localrf_tpu_torch.ops.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    counts = {k: 0 for k in MMA_KERNELS + CORE_KERNELS}
    for section in sass.split("Function : ")[1:]:
        name = section.split("\n", 1)[0]
        for k in MMA_KERNELS + CORE_KERNELS:
            if k in name:
                counts[k] += len(re.findall(r"\bHG?MMA\b", section))
                break
    missing = [k for k in MMA_KERNELS if not counts[k]]
    if missing:
        raise AssertionError(f"no HMMA/HGMMA in the SASS of {missing}: the bf16 K4 products are not on tensor cores")
    return counts


def check_k1(dev, gen) -> list[dict]:
    """K1 forward and backward against fused_weights_plain at the main
    path's shapes (64^3: [4096, 72], the shared [1, 72] dist row; 640^3:
    [4096, 332], per-ray dists) and on near-opaque samples (1 in 20 with
    sigma 1e3, so 1 - a rounds to 0 and T runs into the 1e-10 clamp and
    underflows), checked, not timed."""
    import torch

    from localrf_tpu_torch.ops.kernels import composite as k1
    from localrf_tpu_torch.ops.rays import sample_ray_contracted

    o = torch.zeros(1, 3, device=dev)
    d = torch.tensor([[0.0, 0.0, -1.0]], device=dev)
    _, _, dists72 = sample_ray_contracted(o, d, 219, False)
    dists332 = 0.01 + 0.49 * torch.rand(4096, 332, generator=gen, device=dev)
    cases = [("64^3 [4096,72], dists [1,72]", 4096, 72, dists72, False),
             ("640^3 [4096,332] near-opaque", 4096, 332, dists332, False),
             ("640^3 [4096,332], dists [4096,332]", 4096, 332, dists332, True),
             # an eval chunk of a two-field blended frame at 640^3: no backward
             (EVAL_K1_SHAPE, 2048, 332, dists332[:2048].contiguous(), False)]
    rows = []
    for label, r, s, dists, main in cases:
        sigma = 2.0 * torch.rand(r, s, generator=gen, device=dev)
        if "opaque" in label:
            sigma = torch.where(torch.rand(r, s, generator=gen, device=dev) < 0.05, 1e3, sigma)
        cot = torch.randn(r, s, generator=gen, device=dev)
        sig_k = sigma.clone().requires_grad_(True)
        sig_p = sigma.clone().requires_grad_(True)
        w_k = k1.fused_weights(sig_k, dists, 25.0)
        w_p = k1.fused_weights_plain(sig_p, dists, 25.0)
        (g_k,) = torch.autograd.grad(w_k, sig_k, cot)
        (g_p,) = torch.autograd.grad(w_p, sig_p, cot)
        err_f = _close(w_k, w_p, *K1_TOL["fwd"])
        err_b = _close(g_k, g_p, K1_TOL["bwd"][0], K1_TOL["bwd"][1] * float(g_p.abs().max()))
        if "opaque" in label:
            if not (w_p == 0).any():
                raise AssertionError("near-opaque K1 case: T never underflowed")
            print(f"kernel fused_weights      {label:38s} err fwd {err_f:.3e} bwd {err_b:.3e}")
            continue
        fwd_row = dict(
            name="fused_weights_fwd", shape=label, main=main, max_abs_err=err_f,
            ms=_time_ms(lambda: k1._launch_fwd(sigma, dists, 25.0)),
            plain_ms=_time_ms(lambda: k1.fused_weights_plain(sigma, dists, 25.0)), library_ms=None,
            **_bound(_nbytes(sigma, dists, w_k)),
        )
        rows.append(fwd_row)
        if label == EVAL_K1_SHAPE:
            continue

        def bwd_plain():
            x = sigma.clone().requires_grad_(True)
            torch.autograd.grad(k1.fused_weights_plain(x, dists, 25.0), x, cot)

        def bwd_plain_fwd():
            x = sigma.clone().requires_grad_(True)
            k1.fused_weights_plain(x, dists, 25.0)

        rows.append(dict(
            name="fused_weights_bwd", shape=label, main=main, max_abs_err=err_b,
            ms=_time_ms(lambda: k1._launch_bwd(sigma, dists, cot, 25.0)),
            # the plain backward alone: autograd (fwd + bwd) less its forward,
            # eager (torch.cumprod's backward checks its input for zeros on
            # the host, so it cannot be captured)
            plain_ms=_time_ms(bwd_plain, eager=True) - _time_ms(bwd_plain_fwd, eager=True),
            library_ms=None,
            **_bound(_nbytes(sigma, dists, cot, g_k)),
        ))
    return rows


def record_sums(model, ds, module, name: str) -> list:
    """(idx, n_rows) of every call of the segment sum `module.name` in one
    eager step of `model` (the backward of its row gathers)."""
    seen, segment_sum = [], getattr(module, name)

    def spy(idx, g, n_rows, *args, **kwargs):
        seen.append((idx.clone(), n_rows))
        return segment_sum(idx, g, n_rows, *args, **kwargs)

    setattr(module, name, spy)
    try:
        model.optimizer_step(ds.sample(BATCH, model.is_refining, True, n_views=N_VIEWS), optimize_poses=True)
    finally:
        setattr(module, name, segment_sum)
    return seen


def record_plane_sums(model, ds) -> list:
    """(idx, n_rows) of every plane segment sum (K2) in one eager step of
    `model` (its three plane gathers' backward)."""
    from localrf_tpu_torch.ops.kernels import binned_scatter as k2

    return record_sums(model, ds, k2, "segment_sum")


def real_line_indices(dev, ds) -> tuple:
    """(idx, n_rows) of the first line segment sum (K3) of one step of
    model_640 on the segsum lines: the ball's 4096 x 332 compacted points
    on a 640-row line table."""
    import torch

    from localrf_tpu_torch.ops.kernels import segsum as k3

    model = model_640(dev, "segsum")
    out = record_sums(model, ds, k3, "segment_sum_small")[0]
    del model
    torch.cuda.empty_cache()
    return out


def real_plane_indices(dev, ds) -> dict:
    """The three plane segment sums' (idx, n_rows) of one step at each
    main-path shape: the full-width model at 64^3 (dense march, 4096 x 72
    points on a 4,096-row plane) and model_640 (default path, the ball's
    4096 x 332 compacted points on a 409,600-row plane)."""
    import torch

    from localrf_tpu_torch.models.local import LocalTensorfs

    m64 = LocalTensorfs(full_width_config(64), device=dev)
    m64.is_refining = True
    m64.rf_iter[-1] = 2
    out = {"64^3": record_plane_sums(m64, ds)}
    del m64
    m640 = model_640(dev, "default")
    out["640^3"] = record_plane_sums(m640, ds)
    del m640
    torch.cuda.empty_cache()
    return out


def _check_k2_bins(idx, n_rows: int) -> None:
    """K2's bin kernels against tile_bins_plain: the same counts, starts,
    partial slots, work list and empty tiles, and every tile's bin holds the
    same points at the same rows (in any order within the tile)."""
    import torch

    from localrf_tpu_torch.ops.kernels import binned_scatter as k2

    plan = k2.tile_plan(idx.shape[0], 128, n_rows)
    with torch.cuda.device(idx.device):
        got = k2._bin_cuda(idx, n_rows, plan)
    want = k2.tile_bins_plain(idx, n_rows, plan)
    n_items, n_empty = got["totals"].tolist()
    for key in ("counts", "starts", "slot_base"):
        if not torch.equal(got[key].long(), want[key]):
            raise AssertionError(f"segment_sum bins: {key} differ from tile_bins_plain")
    if (n_items != want["items"].shape[0] or not torch.equal(got["items"][:n_items].long(), want["items"])
            or not torch.equal(got["empty"][:n_empty].long(), want["empty"])):
        raise AssertionError("segment_sum bins: the work list or the empty tiles differ from tile_bins_plain")
    n = int(want["starts"][-1])
    tile = torch.repeat_interleave(torch.arange(plan.n_tiles, device=idx.device), want["counts"])
    key_got = (tile * plan.tile_rows + got["bin_row"][:n].long()) * (idx.shape[0] + 1) + got["bin_pt"][:n].long()
    key_want = (tile * plan.tile_rows + want["bin_row"]) * (idx.shape[0] + 1) + want["bin_pt"]
    if not torch.equal(torch.sort(key_got).values, torch.sort(key_want).values):
        raise AssertionError("segment_sum bins: a tile's bin holds other points than tile_bins_plain's")


def check_k2(dev, gen, real: dict) -> list[dict]:
    """K2 against segment_sum_plain (f32 out to K2_TOL_F32, bf16 out to one
    bf16 ulp) at the main path's two plane shapes, on uniform random
    indices and on the first recorded plane sum of a real step (`real`),
    with a random bf16 payload of 128 channels; its bin kernels against
    tile_bins_plain; timed bf16 -> bf16 beside the plain version and
    index_add_. Also checked, not timed: indices out of range, and P = 0."""
    import torch

    from localrf_tpu_torch.ops.kernels import binned_scatter as k2

    rows = []
    for label, n_rows, p in (("64^3", 4096, 4096 * 72), ("640^3", 409_600, 4096 * 332)):
        r_idx, r_rows = real[label][0]
        if r_idx.shape[0] != p or r_rows != n_rows:
            raise AssertionError(f"{label}: the step's plane sum has P {r_idx.shape[0]} on {r_rows} rows")
        g = torch.randn(p, 128, generator=gen, device=dev).to(torch.bfloat16)
        uniform = torch.randint(0, n_rows, (p,), generator=gen, device=dev)
        for kind, idx in (("uniform", uniform), ("real step", r_idx)):
            _check_k2_bins(idx, n_rows)
            err32 = _close(k2.segment_sum(idx, g, n_rows, torch.float32),
                           k2.segment_sum_plain(idx, g, n_rows, torch.float32), *K2_TOL_F32)
            # bf16 out on |g| where rows are hot (see K2_TOL_F32)
            g16 = g if kind == "uniform" else g.abs()
            err16 = _within_one_bf16_ulp(k2.segment_sum(idx, g16, n_rows, torch.bfloat16),
                                         k2.segment_sum_plain(idx, g16, n_rows, torch.bfloat16))
            shape = f"{label} {kind}: n_rows {n_rows}, P {p}, bf16 -> bf16"
            out = k2.segment_sum(idx, g, n_rows, torch.bfloat16)
            counts = k2.tile_bins_plain(idx, n_rows, k2.tile_plan(p, 128, n_rows))["counts"]
            rows.append(dict(
                name="segment_sum", shape=shape, main=label == "640^3" and kind == "real step",
                max_abs_err=err32, bf16_err=err16,
                ms=_time_ms(lambda: k2.segment_sum(idx, g, n_rows, torch.bfloat16)),
                plain_ms=_time_ms(lambda: k2.segment_sum_plain(idx, g, n_rows, torch.bfloat16)),
                library_ms=_index_add_ms(idx, g, n_rows), **_bound(_nbytes(idx, g, out)),
                occupied_tiles=int((counts > 0).sum()), max_tile_points=int(counts.max()),
            ))
        # out of range (skipped) and P = 0 (zeros), in both out dtypes
        wild = torch.randint(-n_rows // 4, n_rows + n_rows // 4, (p,), generator=gen, device=dev)
        _check_k2_bins(wild, n_rows)
        keep = (wild >= 0) & (wild < n_rows)
        err_w = _close(k2.segment_sum(wild, g, n_rows, torch.float32),
                       k2.segment_sum_plain(wild[keep], g[keep], n_rows, torch.float32), *K2_TOL_F32)
        _within_one_bf16_ulp(k2.segment_sum(wild, g.abs(), n_rows, torch.bfloat16),
                             k2.segment_sum_plain(wild[keep], g[keep].abs(), n_rows, torch.bfloat16))
        for dt in (torch.float32, torch.bfloat16):
            empty = k2.segment_sum(wild[:0], g[:0], n_rows, dt)
            if empty.dtype != dt or empty.shape != (n_rows, 128) or empty.any():
                raise AssertionError(f"segment_sum with P = 0 ({dt}) is not a zero table")
        print(f"kernel segment_sum        {label} out of range ({int((~keep).sum())} skipped) err"
              f" {err_w:.3e}; P = 0 gives zeros")
    return rows


def _check_k5_exact(idx, g, n_rows: int, label: str) -> float:
    """K5 in f32 and bf16 out equal to its ordered plain version and to a
    second launch, bit for bit; its two sort levels equal to
    merged_bins_plain (level 2 read from the global scratch: seg_cap 0).
    Returns max |K5 - ordered plain| (0 once equal)."""
    import torch

    from localrf_tpu_torch.ops.kernels import binned_scatter as k2

    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        got = k2.binned_segment_sum_merged(idx, g, n_rows, dt)
        if got.dtype != dt or got.shape != (n_rows, g.shape[1]):
            raise AssertionError(f"segment_sum_merged {label}: out {got.dtype} {tuple(got.shape)}")
        want = k2.binned_segment_sum_merged_ordered(idx, g, n_rows, dt)
        if got.numel():
            err = max(err, float((got.float() - want.float()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"segment_sum_merged {label} ({dt}): differs from its ordered plain version")
        if not torch.equal(got, k2.binned_segment_sum_merged(idx, g, n_rows, dt)):
            raise AssertionError(f"segment_sum_merged {label} ({dt}): two launches differ")
    want = k2.merged_bins_plain(idx, n_rows, k2.merged_plan(idx.shape[0], g.shape[1], n_rows))
    n = int(want["starts"][-1])
    _, sched = k2._merged_cuda(idx, g, n_rows, torch.bfloat16, seg_cap=0)
    if not (torch.equal(sched["tile_start"].long(), want["starts"])
            and torch.equal(sched["bins"][:n, 0].long(), want["by_point"])
            and torch.equal(sched["bins"][:n, 1].long(), want["by_point_row"])
            and torch.equal(sched["scratch"][:n].long(), want["by_row"])):
        raise AssertionError(f"segment_sum_merged {label}: its sort levels differ from merged_bins_plain")
    return err


def check_k5(dev, gen, real: dict) -> list[dict]:
    """K5 at the main path's two plane shapes on uniform random indices and
    on each of the three recorded plane sums of a real step (`real`), with
    a random bf16 payload of 128 channels: bit for bit against its ordered
    plain version and a second launch, its sort levels against
    merged_bins_plain; timed bf16 -> bf16 beside the plain version,
    index_add_ and K2 on the same inputs, with the device us of each of its
    kernels (one profiled call: count, scan, scatter, reduce) and the most
    points in a tile and in a row. Also checked, not timed: indices out of
    range, and P = 0."""
    import torch

    from localrf_tpu_torch.ops.kernels import binned_scatter as k2
    from localrf_tpu_torch.scripts.kernel_ab import kernel_us

    rows = []
    for label, n_rows, p in (("64^3", 4096, 4096 * 72), ("640^3", 409_600, 4096 * 332)):
        g = torch.randn(p, 128, generator=gen, device=dev).to(torch.bfloat16)
        cases = [("uniform", torch.randint(0, n_rows, (p,), generator=gen, device=dev))]
        for k, (r_idx, r_rows) in enumerate(real[label]):
            if r_idx.shape[0] != p or r_rows != n_rows:
                raise AssertionError(f"{label}: plane sum {k} has P {r_idx.shape[0]} on {r_rows} rows")
            cases.append((f"real step sum {k}", r_idx))
        for kind, idx in cases:
            shape = f"{label} {kind}: n_rows {n_rows}, P {p}, bf16 -> bf16"
            err = _check_k5_exact(idx, g, n_rows, shape)
            out = k2.binned_segment_sum_merged(idx, g, n_rows, torch.bfloat16)
            plan = k2.merged_plan(p, 128, n_rows)
            rows.append(dict(
                name="segment_sum_merged", shape=shape, main=label == "640^3" and kind == "real step sum 0",
                max_abs_err=err,
                ms=_time_ms(lambda: k2.binned_segment_sum_merged(idx, g, n_rows, torch.bfloat16)),
                plain_ms=_time_ms(lambda: k2.binned_segment_sum_merged_plain(idx, g, n_rows, torch.bfloat16)),
                library_ms=_index_add_ms(idx, g, n_rows), **_bound(_nbytes(idx, g, out)),
                k2_ms=_time_ms(lambda: k2.segment_sum(idx, g, n_rows, torch.bfloat16)),
                kernel_us=kernel_us(lambda: k2.binned_segment_sum_merged(idx, g, n_rows, torch.bfloat16)),
                max_tile_points=int(torch.bincount(idx >> plan.shift).max()),
                max_row_points=int(torch.bincount(idx).max()),
            ))
        wild = torch.randint(-n_rows // 4, n_rows + n_rows // 4, (p,), generator=gen, device=dev)
        _check_k5_exact(wild, g, n_rows, f"{label} out of range")
        for dt in (torch.float32, torch.bfloat16):
            empty = k2.binned_segment_sum_merged(wild[:0], g[:0], n_rows, dt)
            if empty.dtype != dt or empty.shape != (n_rows, 128) or empty.any():
                raise AssertionError(f"segment_sum_merged with P = 0 ({dt}) is not a zero table")
        print(f"kernel segment_sum_merged {label} out of range ({int(((wild < 0) | (wild >= n_rows)).sum())}"
              f" skipped) and P = 0: bit for bit = ordered plain = 2nd launch, bins = merged_bins_plain")
    return rows


def march_inputs(g: int, p: int, dtype, gen, dev) -> tuple[list, "torch.Tensor"]:
    """Random march-core arguments at table size g and P points (the
    field's init scales), every differentiable one requiring grad, and a
    cotangent."""
    import torch

    def leaf(t):
        return t.requires_grad_(True)

    def uni(shape, bound):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound

    rows = [leaf((0.1 * torch.randn(p, 128, generator=gen, device=dev)).to(dtype)) for _ in range(3)]
    args = rows + [
        leaf(torch.rand(p, 6, generator=gen, device=dev)),
        leaf(torch.rand(p, 3, generator=gen, device=dev)),
        torch.randint(0, g, (p, 3), generator=gen, device=dev, dtype=torch.int32),
        torch.nn.functional.normalize(torch.randn(p, 3, generator=gen, device=dev), dim=-1),
        leaf((0.1 * torch.randn(3, g, 64, generator=gen, device=dev)).to(dtype)),
        leaf(uni((72, 27), 72**-0.5)), leaf(uni((27, 128), 27**-0.5)), leaf(uni((128,), 27**-0.5)),
        leaf(uni((128, 128), 128**-0.5)), leaf(uni((128,), 128**-0.5)),
        leaf(uni((131, 3), 131**-0.5)), leaf(uni((3,), 0.1)),
    ]
    return args, torch.randn(p, 4, generator=gen, device=dev)


# K4's operations per point, counted from csrc/march.cu: the forward's
# plane bilerps, line lerps and products (~1.3k), basis 72 -> 27 (3,888),
# MLP 27 -> 128 -> 128 and 131 -> 3 (6,912 + 32,768 + 786); the backward
# recomputes the forward and runs the MLP and basis VJPs (inputs and
# weights: twice the forward's products) and the factor VJP (~2k)
K4_FWD_FLOP = 1_300 + 3_888 + 6_912 + 32_768 + 786
K4_BWD_FLOP = K4_FWD_FLOP + 2 * (3_888 + 6_912 + 32_768 + 786) + 2_000


def check_k3(dev, gen, real: tuple) -> list[dict]:
    """K3 at the main path's line-table shapes, on uniform random indices
    and on the line indices of a real 640^3 segsum step (`real`), with a
    random bf16 payload of 64 channels: bit for bit against its ordered
    plain version (segment_sum_small_ordered on copies on the CPU) and
    against a second launch, and to K3_TOL against the plain index_add_;
    timed beside the plain version and index_add_. The bound counts the
    function's bytes; `partial_bytes` are the partial tables the kernel
    writes and reads back besides."""
    import torch

    from localrf_tpu_torch.ops.kernels import segsum as k3

    cases = [(f"{n_rows} rows uniform", torch.randint(0, n_rows, (p,), generator=gen, device=dev), n_rows)
             for n_rows, p in K3_CASES]
    r_idx, r_rows = real
    if r_idx.shape[0] != K3_CASES[1][1] or r_rows != K3_CASES[1][0]:
        raise AssertionError(f"640^3 segsum step: the line sum has P {r_idx.shape[0]} on {r_rows} rows")
    cases.append((f"{r_rows} rows real step", r_idx, r_rows))
    rows = []
    for label, idx, n_rows in cases:
        p = idx.shape[0]
        g = torch.randn(p, 64, generator=gen, device=dev).to(torch.bfloat16)
        got = k3.segment_sum_small(idx, g, n_rows)
        if not torch.equal(got, k3.segment_sum_small(idx, g, n_rows)):
            raise AssertionError(f"segment_sum_small {label}: two launches differ")
        if not torch.equal(got.cpu(), k3.segment_sum_small_ordered(idx.cpu(), g.cpu(), n_rows)):
            raise AssertionError(f"segment_sum_small {label}: differs from its ordered plain version")
        want = k3.segment_sum_small_plain(idx, g, n_rows)
        err = _close(got, want, K3_TOL[0], K3_TOL[1] * float(want.abs().max()))
        plan = k3.segsum_plan(p, n_rows, 64)
        rows.append(dict(
            name="segment_sum_small", shape=f"{label}, P {p}, bf16 -> f32", main="real" in label,
            max_abs_err=0.0, index_add_err=err,
            ms=_time_ms(lambda: k3.segment_sum_small(idx, g, n_rows)),
            plain_ms=_time_ms(lambda: k3.segment_sum_small_plain(idx, g, n_rows)),
            library_ms=_index_add_ms(idx, g, n_rows), **_bound(_nbytes(idx, g, got)),
            partial_bytes=0 if plan.n_ranges == 1 else 2 * plan.n_ranges * n_rows * 64 * 4,
            n_ranges=plan.n_ranges, rows_hit=int((torch.bincount(idx, minlength=n_rows) > 0).sum()),
            # consecutive points on one row, on average
            mean_run=p / (int((idx[1:] != idx[:-1]).sum()) + 1),
        ))
    return rows


def check_k4(dev, gen) -> list[dict]:
    """K4 against its plain version at the main path's shapes."""
    import torch

    from localrf_tpu_torch.ops.kernels import march as k4
    from localrf_tpu_torch.scripts.kernel_ab import kernel_us

    rows = []

    for g_rows, p in K4_CASES:
        args, gout = march_inputs(g_rows, p, torch.bfloat16, gen, dev)
        leaves = [a for a in args if a.requires_grad]
        out_k = k4.march_core(*args, "bfloat16")
        out_p = k4.march_core_plain(*args, "bfloat16")
        err_f = _close(out_k, out_p, 0.0, K4_TOL["out"])
        grads_k = torch.autograd.grad(out_k, leaves, gout)
        grads_p = torch.autograd.grad(out_p, leaves, gout)
        err_b = 0.0
        for gk, gp in zip(grads_k, grads_p):
            if gk.dtype != gp.dtype:
                raise AssertionError(f"march_bwd: gradient dtype {gk.dtype} vs {gp.dtype}")
            err_b = max(err_b, _close(gk, gp, 0.0, K4_TOL["grad"] * float(gp.abs().max())))
        plain = [a.detach() for a in args]
        shape = f"G {g_rows}, P {p}, bf16"
        rows.append(dict(
            name="march_fwd", shape=shape, main=g_rows == 640, max_abs_err=err_f,
            ms=_time_ms(lambda: k4._launch_fwd(plain, "bfloat16"), reps=10),
            plain_ms=_time_ms(lambda: k4.march_fwd_plain(*plain, "bfloat16"), reps=5), library_ms=None,
            **_bound(_nbytes(*plain, out_k), K4_FWD_FLOP * p),
        ))
        rows.append(dict(
            name="march_bwd", shape=shape, main=g_rows == 640, max_abs_err=err_b,
            ms=_time_ms(lambda: k4._launch_bwd(plain, gout, "bfloat16"), reps=10),
            plain_ms=_time_ms(lambda: k4.march_bwd_plain(*plain, gout, "bfloat16"), reps=5),
            library_ms=None, **_bound(_nbytes(*plain, gout, *grads_k), K4_BWD_FLOP * p),
            # its MLP, factor and reduce kernels (and the wrapper's zero fills and cast)
            kernel_us=kernel_us(lambda: k4._launch_bwd(plain, gout, "bfloat16")),
        ))
        del args, grads_k, grads_p, plain
    return rows


KERNELS = {
    # name -> (source, pallas_call site of the TPU kernel it replaces)
    "fused_weights_fwd": ("localrf_tpu_torch/csrc/composite.cu",
                          "localrf_tpu/ops/pallas/composite.py:94"),
    "fused_weights_bwd": ("localrf_tpu_torch/csrc/composite.cu",
                          "localrf_tpu/ops/pallas/composite.py:120"),
    "segment_sum": ("localrf_tpu_torch/csrc/segment_sum.cu",
                    "localrf_tpu/ops/pallas/binned_scatter.py:191"),
    "segment_sum_small": ("localrf_tpu_torch/csrc/segsum_small.cu",
                          "localrf_tpu/ops/pallas/segsum.py:68"),
    "march_fwd": ("localrf_tpu_torch/csrc/march.cu", "localrf_tpu/ops/pallas/march.py:318"),
    "march_bwd": ("localrf_tpu_torch/csrc/march.cu", "localrf_tpu/ops/pallas/march.py:380"),
    "segment_sum_merged": ("localrf_tpu_torch/csrc/segment_sum_merged.cu",
                           "localrf_tpu/ops/pallas/binned_scatter.py:365"),
}
# K5 is on no training path as it runs; with every sum in a fixed order
# (deterministic_sums) it takes K2's place as the plane gathers' VJP
FIXED_ORDER = {"segment_sum": "segment_sum_merged"}
# each launch counter's kernel symbol, as a profiler trace names it
SYMBOLS = {
    "fused_weights_fwd": "composite_fwd_kernel",
    "fused_weights_bwd": "composite_bwd_kernel",
    "segment_sum": "segment_sum_tile_kernel",
    "segment_sum_small": "segsum_small_kernel",
    "march_fwd": "march_fwd_mma_kernel",
    "march_bwd": "march_bwd_mlp_mma_kernel",
    "segment_sum_merged": "merged_reduce_kernel",
}
# the kernels each training path launches (and no other)
PATH_KERNELS = {
    "default": {"fused_weights_fwd", "fused_weights_bwd", "segment_sum"},
    "fused_march": {"fused_weights_fwd", "fused_weights_bwd", "segment_sum", "march_fwd", "march_bwd"},
    "segsum": {"fused_weights_fwd", "fused_weights_bwd", "segment_sum", "segment_sum_small"},
}
PATH_TF = {"default": {}, "fused_march": {"fused_march": True}, "segsum": {"line_bwd": "segsum"}}
# paths with a sum that deterministic_sums leaves in no fixed order: no
# bit-for-bit chunk check there
UNORDERED_SUMS = {"fused_march": "K4-bwd adds the line-table gradient atomically"}


def _counters() -> list[dict]:
    from localrf_tpu_torch.ops.kernels import binned_scatter, composite, march, segsum

    return [composite.LAUNCHES, binned_scatter.LAUNCHES, segsum.LAUNCHES, march.LAUNCHES]


def _launch_counts() -> dict:
    return {k: v for counts in _counters() for k, v in counts.items()}


def _reset_launch_counts() -> None:
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def make_dataset(w: int, h: int, n_frames: int, seed: int = 0, n_init: int | None = None):
    """Random frames with depth and flow supervision, made in bulk; the
    first n_init (default all) active."""
    from localrf_tpu_torch.data.dataset import SyntheticDataset

    rng = np.random.default_rng(seed)
    shape = (n_frames, h, w)
    return SyntheticDataset(
        rng.random((*shape, 3), dtype=np.float32), "train",
        invdepths=(0.1 + 0.9 * rng.random(shape, dtype=np.float32)),
        fwd_flow=rng.normal(0, 2, (*shape, 2)).astype(np.float32), fwd_mask=np.ones(shape, np.float32),
        bwd_flow=rng.normal(0, 2, (*shape, 2)).astype(np.float32), bwd_mask=np.ones(shape, np.float32),
        n_init_frames=n_frames if n_init is None else n_init, test_frame_every=0,
    )


def full_width_config(grid: int, path: str = "default", **local_kw):
    """The default TensoRF-VM model at full width (train.py's defaults: the
    compositing kernel on, bf16 gather tables and MLP, f32 Adam moments),
    with the TensorfConfig flags of `path` (PATH_TF)."""
    from localrf_tpu_torch.models.local import LocalConfig
    from localrf_tpu_torch.models.tensorf import TensorfConfig

    tf = TensorfConfig(
        grid_size=(grid, grid, grid), pallas_composite=True,
        gather_dtype="bfloat16", mlp_dtype="bfloat16", **PATH_TF[path],
    )
    kw = dict(WH=(W, H), n_init_frames=N_FRAMES, n_views=N_VIEWS, batch_size=BATCH)
    return LocalConfig(tensorf=tf, **{**kw, **local_kw})


def _snapshot(model) -> dict:
    f = model.fields[-1]["params"]
    return {
        "basis_mat": f["basis_mat"].detach().clone(),
        "mlp.w1": f["mlp"]["w1"].detach().clone(),
        "pose_r": model._pose_dev.r.detach().clone(),
        "pose_t": model._pose_dev.t.detach().clone(),
        "exposure": model._pose_dev.exposure.detach().clone(),
    }


def _check_losses_and_updates(label: str, losses: list[dict], before: dict, model) -> None:
    """Every loss finite; the field, poses and exposures moved."""
    import torch

    for i, m in enumerate(losses):
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{label}: step {i} has a non-finite loss: {m}")
    after = _snapshot(model)
    for k in before:
        if torch.equal(before[k], after[k]):
            raise AssertionError(f"{label}: {k} did not change")


def _check_launches(label: str, launches: dict, path: str, fixed_order: bool = False) -> None:
    """The kernels of `path` launched (count > 0), no other did; with
    `fixed_order`, K5 in K2's place (FIXED_ORDER)."""
    kernels = {FIXED_ORDER.get(k, k) for k in PATH_KERNELS[path]} if fixed_order else PATH_KERNELS[path]
    for k, n in launches.items():
        if k in kernels and n <= 0:
            raise AssertionError(f"{label}: kernel {k} was not launched by the training step")
        if k not in kernels and n != 0:
            raise AssertionError(f"{label}: kernel {k} is off this path but launched {n} times")


def run_slice(label: str, model, ds, n_steps: int, path: str = "default") -> dict:
    """Drive n_steps optimizer_steps; check losses, updates, and that the
    kernels of `path` (PATH_KERNELS) launched and no other did."""
    import torch

    before = _snapshot(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    times, losses = [], []
    for _ in range(n_steps):
        batch = ds.sample(BATCH, model.is_refining, True, n_views=N_VIEWS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.optimizer_step(batch, optimize_poses=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(dict(model.last_metrics))
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    _check_losses_and_updates(label, losses, before, model)
    _check_launches(label, launches, path)
    f = model.fields[-1]
    ms = float(np.median(times))
    print(f"slice {label}: grid {f['cfg'].grid_size} occ_m {f['cfg'].occ_m} "
          f"alpha {None if f['alpha_volume'] is None else tuple(f['alpha_volume'].shape)}")
    print(f"slice {label}: step ms {[round(t, 3) for t in times]} median {ms:.3f}"
          f" peak mem {peak / 2**30:.3f} GiB launches {launches}")
    print(f"slice {label}: last losses {losses[-1]}")
    return {"ms": ms, "peak": peak, "launches": launches}


def check_small_step_against_cpu(dev, path: str = "default") -> None:
    """Losses and gradients of one training step on a small field, on the
    card (kernels) and on the CPU (plain versions), from the same weights,
    batch and noise: without an alpha volume (dense march) and with a ball
    alpha volume (coarse probe + compaction), with the flags of `path`.
    f32 tables and MLP; gradients agree to 1e-3 of their largest entry
    (atomic-add order on the card)."""
    import torch

    from localrf_tpu_torch.models.local import LocalConfig, LocalTensorfs
    from localrf_tpu_torch.models.step import loss_grads
    from localrf_tpu_torch.models.tensorf import TensorfConfig, TensorfField

    w, h = 96, 64
    ds = make_dataset(w, h, 4, seed=1)
    tf = TensorfConfig(grid_size=(32, 32, 32), pallas_composite=True, binned_min_rows=500,
                       **PATH_TF[path])
    cfg = LocalConfig(WH=(w, h), n_init_frames=4, n_views=4, batch_size=512, occ_min=8, tensorf=tf)
    _reset_launch_counts()
    gpu = LocalTensorfs(cfg, device=dev)
    cpu = LocalTensorfs(cfg, device="cpu")
    cpu.fields[-1]["params"] = TensorfField(
        {k: p.detach().cpu() for k, p in gpu.fields[-1]["params"].named_parameters()})
    noise = gpu._next_noise(tf)
    batch = ds.sample(512, True, True, n_views=4)
    ax = torch.linspace(-1, 1, 16)
    zz, yy, xx = torch.meshgrid(ax, ax, ax, indexing="ij")
    ball = ((xx**2 + yy**2 + zz**2) < 0.6**2).to(torch.float32)
    for label, alpha in (("dense", None), ("probe", ball)):
        out = []
        for m in (gpu, cpu):
            m.is_refining = True
            m.rf_iter[-1] = 2
            f = m.fields[-1]
            f["alpha_volume"] = None if alpha is None else alpha.to(m.device)
            f["cfg"] = dataclasses.replace(f["cfg"], occ_m=m._occ_m(f["cfg"], alpha is not None))
            g_field, g_pose, _, metrics = loss_grads(
                f["params"], m._pose_dev, m.intr.params, m._statics(True),
                m._device_batch(batch), m._scalars_py(),
                {k: v.to(m.device) for k, v in noise.items()}, f["alpha_volume"],
            )
            grads = {**g_field, "r": g_pose[0], "t": g_pose[1], "exposure": g_pose[2]}
            out.append(({k: float(v) for k, v in metrics.items()},
                        {k: v.detach().float().cpu() for k, v in grads.items()}))
        (m_gpu, g_gpu), (m_cpu, g_cpu) = out
        for k in m_cpu:
            if not np.isclose(m_gpu[k], m_cpu[k], rtol=1e-4, atol=1e-6):
                raise AssertionError(f"small step {label}: {k} card {m_gpu[k]} vs cpu {m_cpu[k]}")
        worst = 0.0
        for k in g_cpu:
            scale = float(g_cpu[k].abs().max()) + 1e-12
            rel = float((g_gpu[k] - g_cpu[k]).abs().max()) / scale
            worst = max(worst, rel)
            if rel > 1e-3:
                raise AssertionError(f"small step {label}: grad {k} off by {rel:.2e} of max")
        print(f"small step card vs cpu ({path}, {label}, occ_m {gpu.fields[-1]['cfg'].occ_m}):"
              f" total_loss {m_gpu['total_loss']:.6f} vs {m_cpu['total_loss']:.6f},"
              f" worst grad err {worst:.2e} of max")
    missing = [k for k, n in _launch_counts().items() if k in PATH_KERNELS[path] and n <= 0]
    if missing:
        raise AssertionError(f"small step ({path}): kernels {missing} did not launch on the card")


def _with_ball(model, dev) -> None:
    """Put a ~8% ball alpha volume at half the grid (320^3 at 640^3) on the
    model's current field, past the schedule's rescale (rf_iter 10): coarse
    probe + compaction to 332 samples per ray at 640^3."""
    import torch

    model.is_refining = True
    model.rf_iter[-1] = 10
    model.lr_factor = 0.999
    f = model.fields[-1]
    ax = torch.linspace(-1, 1, f["cfg"].grid_size[0] // 2, device=dev)
    zz, yy, xx = torch.meshgrid(ax, ax, ax, indexing="ij")
    f["alpha_volume"] = ((xx**2 + yy**2 + zz**2) < 0.535**2).to(torch.float32)
    f["cfg"] = dataclasses.replace(f["cfg"], occ_m=model._occ_m(f["cfg"], True))
    if f["cfg"].occ_m != 332:
        raise AssertionError(f"640^3 field: occ_m {f['cfg'].occ_m}, expected 332")


def model_640(dev, path: str, **local_kw):
    """The full-width model at 640^3 with a ~8% ball alpha volume at 320^3
    (coarse probe + compaction to 332 samples per ray), the flags of
    `path`, past the schedule's rescale (rf_iter 10)."""
    from localrf_tpu_torch.models.local import LocalTensorfs

    model = LocalTensorfs(full_width_config(640, path, **local_kw), device=dev)
    _with_ball(model, dev)
    return model


def slice_640(ds, dev, path: str) -> dict:
    """3 eager steps at 640^3 (model_640)."""
    return run_slice(f"640^3 {path}", model_640(dev, path), ds, 3, path)


def _run_chunk(model, batches) -> float:
    """One run_chunk; host ms, ending after the card has finished."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.run_chunk(batches, optimize_poses=True)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _step_losses(model) -> list[dict]:
    m = model.chunk_metrics
    return [{k: float(v[i]) for k, v in m.items()} for i in range(len(m["total_loss"]))]


@contextlib.contextmanager
def deterministic_sums():
    """Every sum of the training step in a fixed order: torch's
    deterministic algorithms (index_add_ and index_put_ by sort) and the
    plane gathers' VJP through K5 (K2's function, sorted, no atomics) in
    place of K2's atomic adds."""
    import torch

    from localrf_tpu_torch.ops.kernels import binned_scatter as k2

    prev = torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()
    segment_sum = k2.segment_sum
    k2.segment_sum = k2.binned_segment_sum_merged
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        k2.segment_sum = segment_sum
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def _state(model) -> dict:
    """The model's trained state: field parameters and Adam state, pose
    window with its Adam state."""
    f = model.fields[-1]
    out = dict(f["params"].named_parameters())
    opt = f["opt"]
    out.update({f"m.{k}": v for k, v in opt.m.items()})
    out.update({f"v.{k}": v for k, v in opt.v.items()})
    out.update(step=opt.step, lr_scale=opt.lr_scale)
    for name, val in model._pose_dev._asdict().items():
        if isinstance(val, tuple):
            out.update({f"{name}.{i}": x for i, x in enumerate(val)})
        else:
            out[name] = val
    return out


def _bits_equal(a, b) -> bool:
    """Equal bit for bit, NaN included (the pose window's padding rows are
    never read and turn NaN, as in the JAX package: their gradient through
    sixD_to_mtx of zeros is NaN, and a gate of 0 times NaN stays NaN)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        as_int = {4: torch.int32, 2: torch.int16}[a.element_size()]
        a, b = a.reshape(-1).view(as_int), b.reshape(-1).view(as_int)
    return torch.equal(a, b)


def _plan(ds, model) -> tuple[list, dict]:
    """The model's next chunk plan (CHUNK joint steps) and the state of the
    dataset's draws before it."""
    state = ds._rng.bit_generator.state
    batches = model.plan_chunk(ds, True, CHUNK)
    if len(batches) != CHUNK or any(b["train_test_poses"] for b in batches):
        raise AssertionError(f"expected {CHUNK} joint steps in the chunk, got {len(batches)}")
    return batches, state


def _replan(ds, state: dict, twin, batches: list) -> list:
    """The twin's plan from the same draws as `batches` (with pixel values
    when the twin has no pool)."""
    after = ds._rng.bit_generator.state
    ds._rng.bit_generator.state = state
    twin_batches = twin.plan_chunk(ds, True, CHUNK)
    ds._rng.bit_generator.state = after
    for b, tb in zip(batches, twin_batches, strict=True):
        np.testing.assert_array_equal(b["idx"], tb["idx"])
    return twin_batches


def chunk_bit_exact(label: str, make, ds, path: str) -> tuple[int, dict]:
    """Under deterministic_sums, a pooled chunk of CHUNK replayed graphs of
    a model from make(True) equals the same steps taken eagerly by a twin
    from make(False), bit for bit: every loss of every step, then every
    tensor of _state. The launch counts of the chunk (warm-up and capture)
    and of the twin's steps are read apart, each right after its own run,
    and each must show K5 in K2's place on `path`. Returns the number of
    tensors compared and the chunk's counts."""
    import torch

    with deterministic_sums():
        model, twin = make(True), make(False)
        batches, state = _plan(ds, model)
        twin_batches = _replan(ds, state, twin, batches)
        _reset_launch_counts()
        _run_chunk(model, batches)
        launches = _launch_counts()
        _check_launches(f"{label} (fixed-order sums)", launches, path, fixed_order=True)
        got = model.chunk_metrics
        _reset_launch_counts()
        for i, b in enumerate(twin_batches):
            twin.optimizer_step(b, optimize_poses=True)
            for k, v in twin.last_metrics.items():
                if float(got[k][i]) != v:
                    raise AssertionError(f"{label} (fixed-order sums): step {i} {k}:"
                                         f" graph {float(got[k][i])!r} vs eager {v!r}")
        _check_launches(f"{label} (fixed-order sums) eager twin", _launch_counts(), path, fixed_order=True)
        mine, theirs = _state(model), _state(twin)
        differ = [k for k in theirs if not _bits_equal(mine[k], theirs[k])]
        if differ or mine.keys() != theirs.keys():
            raise AssertionError(f"{label} (fixed-order sums): graph and eager state differ in {differ}")
        model.drop_graphs()  # captured with K5 in the step
    del model, twin
    torch.cuda.empty_cache()
    return len(mine), launches


def chunk_against_eager(label: str, model, make_twin, ds, path: str) -> dict:
    """The model's next chunk (its graphs captured in it) against the same
    batches as eager optimizer_steps of a twin made by make_twin() from the
    same initial state (same config and seed), to CHUNK_TOL. The launch
    counts of the chunk (warm-up and capture; replays call no wrapper) and
    of the twin's steps are read apart, each right after its own run, and
    the twin's are checked against `path`. Returns the chunk's host ms and
    peak allocated bytes, the worst relative rgb_loss difference and the
    chunk's launch counts."""
    import torch

    batches, state = _plan(ds, model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    ms = _run_chunk(model, batches)
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    got = _step_losses(model)
    twin = make_twin()
    twin_batches = _replan(ds, state, twin, batches)
    _reset_launch_counts()
    worst = 0.0
    for i, b in enumerate(twin_batches):
        twin.optimizer_step(b, optimize_poses=True)
        for k, v in twin.last_metrics.items():
            rtol = CHUNK_TOL["first" if i == 0 else "rgb" if k == "rgb_loss" else "other"]
            err = abs(got[i][k] - v)
            if k == "rgb_loss":
                worst = max(worst, err / (abs(v) + 1e-7))
            if not err <= rtol * abs(v) + 1e-7:
                raise AssertionError(f"{label}: step {i} {k}: graph {got[i][k]} vs eager {v}")
    _check_launches(f"{label} eager twin", _launch_counts(), path)
    del twin
    torch.cuda.empty_cache()
    return {"capture_ms": ms, "peak": peak, "worst_rel": worst, "launches": launches}


def profile_chunk(model, batches) -> dict:
    """One chunk under torch.profiler (profile_run)."""
    return profile_run(lambda: _run_chunk(model, batches))


def profile_run(run) -> dict:
    """run() (which returns its host ms, ending after the card finished)
    under torch.profiler: the kernels each graph launch ran (a kernel of a
    graph carries its cudaGraphLaunch's correlation id), the card's busy
    time (the union of its kernel and copy intervals), and the host time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms = run()
    events = prof.profiler.kineto_results.events()
    launches = sorted((e for e in events if e.name() == "cudaGraphLaunch"), key=lambda e: e.start_ns())
    step_of = {e.correlation_id(): k for k, e in enumerate(launches)}
    per_step = [collections.Counter() for _ in launches]
    outside = collections.Counter()
    ns_by_name = collections.Counter()
    spans = []
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        spans.append((e.start_ns(), e.end_ns()))
        ns_by_name[e.name()] += e.duration_ns()
        k = step_of.get(e.correlation_id())
        (outside if k is None else per_step[k])[e.name()] += 1
    busy, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    span_ns = max(b for _, b in spans) - min(a for a, _ in spans) if spans else 0
    return {"wall_ms": wall_ms, "busy_ms": busy / 1e6, "device_span_ms": span_ns / 1e6,
            "per_step": per_step, "outside": outside, "ns_by_name": ns_by_name}


def _kernels_in(counter, key: str) -> int:
    return sum(n for name, n in counter.items() if SYMBOLS[key] in name)


def check_replay_trace(label: str, trace: dict, path: str, n_steps: int) -> dict:
    """The traced chunk made one graph launch per step; its replays ran
    every kernel of `path` and no kernel of another path, and no kernel of
    ours ran outside a replay. Every replay of one graph runs the same
    kernels, so a step whose trace holds fewer kernels than the fullest one
    lost records in the profiler (seen on the card: a few hundred of ~3,000
    in some steps); each complete step must hold every kernel of `path`.
    Returns {kernel: count in the trace's replays}."""
    per_step = trace["per_step"]
    if len(per_step) != n_steps:
        raise AssertionError(f"{label}: {len(per_step)} graph launches for {n_steps} steps")
    total = sum(per_step, collections.Counter())
    for key in SYMBOLS:
        n = _kernels_in(total, key)
        if key in PATH_KERNELS[path] and n < 1:
            raise AssertionError(f"{label}: the replays ran no {SYMBOLS[key]}")
        if key not in PATH_KERNELS[path] and n != 0:
            raise AssertionError(f"{label}: the replays ran {SYMBOLS[key]}, off this path")
        if _kernels_in(trace["outside"], key):
            raise AssertionError(f"{label}: {SYMBOLS[key]} ran outside a graph replay")
    sizes = [sum(c.values()) for c in per_step]
    complete = [k for k, n in enumerate(sizes) if n == max(sizes)]
    for k in complete:
        missing = [SYMBOLS[key] for key in PATH_KERNELS[path] if not _kernels_in(per_step[k], key)]
        if missing:
            raise AssertionError(f"{label}: step {k}'s replay ran no {missing}")
    trace["complete_steps"] = len(complete)
    return {key: _kernels_in(total, key) for key in SYMBOLS}


def run_chunks(label: str, make, ds, path: str, model=None) -> tuple[dict, object]:
    """The chunk path on `path`, models from make(with_pool): a chunk held
    bit for bit against eager steps under fixed-order sums
    (chunk_bit_exact; not on UNORDERED_SUMS paths); then, on the path as it
    runs, a pooled model's (`model`, by default make(True)) first
    chunk (captures) against a twin's eager steps (chunk_against_eager),
    N_TIMED timed chunks and one chunk under the profiler. Checks losses,
    updates, the first chunk's launch counts, and that no chunk after the
    first captured or called a kernel wrapper (every step a replay).
    Returns (results, the pooled model)."""
    import torch

    n_exact, exact_launches = (0, {}) if path in UNORDERED_SUMS else chunk_bit_exact(label, make, ds, path)
    model = make(True) if model is None else model
    graphs = model._graphs
    before = _snapshot(model)
    first = chunk_against_eager(label, model, lambda: make(False), ds, path)
    launches = first["launches"]
    n_graphs = len(graphs)
    losses = _step_losses(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    captures = graphs.captures
    _reset_launch_counts()
    times = []
    for _ in range(N_TIMED):
        times.append(_run_chunk(model, model.plan_chunk(ds, True, CHUNK)) / CHUNK)
        losses += _step_losses(model)
    batches = model.plan_chunk(ds, True, CHUNK)
    trace = profile_chunk(model, batches)
    losses += _step_losses(model)
    peak = max(first["peak"], torch.cuda.max_memory_allocated())
    reserved = torch.cuda.memory_reserved()
    if graphs.captures != captures or any(_launch_counts().values()):
        raise AssertionError(f"{label}: a chunk after the first captured or launched eagerly "
                             f"({graphs.captures - captures} captures, {_launch_counts()})")
    _check_launches(label, launches, path)
    _check_losses_and_updates(label, losses, before, model)
    replayed = check_replay_trace(label, trace, path, len(batches))
    ms = float(np.median(times))
    idle = 1.0 - trace["busy_ms"] / trace["wall_ms"]
    gaps = 1.0 - trace["busy_ms"] / trace["device_span_ms"]
    step0 = {SYMBOLS[k]: _kernels_in(trace["per_step"][0], k) for k in SYMBOLS
             if _kernels_in(trace["per_step"][0], k)}
    n_kernels = [sum(c.values()) for c in trace["per_step"]]
    f = model.fields[-1]
    print(f"chunk {label}: not compared bit for bit ({UNORDERED_SUMS[path]})" if path in UNORDERED_SUMS
          else f"chunk {label}: with fixed-order sums, graph and eager equal bit for bit over"
               f" {CHUNK} steps (every loss, {n_exact} state tensors; launches {exact_launches})")
    print(f"chunk {label}: grid {f['cfg'].grid_size} occ_m {f['cfg'].occ_m}, {n_graphs} graph(s)"
          f" captured in the first chunk ({first['capture_ms']:.1f} ms for {CHUNK} steps, warm-up and"
          f" capture included; launches {launches}); graph vs eager: worst relative rgb_loss"
          f" difference {first['worst_rel']:.3e}")
    print(f"chunk {label}: ms/step of {N_TIMED} timed chunks {[round(t, 3) for t in times]} median"
          f" {ms:.3f} (spread {max(times) - min(times):.3f}); profiled chunk"
          f" {trace['wall_ms'] / CHUNK:.3f} ms/step host, {trace['busy_ms'] / CHUNK:.3f} busy on the"
          f" card: idle share {idle:.3f} ({gaps:.3f} inside the card's span)")
    print(f"chunk {label}: replayed step 0 ran {n_kernels[0]} kernels, ours {step0}; kernels per"
          f" step {min(n_kernels)}..{max(n_kernels)} ({trace['complete_steps']} of {CHUNK} steps"
          f" with all {max(n_kernels)} in the trace); peak allocated {peak / 2**30:.3f} GiB,"
          f" reserved {reserved / 2**30:.3f} GiB")
    top = "; ".join(f"{name.removeprefix('void ')[:100]} {ns / 1e6 / CHUNK:.3f}"
                    for name, ns in trace["ns_by_name"].most_common(8))
    print(f"chunk {label}: card ms/step by kernel, largest first: {top}")
    print(f"chunk {label}: last losses {losses[-1]}")
    return {"ms": ms, "ms_all": times, "idle": idle, "device_gaps": gaps, "peak": peak,
            "reserved": reserved, "graphs": n_graphs, "captures": graphs.captures,
            "launches": launches, "replayed": replayed, "capture_ms": first["capture_ms"],
            "worst_rel": first["worst_rel"], "bit_exact_tensors": n_exact,
            "exact_launches": exact_launches, "trace": trace}, model


def chunk_64(ds, dev, pool) -> dict:
    """The chunk path at 64^3 (dense march): run_chunks, then a chunk that
    ends in an alpha refresh (the graphs are dropped) and one captured again
    after it (the probe + compaction key)."""
    from localrf_tpu_torch.models.local import LocalTensorfs

    # from rf_iter 2 in chunks of 16: run_chunks trains N_TIMED + 2 chunks,
    # the refresh follows the last step of the chunk after those
    cfg = full_width_config(64, update_AlphaMask_list=[2 + (N_TIMED + 3) * CHUNK - 1])

    def make(with_pool: bool):
        m = LocalTensorfs(cfg, device=dev)
        m.is_refining = True
        m.rf_iter[-1] = 2  # past the schedule rescale at rf_iter 1
        if with_pool:
            m.attach_pool(pool)
        return m

    out, model = run_chunks("64^3", make, ds, "default")
    _reset_launch_counts()
    _run_chunk(model, model.plan_chunk(ds, True, CHUNK))
    f = model.fields[-1]
    if f["alpha_volume"] is None or len(model._graphs):
        raise AssertionError("64^3 chunks: the alpha refresh did not happen or kept the graphs")
    captures = model._graphs.captures
    _run_chunk(model, model.plan_chunk(ds, True, CHUNK))
    if model._graphs.captures <= captures or not np.isfinite(model.chunk_metrics["total_loss"]).all():
        raise AssertionError("64^3 chunks: no capture, or a non-finite loss, after the refresh")
    _check_launches("64^3 chunks after the refresh", _launch_counts(), "default")
    print(f"chunk 64^3: after the alpha refresh occ_m {f['cfg'].occ_m}, {len(model._graphs)}"
          f" graph(s), last losses {_step_losses(model)[-1]}")
    out["captures"] = model._graphs.captures
    return out


def chunk_640(ds, dev, pool, path: str) -> dict:
    """The chunk path at 640^3 (model_640) on `path`."""

    def make(with_pool: bool):
        m = model_640(dev, path)
        if with_pool:
            m.attach_pool(pool)
        return m

    out, model = run_chunks(f"640^3 {path}", make, ds, path)
    del model
    return out


# the spawn and eval phase: SPAWN_FRAMES frames, the first SPAWN_INIT
# active; SPAWN_ADDED appended one at a time before the spawn (a chunk of
# SPAWN_PRE_STEPS steps after each), the spawn cross-fading over them, and
# SPAWN_AFTER appended after it (linked to the new field)
SPAWN_FRAMES, SPAWN_INIT, SPAWN_ADDED, SPAWN_AFTER, SPAWN_PRE_STEPS = 12, 5, 4, 2, 4
# the retiring field's grid (the run's grid after its upsamples) and the run's
# initial grid, which the new field starts from
SPAWN_GRIDS = (640, 64)
# an eval frame against the same frame rendered with the plain compositing:
# rgb to K1_TOL's rtol and 1e-4 absolute, depth to K1_TOL's rtol and 1e-4
# of its largest value (a K1 fault moves a weight by O(1)); against the sum
# over fields of w_k * render_frame_k (the same kernels in the same order),
# 1e-6
EVAL_TOL = (K1_TOL["fwd"][0], 1e-4)
SUM_TOL = (1e-6, 1e-6)


def graph_pool_bytes() -> int:
    """Bytes the caching allocator holds in private pools: those of captured
    CUDA graphs (the default pool is (0, 0))."""
    import torch

    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def _memory(label: str) -> dict:
    import torch

    torch.cuda.synchronize()
    out = {"allocated": torch.cuda.memory_allocated(), "reserved": torch.cuda.memory_reserved(),
           "peak": torch.cuda.max_memory_allocated(), "graph_pool": graph_pool_bytes()}
    print(f"memory {label}: " + ", ".join(f"{k} {v / 2**30:.3f} GiB" for k, v in out.items()))
    return out


def clone_model(model, dev, pool=None):
    """A twin of `model` in the same state (fields, pose window and its Adam
    state, intrinsics, schedule, noise generator) with graphs of its own,
    `pool` attached (or none); the retired fields' host parameters and alpha
    volumes are shared (read only)."""
    import copy

    import torch

    from localrf_tpu_torch.models.graph import ChunkGraphs

    shared = [model.pool, model._graphs, model._gen]
    for f in model.fields[:-1]:
        shared += [f["params"], f["alpha_volume"]]
    twin = copy.deepcopy(model, {id(x): x for x in shared if x is not None})
    twin._gen = torch.Generator(device=dev)
    twin._gen.set_state(model._gen.get_state())
    twin._graphs = ChunkGraphs(dev) if torch.device(dev).type == "cuda" else None
    twin.pool = None
    if pool is not None:
        twin.attach_pool(pool)
    return twin


@contextlib.contextmanager
def _field_cfgs(model, **kw):
    """Every field's TensorfConfig with `kw` replaced, restored after."""
    saved = [f["cfg"] for f in model.fields]
    for f in model.fields:
        f["cfg"] = dataclasses.replace(f["cfg"], **kw)
    try:
        yield
    finally:
        for f, cfg in zip(model.fields, saved):
            f["cfg"] = cfg


def _eval(model, ids, views, counts: dict | None, **kw) -> tuple:
    """forward_eval of `ids` in `views` at 960x540 with train.py's chunk
    (the batch size), host ms ending after the card finished. With
    `counts`, this is the main path: the launch counts are set to 0 just
    before and its own are added to `counts` (and returned)."""
    import torch

    torch.cuda.synchronize()
    _reset_launch_counts()
    t0 = time.perf_counter()
    rgb, depth, _, _ = model.forward_eval(ids, np.asarray(views), W, H, chunk=BATCH, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = _launch_counts()
    if counts is not None:
        for k, n in launches.items():
            counts[k] = counts.get(k, 0) + n
    if not (torch.isfinite(rgb).all() and torch.isfinite(depth).all()):
        raise AssertionError(f"eval of views {list(views)}: non-finite output")
    if float(rgb.min()) < 0 or float(rgb.max()) > 1:
        raise AssertionError(f"eval of views {list(views)}: rgb outside [0, 1]")
    return rgb, depth, ms, launches


def _expect_launches(label: str, launches: dict, want: dict) -> None:
    """Exactly `want` launches of each kernel ({} = none of any)."""
    got = {k: n for k, n in launches.items() if n}
    if got != want:
        raise AssertionError(f"{label}: kernel launches {got}, expected {want}")


def _blend_of_fields(model, view: int) -> tuple:
    """The frame of `view` as the sum over its fields of w_k *
    render_frame_k (the chunk forward_eval gives each field, the last chunk
    padded with ray id 0), then exposed and clipped like forward_eval."""
    import torch

    from localrf_tpu_torch.models.step import render_frame

    dev = model.device
    bw = model.blending_weights[view]
    fields = [k for k in range(len(model.fields)) if bw[k] != 0]
    chunk = BATCH // len(fields)
    n, n_chunks = W * H, -(-W * H // chunk)
    ids = torch.cat([torch.arange(n, device=dev), torch.zeros(n_chunks * chunk - n, dtype=torch.int64,
                                                               device=dev)]).reshape(n_chunks, chunk)
    c2w = model.get_cam2world([view])[0]
    rgb = torch.zeros((n, 3), device=dev)
    depth = torch.zeros((n,), device=dev)
    for k in fields:
        f = model.fields[k]
        c2rf = c2w.copy()
        c2rf[:3, 3] += model.world2rf[k]
        r, d = render_frame(
            model._eval_params(f), f["cfg"], ids, torch.from_numpy(c2rf).to(dev),
            torch.tensor(model.focal(W), dtype=torch.float32, device=dev),
            torch.from_numpy(model.center(W, H)).to(dev), w=W, h=H,
            refine=1.0 if model.is_refining else 0.0, alpha_volume=f["alpha_volume"],
        )
        rgb += r[:n] * float(bw[k])
        depth += d[:n] * float(bw[k])
    exposure = torch.from_numpy(model.exp_all[view]).to(dev)
    return torch.clamp(rgb @ exposure.T, 0.0, 1.0), depth


def _frame_metrics(rgb, ds, view: int) -> tuple[float, float]:
    """PSNR and SSIM of a rendered frame against the dataset's frame, on the
    card (the data is random: the values show only that the metrics run)."""
    import torch

    from localrf_tpu_torch.utils.metrics import rgb_psnr, rgb_ssim

    gt = torch.from_numpy(ds._src["rgbs"][view]).to(rgb.device)
    img = rgb.reshape(H, W, 3)
    return rgb_psnr(img, gt), rgb_ssim(img, gt, 1.0)


def spawn_and_eval(dev) -> tuple[dict, dict]:
    """The spawn and eval phase (module docstring, 7): field 0 at 640^3
    trains through frame appends, field 1 spawns, the window slides, field 1
    trains in chunks (run_chunks), then blended eval frames. Returns (the
    post-spawn chunk results, the eval frames' launch counts)."""
    import torch

    from localrf_tpu_torch.data.pool import DevicePixelPool
    from localrf_tpu_torch.models.local import LocalTensorfs
    from localrf_tpu_torch.models.tensorf import init_tensorf
    from localrf_tpu_torch.optim import pytree_adam_init

    ds = make_dataset(W, H, SPAWN_FRAMES, seed=3, n_init=SPAWN_INIT)
    pool = DevicePixelPool(ds, capacity=POOL_SLOTS, device=dev)
    model = LocalTensorfs(full_width_config(SPAWN_GRIDS[1], n_init_frames=SPAWN_INIT), device=dev)
    f0 = model.fields[0]  # the retiring field: the run's 64^3 grid upsampled to 640^3
    f0["cfg"] = f0["cfg"].with_grid((SPAWN_GRIDS[0],) * 3)
    f0["params"] = init_tensorf(f0["cfg"], model._gen, dev)
    f0["opt"] = pytree_adam_init(f0["params"], model.cfg.moment_dtype)
    _with_ball(model, dev)
    model.attach_pool(pool)

    def pre_spawn_chunk():
        _run_chunk(model, model.plan_chunk(ds, True, SPAWN_PRE_STEPS))
        if not np.isfinite(model.chunk_metrics["total_loss"]).all():
            raise AssertionError(f"spawn: non-finite loss on field 0 {model.chunk_metrics}")

    pre_spawn_chunk()
    for _ in range(SPAWN_ADDED):
        model.append_frame()
        ds.activate_frames()
        pool.sync()
        pre_spawn_chunk()
    mem = {"before": _memory("spawn: before it (field 0 at 640^3 with its graphs)")}
    if not mem["before"]["graph_pool"]:
        raise AssertionError("spawn: no graph memory before the spawn")
    f0_bytes = _nbytes(*f0["params"].parameters(), *f0["opt"].m.values(), *f0["opt"].v.values())
    captures = model._graphs.captures

    model.append_rf(SPAWN_ADDED)
    first = int(np.argmax(model.blending_weights[:, -1] > 0))
    ds.deactivate_frames(first)
    model.set_window_start(first)
    pool.sync()
    retired = model.fields[0]
    if retired["opt"] is not None or any(p.device.type != "cpu" for p in retired["params"].parameters()):
        raise AssertionError("spawn: field 0's params are not on the host, or it kept its optimizer")
    if len(model._graphs):
        raise AssertionError("spawn: the graphs were not dropped")
    host = {k: p.detach().clone() for k, p in retired["params"].named_parameters()}
    for _ in range(SPAWN_AFTER):
        model.append_frame()
        ds.activate_frames()
        pool.sync()
    gate = model._gate()[: model.win_len]
    if model.pose_linked_rf[-SPAWN_AFTER:] != [1] * SPAWN_AFTER or gate.tolist() != (
            [False] * (model.win_len - SPAWN_AFTER) + [True] * SPAWN_AFTER):
        raise AssertionError(f"spawn: links {model.pose_linked_rf}, gate {gate.tolist()}")
    if sorted(pool.slot_of_frame) != list(range(first, model.n_frames)):
        raise AssertionError(f"spawn: pool holds frames {sorted(pool.slot_of_frame)}")
    print(f"spawn: field 1 over the last {SPAWN_ADDED} of {first + SPAWN_ADDED} frames, blending"
          f" weights {model.blending_weights[:, 1].tolist()}, window from frame {model.win_start},"
          f" links {model.pose_linked_rf}, world2rf {model.world2rf[1].tolist()}")
    # field 0's params and Adam moments left the card; its graphs' pool is
    # cached by the allocator (free, reused on demand) until empty_cache
    mem["after"] = _memory("spawn: after it (field 0 on the host, graphs dropped)")
    freed = mem["before"]["allocated"] - mem["after"]["allocated"]
    if freed < f0_bytes - 2**26:
        raise AssertionError(f"spawn: {freed} bytes freed, field 0 held {f0_bytes} on the card")
    torch.cuda.empty_cache()
    mem["emptied"] = _memory("spawn: after it and empty_cache")
    # cuBLAS keeps a workspace per stream: the capture stream's was taken
    # from the graphs' pool, and nothing else may hold it
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    mem["no_workspaces"] = _memory("spawn: after it, cuBLAS's workspaces cleared")
    if mem["no_workspaces"]["graph_pool"]:
        raise AssertionError("spawn: the dropped graphs' pool is still held")
    torch.cuda.reset_peak_memory_stats()

    # field 1 (64^3, dense march) in chunks: twins from a frozen copy of
    # the post-spawn state
    frozen = clone_model(model, dev)
    out, model = run_chunks("spawn: field 1 at 64^3", lambda with_pool: clone_model(
        frozen, dev, pool if with_pool else None), ds, "default", model=model)
    del frozen
    if model._graphs.captures <= captures:
        raise AssertionError("spawn: no graph captured after the spawn")
    mem["chunks"] = _memory("spawn: after field 1's chunks (with its graphs)")
    for k, p in retired["params"].named_parameters():
        if not torch.equal(p, host[k]):
            raise AssertionError(f"spawn: field 0's host {k} changed")
    out["memory"] = mem
    model.drop_graphs()
    torch.cuda.empty_cache()

    # eval frames of 960x540
    bw = model.blending_weights
    v_blend = int(np.argmin(np.abs(bw[:, 1] - 0.5)))
    v_old, v_new = first // 2, model.n_frames - 1
    if not (0 < bw[v_blend]).all() or not (bw[v_blend] < 1).all() or bw[v_old, 1] or bw[v_new, 0]:
        raise AssertionError(f"spawn: no blended frame, or a frame of one field, in {bw.tolist()}")
    ids = np.arange(W * H)
    counts: dict = {}
    frames = {}
    alloc0 = torch.cuda.memory_allocated()
    rgb_b, depth_b, frames["blended"], lb = _eval(model, ids, [v_blend], counts)
    _expect_launches("eval blended", lb, {"fused_weights_fwd": 2 * -(-W * H // (BATCH // 2))})
    with _field_cfgs(model, pallas_composite=False):
        rgb_p, depth_p, _, lp = _eval(model, ids, [v_blend], None)
    _expect_launches("eval blended, plain compositing", lp, {})
    err_plain = (_close(rgb_b, rgb_p, *EVAL_TOL),
                 _close(depth_b, depth_p, EVAL_TOL[0], EVAL_TOL[1] * float(depth_p.abs().max())))
    rgb_s, depth_s = _blend_of_fields(model, v_blend)
    err_sum = (_close(rgb_b, rgb_s, *SUM_TOL), _close(depth_b, depth_s, SUM_TOL[0], SUM_TOL[1]))
    rgb_o, depth_o, frames["field 0"], lo = _eval(model, ids, [v_old], counts)
    _expect_launches("eval field 0", lo, {"fused_weights_fwd": -(-W * H // BATCH)})
    trace = profile_run(lambda: _eval(model, ids, [v_old], None)[2])
    top = "; ".join(f"{name.removeprefix('void ')[:80]} {ns / 1e6:.1f}"
                    for name, ns in trace["ns_by_name"].most_common(6))
    print(f"eval field 0, profiled: {trace['wall_ms']:.1f} ms host, {trace['busy_ms']:.1f} busy on the"
          f" card: idle share {1 - trace['busy_ms'] / trace['wall_ms']:.3f}; card ms by kernel: {top}")
    sub = np.random.default_rng(0).choice(W * H, BATCH // 2, replace=False)
    rgb_m, depth_m, frames["render_chunk, 2 views"], lm = _eval(
        model, np.concatenate([sub, sub]), [v_blend, v_old], counts)
    _expect_launches("eval 2 views", lm, {"fused_weights_fwd": 2 * -(-BATCH // (BATCH // 2))})
    sub_t = torch.from_numpy(sub).to(dev)
    err_multi = max(_close(rgb_m, torch.cat([rgb_b[sub_t], rgb_o[sub_t]]), *EVAL_TOL),
                    _close(depth_m, torch.cat([depth_b[sub_t], depth_o[sub_t]]), EVAL_TOL[0],
                           EVAL_TOL[1] * float(depth_b.abs().max())))
    rgb_f, _, frames["floater 0.5"], lf = _eval(model, ids, [v_new], counts, floater_thresh=0.5)
    _expect_launches("eval floater_thresh", lf, {})
    cached = torch.cuda.memory_allocated()
    del rgb_p, depth_p, rgb_s, depth_s
    model.clear_eval_cache()
    cleared = torch.cuda.memory_allocated()
    for label, rgb, view in (("blended", rgb_b, v_blend), ("field 0", rgb_o, v_old),
                             ("floater 0.5", rgb_f, v_new)):
        psnr, ssim = _frame_metrics(rgb, ds, view)
        print(f"eval {label} (frame {view}, weights {bw[view].tolist()}): {frames[label]:.1f} ms,"
              f" PSNR {psnr:.3f} SSIM {ssim:.4f} against the random frame")
    print(f"eval render_chunk over frames {v_blend} and {v_old} ({BATCH // 2} pixels each):"
          f" {frames['render_chunk, 2 views']:.1f} ms, max err against the frames {err_multi:.3e}")
    print(f"eval blended: max err against the plain compositing rgb {err_plain[0]:.3e} depth"
          f" {err_plain[1]:.3e}; against the sum over fields of w_k * render_frame_k rgb {err_sum[0]:.3e}"
          f" depth {err_sum[1]:.3e}")
    print(f"eval memory: allocated {alloc0 / 2**30:.3f} GiB before the frames, {cached / 2**30:.3f} with"
          f" field 0 cached, {cleared / 2**30:.3f} after clear_eval_cache; launches {counts}")
    out["eval"] = {"ms": frames, "cache_bytes": cached - cleared, "err_plain": err_plain,
                   "err_sum": err_sum, "err_multi": err_multi,
                   "field0_idle": 1 - trace["busy_ms"] / trace["wall_ms"]}
    del model, pool
    torch.cuda.empty_cache()
    return out, counts


def fused_eval(dev) -> dict:
    """One 960x540 eval frame of model_640 on the fused march (K4-fwd and
    K1-fwd a chunk) against the same frame with the fused march off, rgb to
    K4_TOL["out"] and depth to K4_TOL["out"] of itself. Returns the frame's
    launch counts."""
    import torch

    model = model_640(dev, "fused_march")
    ids = np.arange(W * H)
    counts: dict = {}
    rgb, depth, ms, launches = _eval(model, ids, [0], counts)
    n = -(-W * H // BATCH)
    _expect_launches("eval fused march", launches, {"fused_weights_fwd": n, "march_fwd": n})
    with _field_cfgs(model, fused_march=False):
        rgb_u, depth_u, ms_u, _ = _eval(model, ids, [0], None)
    err = (_close(rgb, rgb_u, 0.0, K4_TOL["out"]), _close(depth, depth_u, K4_TOL["out"], K4_TOL["out"]))
    print(f"eval fused march 640^3: {ms:.1f} ms/frame ({ms_u:.1f} with the fused march off), launches"
          f" {launches}; max err against the unfused frame rgb {err[0]:.3e} depth {err[1]:.3e}")
    del model
    torch.cuda.empty_cache()
    return counts


def check_spawn_eval_against_cpu(dev) -> None:
    """A small f32 model (32^3) on the card and on the CPU spawns a field
    over 2 frames, slides, appends a frame and takes one step on the new
    field from the same weights, batch and noise (losses to rtol 1e-4);
    then, from the card's state after the step (an Adam step moves a
    near-zero gradient by ~lr * sign(g), and the card's atomic adds may
    flip that sign), each renders one 40x30 blended frame, held to rtol
    1e-4 / atol 1e-4."""
    import torch

    from localrf_tpu_torch.models.local import LocalConfig, LocalTensorfs
    from localrf_tpu_torch.models.tensorf import TensorfConfig, TensorfField
    from localrf_tpu_torch.optim import pytree_adam_init

    w, h = 40, 30
    ds = make_dataset(w, h, 8, seed=2, n_init=4)
    tf = TensorfConfig(grid_size=(32, 32, 32), pallas_composite=True, binned_min_rows=500)
    cfg = LocalConfig(WH=(w, h), n_init_frames=4, n_views=4, batch_size=512, n_overlap=2, tensorf=tf)
    gpu, cpu = LocalTensorfs(cfg, device=dev), LocalTensorfs(cfg, device="cpu")

    def copy_field():
        p = TensorfField({k: v.detach().to("cpu", copy=True)
                          for k, v in gpu.fields[-1]["params"].named_parameters()})
        cpu.fields[-1]["params"], cpu.fields[-1]["opt"] = p, pytree_adam_init(p)

    copy_field()
    t = np.random.default_rng(2).uniform(-0.3, 0.3, (6, 3)).astype(np.float32)
    for m in (gpu, cpu):
        for _ in range(2):
            m.append_frame()
        m.t_all[:] = t
        m._build_window()
        m.append_rf(2)
    copy_field()
    first = int(np.argmax(gpu.blending_weights[:, -1] > 0))
    ds.activate_frames(3)
    ds.deactivate_frames(first)
    for m in (gpu, cpu):
        m.set_window_start(first)
        m.append_frame()
        m.is_refining = True
        m.rf_iter[-1] = 2
    noise = gpu._next_noise(tf)
    batch = ds.sample(512, True, True, n_views=4)
    _reset_launch_counts()
    for m in (gpu, cpu):
        m._next_noise = lambda _, m=m: {k: v.to(m.device) for k, v in noise.items()}
        m.optimizer_step(batch, optimize_poses=True)
    for k, v in cpu.last_metrics.items():
        if not np.isclose(gpu.last_metrics[k], v, rtol=1e-4, atol=1e-6):
            raise AssertionError(f"small spawn: {k} card {gpu.last_metrics[k]} vs cpu {v}")
    missing = [k for k, n in _launch_counts().items() if k in PATH_KERNELS["default"] and n <= 0]
    if missing:
        raise AssertionError(f"small spawn: kernels {missing} did not launch on the card")
    copy_field()
    gpu.sync_window_to_host()
    cpu.r_all, cpu.t_all, cpu.exp_all = gpu.r_all.copy(), gpu.t_all.copy(), gpu.exp_all.copy()
    cpu._build_window()
    view = int(np.argmin(np.abs(gpu.blending_weights[:, 1] - 0.5)))
    if not (0 < gpu.blending_weights[view]).all():
        raise AssertionError("small spawn: the frame is not blended")
    out = [m.forward_eval(np.arange(w * h), np.array([view]), w, h, chunk=600) for m in (gpu, cpu)]
    err = [_close(a.cpu(), b, 1e-4, 1e-4) for a, b in zip(out[0][:2], out[1][:2])]
    print(f"small spawn card vs cpu: step total_loss {gpu.last_metrics['total_loss']:.6f} vs"
          f" {cpu.last_metrics['total_loss']:.6f}; blended frame {view} max err rgb {err[0]:.3e}"
          f" depth {err[1]:.3e}")


# the cli phase: train.py's reconstruction through config_parser at the
# default widths and flags (batch 4096 in 16 views, n_lamb 8/24, app_dim 27,
# featureC 128, bf16 tables and MLP, --use_pallas 1 --binned_scatter 1
# --scan_chunk 16 --pixel_pool 1) on a seeded 960x540 scene written to disk.
# Cut from the defaults (flag: (this run, default)): the frame count (8
# frames; with it the initial window, the window that triggers refinement,
# the cross-fade, the frames between appends and the test-frame stride),
# the iterations per frame and the final grid; the eval stride follows the
# shorter run
CLI_FRAMES = 8
CLI_CUTS = {
    "n_init_frames": ("3", "5"),
    "n_max_frames": ("4", "100"),
    "n_overlap": ("2", "30"),
    "add_frames_every": ("16", "100"),
    "test_frame_every": ("4", "10"),
    "n_iters_per_frame": ("16", "600"),
    "n_iters_reg": ("4", "100"),
    "upsamp_list": (["2", "4"], ["100", "150", "200", "250", "300"]),
    "update_AlphaMask_list": (["3"], ["100", "200", "300"]),
    "N_voxel_final": (str(128**3), str(640**3)),
    "vis_every": ("64", "10000"),
}
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", "jax_ckpt_12")
# the JAX fixture's frame (JAX on the CPU, f32 tables and MLP) against the
# port's on the card: K1-fwd and the MLP sum in another order
FIXTURE_TOL = (1e-4, 1e-4)


def _sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def write_scene(root: str, w: int, h: int, n_frames: int, seed: int = 0, images_only: bool = False) -> None:
    """A seeded scene on disk as the datasets read it: images/ (jpg),
    depth/ (uint16 png inverse depth), flow_ds/ (fwd/bwd flow at half
    resolution, the uint16 png codec); with `images_only`, images/ alone
    (what preprocessing starts from)."""
    import cv2

    from localrf_tpu_torch.data.flow_io import encode_flow

    rng = np.random.default_rng(seed)
    for d in ("images",) if images_only else ("images", "depth", "flow_ds"):
        os.makedirs(os.path.join(root, d))
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    for i in range(n_frames):
        wave = np.sin(2 * np.pi * (3 * xx + 2 * yy + 0.05 * i))[..., None] * np.array([0.25, 0.2, 0.15])
        img = np.clip(0.5 + wave + rng.normal(0, 0.05, (h, w, 3)), 0, 1)
        cv2.imwrite(f"{root}/images/{i:06d}.jpg", (img[..., ::-1] * 255).astype(np.uint8))
        if images_only:
            continue
        inv = 0.3 + 0.5 * yy + 0.1 * rng.random((h, w))
        cv2.imwrite(f"{root}/depth/{i:06d}.png", (inv / inv.max() * 65535).astype(np.uint16))
        for kind in ("fwd", "bwd"):
            flow = rng.normal(0, 1, (h // 2, w // 2, 2)).astype(np.float32)
            cv2.imwrite(f"{root}/flow_ds/{kind}_{i:06d}.png", encode_flow(flow, np.ones((h // 2, w // 2), bool)))


def _live_state(model) -> dict:
    """_state with only the pose window's live rows (its padding rows are
    never read, and a gated-off update leaves NaN in them)."""
    out = _state(model)
    n = model.win_len
    for name, val in model._pose_dev._asdict().items():
        if isinstance(val, tuple):
            out.update({f"{name}.{i}": x[:n] for i, x in enumerate(val)})
        else:
            out[name] = val[:n]
    return out


@contextlib.contextmanager
def _patched(obj, name: str, wrap):
    """obj.name replaced by wrap(original) inside the block."""
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def cli_phase(dev, w: int = W, h: int = H) -> tuple[dict, dict, object]:
    """`reconstruction` as `python -m localrf_tpu_torch.train` runs it, then
    a resume from its tmp checkpoint, its render-only entry and the JAX
    fixture. Returns (results, the run's launch counts, the trained model)."""
    import tempfile

    import torch

    from localrf_tpu_torch import checkpoint, train
    from localrf_tpu_torch.config import config_parser
    from localrf_tpu_torch.data.dataset import LocalRFDataset
    from localrf_tpu_torch.data.pool import DevicePixelPool
    from localrf_tpu_torch.models.local import LocalTensorfs

    cuda = torch.device(dev).type == "cuda"
    tmp = tempfile.TemporaryDirectory()
    scene, log = f"{tmp.name}/scene", f"{tmp.name}/log"
    t0 = time.perf_counter()
    write_scene(scene, w, h, CLI_FRAMES)
    scene_s = time.perf_counter() - t0
    cuts = [a for k, (v, _) in CLI_CUTS.items() for a in (f"--{k}", *(v if isinstance(v, list) else [v]))]
    argv = ["--datadir", scene, "--logdir", log, "--device", str(dev), *cuts]
    print(f"cli: {CLI_FRAMES} frames of {w}x{h} written in {scene_s:.1f} s; cut from the defaults: "
          + ", ".join(f"--{k} {v} (default {d})" for k, (v, d) in CLI_CUTS.items()))

    chunks, frames, saves, twin = [], [], [], {}

    def timed_chunk(run_chunk):
        def run(self, batches, optimize_poses):
            before = self._graphs.captures if self._graphs is not None else 0
            _sync(dev)
            t = time.perf_counter()
            out = run_chunk(self, batches, optimize_poses)
            _sync(dev)
            captured = (self._graphs.captures if self._graphs is not None else 0) - before
            chunks.append((len(batches), (time.perf_counter() - t) * 1e3, captured,
                           self.fields[-1]["cfg"].grid_size[0]))
            return out
        return run

    def timed_eval(forward_eval):
        def run(self, ray_ids, view_ids, w_, h_, **kw):
            _sync(dev)
            t = time.perf_counter()
            out = forward_eval(self, ray_ids, view_ids, w_, h_, **kw)
            _sync(dev)
            frames.append((w_ * h_, (time.perf_counter() - t) * 1e3))
            return out
        return run

    def noted_save(save):
        def run(model, path, extra=None):
            if path.endswith("checkpoints_tmp.th"):  # the state the file holds, as a twin
                twin.clear()
                twin.update(model=clone_model(model, dev), extra=dict(extra))
            t = time.perf_counter()
            save(model, path, extra)
            saves.append((os.path.basename(path), time.perf_counter() - t, os.path.getsize(path)))
        return run

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    with (_patched(LocalTensorfs, "run_chunk", timed_chunk), _patched(LocalTensorfs, "forward_eval", timed_eval),
          _patched(train, "save_checkpoint", noted_save)):
        model, metrics = train.reconstruction(config_parser(argv))
    run_s = time.perf_counter() - t0
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    _check_launches("cli run", launches, "default")

    # what the run went through, and what it wrote
    f0 = model.fields[0]
    if (len(model.fields) < 2 or f0["alpha_volume"] is None or f0["cfg"].grid_size == model.cfg.tensorf.grid_size
            or not twin):
        raise AssertionError(f"cli: expected a spawn, an upsample, an alpha refresh and a mid-run eval; fields"
                             f" {[f['cfg'].grid_size for f in model.fields]}, alpha {f0['alpha_volume'] is not None},"
                             f" tmp checkpoint {bool(twin)}")
    with open(f"{log}/transforms.json") as f:
        tr = json.load(f)
    if len(tr["frames"]) != CLI_FRAMES or (tr["w"], tr["h"]) != (w, h):
        raise AssertionError(f"cli: transforms.json has {len(tr['frames'])} frames of {tr['w']}x{tr['h']}")
    pngs = {p: open(f"{log}/test/rgb_maps/{p}", "rb").read() for p in sorted(os.listdir(f"{log}/test/rgb_maps"))}
    videos = [v for v in ("video", "posevideo", "depthvideo") if os.path.isfile(f"{log}/smooth_spline/{v}.mp4")]
    if not pngs or not os.listdir(f"{log}/smooth_spline/rgb_maps") or not metrics:
        raise AssertionError(f"cli: missing outputs (test renders {sorted(pngs)}, metrics {metrics})")
    if not all(np.isfinite([m["mse"], m["ssim"], m["lpips_randinit"]]).all() for m in metrics.values()):
        raise AssertionError(f"cli: non-finite eval metrics {metrics}")
    steady = [(ms / n, grid) for n, ms, captured, grid in chunks if n == CHUNK and not captured]
    if not steady:
        raise AssertionError(f"cli: no chunk of {CHUNK} steps ran without a capture: {chunks}")
    ms_step = float(np.median([ms for ms, _ in steady]))
    by_grid = {g: float(np.median([ms for ms, gg in steady if gg == g])) for g in sorted({g for _, g in steady})}
    full = [ms for px, ms in frames if px == w * h]
    print(f"cli run: {run_s:.1f} s, {sum(c[0] for c in chunks)} steps in {len(chunks)} chunks"
          f" ({sum(1 for c in chunks if c[2])} captured graphs); fields {[f['cfg'].grid_size for f in model.fields]},"
          f" rf_iter {model.rf_iter}; {len(steady)} steady chunks of {CHUNK}: median {ms_step:.3f} ms/step"
          f" ({[(round(x, 3), g) for x, g in steady]}; by grid {by_grid}); peak allocated {peak / 2**30:.3f} GiB;"
          f" launches {launches}")
    print(f"cli eval: {len(frames)} frames, {w}x{h} median {np.median(full) if full else float('nan'):.1f} ms/frame;"
          f" by size {sorted({px: round(ms, 1) for px, ms in frames}.items())}; metrics {metrics}; videos {videos}")
    print(f"cli checkpoints: " + "; ".join(f"{n} {b} B saved in {s:.3f} s" for n, s, b in saves))

    # resume: the tmp checkpoint loaded, one chunk under fixed-order sums,
    # bit for bit with a twin of the saved model (its generator as the
    # loader sets it)
    args = config_parser(argv)
    t0 = time.perf_counter()
    loaded, extra = checkpoint.load_checkpoint(f"{log}/checkpoints_tmp.th", return_extra=True, device=dev)
    load_s = time.perf_counter() - t0
    saved = twin["model"]
    saved._gen = torch.Generator(device=dev).manual_seed(saved.cfg.seed + 1)
    if extra != twin["extra"]:
        raise AssertionError(f"cli resume: extra {extra} vs saved {twin['extra']}")
    ds = LocalRFDataset(scene, split="train", downsampling=args.downsampling, test_frame_every=args.test_frame_every,
                        load_depth=True, load_flow=True, n_init_frames=args.n_init_frames,
                        subsequence=args.subsequence, frame_step=args.frame_step)
    b0, b1 = extra["active_bounds"]
    ds.activate_frames(b1 - ds.active_frames_bounds[1])
    if b0:
        ds.deactivate_frames(b0)
    pool = DevicePixelPool(ds, capacity=args.n_max_frames + args.n_overlap + 16, device=dev)
    loaded.attach_pool(pool)
    saved.attach_pool(pool)
    with deterministic_sums():
        batches = loaded.plan_chunk(ds, True, CHUNK)
        _reset_launch_counts()
        loaded.run_chunk(batches, optimize_poses=True)
        resume_launches = _launch_counts()
        saved.run_chunk(batches, optimize_poses=True)
        for k, v in saved.chunk_metrics.items():
            if not np.array_equal(loaded.chunk_metrics[k], v):
                raise AssertionError(f"cli resume: {k} {loaded.chunk_metrics[k]} vs the twin's {v}")
        mine, theirs = _live_state(loaded), _live_state(saved)
        differ = [k for k in theirs if not _bits_equal(mine[k], theirs[k])]
        if differ or mine.keys() != theirs.keys() or loaded.rf_iter != saved.rf_iter:
            raise AssertionError(f"cli resume: the loaded model and the twin differ in {differ}")
        loaded.drop_graphs()
        saved.drop_graphs()
    if not resume_launches.get("segment_sum_merged") or resume_launches.get("segment_sum"):
        raise AssertionError(f"cli resume: K5 did not take K2's place ({resume_launches})")
    print(f"cli resume: checkpoints_tmp.th loaded in {load_s:.3f} s at iteration {extra['iteration']},"
          f" window {extra['active_bounds']}; a chunk of {len(batches)} steps under fixed-order sums equals the"
          f" twin's bit for bit ({len(mine)} tensors); launches {resume_launches}")
    del loaded, saved, pool, twin["model"]

    # render-only: the final checkpoint's test renders, byte for byte the run's
    for p in pngs:
        os.remove(f"{log}/test/rgb_maps/{p}")
    n_frames = len(frames)
    t0 = time.perf_counter()
    with _patched(LocalTensorfs, "forward_eval", timed_eval):
        train.render_test(config_parser(argv + ["--render_only", "1", "--render_path", "0"]))
    render_s = time.perf_counter() - t0
    again = {p: open(f"{log}/test/rgb_maps/{p}", "rb").read() for p in sorted(os.listdir(f"{log}/test/rgb_maps"))}
    if again != pngs:
        raise AssertionError(f"cli render-only: PNGs differ from the run's: "
                             f"{[p for p in pngs if again.get(p) != pngs[p]]}")
    print(f"cli render-only: {len(pngs)} PNGs byte-equal to the run's in {render_s:.1f} s"
          f" ({[round(ms, 1) for _, ms in frames[n_frames:]]} ms a frame)")

    # the JAX package's fixture, on this device
    fx = np.load(f"{FIXTURE}_frame.npz")
    jm = checkpoint.load_checkpoint(f"{FIXTURE}.th", device=dev)
    view, chunk = int(fx["view"]), int(fx["chunk"])
    fw, fh = jm.W, jm.H
    rgb, depth, _, _ = jm.forward_eval(np.arange(fw * fh), np.array([view]), fw, fh, chunk=chunk)
    err = (_close(rgb.cpu(), torch.from_numpy(fx["rgb"]), *FIXTURE_TOL),
           _close(depth.cpu(), torch.from_numpy(fx["depth"]), *FIXTURE_TOL))
    print(f"cli JAX fixture: {os.path.basename(FIXTURE)}.th ({len(jm.fields)} fields) view {view} at {fw}x{fh}"
          f" against JAX's CPU frame: max err rgb {err[0]:.3e} depth {err[1]:.3e}")
    tmp.cleanup()
    out = {"run_s": run_s, "ms_per_step": ms_step, "ms_per_step_by_grid": by_grid, "steady_chunks": steady,
           "eval_ms": frames,
           "checkpoints": saves, "load_s": load_s, "peak": peak, "render_only_s": render_s,
           "fixture_err": err, "resume_launches": resume_launches, "steps": sum(c[0] for c in chunks)}
    return out, launches, model


# the preprocess phase: run_flow at its defaults (scale 0.5, 30 iterations)
# and run_depth's default backend (the port's DPT-Large at --size 384) on a
# seeded scene of 8 frames of 960x540 images, random weights from seeded
# generators. Card against the port on the CPU in full f32: RAFT (one pair
# at 480x272, 30 iterations) within 1e-4 of the flow's scale, DPT-Large
# (one 384x384 image) within 1e-4 of the depth's maximum; the metrics on
# CUDA tensors within tests/test_torch_eval.py's 1e-5 of their CPU values
PRE_FRAMES = 8
RAFT_TOL = 1e-4
DPT_TOL = 1e-4
METRIC_TOL = 1e-5


def preprocess_phase(dev, field: dict, w: int = W, h: int = H, dpt_cfg=None, depth_size: int = 384) -> dict:
    """Preprocessing as a user runs it, on `dev`: a scene of images/ to
    flow_ds/, flow_vis/ and depth/, read back by the port's dataset; RAFT,
    DPT and the metrics card vs CPU; the mesh of `field` (a LocalTensorfs
    field: "params", "cfg") at the default 128^3 lattice. Raises on any
    failed check."""
    import tempfile

    import cv2
    import torch

    from localrf_tpu_torch.data.dataset import LocalRFDataset
    from localrf_tpu_torch.data.flow_io import decode_flow
    from localrf_tpu_torch.preprocess import run_depth, run_flow
    from localrf_tpu_torch.preprocess.dpt import DPTConfig, init_dpt, load_dpt_checkpoint
    from localrf_tpu_torch.preprocess.raft import InputPadder, init_raft
    from localrf_tpu_torch.models.tensorf import compute_dense_alpha
    from localrf_tpu_torch.utils.mesh import export_density_ply
    from localrf_tpu_torch.utils.metrics import rgb_lpips, rgb_ssim

    cuda = torch.device(dev).type == "cuda"
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    scene = f"{tmp.name}/scene"
    write_scene(scene, w, h, PRE_FRAMES, images_only=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out: dict = {}

    # flow: run_flow at its defaults from a module.-prefixed random RAFT
    raft_cpu = init_raft(torch.Generator().manual_seed(0), device=cpu)
    ckpt = f"{tmp.name}/raft-things.pth"
    torch.save({f"module.{k}": v for k, v in raft_cpu.state_dict().items()}, ckpt)
    t0 = time.perf_counter()
    run_flow.main(["--data_dir", scene, "--ckpt", ckpt, "--device", str(dev)])
    out["run_flow_s"] = time.perf_counter() - t0
    names = sorted(os.listdir(f"{scene}/flow_ds"))
    if len(names) != 2 * (PRE_FRAMES - 1) or len(os.listdir(f"{scene}/flow_vis")) != len(names):
        raise AssertionError(f"preprocess: flow_ds {names}, flow_vis {sorted(os.listdir(f'{scene}/flow_vis'))}")
    valid = []
    for n in names:
        flow, mask = decode_flow(cv2.imread(f"{scene}/flow_ds/{n}", cv2.IMREAD_UNCHANGED))
        if flow.shape != (h // 2, w // 2, 2) or not np.isfinite(flow).all():
            raise AssertionError(f"preprocess: {n} decodes to {flow.shape}, finite {np.isfinite(flow).all()}")
        valid.append(float(mask.mean()))
    out["flow_valid_share"] = valid

    # depth: run_depth's default backend, DPT-Large from a state dict
    cfg = dpt_cfg or DPTConfig.large()
    sd = init_dpt(cfg, torch.Generator().manual_seed(1), device=cpu).state_dict()
    t0 = time.perf_counter()
    dpt = load_dpt_checkpoint(sd, cfg, device=dev)
    out["dpt_load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_depth.write_depths(scene, run_depth.dpt_infer(dpt, depth_size))
    out["run_depth_s"] = time.perf_counter() - t0
    for n in sorted(os.listdir(f"{scene}/depth")):
        d = cv2.imread(f"{scene}/depth/{n}", cv2.IMREAD_UNCHANGED)
        if d.dtype != np.uint16 or d.shape != (h, w) or d.max() == 0:
            raise AssertionError(f"preprocess: depth/{n} is {d.dtype} {d.shape}, max {d.max()}")

    # read-back: what preprocessing wrote is what training reads
    ds = LocalRFDataset(scene, load_depth=True, load_flow=True, n_init_frames=PRE_FRAMES)
    n_px = w * h
    arrays = (ds.all_invdepths, ds.all_fwd_flow, ds.all_bwd_flow)
    if (ds.all_invdepths.shape != (PRE_FRAMES * n_px, 1) or ds.all_fwd_flow.shape != (PRE_FRAMES * n_px, 2)
            or not all(np.isfinite(a).all() for a in arrays) or ds.all_fwd_mask[-n_px:].any()):
        raise AssertionError("preprocess: the dataset's read-back of depth/ and flow_ds/ is off")

    # card against CPU: RAFT on frames 0 and 1 as run_flow loads them
    def load(i):
        img = cv2.imread(f"{scene}/images/{i:06d}.jpg")[..., ::-1]
        img = cv2.resize(img, None, fx=0.5, fy=0.5, interpolation=cv2.INTER_AREA)
        return torch.from_numpy(img.astype(np.float32)).permute(2, 0, 1)

    im1, im2 = load(0), load(1)
    padder = InputPadder(im1.shape)
    a, b = padder.pad(torch.stack([im1, im2])), padder.pad(torch.stack([im2, im1]))
    raft = init_raft(torch.Generator().manual_seed(0), device=dev)
    a_dev, b_dev = a.to(dev), b.to(dev)
    got = raft(a_dev, b_dev, iters=30).cpu()
    if cuda:
        out["raft_ms_per_pair"] = _time_ms(lambda: raft(a_dev, b_dev, iters=30), 3, eager=True)
    t0 = time.perf_counter()
    ref = raft_cpu(a, b, iters=30)
    out["raft_cpu_s"] = time.perf_counter() - t0
    scale = max(float(ref.abs().max()), 1.0)
    out["raft_shape"], out["raft_scale"] = list(a.shape), scale
    out["raft_err"] = _close(got, ref, 0.0, RAFT_TOL * scale)
    del raft, raft_cpu

    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (1, 3, depth_size, depth_size)).astype(np.float32))
    x_dev = x.to(dev)
    got = dpt(x_dev).cpu()
    if cuda:
        out["dpt_ms_per_image"] = _time_ms(lambda: dpt(x_dev), 5, eager=True)
    del dpt
    dpt_cpu = load_dpt_checkpoint(sd, cfg, device=cpu)
    t0 = time.perf_counter()
    ref = dpt_cpu(x)
    out["dpt_cpu_s"] = time.perf_counter() - t0
    del dpt_cpu, sd
    out["dpt_max"] = float(ref.abs().max())
    out["dpt_err"] = _close(got, ref, 0.0, DPT_TOL * out["dpt_max"])

    # the metrics on the card against the CPU, under torch's default flags
    img0, img1 = ds.all_rgbs[:n_px].reshape(h, w, 3), ds.all_rgbs[n_px:2 * n_px].reshape(h, w, 3)
    on_card = [torch.from_numpy(np.ascontiguousarray(i)).to(dev) for i in (img0, img1)]
    metric_err = {}
    for name, fn in (("ssim", lambda x0, x1: rgb_ssim(x0, x1, 1.0)), ("lpips", rgb_lpips)):
        card, host = fn(*on_card), fn(img0, img1)
        metric_err[name] = abs(card - host)
        if not abs(card - host) <= METRIC_TOL:
            raise AssertionError(f"preprocess: {name} on the card {card} vs the CPU {host}")
    out["metric_err"] = metric_err

    # the mesh of a trained field at the default 128^3 lattice: at the
    # default level 0.5, and at the lattice's 99th alpha percentile, where
    # the field must have a surface (a short run's alpha may stay below 0.5)
    _sync(dev)
    t0 = time.perf_counter()
    n_v, n_f = export_density_ply(field["params"], field["cfg"], f"{tmp.name}/mesh.ply")
    out["mesh"] = {"vertices": n_v, "faces": n_f, "s": time.perf_counter() - t0,
                   "grid": list(field["cfg"].grid_size)}
    with torch.no_grad():
        alpha = compute_dense_alpha(field["params"], field["cfg"], (128, 128, 128))
    level = float(torch.quantile(alpha.flatten()[::8], 0.99))
    n_v99, n_f99 = export_density_ply(field["params"], field["cfg"], f"{tmp.name}/mesh.ply", level=level)
    if not n_f99:
        raise AssertionError(f"preprocess: no surface at the 99th alpha percentile {level}")
    out["mesh_p99"] = {"level": level, "vertices": n_v99, "faces": n_f99}
    out["peak"] = torch.cuda.max_memory_allocated() if cuda else 0
    out["s"] = time.perf_counter() - t_phase
    tmp.cleanup()
    print(f"preprocess: run_flow {out['run_flow_s']:.1f} s for {PRE_FRAMES - 1} pairs of {w}x{h} (valid share"
          f" {np.round(valid, 3).tolist()}), run_depth {out['run_depth_s']:.1f} s for {PRE_FRAMES} frames"
          f" (DPT loaded in {out['dpt_load_s']:.1f} s); read back by LocalRFDataset")
    print(f"preprocess: RAFT {out['raft_shape']} x 30 iterations card vs CPU max err {out['raft_err']:.3e}"
          f" (flow scale {scale:.3f}, tolerance {RAFT_TOL} of it), {out.get('raft_ms_per_pair', float('nan')):.2f}"
          f" ms a pair; DPT ({cfg.num_layers} layers of {cfg.hidden_size}) {depth_size}^2 card vs CPU max err {out['dpt_err']:.3e} (max"
          f" {out['dpt_max']:.4f}, tolerance {DPT_TOL} of it), {out.get('dpt_ms_per_image', float('nan')):.2f}"
          f" ms an image; ssim / lpips card vs CPU {metric_err['ssim']:.2e} / {metric_err['lpips']:.2e}")
    print(f"preprocess: mesh of a {out['mesh']['grid']} field at 128^3: level 0.5 {n_v} vertices, {n_f} faces in"
          f" {out['mesh']['s']:.2f} s; level {level:.4g} (the 99th alpha percentile) {n_v99} vertices, {n_f99}"
          f" faces; peak allocated {out['peak'] / 2**30:.3f} GiB; phase {out['s']:.1f} s")
    return out


# phase 10: ray-batch data parallelism (parallel/sharding.py, the reduction
# in models/step.py, LocalTensorfs.set_mesh) and the sample-split render
# (parallel/sp.py). (a) NCCL over one rank in this process; (b) and (c) two
# gloo ranks on this card, spawned (NCCL refuses two ranks on one card);
# (d) NCCL over two cards, where there are two
DP_TIMEOUT_S = 300
SP_GROUP, SP_RAYS = 2, 4096
# render_rays_sp against render_rays (eval, no compaction): K1's tolerance
# (render_rays composites through K1, render_rays_sp through cumprod), as
# EVAL_TOL; depth to 1e-4 of its largest value
SP_TOL = EVAL_TOL


def _nccl_events(counter) -> int:
    """NCCL's device work in a profiler counter of names (its kernels are
    `ncclDevKernel_*`; a one-rank reduce that must scale is `oneRankReduce`)."""
    return sum(n for name, n in counter.items() if "nccl" in name.lower() or "onerank" in name.lower())


def _init_group(backend: str, store: str, rank: int, world: int) -> None:
    import datetime

    import torch.distributed as dist

    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))


def _host_state(model) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in _state(model).items()}


def _losses_close(label: str, got: dict, want: dict) -> float:
    """Every step's losses of two runs of the same chunk to CHUNK_TOL;
    returns the worst relative rgb_loss difference."""
    worst = 0.0
    for k, v in want.items():
        for i in range(len(v)):
            rtol = CHUNK_TOL["first" if i == 0 else "rgb" if k == "rgb_loss" else "other"]
            err = abs(float(got[k][i]) - float(v[i]))
            if k == "rgb_loss":
                worst = max(worst, err / (abs(float(v[i])) + 1e-7))
            if not err <= rtol * abs(float(v[i])) + 1e-7:
                raise AssertionError(f"{label}: step {i} {k}: {float(got[k][i])} vs one process {float(v[i])}")
    return worst


def _spawn_ranks(kind: str, world: int, tmp: str) -> list[dict]:
    """`world` spawned processes running _rank_main(kind); each one's .npz."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    out = os.path.join(tmp, f"{kind}_%d.npz")
    procs = [ctx.Process(target=_rank_main, args=(kind, r, world, os.path.join(tmp, f"{kind}_store"), out))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DP_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join(10)
    bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if hung or bad:
        raise AssertionError(f"{kind} ranks: {hung} hung, exit codes {bad}")
    return [dict(np.load(out % r)) for r in range(world)]


def _rank_main(kind: str, rank: int, world: int, store: str, out: str) -> None:
    """A spawned rank: "gloo" (both ranks on card 0) or "nccl" (rank r on card r)."""
    import traceback

    try:
        import torch
        import torch.distributed as dist

        torch.cuda.set_device(0 if kind == "gloo" else rank)
        _init_group(kind, store, rank, world)
        results = (_gloo_rank if kind == "gloo" else _nccl_rank)(torch.device("cuda", torch.cuda.current_device()))
        if "jax" in sys.modules:
            raise AssertionError("a rank imported jax")
        dist.barrier()
        dist.destroy_process_group()
        np.savez(out % rank, **results)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def _model_64(dev, pool):
    from localrf_tpu_torch.models.local import LocalTensorfs

    m = LocalTensorfs(full_width_config(64), device=dev)
    m.is_refining = True
    m.rf_iter[-1] = 2  # past the schedule rescale at rf_iter 1
    m.attach_pool(pool)
    return m


def _sp_rays(dev):
    import torch

    rng = np.random.default_rng(5)
    return (torch.from_numpy(rng.uniform(-0.3, 0.3, (SP_RAYS, 3)).astype(np.float32)).to(dev),
            torch.from_numpy(rng.normal(0, 1, (SP_RAYS, 3)).astype(np.float32)).to(dev))


def _gloo_rank(dev) -> dict:
    """(b) one chunk of CHUNK eager steps at 64^3 (full width, the 146-slot
    pool) under a 2-rank gloo mesh, its launch counts, the state; a 960x540
    frame split over the ranks and the same frame on this rank alone; (c)
    render_rays_sp over a sample group of 2 and render_rays of the same
    640^3 field with the ball alpha volume."""
    import dataclasses

    import torch

    from localrf_tpu_torch.data.pool import DevicePixelPool
    from localrf_tpu_torch.models.render import render_rays
    from localrf_tpu_torch.parallel import sharding, sp

    mesh = sharding.make_mesh(2, "cuda")
    ds = make_dataset(W, H, N_FRAMES)
    model = _model_64(dev, DevicePixelPool(ds, capacity=POOL_SLOTS, device=dev))
    model.set_mesh(mesh)
    if model._graphs is not None:
        raise AssertionError("a gloo mesh kept the chunk's CUDA graphs")
    batches = model.plan_chunk(ds, True, CHUNK)
    _reset_launch_counts()
    ms = _run_chunk(model, batches)
    launches = _launch_counts()
    out = {f"state/{k}": v for k, v in _host_state(model).items()}
    out.update({f"loss/{k}": v for k, v in model.chunk_metrics.items()})
    out.update({f"launch/{k}": np.int64(n) for k, n in launches.items()})
    out["ms_per_step"] = np.float64(ms / CHUNK)

    ids = np.arange(W * H)
    _reset_launch_counts()
    t0 = time.perf_counter()
    rgb, depth, _, _ = model.forward_eval(ids, np.asarray([1]), W, H, chunk=BATCH)
    torch.cuda.synchronize()
    out["eval_ms"] = np.float64((time.perf_counter() - t0) * 1e3)
    out.update({f"eval_launch/{k}": np.int64(n) for k, n in _launch_counts().items()})
    out["eval/rgb"], out["eval/depth"] = rgb.cpu().numpy(), depth.cpu().numpy()
    model.set_mesh(None)
    rgb, depth, _, _ = model.forward_eval(ids, np.asarray([1]), W, H, chunk=BATCH)
    out["eval_one/rgb"], out["eval_one/depth"] = rgb.cpu().numpy(), depth.cpu().numpy()
    del model

    m640 = model_640(dev, "default")
    f = m640.fields[-1]
    cfg = dataclasses.replace(f["cfg"], occ_m=0)
    rays_o, rays_d = _sp_rays(dev)
    group = sp.make_sp_mesh(SP_GROUP, "cuda")
    sp.render_rays_sp(f["params"], cfg, rays_o, rays_d, group, alpha_volume=f["alpha_volume"])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rgb, depth = sp.render_rays_sp(f["params"], cfg, rays_o, rays_d, group, alpha_volume=f["alpha_volume"])
    torch.cuda.synchronize()
    out["sp_ms"] = np.float64((time.perf_counter() - t0) * 1e3)
    with torch.no_grad():
        ref_rgb, ref_depth = render_rays(f["params"], cfg, rays_o, rays_d, is_train=False, white_bg=True,
                                         alpha_volume=f["alpha_volume"])
    out["sp/rgb"], out["sp/depth"] = rgb.cpu().numpy(), depth.cpu().numpy()
    out["sp_ref/rgb"], out["sp_ref/depth"] = ref_rgb.cpu().numpy(), ref_depth.cpu().numpy()
    out["sp_samples"] = np.int64(cfg.n_samples // 6 * 2)
    return out


def _nccl_rank(dev) -> dict:
    """(d) the 640^3 default pooled chunk under an NCCL mesh of two cards:
    the first chunk (captures), N_TIMED timed, one profiled; the state."""
    from localrf_tpu_torch.data.pool import DevicePixelPool
    from localrf_tpu_torch.parallel import sharding

    ds = make_dataset(W, H, N_FRAMES)
    model = model_640(dev, "default")
    model.attach_pool(DevicePixelPool(ds, capacity=POOL_SLOTS, device=dev))
    model.set_mesh(sharding.make_mesh(2, "cuda"))
    _run_chunk(model, model.plan_chunk(ds, True, CHUNK))
    out = {f"loss/{k}": v for k, v in model.chunk_metrics.items()}
    times = [_run_chunk(model, model.plan_chunk(ds, True, CHUNK)) / CHUNK for _ in range(N_TIMED)]
    trace = profile_chunk(model, model.plan_chunk(ds, True, CHUNK))
    out["ms_all"] = np.asarray(times)
    out["nccl_per_step"] = np.asarray([_nccl_events(c) for c in trace["per_step"]])
    out["nccl_ms_per_step"] = np.float64(sum(ns for name, ns in trace["ns_by_name"].items()
                                             if _nccl_events({name: 1})) / 1e6 / CHUNK)
    out["graph_launches"] = np.int64(len(trace["per_step"]))
    out.update({f"state/{k}": v for k, v in _host_state(model).items()})
    return out


def _ranks_bit_equal(label: str, results: list[dict]) -> int:
    keys = [k for k in results[0] if k.startswith("state/")]
    for r in results[1:]:
        differ = [k for k in keys if r[k].tobytes() != results[0][k].tobytes()]
        if differ:
            raise AssertionError(f"{label}: the ranks' state differs in {differ}")
    return len(keys)


def nccl_chunk(dev, ds, pool) -> dict:
    """(a) The 640^3 default pooled chunk of 16 steps at full width under an
    NCCL mesh of this one rank, the all-reduces captured in its graphs
    (run_chunks: under fixed-order sums bit for bit against a twin with no
    mesh, whose steps are eager; on the path as it runs against a twin's
    eager steps; timed; profiled). Then: a fresh capture issues the step's
    collectives (two a step: the rgb loss's denominator, the gradients and
    metrics) at warm-up and capture and its replays none; NCCL's device
    work per replayed step in the trace; ms/step with and without the mesh,
    in turns, on two fresh models."""
    import tempfile

    import torch.distributed as dist

    from localrf_tpu_torch.parallel import sharding

    with tempfile.TemporaryDirectory() as tmp:
        _init_group("nccl", os.path.join(tmp, "store"), 0, 1)
        try:
            mesh = sharding.make_mesh(1, "cuda")

            def make(with_pool: bool):
                m = model_640(dev, "default")
                if with_pool:
                    m.attach_pool(pool)
                    m.set_mesh(mesh)
                return m

            out, model = run_chunks("640^3 default, NCCL mesh of 1 rank", make, ds, "default")
            trace = out.pop("trace")
            nccl = [_nccl_events(c) for c in trace["per_step"]]
            model.drop_graphs()
            sharding.COLLECTIVES.update(all_reduce=0, broadcast=0)
            _run_chunk(model, model.plan_chunk(ds, True, CHUNK))
            captured = dict(sharding.COLLECTIVES)
            sharding.COLLECTIVES.update(all_reduce=0, broadcast=0)
            _run_chunk(model, model.plan_chunk(ds, True, CHUNK))
            replayed = dict(sharding.COLLECTIVES)
            n_graphs = len(model._graphs)
            if captured["all_reduce"] != 2 * 2 * n_graphs or any(replayed.values()):
                raise AssertionError(f"NCCL chunk: collectives at capture {captured}, at replay {replayed},"
                                     f" {n_graphs} graph(s)")
            del model
            # two fresh models at the same schedule (model_640's rf_iter 10:
            # the L1 term on through 4 chunks; past n_iters_reg it turns off
            # and a step is ~25 ms shorter), their first chunks capturing
            timed = {"mesh": make(True), "none": make(False)}
            timed["none"].attach_pool(pool)
            for m in timed.values():
                _run_chunk(m, m.plan_chunk(ds, True, CHUNK))
            times = {"mesh": [], "none": []}
            for name in ("none", "mesh", "mesh", "none", "none", "mesh"):
                m = timed[name]
                times[name].append(_run_chunk(m, m.plan_chunk(ds, True, CHUNK)) / CHUNK)
            if any(m.chunk_metrics["l1_loss"][-1] <= 0 for m in timed.values()):
                raise AssertionError("NCCL chunk timing: the L1 term turned off in a timed chunk")
            del timed
        finally:
            dist.destroy_process_group()
    out.update(nccl_per_step=nccl, collectives_at_capture=captured, collectives_at_replay=replayed,
               ms_mesh=float(np.median(times["mesh"])), ms_none=float(np.median(times["none"])), times=times)
    print(f"parallel (a) NCCL mesh of 1: chunk bit for bit with fixed-order sums against a twin with no mesh"
          f" ({out['bit_exact_tensors']} tensors), on the path as it runs within CHUNK_TOL (worst rgb_loss"
          f" {out['worst_rel']:.3e}); a capture issued {captured['all_reduce']} all-reduces for {n_graphs}"
          f" graph(s) (2 a step, warm-up and capture), its replays {replayed['all_reduce']}; NCCL device"
          f" events per replayed step {nccl} (one rank: an in-place sum enqueues nothing); ms/step with the"
          f" mesh {out['ms_mesh']:.3f} {[round(t, 3) for t in times['mesh']]}, without"
          f" {out['ms_none']:.3f} {[round(t, 3) for t in times['none']]}")
    return out


def gloo_ranks(dev, pool) -> dict:
    """(b) and (c) on two spawned gloo ranks on this card (_gloo_rank),
    against this process: the chunk's losses against the same chunk in one
    process (CHUNK_TOL), the ranks' state bit for bit, K1-fwd, K1-bwd and
    K2 launched on each rank (and no other kernel); the split 960x540 frame
    equal on both ranks and against one rank's (EVAL_TOL); render_rays_sp
    against render_rays (SP_TOL)."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        results = _spawn_ranks("gloo", 2, tmp)
        wall = time.perf_counter() - t0
    n_state = _ranks_bit_equal("gloo ranks", results)
    ds = make_dataset(W, H, N_FRAMES)
    twin = _model_64(dev, pool)
    _run_chunk(twin, twin.plan_chunk(ds, True, CHUNK))
    want = twin.chunk_metrics
    del twin
    torch.cuda.empty_cache()
    launches, worst, eval_err, sp_err = {}, 0.0, [0.0, 0.0], [0.0, 0.0]
    for rank, r in enumerate(results):
        got = {k[5:]: v for k, v in r.items() if k.startswith("loss/")}
        worst = max(worst, _losses_close(f"gloo rank {rank}", got, want))
        mine = {k[7:]: int(v) for k, v in r.items() if k.startswith("launch/")}
        _check_launches(f"gloo rank {rank}", mine, "default")
        for k, n in mine.items():
            launches[k] = launches.get(k, 0) + n
        evl = {k[12:]: int(v) for k, v in r.items() if k.startswith("eval_launch/")}
        n_chunks = -(-W * H // BATCH)
        _expect_launches(f"gloo rank {rank} split frame", evl, {"fused_weights_fwd": n_chunks})
        for k, n in evl.items():
            launches[k] = launches.get(k, 0) + n
        for part in ("rgb", "depth"):
            if r[f"eval/{part}"].tobytes() != results[0][f"eval/{part}"].tobytes():
                raise AssertionError(f"gloo rank {rank}: the gathered frame differs from rank 0's")
        errs = [_close(torch.from_numpy(r["eval/rgb"]), torch.from_numpy(r["eval_one/rgb"]), *EVAL_TOL),
                _close(torch.from_numpy(r["eval/depth"]), torch.from_numpy(r["eval_one/depth"]),
                       EVAL_TOL[0], EVAL_TOL[1] * float(np.abs(r["eval_one/depth"]).max())),
                _close(torch.from_numpy(r["sp/rgb"]), torch.from_numpy(r["sp_ref/rgb"]), *SP_TOL),
                _close(torch.from_numpy(r["sp/depth"]), torch.from_numpy(r["sp_ref/depth"]),
                       SP_TOL[0], SP_TOL[1] * float(np.abs(r["sp_ref/depth"]).max()))]
        eval_err = [max(a, b) for a, b in zip(eval_err, errs[:2])]
        sp_err = [max(a, b) for a, b in zip(sp_err, errs[2:])]
    r0 = results[0]
    print(f"parallel (b) gloo, 2 ranks on one card (spawned, {wall:.1f} s): a 64^3 chunk of {CHUNK} eager"
          f" steps at {float(r0['ms_per_step']):.3f} ms/step, its losses within CHUNK_TOL of one process"
          f" (worst rgb_loss {worst:.3e}), the ranks' {n_state} state tensors bit for bit; launches on both"
          f" ranks {launches}; the 960x540 frame split over the ranks in {float(r0['eval_ms']):.1f} ms, equal on"
          f" both, against one rank's: rgb err {eval_err[0]:.3e}, depth err {eval_err[1]:.3e}")
    print(f"parallel (c) render_rays_sp, a sample group of {SP_GROUP} (gloo), {SP_RAYS} rays through the"
          f" 640^3 field with the ball alpha volume, {int(r0['sp_samples'])} samples a ray:"
          f" {float(r0['sp_ms']):.1f} ms; against render_rays (eval, no compaction) rgb err {sp_err[0]:.3e},"
          f" depth err {sp_err[1]:.3e}")
    return {"launches": launches, "ms_per_step": float(r0["ms_per_step"]), "eval_ms": float(r0["eval_ms"]),
            "eval_err": eval_err, "sp_ms": float(r0["sp_ms"]), "sp_err": sp_err, "worst_rel": worst,
            "state_tensors": n_state}


def nccl_cards(dev, pool) -> dict | None:
    """(d) NCCL over two cards (_nccl_rank on cards 0 and 1) against this
    process's same chunk on card 0: losses to CHUNK_TOL, the ranks' state
    bit for bit, NCCL kernels in every replayed step; ms/step on two cards
    and on one. Returns None, saying why, with fewer than two cards."""
    import tempfile

    import torch

    n = torch.cuda.device_count()
    if n < 2:
        print(f"parallel (d) NCCL across cards: not run: {n} card visible, two are needed (NCCL refuses two"
              " ranks on one card; (a) and (b) hold the same path on one)")
        return None
    with tempfile.TemporaryDirectory() as tmp:
        results = _spawn_ranks("nccl", 2, tmp)
    n_state = _ranks_bit_equal("nccl ranks", results)
    ds = make_dataset(W, H, N_FRAMES)
    twin = model_640(dev, "default")
    twin.attach_pool(pool)
    _run_chunk(twin, twin.plan_chunk(ds, True, CHUNK))
    want = twin.chunk_metrics
    one = [_run_chunk(twin, twin.plan_chunk(ds, True, CHUNK)) / CHUNK for _ in range(N_TIMED)]
    del twin
    worst = max(_losses_close(f"nccl rank {r}", {k[5:]: v for k, v in res.items() if k.startswith("loss/")}, want)
                for r, res in enumerate(results))
    nccl = results[0]["nccl_per_step"].tolist()
    if len(nccl) != CHUNK or min(nccl) < 2:
        raise AssertionError(f"NCCL across cards: NCCL device events per replayed step {nccl}, expected >= 2")
    ms2 = float(np.median(results[0]["ms_all"]))
    nccl_ms = float(results[0]["nccl_ms_per_step"])
    print(f"parallel (d) NCCL across 2 cards: losses within CHUNK_TOL of one process (worst rgb_loss"
          f" {worst:.3e}), the ranks' {n_state} state tensors bit for bit, NCCL kernels per replayed step"
          f" {nccl} ({nccl_ms:.3f} ms a step on rank 0's card); 640^3 default ms/step on two cards {ms2:.3f} {results[0]['ms_all'].round(3).tolist()},"
          f" on one {float(np.median(one)):.3f} {[round(t, 3) for t in one]}")
    return {"ms_two_cards": ms2, "ms_one_card": float(np.median(one)), "nccl_per_step": nccl,
            "nccl_ms_per_step": nccl_ms, "worst_rel": worst}


def parallel_phase(dev, ds) -> dict:
    """Phase 10 ((a)-(d) above) over one 146-slot pool."""
    import torch

    from localrf_tpu_torch.data.pool import DevicePixelPool

    t0 = time.perf_counter()
    pool = DevicePixelPool(ds, capacity=POOL_SLOTS, device=dev)
    out = {"nccl": nccl_chunk(dev, ds, pool)}
    torch.cuda.empty_cache()
    out["gloo"] = gloo_ranks(dev, pool)
    torch.cuda.empty_cache()
    out["cards"] = nccl_cards(dev, pool)
    del pool
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"parallel: phase {out['seconds']:.1f} s")
    return out


def main() -> None:
    # the H100's default cuBLAS workspace (8 x 4 MiB), named so that cuBLAS
    # calls raise no warning under deterministic_sums
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t_start = time.perf_counter()
    torch = _require_cuda()
    from localrf_tpu_torch.models.local import LocalTensorfs
    from localrf_tpu_torch.ops.kernels import _build

    dev = torch.device("cuda", 0)
    print(_gpu_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s ({_build.build_info['path']})")
    for ln in _build.build_info["log"].splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"  ptxas: {ln.strip()}")
    print(f"sass: tensor-core instructions (HMMA/HGMMA) per K4 MLP kernel {check_sass(_build.build_info['path'])}")

    # phase 2: kernels against their plain versions (K2 also on the plane
    # indices of a real step at each shape)
    ds = make_dataset(W, H, N_FRAMES)
    real = real_plane_indices(dev, ds)
    real_lines = real_line_indices(dev, ds)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = check_k1(dev, gen) + check_k2(dev, gen, real) + check_k5(dev, gen, real)
    del real
    gen = torch.Generator(device=dev).manual_seed(1)
    rows += check_k3(dev, gen, real_lines) + check_k4(dev, gen)
    del real_lines
    for row in rows:
        extra = (f"  bit for bit = ordered plain = 2nd launch, bins = merged_bins_plain; K2 {row['k2_ms']:.4f}"
                 f" ms; most points in a tile {row['max_tile_points']}, in a row {row['max_row_points']}"
                 if "k2_ms" in row else "")
        if "kernel_us" in row:
            extra += "  per kernel us " + ", ".join(f"{k} {v:.1f}" for k, v in row["kernel_us"].items())
        if "occupied_tiles" in row:
            extra += (f"  bf16 out err {row['bf16_err']:.3e} (within one ulp); tiles hit"
                      f" {row['occupied_tiles']}, most points in a tile {row['max_tile_points']}")
        if "partial_bytes" in row:
            with_partials = (row["bound_bytes"] + row["partial_bytes"]) / HBM_BYTES_PER_S * 1e3
            extra += (f"  bit for bit = ordered plain = 2nd launch; index_add_ err {row['index_add_err']:.3e};"
                      f" {row['n_ranges']} ranges, {row['rows_hit']} rows hit, runs of"
                      f" {row['mean_run']:.2f} points on one row on average; bound with the partial"
                      f" tables ({row['partial_bytes']} B) {with_partials:.4f} ms")
        lib = "-" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
        print(f"kernel {row['name']:18s} {row['shape']:44s} err {row['max_abs_err']:.3e}"
              f"  {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  library {lib}"
              f"  bound {row['bound_ms']:.4f} ms ({row['bound_by']}: {row['bound_bytes']} B,"
              f" {row['bound_flop']:.3g} flop; share {row['bound_ms'] / row['ms']:.3f}){extra}")
    torch.cuda.empty_cache()
    for path in PATH_TF:
        check_small_step_against_cpu(dev, path)
    check_spawn_eval_against_cpu(dev)

    # phase 4: the slice at 64^3 — dense march, alpha refresh after the 2nd
    # step, dense cull, upsample to 101^3 after the 3rd
    model = LocalTensorfs(
        full_width_config(64, update_AlphaMask_list=[3], N_voxel_list={4: 101**3}), device=dev
    )
    model.is_refining = True
    model.rf_iter[-1] = 2  # past the schedule rescale at rf_iter 1
    phases = {"64^3": run_slice("64^3", model, ds, 5)}
    f = model.fields[-1]
    if f["cfg"].grid_size != (101, 101, 101) or f["alpha_volume"] is None:
        raise AssertionError("64^3 slice: the upsample / alpha refresh did not happen")
    del model, f

    # phase 5: 640^3 for each path, the previous model freed first
    for path, label in (("default", "640^3"), ("fused_march", "640^3 fused_march"),
                        ("segsum", "640^3 segsum")):
        torch.cuda.empty_cache()
        phases[label] = slice_640(ds, dev, path)

    # phase 6: the chunk path over the default-capacity pixel pool
    from localrf_tpu_torch.data.pool import DevicePixelPool

    torch.cuda.empty_cache()
    pool = DevicePixelPool(ds, capacity=POOL_SLOTS, device=dev)
    pool_bytes = sum(a.numel() * a.element_size() for a in pool.arrays.values())
    print(f"pixel pool: {POOL_SLOTS} slots of {pool.n_px} px, {pool_bytes / 2**30:.3f} GiB")
    chunks = {"64^3": chunk_64(ds, dev, pool)}
    for path in ("default", "fused_march", "segsum"):
        torch.cuda.empty_cache()
        chunks[f"640^3 {path}"] = chunk_640(ds, dev, pool, path)
    del pool
    torch.cuda.empty_cache()

    # phase 7: spawn and eval
    evals = {}
    chunks["spawn 64^3"], evals["spawn"] = spawn_and_eval(dev)
    evals["fused march"] = fused_eval(dev)

    # phase 8: the CLI (reconstruction, resume, render-only, the JAX fixture)
    torch.cuda.empty_cache()
    cli, cli_launches, cli_model = cli_phase(dev)

    # phase 9: preprocessing (RAFT flow, DPT depth) on a scene of images,
    # read back by the dataset; the networks and metrics card vs CPU; the
    # mesh of the CLI's last field
    torch.cuda.empty_cache()
    pre = preprocess_phase(dev, cli_model.fields[-1])
    del cli_model

    # phase 10: ray-batch data parallelism and the sample-split render
    torch.cuda.empty_cache()
    par = parallel_phase(dev, ds)
    # this phase's launches: the NCCL chunk's first chunk and the gloo ranks'
    # chunk and split frames (main path), the fixed-order chunk's (K5)
    par_launches = {k: par["nccl"]["launches"].get(k, 0) + par["gloo"]["launches"].get(k, 0) for k in KERNELS}

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        mine = [r for r in rows if r["name"] == name]
        (row,) = [r for r in mine if r["main"]]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(ph["launches"][name] for ph in (*phases.values(), *chunks.values()))
            + sum(counts.get(name, 0) for counts in evals.values()) + cli_launches[name]
            + par_launches[name],
            "cli_launches": cli_launches[name],
            "parallel_launches": par_launches[name],
            "eval_launches": sum(counts.get(name, 0) for counts in evals.values()),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "bound_share": row["bound_ms"] / row["ms"],
            "bound_bytes": row["bound_bytes"], "library_ms": row["library_ms"], "shape": row["shape"],
            "replayed": sum(ph["replayed"][name] for ph in chunks.values()),
        }
        if name in FIXED_ORDER.values():
            # on the fixed-order chunks' path only
            entry["parallel_launches"] = par["nccl"]["exact_launches"].get(name, 0)
            entry["launches"] = (sum(ph["exact_launches"].get(name, 0) for ph in chunks.values())
                                 + cli["resume_launches"].get(name, 0) + entry["parallel_launches"])
            entry.update(path="fixed-order chunks", k2_ms=row["k2_ms"], max_tile_points=row["max_tile_points"],
                         max_row_points=row["max_row_points"])
        if "kernel_us" in row:
            entry["kernel_us"] = row["kernel_us"]
        for r in mine:
            if r["shape"] == EVAL_K1_SHAPE:
                entry.update(eval_shape=r["shape"], eval_ms=r["ms"], eval_plain_ms=r["plain_ms"],
                             eval_bound_ms=r["bound_ms"])
        kernels.append(entry)
    print(json.dumps({"slice": {
        label: {"ms_per_step": ph["ms"], "peak_bytes": ph["peak"]} for label, ph in phases.items()}}))
    print(json.dumps({"chunk": {
        label: {k: ph[k] for k in ("ms", "ms_all", "idle", "device_gaps", "peak", "reserved",
                                   "captures", "capture_ms", "worst_rel", "bit_exact_tensors")}
        for label, ph in chunks.items()}}))
    spawn = chunks["spawn 64^3"]
    print(json.dumps({"spawn": {"memory": spawn["memory"], "eval": spawn["eval"]}, "eval_launches": evals}))
    print(json.dumps({"cli": cli, "cli_launches": cli_launches}))
    print(json.dumps({"preprocess": pre}))
    print(json.dumps({"parallel": {
        "nccl": {k: v for k, v in par["nccl"].items() if k not in ("launches", "exact_launches", "replayed")},
        "gloo": par["gloo"], "cards": par["cards"], "seconds": par["seconds"]}}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start to here")
    print(_gpu_line())
    print(json.dumps({"kernels": kernels}))
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
