"""The density L1 term on a cubic grid, value and gradients in one pass.

`density_l1` launches the CUDA kernels in csrc/density_l1.cu (see the note
there for what bounds them on the card). They replace no Pallas kernel: the
JAX package computes the term in `jnp` (localrf_tpu/models/tensorf.py
`density_l1`). On a cubic grid voxel v = p G + d has the same plane pixel
p and line entry d in all three orientations, so with A the stacked planes
[K, G^2] and B the stacked lines [K, G] (K = C_0 + C_1 + C_2):

    value = mean over (p, d) of sqrt(max(sigma(sum_k A[k, p] B[k, d]), 1e-5))

with sigma = softplus(f + shift) (or relu(f)), the function of
`models/tensorf.py::density_l1` on such a grid.

The kernel computes the value and both gradients at once; `_DensityL1`
keeps the gradients and its backward scales them by the incoming gradient,
so a training step runs the pass once. The plain version is the blocked
path the program takes on the CPU and on non-cubic grids,
`models/tensorf.py::density_l1_blocked` (checkpointed blocks of f32
einsums, autograd's backward); this module launches or raises.

The kernel sums in an order the shapes fix (no atomics), so two launches
give the same bits. Against the plain version, which sums in cuBLAS's and
autograd's order, the value agrees to ~1e-6 relative; each gradient entry
is a sum of G (plane) or G^2 (line) terms of both signs, so the entries
agree to a fraction of the largest entry (tests/test_torch_gpu.py).
"""
from __future__ import annotations

import torch

from . import _build

LAUNCHES = {"density_l1": 0}

# persistent blocks of the kernel: 2 per SM of an H100 (fixed here, not read
# from the card, so that the summation order never depends on the card)
BLOCKS = 264
MAX_K = 96  # the kernel's channels (its register tiles are instantiated up to 96)
# shared memory a block may use on sm_90 (the kernel also takes 64 static bytes)
SMEM_LIMIT = 232_448 - 64


def _check_cubic(planes, lines) -> tuple[int, int]:
    """(K, G) of a cubic grid's planes [C_i, G, G] and lines [C_i, G]; raises
    where the grid is not cubic."""
    g = lines[0].shape[1]
    for p, ln in zip(planes, lines):
        if p.shape[1:] != (g, g) or ln.shape != (p.shape[0], g):
            raise ValueError(
                f"density_l1 takes a cubic grid: planes [C, {g}, {g}] and lines [C, {g}], got "
                f"{[list(p.shape) for p in planes]} and {[list(ln.shape) for ln in lines]}")
    return sum(p.shape[0] for p in planes), g


def _launch(planes, lines, shift: float, relu: bool) -> tuple:
    """The kernel's (value, plane gradients..., line gradients...) of one to
    three plane/line pairs (a CP field gives its virtual plane and one
    line)."""
    n = len(planes)
    if not 1 <= n <= 3 or len(lines) != n:
        raise ValueError("density_l1 takes one to three planes and as many lines")
    if planes[0].device.type != "cuda":
        raise ValueError(f"density_l1: no kernel for device {planes[0].device}")
    k, g = _check_cubic(planes, lines)
    # the kernel's channels past the given pairs: empty planes and lines
    planes = [*planes, *(planes[0].new_empty((0, g, g)) for _ in range(3 - n))]
    lines = [*lines, *(lines[0].new_empty((0, g)) for _ in range(3 - n))]
    for t in (*planes, *lines):
        if t.dtype != torch.float32 or t.device != planes[0].device:
            raise TypeError(f"density_l1 takes f32 tensors on one device, got {t.dtype} on {t.device}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"density_l1: the kernel takes 1 to {MAX_K} channels, got {k}")
    lib = _build.library()
    smem = int(lib.lrf_density_l1_smem(k, g))
    if smem > SMEM_LIMIT:
        raise ValueError(f"density_l1: {k} channels of lines of {g} need {smem} bytes of shared memory"
                         f" a block, more than the card's {SMEM_LIMIT}")
    dev = planes[0].device
    planes = [p.contiguous() for p in planes]
    lines = [ln.contiguous() for ln in lines]
    dplanes = [torch.empty_like(p) for p in planes]
    dlines = torch.empty((k, g), dtype=torch.float32, device=dev)
    value = torch.empty((), dtype=torch.float32, device=dev)
    partials = torch.empty((BLOCKS, k, -(-g // 32) * 32), dtype=torch.float32, device=dev)
    sums = torch.empty((BLOCKS,), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        _build.launch(
            "lrf_density_l1", *(t.data_ptr() for t in (*planes, *lines, *dplanes)),
            *(p.shape[0] for p in planes), g, float(shift), int(relu), partials.data_ptr(), sums.data_ptr(),
            dlines.data_ptr(), value.data_ptr(), BLOCKS, _build.stream_ptr(dev),
        )
    LAUNCHES["density_l1"] += 1
    return (value, *dplanes[:n]) + dlines.split([p.shape[0] for p in planes])[:n]


class _DensityL1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shift, relu, *tensors):
        n = len(tensors) // 2
        value, *grads = _launch(tensors[:n], tensors[n:], shift, relu)
        ctx.save_for_backward(*grads)
        return value

    @staticmethod
    def backward(ctx, gout):
        return (None, None) + tuple(g * gout for g in ctx.saved_tensors)


def density_l1(planes, lines, shift: float, relu: bool = False) -> torch.Tensor:
    """The L1 term of a cubic grid's density planes [C_i, G, G] and lines
    [C_i, G] (one to three of each: a CP field gives its virtual plane and
    one line), differentiable w.r.t. all of them: CUDA tensors launch the
    kernel; any other device raises."""
    return _DensityL1.apply(float(shift), bool(relu), *planes, *lines)
