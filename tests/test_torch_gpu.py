"""The port's CUDA kernels against their plain PyTorch versions on a card,
at the training step's shapes. Marked `gpu`: each test skips without a
CUDA device. This file imports no jax, so it runs on a machine without
it: `python -m pytest tests/test_torch_gpu.py -q --noconftest` (the
tests' conftest.py imports jax).

Tolerances: K1 forward rtol 1e-4 / atol 1e-6 and gradient rtol 1e-3 /
atol 1e-5 of its largest entry (torch.cumprod multiplies in another order
on the card); K2 rtol 1e-4 / atol 1e-4 in f32 (atomic-add order), one
bf16 ulp in bf16 (its adds within a tile run in no fixed order); K3 bit
for bit against its ordered plain version and a second launch (its order
is fixed by the shapes), and against the plain index_add_ rtol 1e-4 /
atol 1e-5 of the largest entry (some 2,000-4,600 points land on each line
row, so the f32 rounding of a reordered sum scales with the row's partial
sums). apply_mlp's bf16 products within one bf16 ulp of f32 products plus
the f32 reorder bound. K4 against march_core_plain: in f32, out
rtol 1e-4 / atol 1e-5 and gradients 1e-4 of their largest entry (sums in
another order, fused multiply-adds); with a bf16 table or MLP (both: the
tensor-core kernels, whose bf16 MMAs sum exact products in f32), out atol
1e-2 and gradients 2e-2 of their largest entry (a reordered f32 sum can
flip one bf16 rounding of a hidden activation). K5 bit for bit against
its ordered plain version and a second launch, and its two sort levels
equal to merged_bins_plain (its order is fixed); against the plain
index_add_ rtol 1e-4 / atol 1e-4 in f32 (another order). A captured chunk
against the same steps taken eagerly from the same state: losses rtol 1e-6 on the first step (the
forward has no atomics) and 1e-3 after (K2's atomic adds reorder f32 sums
in the gradients, which Adam's first ~lr*sign(g) steps amplify); with
every sum in a fixed order, bit for bit.
"""
import numpy as np
import pytest
import torch

from localrf_tpu_torch.ops.kernels import binned_scatter as k2
from localrf_tpu_torch.ops.kernels import composite as k1
from localrf_tpu_torch.ops.kernels import march as k4
from localrf_tpu_torch.ops.kernels import segsum as k3

SCALE = 25.0


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.abs(x).astype(np.float32)
    return np.where(mag > 0, np.exp2(np.floor(np.log2(np.maximum(mag, 1e-38))) - 7), 2.0**-133)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("r,s,per_ray", [(4096, 72, False), (4096, 332, True),
                                         # one sample (the terminator alone), and 32 windows
                                         (4096, 1, False), (4096, 1, True), (512, 1000, True)])
def test_k1_kernel_matches_plain_on_card(cuda_device, r, s, per_ray):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    sigma = 2 * torch.rand(r, s, generator=gen, device=cuda_device)
    dists = 0.01 + 0.49 * torch.rand(r if per_ray else 1, s, generator=gen, device=cuda_device)
    cot = torch.randn(r, s, generator=gen, device=cuda_device)
    xk = sigma.clone().requires_grad_(True)
    xp = sigma.clone().requires_grad_(True)
    n0 = dict(k1.LAUNCHES)
    wk = k1.fused_weights(xk, dists, SCALE)
    wp = k1.fused_weights_plain(xp, dists, SCALE)
    (gk,) = torch.autograd.grad(wk, xk, cot)
    (gp,) = torch.autograd.grad(wp, xp, cot)
    torch.testing.assert_close(wk, wp, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(gk, gp, rtol=1e-3, atol=1e-5 * float(gp.abs().max()))
    assert k1.LAUNCHES["fused_weights_fwd"] == n0["fused_weights_fwd"] + 1
    assert k1.LAUNCHES["fused_weights_bwd"] == n0["fused_weights_bwd"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows,p", [(4096, 4096 * 72), (409_600, 4096 * 332)])
def test_k2_kernel_matches_plain_on_card(cuda_device, n_rows, p):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    idx = torch.randint(0, n_rows, (p,), generator=gen, device=cuda_device)
    g = torch.randn(p, 128, generator=gen, device=cuda_device).to(torch.bfloat16)
    torch.testing.assert_close(k2.segment_sum(idx, g, n_rows), k2.segment_sum_plain(idx, g, n_rows),
                               rtol=1e-4, atol=1e-4)
    got = k2.segment_sum(idx, g, n_rows, torch.bfloat16).float().cpu().numpy()
    want = k2.segment_sum_plain(idx, g, n_rows, torch.bfloat16).float().cpu().numpy()
    assert (np.abs(got - want) <= bf16_ulp(np.maximum(np.abs(got), np.abs(want)))).all()
    with pytest.raises(TypeError):
        k2.segment_sum(idx.to(torch.int32), g, n_rows)


def _ball_rows(gen, p: int, side: int, dev) -> torch.Tensor:
    """Plane rows of points in a disc a quarter of the plane wide, packed
    toward its centre (the ball of a 640^3 step): most tiles empty, a few
    holding many times the mean."""
    u = torch.rand(4, p, generator=gen, device=dev)
    rad = 0.25 * side * u[0].sqrt() * (0.2 + 0.8 * u[1])
    ang = 2 * np.pi * u[2]
    x = (side / 2 + rad * torch.cos(ang)).long().clamp(0, side - 1)
    y = (side / 2 + rad * torch.sin(ang)).long().clamp(0, side - 1)
    return y * side + x


def _k2_against_plain(idx, g, n_rows):
    """K2 (f32 and bf16 out) against segment_sum_plain over the in-range
    points, one launch per call; its bins against tile_bins_plain. bf16 out
    is compared on |g|: where hundreds of signed terms land on one row, a
    sum that cancels to near 0 moves by more than one bf16 ulp of itself
    with the order of the f32 adds (the plain index_add_'s own atomics
    included), while sums of non-negative terms stay within one ulp in any
    order."""
    keep = (idx >= 0) & (idx < n_rows)
    plan = k2.tile_plan(idx.shape[0], g.shape[1], n_rows)
    sched, want = k2._bin_cuda(idx, n_rows, plan), k2.tile_bins_plain(idx, n_rows, plan)
    n_items, n_empty = sched["totals"].tolist()
    for key in ("counts", "starts", "slot_base"):
        assert torch.equal(sched[key].long(), want[key]), key
    assert torch.equal(sched["items"][:n_items].long(), want["items"])
    assert torch.equal(sched["empty"][:n_empty].long(), want["empty"])
    n = int(want["starts"][-1])
    for t in torch.nonzero(want["counts"]).flatten()[:50].tolist():  # each bin holds its points
        lo, hi = int(want["starts"][t]), int(want["starts"][t + 1])
        got_bin = sorted(zip(sched["bin_pt"][lo:hi].tolist(), sched["bin_row"][lo:hi].tolist()))
        assert got_bin == list(zip(want["bin_pt"][lo:hi].tolist(), want["bin_row"][lo:hi].tolist()))
    assert n <= idx.shape[0]
    n0 = k2.LAUNCHES["segment_sum"]
    got = k2.segment_sum(idx, g, n_rows)
    torch.testing.assert_close(got, k2.segment_sum_plain(idx[keep], g[keep], n_rows), rtol=1e-4, atol=1e-4)
    pos = g.abs()
    got16 = k2.segment_sum(idx, pos, n_rows, torch.bfloat16).float().cpu().numpy()
    want16 = k2.segment_sum_plain(idx[keep], pos[keep], n_rows, torch.bfloat16).float().cpu().numpy()
    assert (np.abs(got16 - want16) <= bf16_ulp(np.maximum(np.abs(got16), np.abs(want16)))).all()
    assert k2.LAUNCHES["segment_sum"] == n0 + 2


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ball", "out-of-range"])
@pytest.mark.parametrize("n_rows,p", [(4096, 4096 * 72), (409_600, 4096 * 332)])
def test_k2_kernel_skewed_and_out_of_range_on_card(cuda_device, n_rows, p, kind):
    """K2 on ball-skewed plane rows (tiles split over several blocks) and
    on indices partly out of range (skipped), bf16 and f32 payloads."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    side = int(round(n_rows**0.5))
    if kind == "ball":
        idx = _ball_rows(gen, p, side, cuda_device)
    else:
        idx = torch.randint(-n_rows // 4, n_rows + n_rows // 4, (p,), generator=gen, device=cuda_device)
    for dtype in (torch.bfloat16, torch.float32):
        _k2_against_plain(idx, torch.randn(p, 128, generator=gen, device=cuda_device).to(dtype), n_rows)


@pytest.mark.gpu
@pytest.mark.parametrize("c,n_rows", [(20, 1000), (128, 1000), (128, 1_000_000)])
def test_k2_kernel_no_points_and_narrow_rows_on_card(cuda_device, c, n_rows):
    """P = 0 gives a zero table in both out dtypes; rows that are not whole
    16-byte pieces (20 channels) take the kernel's one-element loads; a
    table of more tiles than a bin block's shared counters hold (15,625 >
    12,288) takes the global counters."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.randn(50_000, c, generator=gen, device=cuda_device).to(dtype)
        idx = torch.randint(0, n_rows, (50_000,), generator=gen, device=cuda_device)
        for out_dtype in (torch.float32, torch.bfloat16):
            empty = k2.segment_sum(idx[:0], g[:0], n_rows, out_dtype)
            assert empty.dtype == out_dtype and empty.shape == (n_rows, c) and not empty.any()
        _k2_against_plain(idx, g, n_rows)


@pytest.mark.gpu
@pytest.mark.parametrize("r,s,per_ray", [(4096, 72, False), (4096, 332, True), (512, 1000, True)])
def test_k1_bwd_near_opaque_on_card(cuda_device, r, s, per_ray):
    """K1 on rays with near-opaque samples (1 in 20 at sigma 1e3: 1 - a
    rounds to 0, so T runs into the 1e-10 clamp and underflows), at the
    tolerances of test_k1_kernel_matches_plain_on_card; 1,000 samples a ray
    run past the windows the backward keeps in registers."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    sigma = 2 * torch.rand(r, s, generator=gen, device=cuda_device)
    sigma = torch.where(torch.rand(r, s, generator=gen, device=cuda_device) < 0.05, 1e3, sigma)
    dists = 0.01 + 0.49 * torch.rand(r if per_ray else 1, s, generator=gen, device=cuda_device)
    cot = torch.randn(r, s, generator=gen, device=cuda_device)
    xk = sigma.clone().requires_grad_(True)
    xp = sigma.clone().requires_grad_(True)
    wk = k1.fused_weights(xk, dists, SCALE)
    wp = k1.fused_weights_plain(xp, dists, SCALE)
    assert (wp == 0).any()  # T underflowed on some ray
    (gk,) = torch.autograd.grad(wk, xk, cot)
    (gp,) = torch.autograd.grad(wp, xp, cot)
    assert torch.isfinite(gk).all()
    torch.testing.assert_close(wk, wp, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(gk, gp, rtol=1e-3, atol=1e-5 * float(gp.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows,p", [(64, 4096 * 72), (640, 4096 * 332)])
def test_k3_kernel_matches_plain_on_card(cuda_device, n_rows, p):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    idx = torch.randint(0, n_rows, (p,), generator=gen, device=cuda_device)
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.randn(p, 64, generator=gen, device=cuda_device).to(dtype)
        n0 = k3.LAUNCHES["segment_sum_small"]
        got = k3.segment_sum_small(idx, g, n_rows)
        assert got.dtype == torch.float32 and k3.LAUNCHES["segment_sum_small"] == n0 + 1
        want = k3.segment_sum_small_plain(idx, g, n_rows)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()))
    with pytest.raises(TypeError):
        k3.segment_sum_small(idx.to(torch.int32), g, n_rows)


def _line_rows(gen, kind: str, p: int, n_rows: int, dev) -> torch.Tensor:
    """Line-table rows: uniform; packed toward the middle rows as a ball's
    points project onto a line; all on one row; or partly out of range."""
    if kind == "uniform":
        return torch.randint(0, n_rows, (p,), generator=gen, device=dev)
    if kind == "ball":
        u = torch.rand(2, p, generator=gen, device=dev)
        return (n_rows / 2 + 0.27 * n_rows * (2 * u[0] - 1) * u[1].sqrt()).long().clamp(0, n_rows - 1)
    if kind == "hot":
        return torch.full((p,), n_rows // 3, dtype=torch.int64, device=dev)
    return torch.randint(-n_rows // 4, n_rows + n_rows // 4, (p,), generator=gen, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows,p,c,dtype,kind", [
    (64, 4096 * 72, 64, "bfloat16", "uniform"), (640, 4096 * 332, 64, "bfloat16", "uniform"),
    (640, 4096 * 332, 64, "bfloat16", "ball"), (64, 4096 * 72, 64, "bfloat16", "out-of-range"),
    (640, 4096 * 332, 64, "float32", "ball"), (640, 100_000, 64, "bfloat16", "hot"),
    # narrow rows (odd C: one channel a lane), a table of three row tiles, no points
    (640, 50_000, 20, "bfloat16", "out-of-range"), (300, 50_000, 7, "float32", "uniform"),
    (1500, 200_000, 64, "bfloat16", "ball"), (640, 0, 64, "bfloat16", "uniform"),
])
def test_k3_kernel_is_its_ordered_plain_version_on_card(cuda_device, n_rows, p, c, dtype, kind):
    """K3 sums in the order segsum_plan fixes: equal bit for bit to
    segment_sum_small_ordered (on copies on the CPU) and to a second
    launch; one launch counted per call with points."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    idx = _line_rows(gen, kind, p, n_rows, cuda_device)
    g = torch.randn(p, c, generator=gen, device=cuda_device).to(getattr(torch, dtype))
    n0 = k3.LAUNCHES["segment_sum_small"]
    got = k3.segment_sum_small(idx, g, n_rows)
    assert k3.LAUNCHES["segment_sum_small"] == n0 + int(p > 0)
    assert got.dtype == torch.float32 and got.shape == (n_rows, c)
    assert torch.equal(got, k3.segment_sum_small(idx, g, n_rows))
    assert torch.equal(got.cpu(), k3.segment_sum_small_ordered(idx.cpu(), g.cpu(), n_rows))
    if p == 0:
        assert not got.any()


@pytest.mark.gpu
def test_apply_mlp_bf16_products_sum_in_f32_on_card(cuda_device):
    """apply_mlp's bf16 hidden products (cuBLAS) at the model's widths
    (27 -> 128 -> 128) on 524,288 points against the same products taken
    in f32 on the card (TF32 off) and rounded to bf16: within one bf16 ulp
    plus the f32 reorder bound K 2^-24 sum_k |x_k w_k| (two f32 sums of the
    same terms in other orders differ by at most that). A sum with bf16
    partial sums would miss by ~2^-8 of sum_k |x_k w_k|. The output agrees
    with the f32-product reference to test_apply_mlp's bf16 tolerance."""
    import torch.nn.functional as F

    from localrf_tpu_torch.models.tensorf import TensorfConfig, apply_mlp, init_mlp

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TensorfConfig(grid_size=(640, 640, 640), mlp_dtype="bfloat16")
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    mlp = {k.removeprefix("mlp."): v for k, v in init_mlp(cfg, gen, cuda_device).items()}
    p = 4096 * 128
    feat = torch.randn(p, cfg.app_dim, generator=gen, device=cuda_device)
    vd = torch.nn.functional.normalize(torch.randn(p, 3, generator=gen, device=cuda_device), dim=-1)
    bf = torch.bfloat16

    def check(x, w):
        got = torch.matmul(x, w).float()
        ref = torch.matmul(x.float(), w.float())
        reorder = x.shape[1] * 2.0**-24 * torch.matmul(x.float().abs(), w.float().abs())
        ref16 = ref.to(bf).float()
        mag = torch.maximum(got.abs(), ref16.abs())
        ulp = torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(mag)) - 7), 2.0**-133)
        err = (got - ref16).abs()
        assert (err <= ulp + reorder).all(), f"{int((err > ulp + reorder).sum())} sums off"

    x = feat.to(bf)
    ref_x = x
    for i in (1, 2):
        w, b = mlp[f"w{i}"].to(bf), mlp[f"b{i}"].to(bf)
        check(x, w)
        x = F.relu(torch.matmul(x, w) + b)
        ref_x = F.relu(torch.matmul(ref_x.float(), w.float()).to(bf) + b)
    w3 = mlp["w3"].to(bf).float()
    ref = torch.sigmoid(torch.matmul(torch.cat([ref_x, vd.to(bf)], -1).float(), w3) + mlp["b3"])
    torch.testing.assert_close(apply_mlp(mlp, None, vd, feat, cfg), ref, rtol=2e-2, atol=1e-2)


def _march_args(g_rows, p, dtype, dev):
    gen = torch.Generator(device=dev).manual_seed(0)

    def leaf(t):
        return t.requires_grad_(True)

    def uni(shape, bound):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound

    args = [leaf((0.1 * torch.randn(p, 128, generator=gen, device=dev)).to(dtype)) for _ in range(3)] + [
        leaf(torch.rand(p, 6, generator=gen, device=dev)),
        leaf(torch.rand(p, 3, generator=gen, device=dev)),
        torch.randint(0, g_rows, (p, 3), generator=gen, device=dev, dtype=torch.int32),
        torch.nn.functional.normalize(torch.randn(p, 3, generator=gen, device=dev), dim=-1),
        leaf((0.1 * torch.randn(3, g_rows, 64, generator=gen, device=dev)).to(dtype)),
        leaf(uni((72, 27), 72**-0.5)), leaf(uni((27, 128), 27**-0.5)), leaf(uni((128,), 27**-0.5)),
        leaf(uni((128, 128), 128**-0.5)), leaf(uni((128,), 128**-0.5)),
        leaf(uni((131, 3), 131**-0.5)), leaf(uni((3,), 0.1)),
    ]
    return args, torch.randn(p, 4, generator=gen, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("g_rows,p,dtype,mlp_dtype", [
    (64, 4096 * 72, "bfloat16", "bfloat16"), (640, 4096 * 332, "bfloat16", "bfloat16"),
    (32, 50_001, "float32", "float32"),
    # ragged: the last tile of 64 points holds 37
    (640, 4096 * 332 + 37, "bfloat16", "bfloat16"),
    # fewer points than one tile, and none
    (64, 5, "bfloat16", "bfloat16"), (64, 0, "bfloat16", "bfloat16"),
    # mixed dtypes: the CUDA-core kernels
    (64, 4096 * 72, "bfloat16", "float32"), (64, 4096 * 72, "float32", "bfloat16"),
])
def test_k4_kernel_matches_plain_on_card(cuda_device, g_rows, p, dtype, mlp_dtype):
    """K4-fwd and K4-bwd: out [P, 4] and every gradient (dtype and value);
    bf16 tables with the bf16 MLP run the tensor-core kernels, every other
    pair the CUDA-core ones. P = 0 launches nothing and gives zeros."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args, gout = _march_args(g_rows, p, getattr(torch, dtype), cuda_device)
    leaves = [a for a in args if a.requires_grad]
    n0 = dict(k4.LAUNCHES)
    out_k = k4.march_core(*args, mlp_dtype)
    out_p = k4.march_core_plain(*args, mlp_dtype)
    grads_k = torch.autograd.grad(out_k, leaves, gout)
    grads_p = torch.autograd.grad(out_p, leaves, gout)
    n = int(p > 0)
    assert k4.LAUNCHES == {"march_fwd": n0["march_fwd"] + n, "march_bwd": n0["march_bwd"] + n}
    f32 = dtype == mlp_dtype == "float32"
    assert out_k.shape == (p, 4)
    if f32:
        torch.testing.assert_close(out_k, out_p, rtol=1e-4, atol=1e-5)
    else:
        torch.testing.assert_close(out_k, out_p, rtol=0.0, atol=1e-2)
    names = "rows0 rows1 rows2 wxy w1l lines basis w1 b1 w2 b2 w3 b3".split()
    for name, leaf, gk, gp in zip(names, leaves, grads_k, grads_p):
        assert gk.dtype == gp.dtype == leaf.dtype and gk.shape == leaf.shape, name
        if p == 0:
            assert not gk.any(), name
            continue
        scale = float(gp.abs().max())
        err = float((gk.float() - gp.float()).abs().max())
        assert err <= (1e-4 if f32 else 2e-2) * scale, f"{name}: {err:.3e} of max {scale:.3e}"
    # rows0 a row short of the other inputs (with P = 0, rows1 a row long)
    if p:
        with pytest.raises(ValueError):
            k4.march_core(args[0][:-1], *args[1:], mlp_dtype)
    else:
        with pytest.raises(ValueError):
            k4.march_core(args[0], args[1].new_zeros(1, 128), *args[2:], mlp_dtype)
    # rows0 a channel narrow
    with pytest.raises(ValueError):
        k4.march_core(args[0][:, :-1], *args[1:], mlp_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("g_rows,p,dtype,mlp_dtype", [
    (64, 4096 * 72, "bfloat16", "bfloat16"), (640, 4096 * 332, "bfloat16", "bfloat16"),
    (32, 50_001, "float32", "float32"), (64, 5, "bfloat16", "bfloat16"),
])
def test_k4_line_gradient_is_fixed_order_on_card(cuda_device, g_rows, p, dtype, mlp_dtype):
    """K4-bwd's dlines: two launches equal bit for bit; K3's sum of the
    factor kernel's per-point cotangents (stage 2) equals
    march_dlines_ordered of that same stage 1 bit for bit, and dlines is it
    cast to the table dtype; stage 1 against march_line_cotangents_plain in
    f32 to 1e-4 and in bf16 to 2e-2 of its largest entry (d_feat comes from
    reordered sums, which can flip a bf16 rounding). K3 launches three times
    a backward."""
    args, gout = _march_args(g_rows, p, getattr(torch, dtype), cuda_device)
    plain = [a.detach() for a in args]
    n3 = k3.LAUNCHES["segment_sum_small"]
    dlines = k4._launch_bwd(plain, gout, mlp_dtype)[5]
    assert k3.LAUNCHES["segment_sum_small"] == n3 + 3
    assert torch.equal(dlines, k4._launch_bwd(plain, gout, mlp_dtype)[5])
    grads, d_lr = k4._launch_bwd_stage1(plain, gout, mlp_dtype)
    assert grads[5] is None and d_lr.shape == (3, p, 64) and d_lr.dtype == plain[0].dtype
    x0 = plain[5]
    stage2 = k4.march_dlines(x0, d_lr, g_rows)
    assert torch.equal(stage2.cpu(), k4.march_dlines_ordered(x0.cpu(), d_lr.cpu(), g_rows))
    assert torch.equal(stage2.to(dlines.dtype), dlines)
    want = k4.march_line_cotangents_plain(*plain, gout, mlp_dtype)
    scale = float(want.abs().max())
    err = float((d_lr.float() - want.float()).abs().max())
    assert err <= (1e-4 if dtype == mlp_dtype == "float32" else 2e-2) * scale, f"{err:.3e} of {scale:.3e}"


# (n_rows, P, index kind, index dtype, payload dtype)
K5_CARD_CASES = [
    (4096, 4096 * 72, "uniform", torch.int64, torch.bfloat16),  # the 64^3 plane
    (4096, 4096 * 72, "hot-tile", torch.int64, torch.bfloat16),  # one tile of 40k points, as in a real 64^3 step
    (409_600, 4096 * 332, "uniform", torch.int64, torch.bfloat16),  # the 640^3 plane
    (2048, 100_000, "hot", torch.int64, torch.bfloat16),  # every point in 60 rows
    (409_600, 300_000, "out-of-range", torch.int64, torch.bfloat16),
    (1000, 0, "uniform", torch.int64, torch.bfloat16),  # P = 0
    (1000, 50_000, "uniform", torch.int64, torch.bfloat16),  # n_rows not a multiple of the tile
    (4096, 150_000, "one-row", torch.int64, torch.bfloat16),  # one row holds 100k points
    (1_000_000, 500_000, "uniform", torch.int64, torch.bfloat16),  # a 1M-row table
    (4096, 100_000, "uniform", torch.int64, torch.float32),  # an f32 payload
    (409_600, 300_000, "uniform", torch.int32, torch.bfloat16),  # int32 indices
]


def _k5_inputs(dev, n_rows, p, kind, idx_dtype, g_dtype, c=128):
    gen = torch.Generator(device=dev).manual_seed(0)
    if kind == "hot":
        idx = torch.randint(0, 60, (p,), generator=gen, device=dev)
    elif kind == "out-of-range":
        idx = torch.randint(-n_rows // 4, n_rows + n_rows // 4, (p,), generator=gen, device=dev)
    else:
        idx = torch.randint(0, n_rows, (p,), generator=gen, device=dev)
    if kind == "one-row":
        idx[torch.randperm(p, generator=gen, device=dev)[:100_000]] = 7
    if kind == "hot-tile":  # 40k points in rows 64..127, skewed to row 64
        u = torch.rand(40_000, generator=gen, device=dev)
        idx[torch.randperm(p, generator=gen, device=dev)[:40_000]] = 64 + (64 * u**4).long()
    g = torch.randn(p, c, generator=gen, device=dev).to(g_dtype)
    return idx.to(idx_dtype), g


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows,p,kind,idx_dtype,g_dtype", K5_CARD_CASES)
def test_k5_kernel_matches_plain_and_is_deterministic(cuda_device, n_rows, p, kind, idx_dtype, g_dtype):
    """K5 equals its ordered plain version bit for bit (f32 and bf16 out) and
    a second launch; each call launches once."""
    idx, g = _k5_inputs(cuda_device, n_rows, p, kind, idx_dtype, g_dtype)
    for dt in (torch.float32, torch.bfloat16):
        n0 = k2.LAUNCHES["segment_sum_merged"]
        got = k2.binned_segment_sum_merged(idx, g, n_rows, dt)
        assert k2.LAUNCHES["segment_sum_merged"] == n0 + 1
        assert got.dtype == dt and got.shape == (n_rows, 128)
        assert torch.equal(got, k2.binned_segment_sum_merged_ordered(idx, g, n_rows, dt))
        assert torch.equal(k2.binned_segment_sum_merged(idx, g, n_rows, dt), got)
        if dt == torch.float32 and kind != "one-row":
            keep = (idx >= 0) & (idx < n_rows)
            torch.testing.assert_close(got, k2.segment_sum_plain(idx[keep], g[keep], n_rows),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [8, 20, 200])
def test_k5_kernel_narrow_and_wide_rows_on_card(cuda_device, c):
    """Rows of 8 (256-row tiles, two lanes of 4), 20 (not a whole number of
    4-value pieces: one value a lane) and 200 values (32-row tiles, two
    passes of the lanes over the channels): bit for bit against the ordered
    plain version, f32 and bf16 payloads."""
    for g_dtype in (torch.float32, torch.bfloat16):
        idx, g = _k5_inputs(cuda_device, 5000, 60_000, "out-of-range", torch.int64, g_dtype, c=c)
        for dt in (torch.float32, torch.bfloat16):
            got = k2.binned_segment_sum_merged(idx, g, 5000, dt)
            assert torch.equal(got, k2.binned_segment_sum_merged_ordered(idx, g, 5000, dt))


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows,p,kind", [(4096, 4096 * 72, "uniform"), (409_600, 300_000, "out-of-range"),
                                           (2048, 100_000, "hot"), (1000, 0, "uniform"),
                                           (4096, 4096 * 72, "hot-tile")])
def test_k5_bins_are_merged_bins_plain_on_card(cuda_device, n_rows, p, kind):
    """K5's two sort levels equal merged_bins_plain (torch.equal): the tile
    starts, each tile's (id, row) in increasing id (level 1) and its ids by
    row (level 2, read from the global scratch: seg_cap 0 sends every tile
    there), and the sum has the same bits as with the segments sorted in
    shared memory."""
    idx, g = _k5_inputs(cuda_device, n_rows, p, kind, torch.int64, torch.bfloat16)
    want = k2.merged_bins_plain(idx, n_rows, k2.merged_plan(p, 128, n_rows))
    n = int(want["starts"][-1])
    ref = k2.binned_segment_sum_merged(idx, g, n_rows, torch.bfloat16)
    out, sched = k2._merged_cuda(idx, g, n_rows, torch.bfloat16, seg_cap=0)
    assert torch.equal(sched["tile_start"].long(), want["starts"])
    assert torch.equal(sched["bins"][:n, 0].long(), want["by_point"])
    assert torch.equal(sched["bins"][:n, 1].long(), want["by_point_row"])
    assert torch.equal(sched["scratch"][:n].long(), want["by_row"])
    assert torch.equal(out, ref)


@pytest.mark.gpu
def test_k5_workspace_is_the_padded_matrix_and_its_chunk_sums(cuda_device):
    """The kernels size K5's workspace: the [tiles, ranges] count matrix
    padded to whole scan chunks of 4,096 ints, then one sum per chunk; -1
    past the 58,112 tiles a block counts in its 227 KB of shared memory, and
    the wrapper then raises before it allocates."""
    plan = k2.merged_plan(4096 * 332, 128, 409_600)  # the 640^3 plane: 6,400 x 664
    n_mat = -(-6400 * 664 // 4096) * 4096
    assert k2._merged_workspace(plan) == n_mat + n_mat // 4096
    assert k2._merged_workspace(plan._replace(n_tiles=58_112, n_ranges=1)) == 4096 * 15 + 15
    assert k2._merged_workspace(plan._replace(n_tiles=58_113, n_ranges=1)) == -1
    idx = torch.zeros(10, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="tiles"):
        k2.binned_segment_sum_merged(idx, torch.zeros(10, 128, device=cuda_device), 64 * 58_113)


@pytest.mark.gpu
def test_k5_captured_replay_equals_eager_call(cuda_device):
    """A K5 call captured in a CUDA graph (no host sync, every buffer sized
    from the shapes) and replayed on new values equals the eager call."""
    idx, g = _k5_inputs(cuda_device, 409_600, 4096 * 332, "uniform", torch.int64, torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k2.binned_segment_sum_merged(idx, g, 409_600, torch.bfloat16)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k2.binned_segment_sum_merged(idx, g, 409_600, torch.bfloat16)
    new_idx, new_g = _k5_inputs(cuda_device, 409_600, 4096 * 332, "out-of-range", torch.int64, torch.bfloat16)
    idx.copy_(new_idx)
    g.copy_(new_g)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, k2.binned_segment_sum_merged(idx, g, 409_600, torch.bfloat16))


@pytest.mark.gpu
def test_k5_calls_no_library_sort(cuda_device, monkeypatch):
    """K5's card path sorts by hand: with torch.sort, torch.argsort,
    torch.searchsorted and Tensor.index_select made to raise, a call still
    runs and gives the ordered version's bits."""
    idx, g = _k5_inputs(cuda_device, 409_600, 300_000, "out-of-range", torch.int64, torch.bfloat16)

    def refuse(*args, **kwargs):
        raise AssertionError("K5 called a library sort, search or gather")

    with monkeypatch.context() as m:
        for owner, name in ((torch, "sort"), (torch, "argsort"), (torch, "searchsorted"),
                            (torch.Tensor, "sort"), (torch.Tensor, "argsort"),
                            (torch.Tensor, "index_select")):
            m.setattr(owner, name, refuse)
        got = k2.binned_segment_sum_merged(idx, g, 409_600, torch.bfloat16)
    assert torch.equal(got, k2.binned_segment_sum_merged_ordered(idx, g, 409_600, torch.bfloat16))


# density L1 kernel cases: (G, ranks, scale of the factors, relu). 64^3 and
# 640^3 with the default ranks, 300^3 with VM-192's; 300 and 100 are no
# multiple of the 128-column tile, and 300^2 and 100^2 no multiple of the
# 64-row tile; uneven ranks; features of std ~20 put voxels past softplus's
# threshold and under the clamp; relu in place of softplus, on factors that
# are multiples of 2^-10 (the field is then exact in any summation order, so
# the relu and clamp masks are compared voxel for voxel; random factors put
# voxels just above the clamp, where the gradient 1/(2 sqrt f) magnifies
# f's rounding: there the kernel and the blocked path, which sums f in
# another order, differ by up to 8.5e-5 of the largest entry on the H100)
L1_CARD_CASES = [(64, (8, 8, 8), 1.0, False), (300, (16, 16, 16), 1.0, False), (640, (8, 8, 8), 1.0, False),
                 (100, (16, 4, 4), 1.0, False), (64, (8, 8, 8), 20.0, False), (64, (8, 8, 8), 1.0, True)]


def _l1_field(dev, g: int, ranks, scale: float):
    gen = torch.Generator(device=dev).manual_seed(g)
    planes = [0.1 * scale * torch.randn(c, g, g, generator=gen, device=dev) for c in ranks]
    lines = [0.1 * scale * torch.randn(c, g, generator=gen, device=dev) for c in ranks]
    return planes, lines


def _l1_blocked(planes, lines, relu: bool) -> tuple:
    """(value, plane gradients..., line gradients...) of the kernel's plain
    version, models/tensorf.py's density_l1_blocked, in f32."""
    from localrf_tpu_torch.models import tensorf as ttf

    g = lines[0].shape[1]
    cfg = ttf.TensorfConfig(grid_size=(g, g, g), density_n_comp=tuple(p.shape[0] for p in planes),
                            density_shift=-5.0, fea2dense_act="relu" if relu else "softplus")
    leaves = [t.detach().clone().requires_grad_(True) for t in (*planes, *lines)]
    params = {f"density_{part}_{i}": leaves[3 * j + i] for j, part in enumerate(("plane", "line")) for i in range(3)}
    value = ttf.density_l1_blocked(params, cfg)
    return (value.detach(), *torch.autograd.grad(value, leaves))


@pytest.mark.gpu
@pytest.mark.parametrize("g,ranks,scale,relu", L1_CARD_CASES)
def test_density_l1_kernel_matches_plain_on_card(cuda_device, g, ranks, scale, relu):
    """The kernel through its autograd Function against its plain version
    (the blocked path, f32): the value within 1e-5 relative; each gradient
    entry within 1e-5 of the gradient's largest entry (an entry sums G plane
    or G^2 line products of both signs, here in another order; each side's
    own f32 error against an f64 reference stays under that at 640^3:
    chip_smoke.py's check_l1 prints both); one launch per call, two
    launches bit-equal."""
    from localrf_tpu_torch.ops.kernels import density_l1 as l1

    planes, lines = _l1_field(cuda_device, g, ranks, scale)
    if relu:
        planes, lines = ([torch.round(t * 640) / 1024 for t in ts] for ts in (planes, lines))
    leaves = [t.clone().requires_grad_(True) for t in planes + lines]
    n0 = l1.LAUNCHES["density_l1"]
    val = l1.density_l1(leaves[:3], leaves[3:], -5.0, relu)
    grads = torch.autograd.grad(val * 3.0, leaves)
    assert l1.LAUNCHES["density_l1"] == n0 + 1
    ref = _l1_blocked(planes, lines, relu)
    assert abs(float(val.detach()) - float(ref[0])) <= 1e-5 * abs(float(ref[0]))
    for got, want in zip(grads, ref[1:]):
        torch.testing.assert_close(got, 3.0 * want, rtol=0.0, atol=3e-5 * float(want.abs().max()))
    again = l1._launch(planes, lines, -5.0, relu)
    first = l1._launch(planes, lines, -5.0, relu)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
def test_density_l1_captured_replay_equals_eager_call(cuda_device):
    """The kernel captured in a CUDA graph (no host sync, every buffer from
    PyTorch's allocator) and replayed on new factors equals the eager call."""
    from localrf_tpu_torch.ops.kernels import density_l1 as l1

    planes, lines = _l1_field(cuda_device, 300, (16, 16, 16), 1.0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        l1._launch(planes, lines, -5.0, False)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = l1._launch(planes, lines, -5.0, False)
    new_planes, new_lines = _l1_field(cuda_device, 300, (16, 16, 16), 2.0)
    for t, new in zip(planes + lines, new_planes + new_lines):
        t.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, l1._launch(planes, lines, -5.0, False)))


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [(48, 48, 48), (48, 40, 56)])
def test_density_l1_takes_the_kernel_on_cubic_grids_on_card(cuda_device, grid):
    """models/tensorf.py's density_l1 on the card: a cubic grid launches the
    kernel (`l1.kernel` counts), any other takes the blocked path
    (`l1.blocked`, no launch); both agree with the blocked path's value."""
    from localrf_tpu_torch.models import tensorf as ttf
    from localrf_tpu_torch.ops.kernels import density_l1 as l1
    from localrf_tpu_torch.utils import profiling

    cfg = ttf.TensorfConfig(grid_size=grid)
    field = ttf.init_tensorf(cfg, torch.Generator().manual_seed(0), "cpu").to(cuda_device)
    n0 = l1.LAUNCHES["density_l1"]
    profiling.RECORDER.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        val = ttf.density_l1(field, cfg)
        counts = profiling.counters()
    cubic = grid[0] == grid[1] == grid[2]
    assert counts.get("l1.kernel" if cubic else "l1.blocked") == 1
    assert ("l1.blocked" if cubic else "l1.kernel") not in counts
    assert l1.LAUNCHES["density_l1"] == n0 + cubic
    blocked = ttf.density_l1({k: v.cpu() for k, v in field.named_parameters()}, cfg)
    assert abs(float(val.detach()) - float(blocked.detach())) <= 1e-5 * abs(float(blocked.detach()))


def _k3_plan_before_column_tiles(p: int, n_rows: int, c: int) -> tuple:
    """segsum_plan as it was before rows wider than MAX_C were tiled (C <=
    64 only): (tile_rows, n_tiles, n_ranges, range_len)."""
    tile_rows = max(1, min(n_rows, k3.ACC_FLOATS // c))
    n_tiles = -(-n_rows // tile_rows)
    n_ranges = max(1, min(-(-p // k3.MIN_RANGE), k3.BLOCKS // n_tiles, k3.SCRATCH_FLOATS // max(n_rows * c, 1)))
    range_len = max(1, -(-(-(-p // n_ranges)) // k3.RANGE_ALIGN)) * k3.RANGE_ALIGN
    return tile_rows, n_tiles, max(1, -(-p // range_len)), range_len


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows,p,c,dtype,kind", [
    (500, 4096 * 259, 768, "bfloat16", "ball"),  # a CP-384 step's line sum at 500^3
    (500, 200_000, 768, "float32", "out-of-range"), (300, 60_000, 100, "bfloat16", "uniform"),
    (70, 30_000, 131, "float32", "hot"),  # odd C: plain copies, one channel a lane
])
def test_k3_column_tiles_are_its_ordered_plain_version_on_card(cuda_device, n_rows, p, c, dtype, kind):
    """Rows wider than MAX_C sum in column tiles in the order segsum_plan
    fixes: bit for bit equal to segment_sum_small_ordered (CPU copies), to
    a second launch and to a captured graph's replay."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    idx = _line_rows(gen, kind, p, n_rows, cuda_device)
    g = torch.randn(p, c, generator=gen, device=cuda_device).to(getattr(torch, dtype))
    assert k3.segsum_plan(p, n_rows, c).n_col_tiles == -(-c // k3.MAX_C)
    got = k3.segment_sum_small(idx, g, n_rows)
    assert got.dtype == torch.float32 and got.shape == (n_rows, c)
    assert torch.equal(got, k3.segment_sum_small(idx, g, n_rows))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k3.segment_sum_small(idx, g, n_rows)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = k3.segment_sum_small(idx, g, n_rows)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, got)
    assert torch.equal(got.cpu(), k3.segment_sum_small_ordered(idx.cpu(), g.cpu(), n_rows))


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows,p,c", [(640, 4096 * 332, 64), (64, 4096 * 72, 64), (300, 50_000, 7),
                                        (1500, 200_000, 64), (640, 0, 64)])
def test_k3_plan_and_sum_up_to_64_columns_are_unchanged_on_card(cuda_device, n_rows, p, c):
    """Up to MAX_C columns K3's plan is the one it had before column tiles
    (one column tile), and its sum is that plan's ordered plain version."""
    plan = k3.segsum_plan(p, n_rows, c)
    assert plan == k3.SegsumPlan(*_k3_plan_before_column_tiles(p, n_rows, c)) and plan.n_col_tiles == 1
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    idx = _line_rows(gen, "ball", p, n_rows, cuda_device)
    g = torch.randn(p, c, generator=gen, device=cuda_device).to(torch.bfloat16)
    got = k3.segment_sum_small(idx, g, n_rows)
    assert torch.equal(got.cpu(), k3.segment_sum_small_ordered(idx.cpu(), g.cpu(), n_rows))


@pytest.mark.gpu
def test_density_l1_of_a_cp_field_at_500_takes_the_kernel_on_card(cuda_device):
    """A CP-384 field's L1 term at 500^3 (K = 96: B whole would not fit the
    block's shared memory, so the kernel streams it) through
    models/tensorf.py's density_l1 (`l1.cp` and `l1.kernel` count, one
    launch) against the blocked path in f64: the value within 1e-5
    relative, each line's gradient within 3e-5 of its largest entry; two
    launches bit-equal."""
    from localrf_tpu_torch.models import tensorf as ttf
    from localrf_tpu_torch.ops.kernels import density_l1 as l1
    from localrf_tpu_torch.utils import profiling

    g = 500
    cfg = ttf.TensorfConfig(grid_size=(g, g, g), density_n_comp=(96,), app_n_comp=(288,), decomposition="cp")
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    lines = [(0.1 * torch.randn(96, g, generator=gen, device=cuda_device)).requires_grad_(True) for _ in range(3)]
    params = {f"density_line_{i}": lines[i] for i in range(3)}
    n0 = l1.LAUNCHES["density_l1"]
    profiling.RECORDER.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        val = ttf.density_l1(params, cfg)
        counts = profiling.counters()
    assert counts.get("l1.cp") == 1 and counts.get("l1.kernel") == 1 and "l1.blocked" not in counts
    assert l1.LAUNCHES["density_l1"] == n0 + 1
    grads = torch.autograd.grad(val, lines)
    exact = [t.detach().double().requires_grad_(True) for t in lines]
    ref = ttf.density_l1_blocked({f"density_line_{i}": exact[i] for i in range(3)}, cfg)
    want = torch.autograd.grad(ref, exact)
    assert abs(float(val.detach()) - float(ref.detach())) <= 1e-5 * abs(float(ref.detach()))
    for got, w in zip(grads, want):
        torch.testing.assert_close(got.double(), w, rtol=0.0, atol=3e-5 * float(w.abs().max()))
    planes, rest = ttf.l1_factors(params, cfg)
    first = l1._launch([planes[0].detach()], [rest[0].detach()], -5.0, False)
    again = l1._launch([planes[0].detach()], [rest[0].detach()], -5.0, False)
    assert len(first) == 3 and all(torch.equal(a, b) for a, b in zip(first, again))


def _chunk_models(dev, n: int):
    from localrf_tpu_torch.data.dataset import SyntheticDataset
    from localrf_tpu_torch.data.pool import DevicePixelPool
    from localrf_tpu_torch.models.local import LocalConfig, LocalTensorfs
    from localrf_tpu_torch.models.tensorf import TensorfConfig

    w, h = 96, 64
    rng = np.random.default_rng(1)
    shape = (6, h, w)
    arrays = dict(
        rgbs=rng.random((*shape, 3), dtype=np.float32),
        invdepths=0.1 + 0.9 * rng.random(shape, dtype=np.float32),
        fwd_flow=rng.normal(0, 2, (*shape, 2)).astype(np.float32), fwd_mask=np.ones(shape, np.float32),
        bwd_flow=rng.normal(0, 2, (*shape, 2)).astype(np.float32), bwd_mask=np.ones(shape, np.float32),
    )
    tf = TensorfConfig(grid_size=(32, 32, 32), pallas_composite=True, binned_min_rows=500)
    cfg = LocalConfig(WH=(w, h), n_init_frames=6, n_views=4, batch_size=512, occ_min=8, tensorf=tf)
    out = []
    for i in range(n):
        ds = SyntheticDataset(arrays["rgbs"], "train", **{k: v for k, v in arrays.items() if k != "rgbs"},
                              n_init_frames=6, test_frame_every=3)
        m = LocalTensorfs(cfg, device=dev)
        m.is_refining = True
        m.rf_iter[-1] = 2
        m.n_iters_reg = 4  # the L1 branch turns off inside the first chunk
        if i == 0:
            m.attach_pool(DevicePixelPool(ds, capacity=8, device=dev))
        out.append((m, ds))
    return out


@pytest.mark.gpu
def test_captured_chunk_matches_eager_steps_on_card(cuda_device):
    """Two chunks through captured graphs (pooled; test-pose steps and an
    L1 flip make several keys) against the same batches as eager steps from
    the same initial state. A key is captured once, when first seen, and
    the launch counters move only then (a replay calls no wrapper). The
    eager steps are chunks of one under eager_chunks.eager_steps."""
    from eager_chunks import eager_steps
    from localrf_tpu_torch.ops.kernels import composite

    torch.backends.cuda.matmul.allow_tf32 = False
    (mg, dsg), (me, dse) = _chunk_models(cuda_device, 2)
    for chunk in range(2):
        bg = mg.plan_chunk(dsg, True, max_len=8)
        be = me.plan_chunk(dse, True, max_len=8)
        assert len(bg) == len(be) == 8
        n0 = dict(composite.LAUNCHES)
        captures, keys = mg._graphs.captures, set(mg._graphs.graphs)
        mg.run_chunk(bg, optimize_poses=True)
        n1 = dict(composite.LAUNCHES)
        new_keys = set(mg._graphs.graphs) - keys
        eager = []
        for b in be:
            with eager_steps(me):
                me.run_chunk([b], optimize_poses=True)
            eager.append(dict(me.last_metrics))
        for i, m in enumerate(eager):
            for k, v in m.items():
                got = float(mg.chunk_metrics[k][i])
                assert np.isfinite(got)
                rtol = 1e-6 if chunk == 0 and i == 0 else 1e-3
                assert abs(got - v) <= rtol * abs(v) + 1e-7, (chunk, i, k, got, v)
        assert mg._graphs.captures == captures + len(new_keys)
        assert (n1 != n0) == bool(new_keys)
        if chunk == 0:
            assert len(new_keys) >= 2
    assert mg.rf_iter == me.rf_iter


@pytest.mark.gpu
def test_chunks_of_one_over_host_batches_match_eager_steps_on_card(cuda_device):
    """`--scan_chunk 1` on a card: with no pool, each single step is a
    chunk of one, a captured graph replayed over the batch values shipped
    from the host. Over 8 steps (test-pose steps and an L1 flip among them)
    its losses match the same batches as eager steps from the same initial
    state; every step after its key's capture is a replay."""
    from eager_chunks import eager_steps

    torch.backends.cuda.matmul.allow_tf32 = False
    _, (mg, dsg), (me, dse) = _chunk_models(cuda_device, 3)
    assert mg.pool is None and me.pool is None
    bg = mg.plan_chunk(dsg, True, max_len=8)
    be = me.plan_chunk(dse, True, max_len=8)
    assert len(bg) == len(be) == 8 and any(b["train_test_poses"] for b in bg)
    for i, (b, c) in enumerate(zip(bg, be)):
        mg.run_chunk([b], optimize_poses=True)
        with eager_steps(me):
            me.run_chunk([c], optimize_poses=True)
        for k, v in me.last_metrics.items():
            got = mg.last_metrics[k]
            assert np.isfinite(got)
            rtol = 1e-6 if i == 0 else 1e-3
            assert abs(got - v) <= rtol * abs(v) + 1e-7, (i, k, got, v)
    graphs = mg._graphs
    assert graphs.captures == len(graphs) >= 2 and graphs.captures + graphs.replays == 8
    assert mg.rf_iter == me.rf_iter


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits as integers (NaN compares equal to itself)."""
    if not t.dtype.is_floating_point:
        return t
    return t.reshape(-1).view({4: torch.int32, 2: torch.int16}[t.element_size()])


def _trained_state(m) -> dict:
    f = m.fields[-1]
    out = dict(f["params"].named_parameters())
    out.update({f"m.{k}": v for k, v in f["opt"].m.items()})
    out.update({f"v.{k}": v for k, v in f["opt"].v.items()})
    out.update(step=f["opt"].step, lr_scale=f["opt"].lr_scale)
    p = m._pose_dev
    for name in ("r", "t", "exposure"):
        out[name] = getattr(p, name)
        for i, x in enumerate(getattr(p, name[0] + "_opt")):
            out[f"{name}_opt.{i}"] = x
    return out


@pytest.mark.gpu
def test_captured_chunk_bit_exact_with_fixed_order_sums(cuda_device, monkeypatch):
    """With every sum of the step in a fixed order (torch's deterministic
    algorithms; the plane gathers' VJP through K5, K2's function without
    atomics), a pooled chunk of captured graphs with test-pose steps and an
    L1 flip equals the same steps taken eagerly (chunks of one under
    eager_chunks.eager_steps), bit for bit: every loss, the field and its
    Adam state, the pose window and its Adam state (the window's padding
    rows hold NaN, as in JAX, and compare by their bits)."""
    from eager_chunks import eager_steps

    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(k2, "segment_sum", k2.binned_segment_sum_merged)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (mg, dsg), (me, dse) = _chunk_models(cuda_device, 2)
        bg = mg.plan_chunk(dsg, True, max_len=8)
        be = me.plan_chunk(dse, True, max_len=8)
        assert any(b["train_test_poses"] for b in be)
        mg.run_chunk(bg, optimize_poses=True)
        assert len(mg._graphs) >= 2
        for i, b in enumerate(be):
            with eager_steps(me):
                me.run_chunk([b], optimize_poses=True)
            for k, v in me.last_metrics.items():
                assert float(mg.chunk_metrics[k][i]) == v, (i, k)
        got, want = _trained_state(mg), _trained_state(me)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(_bits(got[k]), _bits(want[k])), k
    finally:
        torch.use_deterministic_algorithms(prev)


@pytest.mark.gpu
def test_default_step_launches_the_fused_march_once_each_way(cuda_device):
    """A default bf16 field at 64^3 (TensorfConfig's defaults: the fused
    march on) takes one eager training step through K4 (a chunk of one
    under eager_chunks.eager_steps): K4-fwd and K4-bwd launch once each, the
    step counts `march.fused` once and no `march.unfused`, and its losses
    are finite."""
    from eager_chunks import eager_steps
    from localrf_tpu_torch.data.dataset import SyntheticDataset
    from localrf_tpu_torch.models.local import LocalConfig, LocalTensorfs
    from localrf_tpu_torch.models.tensorf import TensorfConfig
    from localrf_tpu_torch.utils import profiling

    w, h = 96, 64
    rng = np.random.default_rng(3)
    shape = (4, h, w)
    ds = SyntheticDataset(rng.random((*shape, 3), dtype=np.float32), "train",
                          invdepths=0.1 + 0.9 * rng.random(shape, dtype=np.float32),
                          fwd_flow=rng.normal(0, 2, (*shape, 2)).astype(np.float32),
                          fwd_mask=np.ones(shape, np.float32),
                          bwd_flow=rng.normal(0, 2, (*shape, 2)).astype(np.float32),
                          bwd_mask=np.ones(shape, np.float32), n_init_frames=4, test_frame_every=0)
    tf = TensorfConfig(grid_size=(64, 64, 64), pallas_composite=True, gather_dtype="bfloat16",
                       mlp_dtype="bfloat16")
    m = LocalTensorfs(LocalConfig(WH=(w, h), n_init_frames=4, n_views=4, batch_size=1024, tensorf=tf),
                      device=cuda_device)
    batch = ds.sample(1024, False, True, n_views=4)
    n0 = dict(k4.LAUNCHES)
    profiling.RECORDER.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), eager_steps(m):
        m.run_chunk([batch], optimize_poses=True)
        counts = profiling.counters()
    assert k4.LAUNCHES == {"march_fwd": n0["march_fwd"] + 1, "march_bwd": n0["march_bwd"] + 1}
    assert counts.get("march.fused") == 1 and "march.unfused" not in counts
    assert all(np.isfinite(v) for v in m.last_metrics.values())


@pytest.mark.gpu
def test_spawn_step_and_blended_eval_card_matches_cpu(cuda_device):
    """A 32^3 f32 model on the card and on the CPU spawns a field, slides,
    takes one step on it (losses rtol 1e-4) and renders one blended 40x30
    frame (rtol 1e-4 / atol 1e-4): chip_smoke's check_spawn_eval_against_cpu."""
    import chip_smoke

    chip_smoke.check_spawn_eval_against_cpu(cuda_device)


@pytest.mark.gpu
def test_eval_frame_launches_k1_once_per_chunk_and_field(cuda_device):
    """A blended frame of two fields on the card launches K1-fwd once per
    chunk and field (the last chunk padded: one shape a frame) and no
    backward kernel; floater_thresh launches none; the cached retired field
    is dropped by clear_eval_cache."""
    from localrf_tpu_torch.models.local import LocalConfig, LocalTensorfs
    from localrf_tpu_torch.models.tensorf import TensorfConfig

    w, h = 40, 30
    tf = TensorfConfig(grid_size=(24, 24, 24), pallas_composite=True)
    m = LocalTensorfs(LocalConfig(WH=(w, h), n_init_frames=3, n_overlap=2, tensorf=tf), device=cuda_device)
    m.append_frame()
    m.append_rf(2)
    view = int(np.argmin(np.abs(m.blending_weights[:, 1] - 0.5)))
    assert 0 < m.blending_weights[view, 0] < 1
    for counts in (k1.LAUNCHES, k2.LAUNCHES):
        for k in counts:
            counts[k] = 0
    rgb, depth, _, _ = m.forward_eval(np.arange(w * h), np.array([view]), w, h, chunk=512)
    assert rgb.device.type == "cuda" and torch.isfinite(rgb).all() and torch.isfinite(depth).all()
    assert k1.LAUNCHES == {"fused_weights_fwd": 2 * 5, "fused_weights_bwd": 0}
    assert not any(k2.LAUNCHES.values())
    assert "_dev_cache" in m.fields[0]
    m.forward_eval(np.arange(w * h), np.array([view]), w, h, chunk=512, floater_thresh=0.5)
    assert k1.LAUNCHES["fused_weights_fwd"] == 10
    m.clear_eval_cache()
    assert "_dev_cache" not in m.fields[0]


@pytest.mark.gpu
@pytest.mark.parametrize("floater_thresh", [0.0, 0.5])
def test_render_frame_makes_no_host_sync(cuda_device, floater_thresh):
    """render_frame's loop over a frame's chunks waits on the card nowhere
    (torch's sync check set to "error"), with the coarse probe and
    compaction of an alpha volume, and with floater_thresh."""
    from localrf_tpu_torch.models.step import render_frame
    from localrf_tpu_torch.models.tensorf import TensorfConfig, build_combined_quad_views, init_tensorf

    cfg = TensorfConfig(grid_size=(32, 32, 32), pallas_composite=True, occ_m=12)
    params = init_tensorf(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    ax = torch.linspace(-1, 1, 16, device=cuda_device)
    zz, yy, xx = torch.meshgrid(ax, ax, ax, indexing="ij")
    alpha = ((xx**2 + yy**2 + zz**2) < 0.6**2).float()
    ids = torch.arange(4 * 300, device=cuda_device).reshape(4, 300)
    args = (params, cfg, ids, torch.eye(3, 4, device=cuda_device),
            torch.full((), 30.0, device=cuda_device), torch.tensor([20.0, 15.0], device=cuda_device))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rgb, depth = render_frame(*args, w=40, h=30, floater_thresh=floater_thresh, alpha_volume=alpha,
                                  quad=build_combined_quad_views(params, cfg) if cfg.fast_gather else None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert rgb.shape == (1200, 3) and depth.shape == (1200,)
    assert torch.isfinite(rgb).all() and torch.isfinite(depth).all()


@pytest.mark.gpu
def test_checkpoint_round_trip_on_card(cuda_device, tmp_path):
    """A model on the card after a spawn: save, load on the card; the state
    is equal bit for bit (the live rows of the pose window), the retired
    field on the host, and a blended eval frame equal."""
    from localrf_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from localrf_tpu_torch.models.local import LocalConfig, LocalTensorfs
    from localrf_tpu_torch.models.tensorf import TensorfConfig

    w, h = 40, 30
    tf = TensorfConfig(grid_size=(24, 24, 24), pallas_composite=True, gather_dtype="bfloat16")
    m = LocalTensorfs(LocalConfig(WH=(w, h), n_init_frames=3, n_overlap=2, moment_dtype="bfloat16", tensorf=tf),
                      device=cuda_device)
    m.append_frame()
    m.append_rf(2)
    path = str(tmp_path / "ckpt.th")
    save_checkpoint(m, path)
    m2 = load_checkpoint(path, device=cuda_device)
    assert m2.fields[0]["params"]["basis_mat"].device.type == "cpu"
    assert m2.fields[1]["opt"].m["basis_mat"].dtype == torch.bfloat16
    for a, b in zip(m.fields, m2.fields):
        for (k, p), (_, q) in zip(a["params"].named_parameters(), b["params"].named_parameters()):
            assert torch.equal(p.cpu(), q.cpu()), k
    n = m.win_len
    assert torch.equal(m._pose_dev.t[:n], m2._pose_dev.t[:n])
    view = int(np.argmin(np.abs(m.blending_weights[:, 1] - 0.5)))
    for x, y in zip(m.forward_eval(np.arange(w * h), np.array([view]), w, h, chunk=512),
                    m2.forward_eval(np.arange(w * h), np.array([view]), w, h, chunk=512)):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_jax_fixture_renders_on_card(cuda_device):
    """The committed JAX-written checkpoint (tests/jax_checkpoint_fixture.py)
    loads on the card and renders its view within chip_smoke's FIXTURE_TOL
    of JAX's CPU frame."""
    import chip_smoke
    from localrf_tpu_torch.checkpoint import load_checkpoint

    fx = np.load(f"{chip_smoke.FIXTURE}_frame.npz")
    m = load_checkpoint(f"{chip_smoke.FIXTURE}.th", device=cuda_device)
    rgb, depth, _, _ = m.forward_eval(np.arange(m.W * m.H), np.array([int(fx["view"])]), m.W, m.H,
                                      chunk=int(fx["chunk"]))
    rtol, atol = chip_smoke.FIXTURE_TOL
    np.testing.assert_allclose(rgb.cpu().numpy(), fx["rgb"], rtol=rtol, atol=atol)
    np.testing.assert_allclose(depth.cpu().numpy(), fx["depth"], rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_reconstruction_and_render_only_on_card(cuda_device, tmp_path):
    """reconstruction at 40x30 on the card (tests/test_e2e_driver.py's
    flags, chunks of 4 over the pixel pool) writes the CLI's outputs, and
    render_test renders the test frames into the same PNG bytes."""
    import json
    import os

    import chip_smoke
    from localrf_tpu_torch.config import config_parser
    from localrf_tpu_torch.train import reconstruction, render_test

    scene, log = str(tmp_path / "scene"), str(tmp_path / "log")
    chip_smoke.write_scene(scene, 40, 30, 8)
    argv = ["--datadir", scene, "--logdir", log, "--batch_size", "64", "--n_views", "4", "--n_init_frames", "3",
            "--n_iters_per_frame", "6", "--n_iters_reg", "3", "--N_voxel_init", str(14**3),
            "--N_voxel_final", str(20**3), "--upsamp_list", "4", "--update_AlphaMask_list", "5",
            "--add_frames_every", "3", "--n_overlap", "2", "--n_max_frames", "6", "--max_drift", "100",
            "--test_frame_every", "4", "--vis_every", "10", "--fov", "60", "--scan_chunk", "4",
            "--skip_saving_video"]
    model, metrics = reconstruction(config_parser(argv))
    assert model.device.type == "cuda" and len(model.fields) >= 2
    with open(f"{log}/transforms.json") as f:
        assert len(json.load(f)["frames"]) == 8
    assert os.path.isfile(f"{log}/checkpoints_tmp.th") and metrics
    folder = f"{log}/test/rgb_maps"
    pngs = {p: open(f"{folder}/{p}", "rb").read() for p in sorted(os.listdir(folder))}
    for p in pngs:
        os.remove(f"{folder}/{p}")
    render_test(config_parser(argv + ["--render_only", "1", "--render_path", "0"]))
    assert {p: open(f"{folder}/{p}", "rb").read() for p in sorted(os.listdir(folder))} == pngs


@pytest.fixture
def tf32_allowed():
    """cuDNN's and cuBLAS's TF32 allowed for f32 during the test (torch's
    default allows it for cuDNN's convolutions; some tests above turn
    cuBLAS's off), the settings restored after."""
    conv, matmul = torch.backends.cudnn.conv, torch.backends.cuda.matmul
    saved = conv.fp32_precision, matmul.fp32_precision
    conv.fp32_precision = matmul.fp32_precision = "tf32"
    yield
    conv.fp32_precision, matmul.fp32_precision = saved


def _smooth_pair(h: int = 270, w: int = 480) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = (0.5 + 0.3 * np.sin(2 * np.pi * (3 * xx + 2 * yy)))[..., None] * np.array([1.0, 0.8, 0.6])
    return img.astype(np.float32), np.clip(img + rng.normal(0, 0.01, img.shape), 0, 1).astype(np.float32)


@pytest.mark.gpu
def test_metrics_on_card_match_cpu_with_tf32_allowed(cuda_device, tf32_allowed):
    """rgb_ssim and rgb_lpips on CUDA tensors with TF32 allowed equal their
    CPU values within tests/test_torch_eval.py's 1e-5: their convolutions
    run in full f32 by their own scope (TF32 operands move this SSIM by
    ~1e-2)."""
    from localrf_tpu_torch.utils.metrics import rgb_lpips, rgb_ssim

    a, b = _smooth_pair()
    ta, tb = torch.from_numpy(a).to(cuda_device), torch.from_numpy(b).to(cuda_device)
    assert abs(rgb_ssim(ta, tb, 1.0) - rgb_ssim(a, b, 1.0)) <= 1e-5
    assert abs(rgb_lpips(ta, tb) - rgb_lpips(a, b)) <= 1e-5


@pytest.mark.gpu
def test_raft_card_matches_cpu(cuda_device, tf32_allowed):
    """A random RAFT (init_raft, seed 0) on a fwd / bwd pair of 128x160,
    12 iterations, with TF32 allowed: the card within 1e-4 of the flow's
    scale of the CPU."""
    from localrf_tpu_torch.preprocess.raft import init_raft

    rng = np.random.default_rng(1)
    im1 = rng.uniform(0, 255, (1, 3, 128, 160)).astype(np.float32)
    im2 = np.clip(im1 + rng.normal(0, 8, im1.shape), 0, 255).astype(np.float32)
    a, b = torch.from_numpy(np.concatenate([im1, im2])), torch.from_numpy(np.concatenate([im2, im1]))
    ref = init_raft(torch.Generator().manual_seed(0), device="cpu")(a, b, iters=12)
    got = init_raft(torch.Generator().manual_seed(0), device=cuda_device)(a.to(cuda_device), b.to(cuda_device),
                                                                          iters=12)
    scale = max(float(ref.abs().max()), 1.0)
    assert float((got.cpu() - ref).abs().max()) <= 1e-4 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("size", [64, 32])
def test_dpt_card_matches_cpu(cuda_device, tf32_allowed, size):
    """A narrow random DPT (hidden 64, 4 layers, image_size 64) at its
    image size and below it (the antialiased shrink of the position grid)
    with TF32 allowed: the card within 1e-4 of the depth's maximum of the
    CPU."""
    from localrf_tpu_torch.preprocess.dpt import DPT, DPTConfig, init_dpt

    cfg = DPTConfig(hidden_size=64, num_layers=4, num_heads=4, intermediate_size=128, image_size=64,
                    out_indices=(0, 1, 2, 3), neck_hidden_sizes=(16, 32, 64, 64), fusion_hidden_size=32)
    model = init_dpt(cfg, torch.Generator().manual_seed(0), device="cpu")
    on_card = DPT(cfg).to(cuda_device)
    on_card.load_state_dict(model.state_dict())
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 3, size, size)).astype(np.float32))
    ref = model(x)
    assert float((on_card(x.to(cuda_device)).cpu() - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def _scene_images(root, n: int, h: int, w: int) -> None:
    import os

    import cv2

    os.makedirs(f"{root}/images")
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 255, (h, w, 3))
    for i in range(n):
        img = np.clip(np.roll(base, 2 * i, axis=1) + rng.normal(0, 4, base.shape), 0, 255)
        cv2.imwrite(f"{root}/images/{i:06d}.jpg", img.astype(np.uint8))


@pytest.mark.gpu
def test_run_flow_on_card_matches_cpu(cuda_device, tmp_path):
    """run_flow --device cuda and --device cpu on a 3-frame 64x96 scene with
    the same random raft-things.pth (4 iterations): the same files, decoded
    flows within one encoding step (1/256 px), masks equal but for at most
    2 pixels a file."""
    import os
    import shutil

    import cv2

    from localrf_tpu_torch.data.flow_io import decode_flow
    from localrf_tpu_torch.preprocess import run_flow
    from localrf_tpu_torch.preprocess.raft import init_raft

    ckpt = str(tmp_path / "raft.pth")
    sd = init_raft(torch.Generator().manual_seed(0), device="cpu").state_dict()
    torch.save({f"module.{k}": v for k, v in sd.items()}, ckpt)
    _scene_images(tmp_path / "card", 3, 64, 96)
    shutil.copytree(tmp_path / "card", tmp_path / "cpu")
    for where in ("card", "cpu"):
        run_flow.main(["--data_dir", str(tmp_path / where), "--ckpt", ckpt, "--iters", "4",
                       "--device", "cuda" if where == "card" else "cpu"])
    names = sorted(os.listdir(tmp_path / "cpu" / "flow_ds"))
    assert len(names) == 4 and names == sorted(os.listdir(tmp_path / "card" / "flow_ds"))
    for n in names:
        f0, m0 = decode_flow(cv2.imread(str(tmp_path / "card" / "flow_ds" / n), cv2.IMREAD_UNCHANGED))
        f1, m1 = decode_flow(cv2.imread(str(tmp_path / "cpu" / "flow_ds" / n), cv2.IMREAD_UNCHANGED))
        assert np.abs(f0 - f1).max() <= 1 / 256 and int((m0 != m1).sum()) <= 2, n


@pytest.mark.gpu
def test_run_depth_on_card_matches_cpu(cuda_device, tmp_path):
    """run_depth's default backend --device cuda and --device cpu from one
    save_pretrained narrow DPT (read through transformers) at --size 64:
    every uint16 PNG within 2 of the other's."""
    import os
    import shutil

    import cv2

    transformers = pytest.importorskip("transformers")
    from localrf_tpu_torch.preprocess import run_depth

    hfc = transformers.DPTConfig(
        hidden_size=64, num_hidden_layers=4, num_attention_heads=4, intermediate_size=128, image_size=64,
        backbone_out_indices=[0, 1, 2, 3], neck_hidden_sizes=[16, 32, 64, 64], fusion_hidden_size=32)
    torch.manual_seed(0)
    transformers.DPTForDepthEstimation(hfc).save_pretrained(str(tmp_path / "dpt"))
    _scene_images(tmp_path / "card", 2, 64, 96)
    shutil.copytree(tmp_path / "card", tmp_path / "cpu")
    for where in ("card", "cpu"):
        run_depth.main(["--data_dir", str(tmp_path / where), "--model_dir", str(tmp_path / "dpt"), "--size", "64",
                        "--device", "cuda" if where == "card" else "cpu"])
    for n in sorted(os.listdir(tmp_path / "cpu" / "depth")):
        d0 = cv2.imread(str(tmp_path / "card" / "depth" / n), cv2.IMREAD_UNCHANGED).astype(np.int64)
        d1 = cv2.imread(str(tmp_path / "cpu" / "depth" / n), cv2.IMREAD_UNCHANGED).astype(np.int64)
        assert d0.shape == d1.shape == (64, 96) and np.abs(d0 - d1).max() <= 2, n
