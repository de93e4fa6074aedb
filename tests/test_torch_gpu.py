"""The port's CUDA kernels against their plain PyTorch versions on a card,
at the training step's shapes. Marked `gpu`: each test skips without a
CUDA device. This file imports no jax, so it runs on a machine without
it: `python -m pytest tests/test_torch_gpu.py -q --noconftest` (the
tests' conftest.py imports jax).

Tolerances: K1 forward rtol 1e-4 / atol 1e-6 and gradient rtol 1e-3 /
atol 1e-5 of its largest entry (torch.cumprod multiplies in another order
on the card); K2 rtol 1e-4 / atol 1e-4 in f32 (atomic-add order), one
bf16 ulp after its bf16 cast; K3 rtol 1e-4 / atol 1e-5 of the largest
entry (the same, but some 2,000-4,600 points land on each line row, so
the f32 rounding of a reordered sum scales with the row's partial sums). K4 against march_core_plain: in f32, out
rtol 1e-4 / atol 1e-5 and gradients 1e-4 of their largest entry (sums in
another order, fused multiply-adds); with bf16 tables and MLP, out atol
1e-2 and gradients 2e-2 of their largest entry (a reordered f32 sum can
flip one bf16 rounding of a hidden activation).
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
@pytest.mark.parametrize("r,s,per_ray", [(4096, 72, False), (4096, 332, True)])
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
@pytest.mark.parametrize("g_rows,p,dtype", [
    (64, 4096 * 72, "bfloat16"), (640, 4096 * 332, "bfloat16"), (32, 50_001, "float32"),
])
def test_k4_kernel_matches_plain_on_card(cuda_device, g_rows, p, dtype):
    """K4-fwd and K4-bwd: out [P, 4] and every gradient (dtype and value)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args, gout = _march_args(g_rows, p, getattr(torch, dtype), cuda_device)
    leaves = [a for a in args if a.requires_grad]
    n0 = dict(k4.LAUNCHES)
    out_k = k4.march_core(*args, dtype)
    out_p = k4.march_core_plain(*args, dtype)
    grads_k = torch.autograd.grad(out_k, leaves, gout)
    grads_p = torch.autograd.grad(out_p, leaves, gout)
    assert k4.LAUNCHES == {"march_fwd": n0["march_fwd"] + 1, "march_bwd": n0["march_bwd"] + 1}
    f32 = dtype == "float32"
    if f32:
        torch.testing.assert_close(out_k, out_p, rtol=1e-4, atol=1e-5)
    else:
        torch.testing.assert_close(out_k, out_p, rtol=0.0, atol=1e-2)
    names = "rows0 rows1 rows2 wxy w1l lines basis w1 b1 w2 b2 w3 b3".split()
    for name, leaf, gk, gp in zip(names, leaves, grads_k, grads_p):
        assert gk.dtype == gp.dtype == leaf.dtype, name
        scale = float(gp.abs().max())
        err = float((gk.float() - gp.float()).abs().max())
        assert err <= (1e-4 if f32 else 2e-2) * scale, f"{name}: {err:.3e} of max {scale:.3e}"
    with pytest.raises(ValueError):
        k4.march_core(args[0][:-1], *args[1:], dtype)
