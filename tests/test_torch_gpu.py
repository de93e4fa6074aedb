"""The port's CUDA kernels against their plain PyTorch versions on a card,
at the training step's shapes. Marked `gpu`: each test skips without a
CUDA device. This file imports no jax, so it runs on a machine without
it: `python -m pytest tests/test_torch_gpu.py -q --noconftest` (the
tests' conftest.py imports jax).

Tolerances: K1 forward rtol 1e-4 / atol 1e-6 and gradient rtol 1e-3 /
atol 1e-5 of its largest entry (torch.cumprod multiplies in another order
on the card); K2 rtol 1e-4 / atol 1e-4 in f32 (atomic-add order), one
bf16 ulp after the bf16 cast.
"""
import numpy as np
import pytest
import torch

from localrf_tpu_torch.ops.kernels import binned_scatter as k2
from localrf_tpu_torch.ops.kernels import composite as k1

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
