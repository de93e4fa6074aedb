"""Port kernels: the plain PyTorch versions of K1 (compositing weights) and
K2 (segment sum) against the Pallas kernels they replace, run in interpret
mode on the CPU, at the shapes of tests/test_pallas_composite.py and
tests/test_binned_scatter.py; the CPU dispatch of the wrappers; and the
build helper. The CUDA kernels themselves are tested on a card by
tests/test_torch_gpu.py.

Tolerances: K1 forward rtol 1e-5 / atol 1e-6, its gradient rtol 1e-4 /
atol 1e-5 (the Pallas suffix scan and torch.cumprod's autograd associate
differently); K2 rtol 1e-4 / atol 1e-4 in f32 (summation order), and one
bf16 ulp after a bf16 cast.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localrf_tpu.ops.pallas import binned_scatter as jbs
from localrf_tpu.ops.pallas import composite as jcomp
from localrf_tpu.ops.pallas.segsum import take_rows_onehot as j_take_onehot
from localrf_tpu_torch.ops.kernels import _build
from localrf_tpu_torch.ops.kernels import binned_scatter as k2
from localrf_tpu_torch.ops.kernels import composite as k1
from localrf_tpu_torch.ops.kernels.segsum import take_rows_onehot

SCALE = 25.0


def T(x, dtype=None):
    t = torch.from_numpy(np.array(x, copy=True))
    return t if dtype is None else t.to(dtype)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.abs(x).astype(np.float32)
    return np.where(mag > 0, np.exp2(np.floor(np.log2(np.maximum(mag, 1e-38))) - 7), 2.0**-133)


# ------------------------------- K1 -------------------------------


@pytest.mark.parametrize("r,s,per_ray", [(32, 16, False), (513, 48, False), (64, 40, True)])
def test_fused_weights_plain_matches_pallas(rng, r, s, per_ray):
    sigma = rng.uniform(0, 2, (r, s)).astype(np.float32)
    dists = rng.uniform(0.01, 0.5, (r if per_ray else 1, s)).astype(np.float32)
    w_j = jcomp.fused_weights(jnp.asarray(sigma), jnp.asarray(dists), SCALE)
    w_t = k1.fused_weights(T(sigma), T(dists), SCALE)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("per_ray", [False, True])
def test_fused_weights_plain_grad_matches_pallas(rng, per_ray):
    r, s = 64, 24
    sigma = rng.uniform(0, 2, (r, s)).astype(np.float32)
    dists = rng.uniform(0.01, 0.5, (r if per_ray else 1, s)).astype(np.float32)
    coef = rng.normal(size=(r, s)).astype(np.float32)
    g_j, gd_j = jax.grad(
        lambda x, d: jnp.sum(jcomp.fused_weights(x, d, SCALE) * coef), argnums=(0, 1)
    )(jnp.asarray(sigma), jnp.asarray(dists))
    x = T(sigma).requires_grad_(True)
    d = T(dists).requires_grad_(True)
    (k1.fused_weights(x, d, SCALE) * T(coef)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j), rtol=1e-4, atol=1e-5)
    # no gradient to dists, as the JAX kernel's zeros
    assert d.grad is None and not np.asarray(gd_j).any()


def test_fused_weights_terminator_and_cpu_dispatch(rng):
    """Weights sum to 1; a CPU tensor takes the plain version (no launch);
    a device without a kernel raises instead of falling back."""
    sigma = T(rng.uniform(0, 3, (16, 12)).astype(np.float32))
    dists = T(rng.uniform(0.01, 0.5, (1, 12)).astype(np.float32))
    before = dict(k1.LAUNCHES)
    w = k1.fused_weights(sigma, dists, SCALE)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-4)
    assert k1.LAUNCHES == before
    with pytest.raises(ValueError, match="no kernel"):
        k1.fused_weights(sigma.to("meta"), dists.to("meta"), SCALE)


# ------------------------------- K2 -------------------------------


def _oracle(idx, g, n_rows):
    out = np.zeros((n_rows, g.shape[1]), np.float32)
    np.add.at(out, idx, g.astype(np.float32))
    return out


@pytest.mark.parametrize(
    "n_rows,p,dist",
    [
        (1000, 4096, "uniform"),
        (512, 999, "uniform"),
        (2048, 4096, "hot"),
        (2048, 4096, "sparse"),
        (130, 64, "uniform"),
    ],
)
def test_segment_sum_plain_matches_binned_pallas(rng, n_rows, p, dist):
    if dist == "uniform":
        idx = rng.integers(0, n_rows, size=p)
    elif dist == "hot":
        idx = rng.integers(5, 60, size=p)
    else:
        idx = rng.choice([3, n_rows - 1, n_rows // 2], size=p)
    g = rng.standard_normal((p, 128), dtype=np.float32)
    want = jbs.binned_segment_sum(jnp.asarray(idx, jnp.int32), jnp.asarray(g), n_rows,
                                  tile_rows=128, chunk=256)
    got = k2.segment_sum(T(idx), T(g), n_rows)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), _oracle(idx, g, n_rows), rtol=1e-4, atol=1e-4)


def test_segment_sum_bf16_payload_and_output(rng):
    n_rows, p = 384, 2048
    idx = rng.integers(0, n_rows, size=p)
    g = np.asarray(jnp.asarray(rng.standard_normal((p, 128)), jnp.bfloat16))
    want = np.asarray(jbs.binned_segment_sum(
        jnp.asarray(idx, jnp.int32), jnp.asarray(g), n_rows, tile_rows=128, chunk=256,
        out_dtype=jnp.bfloat16)).astype(np.float32)
    got = k2.segment_sum(T(idx), T(g.astype(np.float32), torch.bfloat16), n_rows, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= bf16_ulp(np.maximum(np.abs(want), np.abs(got.float().numpy())))).all()


def test_take_rows_binned_grad_matches_pallas(rng):
    n_rows, p, c = 300, 1111, 128
    table = rng.standard_normal((n_rows, c)).astype(np.float32)
    idx = rng.integers(0, n_rows, size=p)
    cot = rng.standard_normal((p, c)).astype(np.float32)
    g_j = jax.grad(lambda t: jnp.vdot(jbs.take_rows_binned(t, jnp.asarray(idx, jnp.int32)), cot))(
        jnp.asarray(table))
    t = T(table).requires_grad_(True)
    rows = k2.take_rows_binned(t, T(idx))
    np.testing.assert_array_equal(rows.detach().numpy(), table[idx])
    (rows * T(cot)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-5)


def test_take_rows_binned_bf16_table_grad_dtype(rng):
    n_rows, p, c = 256, 512, 128
    table = T(rng.standard_normal((n_rows, c)), torch.bfloat16).requires_grad_(True)
    idx = rng.integers(0, n_rows, size=p)
    k2.take_rows_binned(table, T(idx)).float().sum().backward()
    assert table.grad.dtype == torch.bfloat16
    g_j = jax.grad(lambda t: jnp.sum(jbs.take_rows_binned(t, jnp.asarray(idx, jnp.int32)).astype(jnp.float32)))(
        jnp.asarray(table.detach().float().numpy(), jnp.bfloat16))
    assert g_j.dtype == jnp.bfloat16
    np.testing.assert_array_equal(table.grad.float().numpy(), np.asarray(g_j, np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_take_rows_onehot_grad_matches_jax(rng, dtype):
    """Line-table gather: f32-accumulated backward cast to the table dtype,
    like JAX's one-hot matmul."""
    t, c, p = 640, 48, 5000
    tab = rng.normal(size=(t, c)).astype(np.float32)
    idx = rng.integers(0, t, p)
    co = rng.normal(size=(p, c)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    g_j = jax.grad(lambda x: jnp.sum(j_take_onehot(x, jnp.asarray(idx, jnp.int32)).astype(jnp.float32) * co))(
        jnp.asarray(tab, jdt))
    x = T(tab, dtype).requires_grad_(True)
    (take_rows_onehot(x, T(idx)).float() * T(co)).sum().backward()
    assert x.grad.dtype == dtype
    want = np.asarray(g_j, np.float32)
    got = x.grad.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert (np.abs(got - want) <= bf16_ulp(np.maximum(np.abs(got), np.abs(want)))).all()


def test_segment_sum_cpu_dispatch_and_no_fallback(rng):
    idx = T(rng.integers(0, 10, 50))
    g = T(rng.normal(size=(50, 4)).astype(np.float32))
    before = dict(k2.LAUNCHES)
    k2.segment_sum(idx, g, 10)
    assert k2.LAUNCHES == before
    with pytest.raises(ValueError, match="no kernel"):
        k2.segment_sum(idx.to("meta"), g.to("meta"), 10)


# ------------------------------- build -------------------------------


def test_build_is_keyed_by_sources_and_fails_loudly(monkeypatch, tmp_path):
    """The library name hashes the sources and flags; without nvcc the build
    raises naming nvcc and writes nothing."""
    h = _build.source_hash()
    assert h == _build.source_hash() and len(h) == 16
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.source_hash() != h
    assert {p.name for p in _build.sources()} >= {"composite.cu", "segment_sum.cu"}
    for src in _build.sources():
        text = src.read_text()
        assert "--use_fast_math" not in text and "localrf_tpu/ops/pallas/" in text
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "kernels").exists()
