"""Port kernels: the plain PyTorch versions of K1 (compositing weights), K2
(segment sum), K3 (small-table segment sum), K4 (fused march core) and K5
(merged segment sum; its order and its two sort levels written out as loops)
against the Pallas kernels they replace, run in interpret mode on the CPU,
at the shapes of tests/test_pallas_composite.py, tests/test_binned_scatter.py
and tests/test_fused_march.py; the CPU dispatch of the wrappers; and the
build helper. The CUDA kernels themselves are tested on a card by
tests/test_torch_gpu.py.

Tolerances: K1 forward rtol 1e-5 / atol 1e-6, its gradient rtol 1e-4 /
atol 1e-5 (the Pallas suffix scan and torch.cumprod's autograd associate
differently); K2, K3 and K5 rtol 1e-4 / atol 1e-4 in f32 (summation order), and
one bf16 ulp after a bf16 cast; K3's gradient on a bf16 table equals JAX's
f32 one to rtol 1e-5 / atol 1e-6 (f32 rounding, far inside one bf16 ulp).
K4 in f32: out rtol 1e-5 / atol 1e-6, every gradient to 1e-5 of its largest
entry (measured ~5e-7: only f32 summation orders differ); in bf16 the JAX
package's own tolerances for this kernel, 2e-2 forward and 6e-2 of the
largest entry for gradients (XLA may keep excess precision between bf16
ops; measured: out 6e-8, d(wx, wy, w1) 5e-3 of max from bf16 sums, the
rest to f32 rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localrf_tpu.ops.pallas import binned_scatter as jbs
from localrf_tpu.ops.pallas import composite as jcomp
from localrf_tpu.ops.pallas import march as jmarch
from localrf_tpu.ops.pallas import segsum as jsegsum
from localrf_tpu.ops.pallas.segsum import take_rows_onehot as j_take_onehot
from localrf_tpu_torch.ops.kernels import _build
from localrf_tpu_torch.ops.kernels import binned_scatter as k2
from localrf_tpu_torch.ops.kernels import composite as k1
from localrf_tpu_torch.ops.kernels import march as k4
from localrf_tpu_torch.ops.kernels import segsum as k3
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


def _bins_oracle(idx: np.ndarray, n_rows: int, tile_rows: int, chunk: int) -> dict:
    """K2's bin schedule written out point by point in numpy."""
    n_tiles = -(-n_rows // tile_rows)
    counts = np.zeros(n_tiles, np.int64)
    bins = [[] for _ in range(n_tiles)]
    for p, r in enumerate(idx):
        if 0 <= r < n_rows:
            counts[r // tile_rows] += 1
            bins[r // tile_rows].append((p, r % tile_rows))
    items, slot_base, slot = [], [], 0
    for t in range(n_tiles):
        k = -(-int(counts[t]) // chunk)  # 0 for an empty tile
        items += [(t, j) for j in range(k)]
        slot_base.append(slot)
        slot += k if k > 1 else 0
    flat = [e for b in bins for e in b]
    return dict(counts=counts, starts=np.concatenate([[0], np.cumsum(counts)]), slot_base=np.array(slot_base),
                items=np.array(items, np.int64).reshape(-1, 2), empty=np.flatnonzero(counts == 0),
                bin_pt=np.array([e[0] for e in flat], np.int64),
                bin_row=np.array([e[1] for e in flat], np.int64), n_slots_used=slot)


def _ball_rows(rng, p: int, side: int) -> np.ndarray:
    """Plane rows of points in a disc a quarter of the plane wide, packed
    toward its centre (a ball's projection): most tiles empty, a few full."""
    rad = 0.25 * side * np.sqrt(rng.uniform(0, 1, p)) * rng.uniform(0.2, 1, p)
    ang = rng.uniform(0, 2 * np.pi, p)
    x = np.clip(side / 2 + rad * np.cos(ang), 0, side - 1).astype(np.int64)
    y = np.clip(side / 2 + rad * np.sin(ang), 0, side - 1).astype(np.int64)
    return y * side + x


@pytest.mark.parametrize("case", ["uniform", "ball", "hot", "out-of-range", "empty-tiles", "no-points"])
def test_tile_bins_plain_matches_numpy(rng, monkeypatch, case):
    """K2's bin schedule in plain PyTorch (tile_bins_plain, the on-card
    reference of the bin kernels) against numpy: per-tile counts, starts,
    the work list of the tiles with points (split past CHUNK points), the
    empty tiles, partial slots, and every
    in-range point binned in tile order at its row in the tile; out-of-range
    points in no bin. tile_plan's sizes hold every schedule (work items and
    partial slots)."""
    monkeypatch.setattr(k2, "TILE_FLOATS", 16 * 128)  # tiles of 16 rows of 128
    monkeypatch.setattr(k2, "CHUNK", 32)
    n_rows, p = 40 * 40, 3000
    if case == "uniform":
        idx = rng.integers(0, n_rows, p)
    elif case == "ball":
        idx = _ball_rows(rng, p, 40)
    elif case == "hot":
        idx = rng.integers(100, 110, p)
    elif case == "out-of-range":
        idx = rng.integers(-200, n_rows + 200, p)
    elif case == "empty-tiles":
        idx = rng.choice([0, 17, n_rows - 1], p)
    else:
        idx = np.zeros(0, np.int64)
    plan = k2.tile_plan(len(idx), 128, n_rows)
    assert (plan.tile_rows, plan.n_tiles, plan.chunk) == (16, 100, 32)
    got = k2.tile_bins_plain(T(idx), n_rows, plan)
    want = _bins_oracle(idx, n_rows, plan.tile_rows, plan.chunk)
    for key in ("counts", "starts", "slot_base", "items", "empty", "bin_pt", "bin_row"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    assert want["items"].shape[0] <= plan.n_items and want["n_slots_used"] <= plan.n_slots
    assert want["items"].shape[0] + want["empty"].shape[0] >= plan.n_tiles
    if case in ("ball", "hot", "empty-tiles"):  # skewed: some tile is split
        assert (want["items"][:, 1] > 0).any()
    np.testing.assert_array_equal(idx[got["bin_pt"].numpy()] // plan.tile_rows * plan.tile_rows
                                  + got["bin_row"].numpy(), idx[got["bin_pt"].numpy()])


# ------------------------------- K5 -------------------------------

K5_CASES = [
    (1000, 4096, "uniform"),  # rows not a tile multiple
    (512, 999, "uniform"),  # points not a chunk multiple
    (2048, 4096, "hot"),  # everything in a few rows
    (2048, 4096, "sparse"),  # most tiles empty
    (130, 64, "uniform"),  # fewer points than one chunk
]


def _k5_idx(rng, n_rows, p, dist):
    if dist == "uniform":
        return rng.integers(0, n_rows, size=p)
    if dist == "hot":
        return rng.integers(5, 60, size=p)
    return rng.choice([3, n_rows - 1, n_rows // 2], size=p)


@pytest.mark.parametrize("n_rows,p,dist", K5_CASES)
def test_segment_sum_merged_plain_matches_pallas(rng, n_rows, p, dist):
    idx = _k5_idx(rng, n_rows, p, dist)
    g = rng.standard_normal((p, 128), dtype=np.float32)
    want = jbs.binned_segment_sum_merged(jnp.asarray(idx, jnp.int32), jnp.asarray(g), n_rows,
                                         tile_rows=128, chunk=256)
    got = k2.binned_segment_sum_merged(T(idx).to(torch.int32), T(g), n_rows)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), _oracle(idx, g, n_rows), rtol=1e-4, atol=1e-4)


def test_segment_sum_merged_multi_split_schedule(rng, monkeypatch):
    """JAX's schedule with several cliff splits interleaved per tile (tiny
    SPLIT_MAX_BYTES): the same sums as the port's single sorted stream."""
    monkeypatch.setattr(jbs, "SPLIT_MAX_BYTES", 256 * 128 * 4)  # 256-row splits
    p, n_rows = 2000, 777
    idx = rng.integers(0, n_rows, size=p)
    g = rng.standard_normal((p, 128), dtype=np.float32)
    want = jbs.binned_segment_sum_merged(jnp.asarray(idx, jnp.int32), jnp.asarray(g), n_rows,
                                         tile_rows=64, chunk=128)
    got = k2.binned_segment_sum_merged(T(idx), T(g), n_rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_segment_sum_merged_bf16_out(rng):
    """bf16 payload, bf16 out: within one bf16 ulp of the f32-accumulated
    oracle, and of JAX's bf16 result."""
    p, n_rows = 999, 300
    idx = rng.integers(0, n_rows, size=p)
    g = np.asarray(jnp.asarray(rng.standard_normal((p, 128), dtype=np.float32), jnp.bfloat16))
    want16 = np.asarray(jbs.binned_segment_sum_merged(
        jnp.asarray(idx, jnp.int32), jnp.asarray(g), n_rows, tile_rows=64, chunk=128,
        out_dtype=jnp.bfloat16)).astype(np.float32)
    got = k2.binned_segment_sum_merged(T(idx), T(g.astype(np.float32), torch.bfloat16), n_rows,
                                       torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    for want in (_oracle(idx, g.astype(np.float32), n_rows), want16):
        assert (np.abs(got - want) <= bf16_ulp(np.maximum(np.abs(got), np.abs(want)))).all()


K5_ORDER_CASES = K5_CASES + [(300, 5000, "out-of-range")]


def _k5_order_idx(rng, n_rows, p, dist):
    if dist == "out-of-range":
        return rng.integers(-20, n_rows + 20, size=p)
    return _k5_idx(rng, n_rows, p, dist)


@pytest.mark.parametrize("n_rows,p,dist", K5_ORDER_CASES)
def test_merged_bins_plain_matches_numpy_loop(rng, n_rows, p, dist):
    """K5's two sort levels (merged_bins_plain, the kernels' reference)
    against a loop: each tile's in-range points in increasing id, then
    each tile's points by row, each row's in increasing id; tile starts
    from the counts; out-of-range indices in no tile."""
    idx = _k5_order_idx(rng, n_rows, p, dist)
    plan = k2.merged_plan(p, 128, n_rows)
    assert plan.tile_rows == 64 and plan.n_tiles == -(-n_rows // 64)
    got = k2.merged_bins_plain(T(idx), n_rows, plan)
    per_tile = [[] for _ in range(plan.n_tiles)]
    for q in range(p):
        if 0 <= idx[q] < n_rows:
            per_tile[idx[q] // plan.tile_rows].append(q)
    by_point = [q for pts in per_tile for q in pts]
    by_row = [q for pts in per_tile for q in sorted(pts, key=lambda q: idx[q])]
    starts = np.cumsum([0] + [len(pts) for pts in per_tile])
    np.testing.assert_array_equal(got["starts"].numpy(), starts)
    np.testing.assert_array_equal(got["by_point"].numpy(), by_point)
    np.testing.assert_array_equal(got["by_point_row"].numpy(), idx[by_point] % plan.tile_rows)
    np.testing.assert_array_equal(got["by_row"].numpy(), by_row)


@pytest.mark.parametrize("n_rows,p,dist", K5_ORDER_CASES)
def test_segment_sum_merged_ordered_is_the_point_order_sum(rng, n_rows, p, dist):
    """K5's order, written as a loop: each row's points added in increasing
    id from 0.0 in f32, out-of-range indices skipped. The ordered version
    (the kernel's reference on the card) equals it bit for bit, and so does
    the CPU plain version (index_add_ adds in index order on the CPU), in
    f32 and in bf16 out."""
    idx = _k5_order_idx(rng, n_rows, p, dist)
    g = rng.standard_normal((p, 128), dtype=np.float32)
    want = np.zeros((n_rows, 128), np.float32)
    for q in range(p):
        if 0 <= idx[q] < n_rows:
            want[idx[q]] = want[idx[q]] + g[q]
    for dt in (torch.float32, torch.bfloat16):
        got = k2.binned_segment_sum_merged_ordered(T(idx), T(g), n_rows, dt)
        assert got.dtype == dt
        assert torch.equal(got, T(want).to(dt))
        assert torch.equal(k2.binned_segment_sum_merged_plain(T(idx), T(g), n_rows, dt), got)
        assert torch.equal(k2.binned_segment_sum_merged(T(idx).to(torch.int32), T(g), n_rows, dt), got)


@pytest.mark.parametrize("p,c,n_rows,tile_rows,range_len", [
    (4096 * 72, 128, 4096, 64, 2048),  # the 64^3 plane
    (4096 * 332, 128, 409_600, 64, 2048),  # the 640^3 plane
    (20_000_000, 8, 1000, 256, 5120),  # many points: longer ranges; narrow rows: 256-row tiles
])
def test_merged_plan_from_shapes(p, c, n_rows, tile_rows, range_len):
    """K5's plan: power-of-two tiles (K2's 64 rows for rows of 128), ranges
    set from P alone (the count matrix's padding is the kernels' own:
    test_k5_workspace_is_the_padded_matrix_and_its_chunk_sums on the card)."""
    plan = k2.merged_plan(p, c, n_rows)
    assert (plan.tile_rows, 1 << plan.shift, plan.range_len) == (tile_rows, tile_rows, range_len)
    assert plan.n_tiles == -(-n_rows // tile_rows) and plan.n_ranges == -(-p // range_len)
    assert plan.n_ranges <= k2.MERGED_RANGES
    assert k2.merged_plan(p, c, 7).range_len == range_len


@pytest.mark.parametrize("case", ["too many tiles", "float indices", "shapes"])
def test_merged_cuda_rejects_what_the_kernel_does_not_take(case, monkeypatch):
    """K5's card wrapper checks its inputs before it allocates or launches
    (so on any device): a table of more tiles than a block can count in
    shared memory (the kernel library's answer, -1, stood in for here: the
    card test test_k5_workspace_is_the_padded_matrix_and_its_chunk_sums
    asks the library), non-integer indices, mismatched shapes."""
    idx, g, n_rows = torch.zeros(10, dtype=torch.int64), torch.zeros(10, 128), 100
    if case == "too many tiles":
        n_rows = 64 * 58_113
        monkeypatch.setattr(k2, "_merged_workspace", lambda plan: -1 if plan.n_tiles > 58_112 else 0)
    elif case == "float indices":
        idx = idx.float()
    else:
        g = g[:9]
    with pytest.raises(TypeError if case == "float indices" else ValueError):
        k2._merged_cuda(idx, g, n_rows, torch.float32)


def test_segment_sum_merged_cpu_dispatch(rng):
    """A CPU tensor takes the plain version (no launch); a device without a
    kernel raises."""
    idx, g = T(rng.integers(0, 50, 200)), T(rng.standard_normal((200, 8), dtype=np.float32))
    before = dict(k2.LAUNCHES)
    k2.binned_segment_sum_merged(idx, g, 50)
    assert k2.LAUNCHES == before
    with pytest.raises(ValueError, match="no kernel"):
        k2.binned_segment_sum_merged(idx.to("meta"), g.to("meta"), 50)


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


# ------------------------------- K3 -------------------------------


@pytest.mark.parametrize(
    "n_rows,p,payload",
    [
        (640, 5000, "float32"),
        (64, 3000, "float32"),
        (700, 2500, "float32"),  # neither n_rows % 512 nor P % 1024 is 0
        (1030, 1500, "float32"),  # three of the Pallas kernel's row tiles
        (640, 4100, "bfloat16"),
    ],
)
def test_segment_sum_small_plain_matches_pallas(rng, n_rows, p, payload):
    idx = rng.integers(0, n_rows, size=p)
    g = rng.standard_normal((p, 64)).astype(np.float32)
    if payload == "bfloat16":
        g = np.asarray(jnp.asarray(g, jnp.bfloat16)).astype(np.float32)
    jdt = jnp.float32 if payload == "float32" else jnp.bfloat16
    want = jsegsum.segment_sum_matmul(jnp.asarray(idx, jnp.int32), jnp.asarray(g, jdt), n_rows)
    got = k3.segment_sum_small(T(idx), T(g, getattr(torch, payload)), n_rows)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), _oracle(idx, g, n_rows), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_take_rows_grad_is_jax_f32_segsum(rng, dtype):
    """K3's gradient stays f32 for a bf16 table, as JAX's does: the port's
    take_rows gathers from the f32 table and rounds the rows, so the
    gradient reaches the table unrounded (a bf16 result would be one bf16
    ulp off, far outside this tolerance)."""
    t, c, p = 640, 64, 5000
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    tab = np.asarray(jnp.asarray(rng.normal(size=(t, c)), jdt)).astype(np.float32)
    idx = rng.integers(0, t, p)
    co = rng.normal(size=(p, c)).astype(np.float32)
    rows_j, vjp = jax.vjp(lambda x: jsegsum.take_rows(x, jnp.asarray(idx, jnp.int32)), jnp.asarray(tab, jdt))
    (g_j,) = vjp(jnp.asarray(co, jdt))
    assert g_j.dtype == jnp.float32
    x = T(tab).requires_grad_(True)
    rows = k3.take_rows(x, T(idx), dtype)
    assert rows.dtype == dtype
    np.testing.assert_array_equal(rows.detach().float().numpy(), np.asarray(rows_j, np.float32))
    rows.backward(T(co, dtype))
    assert x.grad.dtype == torch.float32
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-6)
    if dtype == torch.bfloat16:
        rounded = x.grad.to(torch.bfloat16).float()
        assert not torch.equal(rounded, x.grad)
    with pytest.raises(TypeError, match="f32 table"):
        k3.take_rows(x.detach().to(torch.bfloat16), T(idx))


def _line_idx(rng, kind: str, p: int, n_rows: int) -> np.ndarray:
    """Line rows: uniform; packed toward the middle as a ball's points
    project onto a line; a few hot rows; partly out of range."""
    if kind == "uniform":
        return rng.integers(0, n_rows, p)
    if kind == "ball":
        rad = 0.27 * n_rows * rng.uniform(-1, 1, p) * np.sqrt(rng.uniform(0, 1, p))
        return np.clip(n_rows / 2 + rad, 0, n_rows - 1).astype(np.int64)
    if kind == "hot":
        return rng.choice([n_rows // 3, n_rows // 3 + 1, n_rows - 1], p, p=[0.8, 0.15, 0.05])
    return rng.integers(-n_rows // 4, n_rows + n_rows // 4, p)


def _k3_order_oracle(idx: np.ndarray, g: np.ndarray, n_rows: int) -> np.ndarray:
    """K3's sum written out point by point in numpy, in the plan's order:
    each range's rows from 0 in point order, then the ranges in order."""
    p, c = g.shape
    plan = k3.segsum_plan(p, n_rows, c)
    out = np.zeros((n_rows, c), np.float32)
    for k in range(plan.n_ranges):
        part = np.zeros((n_rows, c), np.float32)
        for q in range(k * plan.range_len, min((k + 1) * plan.range_len, p)):
            if 0 <= idx[q] < n_rows:
                part[idx[q]] += g[q]
        out += part
    return out


@pytest.mark.parametrize("n_rows,p,c,payload,kind", [
    (640, 5000, 64, "float32", "uniform"), (640, 5000, 64, "bfloat16", "ball"),
    (64, 3000, 64, "bfloat16", "hot"), (640, 4000, 64, "float32", "out-of-range"),
    (640, 0, 64, "bfloat16", "uniform"),  # no points
    (100, 2500, 20, "float32", "uniform"), (50, 2000, 7, "bfloat16", "ball"),  # C < 64, odd C
    (1500, 4000, 64, "bfloat16", "uniform"),  # three row tiles of 640
    (30, 777, 64, "float32", "hot"),  # one range, P not a multiple of 32
])
def test_segment_sum_small_ordered_is_the_plan_order(rng, n_rows, p, c, payload, kind):
    """segment_sum_small_ordered (the kernel's plain version) equals the sum
    written out point by point in the plan's order, bit for bit, and the
    plain index_add_ to rtol 1e-4 / atol 1e-4."""
    idx = _line_idx(rng, kind, p, n_rows)
    g = (10 * rng.standard_normal((p, c))).astype(np.float32)
    if payload == "bfloat16":
        g = np.asarray(jnp.asarray(g, jnp.bfloat16)).astype(np.float32)
    got = k3.segment_sum_small_ordered(T(idx), T(g, getattr(torch, payload)), n_rows)
    assert got.dtype == torch.float32 and got.shape == (n_rows, c)
    np.testing.assert_array_equal(got.numpy(), _k3_order_oracle(idx, g, n_rows))
    keep = (idx >= 0) & (idx < n_rows)
    np.testing.assert_allclose(got.numpy(), _oracle(idx[keep], g[keep], n_rows), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_rows,p,payload,kind", [
    (640, 5000, "float32", "ball"), (64, 3000, "bfloat16", "uniform"),
    (1030, 1500, "float32", "uniform"), (700, 2500, "bfloat16", "out-of-range"),
])
def test_segment_sum_small_ordered_matches_pallas(rng, n_rows, p, payload, kind):
    """The ordered plain version against JAX's segment_sum_matmul (interpret
    mode), at test_segment_sum_small_plain_matches_pallas's tolerance;
    JAX's kernel skips out-of-range indices too."""
    idx = _line_idx(rng, kind, p, n_rows)
    g = rng.standard_normal((p, 64)).astype(np.float32)
    if payload == "bfloat16":
        g = np.asarray(jnp.asarray(g, jnp.bfloat16)).astype(np.float32)
    jdt = jnp.float32 if payload == "float32" else jnp.bfloat16
    want = jsegsum.segment_sum_matmul(jnp.asarray(idx, jnp.int32), jnp.asarray(g, jdt), n_rows)
    got = k3.segment_sum_small_ordered(T(idx), T(g, getattr(torch, payload)), n_rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_segsum_plan_is_a_function_of_the_shapes(monkeypatch):
    """K3's plan reads no device: the same (P, n_rows, C) give the same
    plan with every card query raising. Its ranges cover the points with
    none empty, in multiples of 32 points; a block's accumulator fits its
    160 KB; row tiles cover the table; the blocks and partial tables stay
    within BLOCKS and SCRATCH_FLOATS (or one range)."""
    shapes = [(4096 * 332, 640, 64), (4096 * 72, 64, 64), (0, 640, 64), (5, 7, 3), (200_000, 1500, 64),
              (50_000, 640, 20), (10**6, 40_000, 64), (777, 30, 64)]
    want = [k3.segsum_plan(*s) for s in shapes]
    for name in ("device_count", "get_device_properties", "current_device"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: (_ for _ in ()).throw(AssertionError("card read")))
    assert [k3.segsum_plan(*s) for s in shapes] == want
    assert want[0] == k3.SegsumPlan(640, 1, 132, 10_304) and want[1] == k3.SegsumPlan(64, 1, 132, 2240)
    for (p, n_rows, c), plan in zip(shapes, want):
        assert plan.range_len % k3.RANGE_ALIGN == 0 and plan.n_ranges >= 1
        if p:
            assert (plan.n_ranges - 1) * plan.range_len < p <= plan.n_ranges * plan.range_len
        assert plan.tile_rows * c <= k3.ACC_FLOATS and plan.n_tiles * plan.tile_rows >= n_rows
        assert plan.n_ranges == 1 or (plan.n_ranges * plan.n_tiles <= k3.BLOCKS
                                      and plan.n_ranges * n_rows * c <= k3.SCRATCH_FLOATS)


def test_segment_sum_small_cpu_dispatch_and_no_fallback(rng):
    idx = T(rng.integers(0, 10, 50))
    g = T(rng.normal(size=(50, 4)).astype(np.float32))
    before = dict(k3.LAUNCHES)
    k3.segment_sum_small(idx, g, 10)
    assert k3.LAUNCHES == before
    with pytest.raises(ValueError, match="no kernel"):
        k3.segment_sum_small(idx.to("meta"), g.to("meta"), 10)


# ------------------------------- K4 -------------------------------


def _march_inputs(rng, p=777, g=24):
    """Inputs of one march core call as numpy (JAX's layouts and the port's)."""
    f = np.float32
    d = {
        "rows": [rng.normal(0, 0.3, (p, 128)).astype(f) for _ in range(3)],
        "wxy": rng.uniform(0, 1, (p, 6)).astype(f),
        "w1l": rng.uniform(0, 1, (p, 3)).astype(f),
        "x0": rng.integers(0, g, (p, 3)).astype(np.int32),
        "vd": rng.normal(size=(p, 3)).astype(f),
        "lines": rng.normal(0, 0.3, (3, g, 64)).astype(f),
        "basis": rng.uniform(-0.12, 0.12, (72, 27)).astype(f),
        "w1": rng.uniform(-0.19, 0.19, (27, 128)).astype(f),
        "b1": rng.uniform(-0.19, 0.19, 128).astype(f),
        "w2": rng.uniform(-0.09, 0.09, (128, 128)).astype(f),
        "b2": rng.uniform(-0.09, 0.09, 128).astype(f),
        "w3": rng.uniform(-0.09, 0.09, (131, 3)).astype(f),
        "b3": rng.uniform(-0.1, 0.1, 3).astype(f),
        "gout": rng.normal(size=(p, 4)).astype(f),
    }
    return d


def _torch_march_args(d, tdt):
    """The port's march_core arguments; every differentiable one requires grad."""
    def leaf(x, dt=torch.float32):
        return T(x, dt).requires_grad_(True)

    return ([leaf(r, tdt) for r in d["rows"]]
            + [leaf(d["wxy"]), leaf(d["w1l"]), torch.from_numpy(d["x0"]), T(d["vd"]), leaf(d["lines"], tdt)]
            + [leaf(d[k]) for k in ("basis", "w1", "b1", "w2", "b2", "w3", "b3")])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_march_core_plain_matches_pallas(rng, dtype):
    """out [P, 4] and all eleven gradient groups (three d_rows, d_aux as
    d(wx, wy) and d(w1), dlines, dbasis, dw1, db1, dw2, db2, dw3 | db3)."""
    d = _march_inputs(rng)
    p = d["wxy"].shape[0]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    aux = np.concatenate([d["wxy"], d["w1l"], d["x0"].astype(np.float32), d["vd"], np.zeros((p, 1), np.float32)], -1)
    jargs = [jnp.asarray(r, jdt) for r in d["rows"]] + [
        jnp.asarray(aux), jnp.asarray(d["lines"], jdt), jnp.asarray(d["basis"]), jnp.asarray(d["w1"]),
        jnp.asarray(d["b1"][None]), jnp.asarray(d["w2"]), jnp.asarray(d["b2"][None]),
        jnp.asarray(np.concatenate([d["w3"], d["b3"][None]])),
    ]
    out_j, vjp = jax.vjp(lambda *a: jmarch.march_core(*a, dtype), *jargs)
    gj = [np.asarray(g, np.float32) for g in vjp(jnp.asarray(np.concatenate([d["gout"], np.zeros((p, 4), np.float32)], -1)))]
    want = gj[:3] + [gj[3][:, :6], gj[3][:, 6:9], gj[4], gj[5], gj[6], gj[7][0], gj[8], gj[9][0], gj[10][:-1], gj[10][-1]]
    assert not gj[3][:, 9:].any()  # no gradient to x0 or vd

    tdt = getattr(torch, dtype)
    args = _torch_march_args(d, tdt)
    out = k4.march_core(*args, dtype)
    leaves = [a for a in args if a.requires_grad]
    grads = torch.autograd.grad(out, leaves, T(d["gout"]))
    f32 = dtype == "float32"
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j)[:, :4],
                               rtol=1e-5 if f32 else 2e-2, atol=1e-6 if f32 else 2e-2)
    names = "rows0 rows1 rows2 wxy w1l lines basis w1 b1 w2 b2 w3 b3".split()
    for name, leaf, got, w in zip(names, leaves, grads, want):
        assert got.dtype == leaf.dtype, name
        scale = float(np.abs(w).max())
        err = float(np.abs(got.float().numpy() - w).max())
        assert err <= (1e-5 if f32 else 6e-2) * scale, f"{name}: {err:.2e} of max {scale:.2e}"


def test_march_plain_backward_matches_autograd(rng):
    """The hand-written VJP against autograd through the same forward (f32,
    independent of JAX)."""
    d = _march_inputs(rng, p=300, g=16)
    args = _torch_march_args(d, torch.float32)
    leaves = [a for a in args if a.requires_grad]
    sigma, rgb, *_ = k4._forward(args[:3], *args[3:], torch.float32)
    auto = torch.autograd.grad(torch.cat([sigma[:, None], rgb], -1), leaves, T(d["gout"]))
    hand = k4.march_bwd_plain(*args, T(d["gout"]), "float32")
    for name, a, h in zip("rows0 rows1 rows2 wxy w1l lines basis w1 b1 w2 b2 w3 b3".split(), auto, hand):
        assert h.shape == a.shape, name
        torch.testing.assert_close(h, a, rtol=1e-5, atol=1e-5 * float(a.abs().max()), msg=name)


@pytest.mark.parametrize("g", [16, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_march_mlp_operands_are_bf16_exact(seed, g):
    """With bf16 tables and MLP, every operand of every basis and MLP
    product of the plain forward and backward is a bf16 value, so the f32
    product of the operands cast to bf16 (what a bf16 tensor-core MMA takes
    in) equals the plain version's _mm bit for bit."""
    d = _march_inputs(np.random.default_rng(seed), p=300, g=g)
    args = [a.detach() for a in _torch_march_args(d, torch.bfloat16)]
    products = k4.march_products_plain(*args, T(d["gout"]), "bfloat16")
    assert {"app0", "app1", "app2", "h1", "h2", "d_h1", "d_app", "dw2", "dw1",
            "dbasis0", "dbasis1", "dbasis2", "d_feat0", "d_feat1", "d_feat2", "dw3"} <= products.keys()
    for name, (a, b) in products.items():
        for x in (a, b):
            assert torch.equal(x.float(), x.to(torch.bfloat16).float()), name
        cast = a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()
        assert torch.equal(k4._mm(a, b), cast), name
        assert cast.abs().max() > 0, name


def test_march_check_rejects_unaligned_rows(rng):
    """The tensor-core kernels (bf16 tables and MLP) copy plane and line
    rows in 16-byte pieces: the launch check refuses a contiguous view that
    starts off a 16-byte boundary, and takes the same rows copied out; the
    CUDA-core kernels (here the f32 MLP) take the view."""
    d = _march_inputs(rng, p=40, g=8)
    args = [a.detach() for a in _torch_march_args(d, torch.bfloat16)]
    k4._check(*args, "bfloat16")
    for i in (0, 2, 7):
        shifted = torch.empty(args[i].numel() + 1, dtype=args[i].dtype)[1:].view(args[i].shape)
        shifted.copy_(args[i])
        with pytest.raises(ValueError, match="16-byte"):
            k4._check(*args[:i], shifted, *args[i + 1:], "bfloat16")
        k4._check(*args[:i], shifted, *args[i + 1:], "float32")


def test_march_core_cpu_dispatch_and_no_fallback(rng):
    d = _march_inputs(rng, p=40, g=8)
    args = _torch_march_args(d, torch.float32)
    before = dict(k4.LAUNCHES)
    out = k4.march_core(*args)
    out.sum().backward()
    assert out.shape == (40, 4) and k4.LAUNCHES == before
    assert args[5].grad is None  # x0: indices
    with pytest.raises(ValueError, match="no kernel"):
        k4.march_core(*(a.detach().to("meta") for a in args))


# ------------------------------- build -------------------------------


def test_build_is_keyed_by_sources_and_fails_loudly(monkeypatch, tmp_path):
    """The library name hashes the sources and flags; without nvcc the build
    raises naming nvcc and writes nothing."""
    h = _build.source_hash()
    assert h == _build.source_hash() and len(h) == 16
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.source_hash() != h
    assert {p.name for p in _build.sources()} >= {
        "composite.cu", "segment_sum.cu", "segsum_small.cu", "march.cu"}
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
