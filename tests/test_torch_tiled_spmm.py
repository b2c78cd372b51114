"""The port's block-sparse SpMM (X7, ``ops/tiled_spmm.py``) against the JAX
``tiled_spmm`` on the CPU, through the plain pass.

The packings must be equal: tile ids exactly, tiles within 1e-6 (duplicate
edges may be summed in another order). Forward and ``dh`` within 1e-4,
bf16 tiles included: both sides round the same ``h`` to bf16 and sum the
exact bf16 products in float32, in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_geometric_tpu.ops.tiled_spmm import build_tiled_spmm as jax_build
from tf_geometric_tpu.ops.tiled_spmm import tiled_spmm as jax_tiled
from tf_geometric_tpu_torch.ops import tiled_spmm as tsp

TOL = dict(rtol=1e-4, atol=1e-4)
TILE_TOL = dict(rtol=1e-6, atol=1e-6)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, n, m, e, f):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, size=e)
    cols = rng.integers(0, m, size=e)
    vals = rng.normal(size=e).astype(np.float32)
    h = rng.normal(size=(m, f)).astype(np.float32)
    cot = rng.normal(size=(n, f)).astype(np.float32)
    return np.stack([rows, cols]), vals, h, cot


def _both(index, vals, shape, tile, dtype):
    jd, td = DTYPES[dtype]
    return (jax_build(index, vals, shape, tile=tile, dtype=jd),
            tsp.build_tiled_spmm(index, vals, shape, tile=tile, dtype=td, device="cpu"))


def _assert_same_packing(j, t):
    for name in ("row_tile", "col_tile", "t_row_tile", "t_col_tile"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)
    for name in ("a_tiles", "t_a_tiles"):
        np.testing.assert_allclose(getattr(t, name).float().numpy(),
                                   np.asarray(getattr(j, name), np.float32), **TILE_TOL,
                                   err_msg=name)
    assert (t.num_row_tiles, t.num_col_tiles, t.tile, t.shape, t.num_edges) == (
        j.num_row_tiles, j.num_col_tiles, j.tile, tuple(j.shape), j.num_edges)
    assert t.occupancy == pytest.approx(j.occupancy)
    assert t.bytes_per_pass(24) == j.bytes_per_pass(24)
    for ptr, rt in ((t.row_ptr, t.row_tile), (t.t_row_ptr, t.t_row_tile)):
        counts = np.bincount(rt.numpy(), minlength=ptr.shape[0] - 1)
        np.testing.assert_array_equal(np.diff(ptr.numpy()), counts)


def _forward_and_grad(j, t, h, cot):
    want = np.asarray(jax_tiled(j, jnp.asarray(h)))
    want_dh = np.asarray(jax.grad(lambda hh: (jax_tiled(j, hh) * cot).sum())(jnp.asarray(h)))
    ht = torch.tensor(h, requires_grad=True)
    out = tsp.tiled_spmm(t, ht)
    (out * torch.as_tensor(cot)).sum().backward()
    return out.detach().numpy(), want, ht.grad.numpy(), want_dh


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,tile", [((300, 260), 64), ((130, 130), 128), ((64, 64), 64)])
def test_tiled_spmm_matches_jax(shape, tile, dtype):
    n, m = shape
    index, vals, h, cot = _inputs(0, n, m, 6 * n, 24)
    j, t = _both(index, vals, shape, tile, dtype)
    _assert_same_packing(j, t)
    out, want, dh, want_dh = _forward_and_grad(j, t, h, cot)
    np.testing.assert_allclose(out, want, **TOL)
    np.testing.assert_allclose(dh, want_dh, **TOL)


def test_tiled_spmm_drops_padded_edges_like_jax():
    """tests/test_tiled_spmm.py's padding case (t = 32): out-of-range edges
    vanish from the packing; empty row tiles give zeros."""
    rng = np.random.default_rng(1)
    n, f = 96, 8
    index = np.array([[0, 5, n, 7], [1, 2, 0, n]], np.int64)
    vals = np.ones(4, np.float32)
    h = rng.normal(size=(n, f)).astype(np.float32)
    cot = rng.normal(size=(n, f)).astype(np.float32)
    j, t = _both(index, vals, (n, n), 32, "float32")
    assert t.num_edges == j.num_edges == 2
    _assert_same_packing(j, t)
    out, want, dh, want_dh = _forward_and_grad(j, t, h, cot)
    np.testing.assert_allclose(out, want, **TOL)
    np.testing.assert_allclose(dh, want_dh, **TOL)
    expect = np.zeros((n, f), np.float32)
    expect[0], expect[5] = h[1], h[2]
    np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("h_dtype", ["float32", "bfloat16"])
def test_tiled_spmm_bf16_tiles_match_jax(h_dtype):
    """tests/test_tiled_spmm.py's bf16 case: bf16 tiles; a bf16 ``h`` keeps
    its dtype in the output on both sides."""
    index, vals, h, cot = _inputs(2, 200, 200, 900, 16)
    j, t = _both(index, vals, (200, 200), 64, "bfloat16")
    _assert_same_packing(j, t)
    jd, td = DTYPES[h_dtype]
    want = np.asarray(jax_tiled(j, jnp.asarray(h, jd)), np.float32)
    got = tsp.tiled_spmm(t, torch.as_tensor(h).to(td))
    assert got.dtype == td
    tol = TOL if h_dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_float32_tiles_widen_a_bf16_operand():
    """float32 tiles against a bf16 ``h``: the operand is widened, not
    narrowed, and the output is bf16 (JAX casts ``h`` to the tiles' dtype)."""
    index, vals, h, _ = _inputs(3, 100, 80, 500, 8)
    j, t = _both(index, vals, (100, 80), 32, "float32")
    hb = torch.as_tensor(h).to(torch.bfloat16)
    want = np.asarray(jax_tiled(j, jnp.asarray(h, jnp.bfloat16)), np.float32)
    got = tsp.tiled_spmm(t, hb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)
    exact = tsp.tiled_spmm_plain(t.row_tile, t.col_tile, t.a_tiles, hb.float(),
                                 t.num_row_tiles, 100, 32)
    np.testing.assert_array_equal(got.float().numpy(),
                                  exact.to(torch.bfloat16).float().numpy())


def test_max_bytes_raises_before_packing():
    index, vals, _, _ = _inputs(4, 300, 260, 1800, 4)
    n_fwd = tsp.count_occupied_tiles(index, (300, 260), 64)
    n_bwd = tsp.count_occupied_tiles(index[::-1], (260, 300), 64)
    need = (n_fwd + n_bwd) * 64 * 64 * 2
    with pytest.raises(MemoryError, match="max_bytes"):
        tsp.build_tiled_spmm(index, vals, (300, 260), tile=64, dtype=torch.bfloat16,
                             device="cpu", max_bytes=need - 1)
    ts = tsp.build_tiled_spmm(index, vals, (300, 260), tile=64, dtype=torch.bfloat16,
                              device="cpu", max_bytes=need)
    assert ts.a_tiles.shape[0] == n_fwd and ts.t_a_tiles.shape[0] == n_bwd


def test_tiles_that_require_grad_raise():
    index, vals, h, _ = _inputs(5, 64, 64, 300, 4)
    ts = tsp.build_tiled_spmm(index, vals, (64, 64), tile=32, device="cpu")
    ts = ts._replace(a_tiles=ts.a_tiles.requires_grad_())
    with pytest.raises(ValueError, match="constants"):
        tsp.tiled_spmm(ts, torch.as_tensor(h))


def test_tiled_pass_bytes_count_the_tiles_and_the_rows_read():
    index, vals, _, _ = _inputs(6, 130, 100, 50, 4)
    ts = tsp.build_tiled_spmm(index, vals, (130, 100), tile=64, dtype=torch.bfloat16,
                              device="cpu")
    b = int(ts.a_tiles.shape[0])
    cols_read = sum(min(100 - c * 64, 64) for c in np.unique(ts.col_tile.numpy()))
    want = b * 64 * 64 * 2 + (cols_read + 130) * 8 * 4 + 4 * (ts.row_ptr.shape[0] + b)
    assert tsp.tiled_pass_bytes(ts, 8, 4) == want


def test_roofline_and_step_timer_of_the_ab():
    """``estimate_spmm_roofline`` keeps the JAX formula at the H100's rate;
    ``measure_step_time`` times only on a card."""
    from tf_geometric_tpu.utils.profiling import estimate_spmm_roofline as jax_roofline
    from tf_geometric_tpu_torch.utils import profiling
    assert profiling.estimate_spmm_roofline(1000, 50, 16) == pytest.approx(
        jax_roofline(1000, 50, 16, hbm_bandwidth=3.35e12))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            profiling.measure_step_time(lambda h: (h,), (torch.ones(2),))
