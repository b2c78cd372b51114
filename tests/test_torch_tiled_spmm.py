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


# ---------------------------------------------------------------------------
# the bf16-tile kernel's host side: its plan and its cast of the operand
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 24, 128, 136, 300])
@pytest.mark.parametrize("tile", [16, 48, 128, 256])
def test_mma_plan_covers_the_pass_within_the_card(tile, width):
    """Every row of the tile has a warpgroup, every column a chunk; the
    fewest F chunks the 128 accumulators a thread allow, balanced atoms;
    16-byte rows of the cast operand; 3 to 6 stages, as many as the shared
    memory of the plan's resident blocks holds, and at most 232,448 bytes
    a block."""
    p = tsp.mma_plan(tile, width)
    assert p.slices == -(-tile // 64) and p.wgs == min(2, p.slices)
    assert p.slices_per_wg == -(-p.slices // p.wgs) and p.threads == 128 * p.wgs + 32
    need = -(-width // 64)
    assert p.chunks == -(-need // (4 // p.slices_per_wg))
    assert p.atoms == -(-need // p.chunks) and p.chunks * p.atoms * 64 >= width
    assert p.slices_per_wg * p.atoms * 32 <= 128
    assert p.f_pad % 8 == 0 and width <= p.f_pad < width + 8
    assert p.stage_bytes == (p.slices + p.atoms) * 8192
    assert 3 <= p.stages <= 6
    assert p.smem_bytes == 1024 + p.stages * (p.stage_bytes + 16) <= 232_448
    assert p.blocks_per_sm in (1, 2) and p.blocks_per_sm * (p.smem_bytes + 1024) <= 233_472
    if p.blocks_per_sm == 2:
        assert p.slices_per_wg * p.atoms <= 2
    budget = 232_448 if p.blocks_per_sm == 1 else 233_472 // 2 - 1024
    assert p.stages == 6 or 1024 + (p.stages + 1) * (p.stage_bytes + 16) > budget


def test_mma_plan_at_the_ab_and_the_edges():
    """The A/B's call (t = 128, F = 128): one chunk of two atoms, two blocks
    an SM of three stages; F = 136 at t = 256 takes two chunks; t = 24 and
    t = 272 are refused."""
    ab = tsp.mma_plan(128, 128)
    assert (ab.atoms, ab.chunks, ab.stages, ab.blocks_per_sm, ab.wgs) == (2, 1, 3, 2, 2)
    assert tsp.mma_plan(256, 136).chunks == 2 and tsp.mma_plan(128, 136).chunks == 1
    assert (tsp.mma_plan(48, 130).atoms, tsp.mma_plan(48, 130).wgs) == (3, 1)
    for tile in (0, 24, 272):
        with pytest.raises(ValueError, match="multiple of 16"):
            tsp.mma_plan(tile, 8)


@pytest.mark.parametrize("h_dtype", ["float32", "bfloat16"])
def test_cast_operand_rounds_once_and_pads_with_zeros(h_dtype):
    """The operand the bf16-tile kernel reads: ``h`` rounded to bf16 once,
    zero rows up to whole tiles, zero columns up to a multiple of 8."""
    rng = np.random.default_rng(8)
    h = torch.as_tensor(rng.normal(size=(70, 13)), dtype=torch.float32).to(DTYPES[h_dtype][1])
    hc = tsp.cast_operand(h, 48)
    assert hc.dtype == torch.bfloat16 and tuple(hc.shape) == (96, 16)
    assert torch.equal(hc[:70, :13], h.to(torch.bfloat16))
    assert not hc[70:].any() and not hc[:, 13:].any()


@pytest.mark.parametrize("shape,tile,width,h_dtype", [((520, 600), 256, 136, "float32"),
                                                      ((100, 70), 48, 130, "bfloat16")])
def test_tiled_spmm_at_the_plans_edges_matches_jax(shape, tile, width, h_dtype):
    """bf16 tiles where the kernel's plan has edges: F = 136 at t = 256 (two
    F chunks) and t = 48 (a k chunk cut at the tile's edge) with a bf16
    ``h``; forward and ``dh`` (bf16 ``h``: 1e-2, one bf16 rounding of the
    output)."""
    n, m = shape
    index, vals, h, cot = _inputs(7, n, m, 6 * n, width)
    j, t = _both(index, vals, shape, tile, "bfloat16")
    _assert_same_packing(j, t)
    jd, td = DTYPES[h_dtype]
    tol = TOL if h_dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    hj = jnp.asarray(h, jd)
    want = np.asarray(jax_tiled(j, hj), np.float32)
    want_dh = np.asarray(jax.grad(lambda hh: (jax_tiled(j, hh).astype(jnp.float32)
                                              * cot).sum())(hj), np.float32)
    ht = torch.as_tensor(h).to(td).requires_grad_()
    out = tsp.tiled_spmm(t, ht)
    (out.float() * torch.as_tensor(cot)).sum().backward()
    assert out.dtype == td and ht.grad.dtype == td
    np.testing.assert_allclose(out.detach().float().numpy(), want, **tol)
    np.testing.assert_allclose(ht.grad.float().numpy(), want_dh, **tol)
