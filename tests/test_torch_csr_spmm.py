"""The port's CsrAdj / csr_spmm (plain versions, as CPU tensors take them)
against the JAX package's BucketedEllAdj / bucketed_spmm.

The graph is small and skewed, and both sides split rows longer than 4
edges (JAX: caps=(1, 2, 4), layout="bucketed"; port: split_width=4), so the
hub split and the merge of virtual-row partials (Kernel B's path) run.

Tolerances: float32 on both sides, same products summed in another order:
rtol = atol = 1e-5. bfloat16: JAX accumulates in bfloat16, rounding after
every multiply and add (ops/ell_bucketed.py:158-162), while the port sums in
float32 and rounds once; with at most 4 slots per packed row plus the merge
and the diagonal, the JAX side takes at most ~8 roundings of 2^-8 relative to
|A|·|h|, which bounds the gap.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_geometric_tpu.ops.ell_bucketed import BucketedEllAdj, bucketed_spmm
from tf_geometric_tpu_torch.ops.csr_spmm import (CsrAdj, csr_spmm, side_matmul,
                                                 side_matmul_plain)

TOL = dict(rtol=1e-5, atol=1e-5)
WIDTH = 4
BF16_ULP = 2.0 ** -8


def _skewed(seed, n_rows=30, n_cols=30, e=220, self_loops=False):
    rng = np.random.default_rng(seed)
    rows = (rng.random(e) ** 3 * n_rows).astype(np.int64)
    cols = rng.integers(0, n_cols, e)
    ei = np.stack([rows, cols])
    if self_loops:
        loops = np.arange(n_rows)
        ei = np.concatenate([ei, np.stack([loops, loops])], axis=1)
    ew = rng.uniform(0.2, 1.5, ei.shape[1]).astype(np.float32)
    return ei.astype(np.int32), ew, rng


def _pair(ei, ew, shape, split_diag=False):
    jadj = BucketedEllAdj.from_coo(ei, ew, shape, caps=(1, 2, WIDTH),
                                   split_diag=split_diag, layout="bucketed")
    tadj = CsrAdj.from_coo(ei, ew, shape, split_diag=split_diag, split_width=WIDTH,
                           device="cpu")
    return jadj, tadj


def _dense(ei, ew, shape):
    a = np.zeros(shape, np.float64)
    np.add.at(a, (ei[0], ei[1]), ew)
    return a


@pytest.mark.parametrize("split_diag", [False, True])
def test_forward_and_dh_match_jax(split_diag):
    ei, ew, rng = _skewed(0, self_loops=split_diag)
    jadj, tadj = _pair(ei, ew, (30, 30), split_diag)
    assert jadj.fwd.virt is not None and tadj.fwd.num_virtual > 0
    assert (tadj.diag_val is not None) == split_diag
    h = rng.normal(size=(30, 6)).astype(np.float32)
    ct = rng.normal(size=(30, 6)).astype(np.float32)

    want, vjp = jax.vjp(lambda x: bucketed_spmm(jadj, x), jnp.asarray(h))
    (want_dh,) = vjp(jnp.asarray(ct))
    th = torch.tensor(h, requires_grad=True)
    got = csr_spmm(tadj, th)
    (got_dh,) = torch.autograd.grad(got, th, torch.as_tensor(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_dh.numpy(), np.asarray(want_dh), **TOL)
    dense = _dense(ei, ew, (30, 30))
    np.testing.assert_allclose(got.detach().numpy(), dense @ h, **TOL)


def test_hub_owners_are_stored_compactly():
    """Only the split hubs carry an owner entry: ``owner_rows`` lists the
    rows with more than ``split_width`` edges, and ``owner_ptr`` gives each
    ceil(degree / split_width) virtual rows, in order after the ordinary rows."""
    ei, ew, _ = _skewed(0)
    _, tadj = _pair(ei, ew, (30, 30))
    side = tadj.fwd
    deg = np.bincount(ei[0], minlength=30)
    hubs = np.nonzero(deg > WIDTH)[0]
    np.testing.assert_array_equal(side.owner_rows.numpy(), hubs)
    np.testing.assert_array_equal(np.diff(side.owner_ptr.numpy()), -(-deg[hubs] // WIDTH))
    assert side.owner_ptr[-1] == side.num_virtual
    assert np.all(np.diff(side.row_ptr.numpy())[:30][hubs] == 0)


def test_split_diag_moves_one_diagonal_entry_per_row():
    ei, ew, _ = _skewed(1, self_loops=True)
    # a duplicate self-loop on row 7: only the first one leaves the CSR
    ei = np.concatenate([ei, np.array([[7], [7]], np.int32)], axis=1)
    ew = np.concatenate([ew, np.float32([0.25])])
    jadj, tadj = _pair(ei, ew, (30, 30), split_diag=True)
    np.testing.assert_allclose(tadj.diag_val.numpy(), np.asarray(jadj.diag_val), **TOL)
    np.testing.assert_array_equal(tadj.diag_eid.numpy(), np.asarray(jadj.diag_eid))
    stored = tadj.fwd.col.shape[0]
    assert stored == ei.shape[1] - 30
    assert tadj.fwd.eid.unique().numel() == stored


def test_with_edge_values_reskins_virtual_rows_and_diagonal():
    ei, ew, rng = _skewed(2, self_loops=True)
    jadj, tadj = _pair(ei, ew, (30, 30), split_diag=True)
    new = rng.normal(size=ei.shape[1]).astype(np.float32)
    h = rng.normal(size=(30, 5)).astype(np.float32)
    ct = rng.normal(size=(30, 5)).astype(np.float32)
    jnew = jadj.with_edge_values(jnp.asarray(new))
    tnew = tadj.with_edge_values(torch.as_tensor(new))
    want, vjp = jax.vjp(lambda x: bucketed_spmm(jnew, x), jnp.asarray(h))
    th = torch.tensor(h, requires_grad=True)
    got = tnew @ th
    (got_dh,) = torch.autograd.grad(got, th, torch.as_tensor(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_dh.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]), **TOL)
    np.testing.assert_allclose(got.detach().numpy(), _dense(ei, new, (30, 30)) @ h, **TOL)
    with pytest.raises(ValueError):
        tadj.with_edge_values(torch.zeros(3))


@pytest.mark.parametrize("splits", [3, [2, 5, 1]])
def test_num_or_size_splits(splits):
    ei, ew, rng = _skewed(3)
    jadj, tadj = _pair(ei, ew, (30, 30))
    h = rng.normal(size=(30, 8)).astype(np.float32)
    want = jadj.matmul(jnp.asarray(h), num_or_size_splits=splits)
    got = tadj.matmul(torch.as_tensor(h), num_or_size_splits=splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rectangular_matrix():
    ei, ew, rng = _skewed(4, n_rows=20, n_cols=45, e=160)
    jadj, tadj = _pair(ei, ew, (20, 45))
    assert tadj.fwd.num_virtual > 0 and tadj.bwd.num_rows == 45
    h = rng.normal(size=(45, 3)).astype(np.float32)
    ct = rng.normal(size=(20, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: bucketed_spmm(jadj, x), jnp.asarray(h))
    th = torch.tensor(h, requires_grad=True)
    got = csr_spmm(tadj, th)
    (got_dh,) = torch.autograd.grad(got, th, torch.as_tensor(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_dh.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]), **TOL)
    with pytest.raises(ValueError):
        CsrAdj.from_coo(ei, ew, (20, 45), split_diag=True, device="cpu")


@pytest.mark.parametrize("shape,split_diag", [((30, 30), True), ((20, 45), False)])
def test_bf16_compute(shape, split_diag):
    """bfloat16 compute against JAX (hub rows in both directions: the
    rectangular case's transpose has them too), and the port's sums rounded
    about once."""
    ei, ew, rng = _skewed(5, n_rows=shape[0], n_cols=shape[1], e=220 if split_diag else 160,
                          self_loops=split_diag)
    jadj, tadj = _pair(ei, ew, shape, split_diag=split_diag)
    h = rng.normal(size=(shape[1], 6)).astype(np.float32)
    ct = rng.normal(size=(shape[0], 6)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: bucketed_spmm(jadj, x, compute_dtype=jnp.bfloat16),
                        jnp.asarray(h))
    th = torch.tensor(h, requires_grad=True)
    got = csr_spmm(tadj, th, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    (got_dh,) = torch.autograd.grad(got, th, torch.as_tensor(ct))
    abs_a = np.abs(_dense(ei, ew, shape))
    for g, w, bound in ((got.detach().numpy(), np.asarray(want), abs_a @ np.abs(h)),
                        (got_dh.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]),
                         abs_a.T @ np.abs(ct))):
        assert np.all(np.abs(g - w) <= 8 * BF16_ULP * bound + 1e-6)
    # the port itself: float32 sums of bf16 inputs, rounded to bf16 about once
    h16 = torch.as_tensor(h).bfloat16().double().numpy()
    exact = _dense(ei, ew, shape) @ h16
    assert np.all(np.abs(got.detach().numpy() - exact) <= 2 * BF16_ULP * (abs_a @ np.abs(h16)) + 1e-6)


@pytest.mark.parametrize("split_diag", [False, True])
def test_bf16_hub_rows_round_once(split_diag):
    """``side_matmul_plain`` in bfloat16 is its float32 result on the same
    bf16 inputs, rounded once, on every row: a hub row's partials and its
    ``diag·h`` are added in float32 before the one cast (Kernel A's merge
    epilogue), not added to a ``diag·h`` already rounded to bfloat16."""
    ei, ew, rng = _skewed(9, self_loops=split_diag)
    _, tadj = _pair(ei, ew, (30, 30), split_diag=split_diag)
    side = tadj.fwd
    assert side.num_virtual > 0
    h = torch.as_tensor(rng.normal(size=(30, 8)).astype(np.float32)).bfloat16()
    got = side_matmul_plain(side, h, tadj.diag_val)
    want = side_matmul_plain(side, h.float(), tadj.diag_val).bfloat16()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_tickets_follow_the_layout():
    """Each side with hub rows carries its own int32 tickets [H], zeros; a
    side without hubs carries none; ``to`` moves them and
    ``with_edge_values`` shares them (its launches run on the same
    stream)."""
    ei, ew, _ = _skewed(10, n_rows=20, n_cols=45, e=160)
    tadj = CsrAdj.from_coo(ei, ew, (20, 45), split_width=WIDTH, device="cpu")
    for side in (tadj.fwd, tadj.bwd):
        if side.num_virtual:
            assert side.tickets.dtype == torch.int32
            assert side.tickets.shape == side.owner_rows.shape
            assert not side.tickets.any()
        else:
            assert side.tickets is None
    assert tadj.fwd.tickets.data_ptr() != tadj.bwd.tickets.data_ptr()
    moved = tadj.to("meta")
    for side, before in ((moved.fwd, tadj.fwd), (moved.bwd, tadj.bwd)):
        assert side.tickets.device.type == "meta"
        assert side.tickets.shape == before.tickets.shape
    reskinned = tadj.with_edge_values(torch.ones(ei.shape[1]))
    assert reskinned.fwd.tickets is tadj.fwd.tickets
    assert reskinned.bwd.tickets is tadj.bwd.tickets


def test_empty_graph_and_zero_degree_rows():
    """No edges at all: the output is diag·h (split_diag) or 0, no launch grid."""
    ei = np.zeros((2, 0), np.int32)
    tadj = CsrAdj.from_coo(ei, np.zeros(0, np.float32), (6, 6), device="cpu")
    h = torch.randn(6, 3)
    assert torch.equal(csr_spmm(tadj, h), torch.zeros(6, 3))
    loops = np.stack([np.arange(0, 6, 2)] * 2).astype(np.int32)
    tadj = CsrAdj.from_coo(loops, np.full(3, 2.0, np.float32), (6, 6), split_diag=True,
                           device="cpu")
    want = h * torch.tensor([2.0, 0, 2.0, 0, 2.0, 0])[:, None]
    assert torch.equal(csr_spmm(tadj, h), want)


def test_out_of_range_entries_are_dropped():
    ei, ew, rng = _skewed(6)
    ei = ei.copy()
    ei[0, :5] = 30   # padding rows
    ei[1, 5:8] = -1
    jadj, tadj = _pair(ei, ew, (30, 30))
    h = rng.normal(size=(30, 4)).astype(np.float32)
    np.testing.assert_allclose(csr_spmm(tadj, torch.as_tensor(h)).numpy(),
                               np.asarray(bucketed_spmm(jadj, jnp.asarray(h))), **TOL)


def test_dropout_contract_and_dispatch():
    ei, ew, _ = _skewed(7)
    tadj = CsrAdj.from_coo(ei, ew, (30, 30), device="cpu")
    assert tadj.dropout(0.5) is tadj
    assert tadj.dropout(0.5, generator=torch.Generator(), training=False) is tadj
    with pytest.raises(NotImplementedError):
        tadj.dropout(0.5, generator=torch.Generator())
    # a CPU tensor takes the plain version; any other non-CUDA device raises
    h = torch.randn(30, 2)
    assert torch.equal(side_matmul(tadj.fwd, h, None), side_matmul_plain(tadj.fwd, h, None))
    with pytest.raises(NotImplementedError):
        side_matmul(tadj.fwd, h.to("meta"), None)
    with pytest.raises(ValueError):
        csr_spmm(tadj, torch.randn(29, 2))
