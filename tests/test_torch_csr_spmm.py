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
from tf_geometric_tpu_torch.ops.csr_spmm import (L2_LINE, L2_SHARE, L2_SLICE_ABOVE, CsrAdj,
                                                 _csr_spmm_plain_f32, csr_spmm, side_matmul,
                                                 side_matmul_plain, slice_width)

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


# ---------------------------------------------------------------------------
# Kernel A's column slices: the plan (``slice_width``) and the launch's
# ticket plan, emulated as the grid runs it
# ---------------------------------------------------------------------------

H100_L2 = 50 * 2 ** 20  # torch.cuda.get_device_properties(...).L2_cache_size on the H100


def _lane_vectors(num_features, elt_bytes):
    """Every lane vector the kernel may take at this width: powers of two
    dividing F, at most 16 bytes (``ops.spmm_heads._vec_elements``)."""
    vec, out = 1, [1]
    while 2 * vec * elt_bytes <= 16 and num_features % (2 * vec) == 0:
        vec *= 2
        out.append(vec)
    return out


@pytest.mark.parametrize("n_src,num_features,elt", [
    (2_708, 16, 4),      # the tutorial's cora
    (2_708, 7, 4),
    (19_717, 16, 4),     # the GCN demo's Pubmed
    (19_717, 3, 4),
    (169_343, 40, 4),    # arxiv at the classes' width (workloads 10-12, the GCN cell's last layer)
    (42_336, 64, 4),     # a halo block's local side (X2, rank 0)
    (42_336, 40, 2),
    (169_343, 64, 4),    # the hard arxiv twins' hidden width: 43 MB, under twice the L2
    (169_343, 256, 2),   # the arxiv cell's hidden width in bfloat16: 87 MB
    (169_344, 96, 4),    # workload 17's MinCut rank block, forward (65 MB)
    (19_717, 500, 4),    # TAGCN's first hops on Pubmed (39 MB)
    (232_965, 41, 4),    # Reddit at the classes' width: rows off the 128-byte lines
])
def test_small_tables_take_one_slice(n_src, num_features, elt):
    assert slice_width(n_src, num_features, elt, H100_L2) == num_features


@pytest.mark.parametrize("n_src,num_features,elt,width", [
    (232_965, 256, 4, 32),   # the Reddit GCN cell's hidden passes: 8 slices of 29.8 MB
    (232_965, 256, 2, 64),   # in bfloat16: half as many
    (169_343, 256, 4, 32),   # the arxiv GCN cell's: 8 slices of 21.7 MB
    (232_965, 128, 4, 32),
])
def test_large_tables_are_cut_to_l2_lines(n_src, num_features, elt, width):
    got = slice_width(n_src, num_features, elt, H100_L2)
    assert got == width
    assert got * elt % L2_LINE == 0
    assert n_src * got * elt <= L2_SHARE * H100_L2


def test_f41_takes_one_slice_of_one_element_vectors():
    """F = 41 loads one-element vectors (41 is odd). Its Reddit table (38 MB)
    is gathered whole, and so would be one of four times the rows: its
    164-byte rows start off the lines, so a slice of one line would touch
    two lines of every row, more than the L2's share."""
    assert _lane_vectors(41, 4) == [1]
    assert slice_width(232_965, 41, 4, H100_L2) == 41
    assert slice_width(4 * 232_965, 41, 4, H100_L2) == 41
    assert 232_965 * 2 * L2_LINE > L2_SHARE * H100_L2


@pytest.mark.parametrize("elt", [4, 2])
@pytest.mark.parametrize("num_features", [1, 3, 41, 64, 96, 128, 256, 500, 602, 1000, 4096])
@pytest.mark.parametrize("n_src", [1, 1_000, 19_717, 100_000, 232_965, 400_000, 2_000_000])
def test_slices_are_lane_vector_multiples_covering_f_once(n_src, num_features, elt):
    width = slice_width(n_src, num_features, elt, H100_L2)
    assert 1 <= width <= num_features
    for vec in _lane_vectors(num_features, elt):
        assert width % vec == 0 or width == num_features
    slices = -(-num_features // width)
    covered = np.zeros(num_features, np.int64)
    for s in range(slices):
        covered[s * width:min(num_features, (s + 1) * width)] += 1
    assert np.all(covered == 1)
    if slices > 1:
        # only a table over twice the L2 is cut, into slices that hold no
        # more of the L2 than its share (one extra line a row where rows
        # start off the lines), a power-of-two number of lines wide
        assert n_src * num_features * elt > L2_SLICE_ABOVE * H100_L2
        lines = -(-width * elt // L2_LINE)
        assert lines & (lines - 1) == 0 and width * elt == lines * L2_LINE
        lines += num_features * elt % L2_LINE != 0
        assert n_src * lines * L2_LINE <= L2_SHARE * H100_L2


def _emulated_sliced_launch(side, h, diag, width, seed):
    """Kernel A's launch over ``width``-column slices as its grid runs it,
    on the CPU: the blocks of every slice in a shuffled order (the card
    keeps none), each lane group storing its row or its virtual row's
    partial for its slice's columns, a virtual row's group taking a ticket
    of (its hub, its slice) at ``slice * H + hub`` and, with the last one,
    merging that slice of the hub row from the partials stored so far.
    Unwritten output and partials are NaN, so a merge that ran early, or a
    row that nobody wrote, shows. Returns the output in h's dtype and the
    tickets after the launch."""
    num_rows, num_virtual, num_features = side.num_rows, side.num_virtual, h.shape[1]
    slices = -(-num_features // width)
    owner_rows, owner_ptr = side.owner_rows.tolist(), side.owner_ptr.tolist()
    hubs = len(owner_rows)
    tickets = np.zeros(slices * hubs, np.int64)
    out = torch.full((num_rows, num_features), float("nan"))
    partial = torch.full((num_virtual, num_features), float("nan"))
    sums = [_csr_spmm_plain_f32(side.row_ptr, side.col, side.val,
                                h[:, s * width:(s + 1) * width], diag, num_rows)
            for s in range(slices)]
    hub_of = np.searchsorted(np.asarray(owner_ptr), np.arange(num_virtual), side="right") - 1
    items = [(s, g) for s in range(slices) for g in range(num_rows + num_virtual)]
    order = np.random.default_rng(seed).permutation(len(items))
    for s, g in (items[i] for i in order):
        cols = slice(s * width, min(num_features, (s + 1) * width))
        if g >= num_virtual:  # an ordinary row; a hub row waits for its merge
            r = g - num_virtual
            if r not in owner_rows:
                out[r, cols] = sums[s][0][r]
            continue
        partial[g, cols] = sums[s][1][g]
        hub = int(hub_of[g])
        t = s * hubs + hub
        tickets[t] += 1
        first, last = owner_ptr[hub], owner_ptr[hub + 1]
        if tickets[t] != last - first:
            continue
        tickets[t] = 0
        row = owner_rows[hub]
        total = torch.zeros(cols.stop - cols.start)
        for i in range(first, last):
            total = total + partial[i, cols]
        own = torch.zeros_like(total) if diag is None else 0 + diag[row] * h[row, cols].float()
        out[row, cols] = total + own
    return out.to(h.dtype), tickets


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width,seed", [(1, 0), (2, 1), (3, 2), (4, 3), (8, 4)])
@pytest.mark.parametrize("split_diag", [False, True])
def test_sliced_ticket_plan_merges_each_hub_slice_once(dtype, width, seed, split_diag):
    """Each (hub, slice) is merged once, by the group that takes its last
    ticket, after every partial of that slice is stored; every ticket is
    back at 0; and the output is ``side_matmul_plain``'s, bit for bit."""
    ei, ew, rng = _skewed(11, self_loops=split_diag)
    _, tadj = _pair(ei, ew, (30, 30), split_diag=split_diag)
    side = tadj.fwd
    assert side.num_virtual > 0
    h = torch.as_tensor(rng.normal(size=(30, 8)).astype(np.float32)).to(dtype)
    got, tickets = _emulated_sliced_launch(side, h, tadj.diag_val, width, seed)
    assert not tickets.any()
    assert torch.equal(got, side_matmul_plain(side, h, tadj.diag_val))


def test_slice_tickets_are_kept_per_side_and_zeroed():
    """A side's slice tickets: zeros, [slices * H], one buffer per side
    reused by its later launches (grown for more slices), dropped with the
    side's own tickets."""
    import gc
    from tf_geometric_tpu_torch.ops import csr_spmm as cs
    ei, ew, _ = _skewed(12, n_rows=20, n_cols=45, e=160)
    tadj = CsrAdj.from_coo(ei, ew, (20, 45), split_width=WIDTH, device="cpu")
    hubs = tadj.fwd.tickets.shape[0]
    first = cs._slice_tickets(tadj.fwd.tickets, 3)
    assert first.shape == (3 * hubs,) and first.dtype == torch.int32 and not first.any()
    assert cs._slice_tickets(tadj.fwd.tickets, 2).data_ptr() == first.data_ptr()
    assert cs._slice_tickets(tadj.fwd.tickets, 5).shape == (5 * hubs,)
    other = cs._slice_tickets(tadj.bwd.tickets, 3)
    assert other.data_ptr() != first.data_ptr()
    keys = {id(tadj.fwd.tickets), id(tadj.bwd.tickets)}
    assert keys <= set(cs._SLICE_TICKETS)
    del tadj, first, other
    gc.collect()
    assert not keys & set(cs._SLICE_TICKETS)
