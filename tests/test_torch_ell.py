"""The port's ``ell_spmm`` (X2) and ``gat_attention_ell`` (X5) and the halo
plans built on them, against the JAX package's on the CPU, and the dry-run
entry that drives them over spawned ranks.

X2 (``ops/ell.py``) runs on a ``CsrAdj`` where JAX runs on a uniform-K
``EllAdj`` of the same COO: square with a split diagonal and rectangular,
with empty rows, unread columns, padded edges and rows longer than the port's
split width (so hub rows and their virtual rows are in play); forward,
``dh`` and, with ``diff_values=True``, the per-edge value gradient taken
through ``with_edge_values`` on both sides. float32, rtol = atol = 1e-5.

X5 (``gat_attention_ell`` in ``ops/gat_attention.py``) runs over a
rectangular ``CsrGatLayout`` where JAX runs over ``build_gat_layout`` of a
rectangular ``EllAdj``, with empty destination rows and source rows no edge reads: out, dQ, dK, dV without
dropout and with an explicit per-edge keep mask (on the JAX side the fused
VJP is called with ``keep_slots`` / ``keep_tail`` built from the mask
through ``slot_eid`` / ``tail_eid``). Tolerance 1e-5 for out, 1e-4 for the
gradients (the backward recomputes the softmax from lse and sums in
another order); bfloat16 compute 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_geometric_tpu.ops.ell import EllAdj, ell_spmm as jell_spmm
from tf_geometric_tpu.ops import ell_attention as jatt
from tf_geometric_tpu.parallel import halo as jhalo
from tf_geometric_tpu_torch.ops import ell
from tf_geometric_tpu_torch.ops.csr_spmm import CsrAdj
from tf_geometric_tpu_torch.ops.gat_attention import CsrGatLayout, gat_attention_ell
from tf_geometric_tpu_torch.parallel import halo, partition

X2_TOL = dict(rtol=1e-5, atol=1e-5)
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
SPLIT = 4  # the port's split width here: rows of more than 4 edges become hubs


def _coo(rng, rows, cols, num_edges, square, hub_row=3, hub_deg=13):
    """A COO over [rows, cols]: a hub row, the last 3 rows empty, the last 5
    columns unread, duplicate self-loops when square, and 4 padded edges
    (row = ``rows``) at the end."""
    r = np.concatenate([np.full(hub_deg, hub_row), rng.integers(0, rows - 3, num_edges)])
    c = rng.integers(0, cols - 5, r.shape[0])
    if square:
        loops = np.arange(0, rows - 3, 2)
        r = np.concatenate([r, loops, loops[:4]])
        c = np.concatenate([c, loops, loops[:4]])
    perm = rng.permutation(r.shape[0])
    ei = np.concatenate([np.stack([r, c])[:, perm], np.full((2, 4), rows)], axis=1)
    return ei.astype(np.int64), rng.uniform(0.5, 1.5, ei.shape[1]).astype(np.float32)


@pytest.mark.parametrize("shape,split_diag", [((30, 30), True), ((30, 30), False),
                                              ((24, 41), False)])
def test_ell_spmm_forward_and_dh_match_jax(shape, split_diag):
    rng = np.random.default_rng(0)
    ei, ew = _coo(rng, *shape, 60, square=split_diag)
    jadj = EllAdj.from_coo(ei, ew, shape, split_diag=split_diag)
    adj = CsrAdj.from_coo(ei, ew, shape, split_diag=split_diag, split_width=SPLIT, device="cpu")
    assert adj.fwd.num_virtual > 0
    h = rng.normal(size=(shape[1], 6)).astype(np.float32)
    dy = rng.normal(size=(shape[0], 6)).astype(np.float32)
    out, vjp = jax.vjp(lambda x: jell_spmm(jadj, x), jnp.asarray(h))
    th = torch.tensor(h, requires_grad=True)
    got = ell.ell_spmm(adj, th)
    got.backward(torch.tensor(dy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **X2_TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(vjp(jnp.asarray(dy))[0]), **X2_TOL)
    assert np.abs(got.detach().numpy()[-3:]).max() == 0.0  # empty rows


@pytest.mark.parametrize("shape,split_diag,hub_deg,width,split", [
    ((30, 30), True, 13, 5, SPLIT), ((24, 41), False, 13, 5, SPLIT),
    ((30, 30), True, 70, 64, None), ((24, 41), False, 70, 64, None)],
    ids=["shape0-True", "shape1-False", "long-row-F64-True", "long-row-F64-False"])
def test_ell_spmm_value_gradient_matches_jax(shape, split_diag, hub_deg, width, split):
    """diff_values=True: dv[e] = <dy[row_e], h[col_e]> for every stored edge,
    the split diagonal's included, 0 on padded edges; flows to the values
    given to ``with_edge_values``. Also at the halo GCN's width 64 with a
    row of more than 64 edges at the port's own split width (the SDDMM's
    view holds its virtual rows)."""
    rng = np.random.default_rng(1)
    ei, ew = _coo(rng, *shape, 60, square=split_diag, hub_deg=hub_deg)
    vals = rng.uniform(0.5, 1.5, ei.shape[1]).astype(np.float32)
    jadj = EllAdj.from_coo(ei, ew, shape, split_diag=split_diag)
    kw = {} if split is None else dict(split_width=split)
    adj = CsrAdj.from_coo(ei, ew, shape, split_diag=split_diag, device="cpu", **kw)
    assert adj.fwd.num_virtual > 0
    h = rng.normal(size=(shape[1], width)).astype(np.float32)
    dy = rng.normal(size=(shape[0], width)).astype(np.float32)

    def jfn(v, x):
        return jell_spmm(jadj.with_edge_values(v), x, diff_values=True)

    out, vjp = jax.vjp(jfn, jnp.asarray(vals), jnp.asarray(h))
    jdv, jdh = vjp(jnp.asarray(dy))
    tv, th = torch.tensor(vals, requires_grad=True), torch.tensor(h, requires_grad=True)
    got = ell.ell_spmm(ell.with_edge_values(adj, tv), th, diff_values=True)
    got.backward(torch.tensor(dy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **X2_TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), **X2_TOL)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jdv), **X2_TOL)
    assert np.all(tv.grad.numpy()[-4:] == 0.0)  # padded edges
    if split_diag:
        assert np.any(tv.grad.numpy()[adj.diag_eid.numpy()[adj.diag_eid.numpy() < len(vals)]])


def test_ell_spmm_constant_values_and_compute_dtype():
    """``diff_values=True`` on a layout without carried values treats them as
    constants, as ``diff_values=False`` does; ``CsrAdj.with_edge_values``
    keeps its constant contract; bfloat16 compute casts back."""
    rng = np.random.default_rng(2)
    ei, ew = _coo(rng, 30, 30, 60, square=True)
    adj = CsrAdj.from_coo(ei, ew, (30, 30), split_diag=True, split_width=SPLIT, device="cpu")
    h = torch.tensor(rng.normal(size=(30, 4)).astype(np.float32))
    want = ell.ell_spmm(adj, h)
    assert torch.equal(ell.ell_spmm(adj, h, diff_values=True), want)
    tv = torch.tensor(ew, requires_grad=True)
    assert not ell.ell_spmm(adj.with_edge_values(tv), h, diff_values=True).requires_grad
    low = ell.ell_spmm(ell.with_edge_values(adj, tv), h, diff_values=True,
                       compute_dtype=torch.bfloat16)
    assert low.dtype == torch.float32 and low.requires_grad
    np.testing.assert_allclose(low.detach().numpy(), want.numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("shape,split_diag", [((30, 30), True), ((24, 41), False)])
def test_csr_pass_bytes_charge_only_rows_read(shape, split_diag):
    """The bench's least bytes of an SpMM pass charge the operand's rows that
    an entry or the diagonal reads (unread columns and empty rows drop out)
    and the whole output."""
    from tf_geometric_tpu_torch import bench
    rng = np.random.default_rng(8)
    ei, ew = _coo(rng, *shape, 60, square=split_diag)
    adj = CsrAdj.from_coo(ei, ew, shape, split_diag=split_diag, split_width=SPLIT, device="cpu")
    ok = ei[0] < shape[0]
    for side, read, operand_rows in ((adj.fwd, ei[1][ok], shape[1]),
                                     (adj.bwd, ei[0][ok], shape[0])):
        n_read = len(np.unique(read))
        assert bench.csr_rows_read(adj, side) == n_read < operand_rows
        assert bench.csr_pass_bytes(adj, side, 8, 4) == (
            (n_read + side.num_rows) * 8 * 4 + 4 * side.row_ptr.shape[0]
            + 8 * side.col.shape[0] + (4 * side.num_rows if split_diag else 0))
    assert bench.csr_diag_rows(adj) == (len(np.unique(ei[0][ok & (ei[0] == ei[1])]))
                                        if split_diag else 0)


def test_gat_pass_bytes_charge_only_rows_read():
    """The bench's least bytes of the attention passes charge inputs on the
    destination and source rows with an entry and outputs on every row; a
    square, self-looped layout is charged every row."""
    from tf_geometric_tpu_torch import bench
    H, d = 2, 4
    ei, q, k, _, _ = _rect_gat(np.random.default_rng(9), H=H, d=d)
    n, s = q.shape[0], k.shape[0]
    layout = CsrGatLayout.build(ei, n, device="cpu", num_src=s)
    ok = ei[0] < n
    n_read, s_read, nnz = len(np.unique(ei[0][ok])), len(np.unique(ei[1][ok])), int(ok.sum())
    assert n_read == n - 3 and s_read <= s - 5
    row = H * d * 4
    want = ((n_read + n + 2 * s_read) * row + 4 * H * n + 4 * (n + 1) + 4 * nnz,
            (3 * n_read + n + 2 * s_read) * row + 4 * H * (n_read + n) + 4 * (n + 1) + 4 * nnz,
            (2 * n_read + 2 * s_read + 2 * s) * row + 4 * H * 2 * n_read + 4 * (s + 1) + 4 * nnz)
    assert tuple(bench.gat_pass_bytes(layout, kind, H, d, 4) for kind in range(3)) == want
    square = CsrGatLayout.build(np.concatenate([ei[:, ok], np.tile(np.arange(n), (2, 1))], 1),
                                n, device="cpu")
    e = int(square.dst.nbr.shape[0])
    assert bench.gat_pass_bytes(square, 2, H, d, 4, with_keep=True) == (
        6 * n * row + 8 * H * n + 4 * (n + 1) + 8 * e + 4 * square.num_edges * H)


def test_gat_src_gather_work_counts_what_the_kernel_moves():
    """The source-pass kernel's own bound: Q and dy on the destination rows
    an entry names, w (2H float32) per stored entry, the side's ids, dK and
    dV on every source row; 4 flops per entry and feature."""
    from tf_geometric_tpu_torch import bench
    H, d = 2, 4
    ei, q, k, _, _ = _rect_gat(np.random.default_rng(6), H=H, d=d)
    n, s = q.shape[0], k.shape[0]
    layout = CsrGatLayout.build(ei, n, device="cpu", num_src=s)
    ok = ei[0] < n
    n_read, nnz = len(np.unique(ei[0][ok])), int(ok.sum())
    row = H * d * 2
    assert bench.gat_src_gather_work(layout, H, d, 2) == (
        (2 * n_read + 2 * s) * row + 4 * 2 * H * nnz + 4 * (s + 1) + 8 * nnz, 4 * nnz * H * d)


def _rect_gat(rng, n_dst=20, n_src=33, H=2, d=4):
    """A rectangular attention graph: destination rows 17-19 without edges,
    sources 28-32 never read, one destination hub, padded edges (row =
    n_dst) in the edge-id order."""
    rows = np.concatenate([np.full(12, 5), rng.integers(0, n_dst - 3, 70)])
    cols = rng.integers(0, n_src - 5, rows.shape[0])
    ei = np.concatenate([np.stack([rows, cols]), np.stack([np.full(6, n_dst), np.zeros(6)])],
                        axis=1).astype(np.int64)
    q, dy = (rng.normal(size=(n_dst, H * d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(n_src, H * d)).astype(np.float32) for _ in range(2))
    return ei, q, k, v, dy


def _port_attention(layout, q, k, v, dy, H, **kw):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = gat_attention_ell(layout, tq, tk, tv, H, **kw)
    out.backward(torch.tensor(dy).to(out.dtype))
    return [t.detach().float().numpy() for t in (out, tq.grad, tk.grad, tv.grad)]


def _check(got, want):
    for name, g, w in zip(("out", "dQ", "dK", "dV"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name,
                                   **(OUT_TOL if name == "out" else GRAD_TOL))


def _check_bf16(got, want):
    """bfloat16 compute: 2e-2 (JAX rounds to bfloat16 where the port sums in
    float32)."""
    for name, g, w in zip(("out", "dQ", "dK", "dV"), got, want):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), err_msg=name, rtol=2e-2,
                                   atol=2e-2)


# (heads, head width) cases beyond the small ones: the halo GAT's two layers
# and the 8-head GAT's, float32 and bfloat16 compute, through the port's two
# backward passes (the destination pass's per-edge weights feed the source
# pass's weighted gather)
SPLIT_CASES = [(H, d, bf16) for H, d in [(8, 8), (1, 64), (8, 32)] for bf16 in (False, True)]


@pytest.mark.parametrize("H,d,bf16", [(2, 4, False), (1, 8, False)] + SPLIT_CASES)
def test_gat_attention_ell_matches_jax(H, d, bf16):
    rng = np.random.default_rng(3)
    ei, q, k, v, dy = _rect_gat(rng, H=H, d=d)
    n_dst, n_src = q.shape[0], k.shape[0]
    cd = jnp.bfloat16 if bf16 else None
    jlayout = jatt.build_gat_layout(EllAdj.from_coo(ei, None, (n_dst, n_src)))
    out, vjp = jax.vjp(lambda a, b, c: jatt.gat_attention_ell(jlayout, a, b, c, H,
                                                              compute_dtype=cd),
                       *map(jnp.asarray, (q, k, v)))
    want = (out,) + vjp(jnp.asarray(dy).astype(out.dtype))
    layout = CsrGatLayout.build(ei, n_dst, device="cpu", num_src=n_src)
    got = _port_attention(layout, q, k, v, dy, H,
                          compute_dtype=torch.bfloat16 if bf16 else None)
    (_check_bf16 if bf16 else _check)(got, want)
    assert np.abs(got[0][-3:]).max() == 0.0  # destination rows without edges
    assert np.abs(got[2][-5:]).max() == 0.0 and np.abs(got[3][-5:]).max() == 0.0  # unread


@pytest.mark.parametrize("H,d,bf16", [(2, 4, False)] + SPLIT_CASES)
def test_gat_attention_ell_keep_mask_matches_jax_fused_vjp(H, d, bf16):
    rng = np.random.default_rng(4)
    ei, q, k, v, dy = _rect_gat(rng, H=H, d=d)
    n_dst, n_src, E = q.shape[0], k.shape[0], ei.shape[1]
    mask = ((rng.random((E, H)) < 0.6) / 0.6).astype(np.float32)
    jell = EllAdj.from_coo(ei, None, (n_dst, n_src))
    jlayout = jatt.build_gat_layout(jell)
    padded = np.concatenate([mask, np.zeros((1, H), np.float32)])
    keep_slots = jnp.asarray(padded[np.clip(np.asarray(jell.slot_eid), 0, E)])
    keep_tail = jnp.asarray(padded[np.clip(np.asarray(jell.tail_eid), 0, E)])
    cd = jnp.bfloat16 if bf16 else jnp.float32

    def fn(a, b, c):
        a, b, c = (t.astype(cd) for t in (a, b, c))
        return jatt._fused_vjp(n_dst, E, H, d, jell.slots_col, jell.slot_eid, jell.tail_row,
                               jell.tail_col, jell.diag_eid, jell.t_slots_col,
                               jlayout.t_slot_pos, jell.t_tail_row, jell.t_tail_col,
                               jlayout.t_tail_pos, a, b, c, keep_slots, keep_tail,
                               jnp.ones((), jnp.float32)).astype(jnp.float32)

    out, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    layout = CsrGatLayout.build(ei, n_dst, device="cpu", num_src=n_src)
    got = _port_attention(layout, q, k, v, dy, H, training=True, edge_drop_rate=0.4,
                          keep_mask=torch.tensor(mask),
                          compute_dtype=torch.bfloat16 if bf16 else None)
    (_check_bf16 if bf16 else _check)(got, (out,) + vjp(jnp.asarray(dy)))
    assert np.abs(got[2][-5:]).max() == 0.0 and np.abs(got[3][-5:]).max() == 0.0  # unread


def test_gat_attention_ell_contract():
    rng = np.random.default_rng(5)
    ei, q, k, v, _ = _rect_gat(rng)
    layout = CsrGatLayout.build(ei, q.shape[0], device="cpu", num_src=k.shape[0])
    assert (layout.num_nodes, layout.num_src, layout.num_edges) == (20, 33, ei.shape[1])
    assert layout.src.row_ptr.shape == (34,) and layout.dst.row_ptr.shape == (21,)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    with pytest.raises(NotImplementedError):
        gat_attention_ell(layout, tq, tk, tv[:, :4], 2)
    with pytest.raises(ValueError, match="rows"):
        gat_attention_ell(layout, tq, tq, tq, 2)
    with pytest.raises(ValueError, match="generator or keep_mask"):
        gat_attention_ell(layout, tq, tk, tv, 2, edge_drop_rate=0.5, training=True)


def _halo_problem(n=600, parts=4, seed=6):
    """A graph with local structure (edges mostly within 40 ids), its
    symmetric-normalized GCN partition and its self-looped GAT partition."""
    from tf_geometric_tpu.nn.conv.gcn import gcn_norm_adj as jgcn_norm_adj
    from tf_geometric_tpu.sparse import SparseMatrix as JSparse
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - 10, 3000)
    near = rng.random(3000) < 0.85
    dst = np.where(near, np.clip(src + rng.integers(-40, 40, 3000), 0, n - 11),
                   rng.integers(0, n - 10, 3000))
    ei = np.stack([dst, src]).astype(np.int32)
    normed = jgcn_norm_adj(JSparse(ei, None, (n, n)))
    gcn_part = partition.partition_edges_by_row(np.asarray(normed.index),
                                                np.asarray(normed.value), n, parts)
    loops = np.concatenate([ei, np.stack([np.arange(n), np.arange(n)])], axis=1)
    return gcn_part, partition.partition_edges_by_row(loops, None, n, parts)


def test_halo_plans_match_jax():
    """send_idx, cap and the local / remote edge sets equal JAX's; the
    packed blocks give JAX's ``A·h``; the GAT layouts JAX's attention."""
    gcn_part, gat_part = _halo_problem()
    P = gcn_part.num_parts
    want, got = jhalo.build_halo_spec(gcn_part), halo.build_halo_spec(gcn_part)
    for field in got._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)), err_msg=field)
    assert got.halo_fraction == want.halo_fraction < 1.0
    jspec, spec = (jhalo.build_halo_spec(gcn_part, layout="ell"),
                   halo.build_halo_spec(gcn_part, layout="ell"))
    np.testing.assert_array_equal(spec.send_idx, jspec.send_idx)
    assert spec.capacity == jspec.capacity
    rng = np.random.default_rng(7)
    npp, cap = spec.nodes_per_part, spec.capacity
    for r in range(P):
        blocks = ([a[r] for a in jspec.local], [a[r] for a in jspec.remote])
        for adj, arrays, rows in ((spec.local[r], blocks[0], npp),
                                  (spec.remote[r], blocks[1], P * cap)):
            h = rng.normal(size=(rows, 8)).astype(np.float32)
            np.testing.assert_allclose(
                ell.ell_spmm(adj, torch.tensor(h)).numpy(),
                np.asarray(jell_spmm(jhalo._ell_adj_from_block(arrays), jnp.asarray(h))),
                **X2_TOL)
    jg, g = jhalo.build_gat_halo_spec(gat_part), halo.build_gat_halo_spec(gat_part)
    np.testing.assert_array_equal(g.send_idx, jg.send_idx)
    assert (g.num_edges, g.capacity) == (jg.num_edges, jg.capacity)
    H, d = 2, 4
    S = g.nodes_per_part + P * g.capacity
    for r in range(P):
        q = rng.normal(size=(g.nodes_per_part, H * d)).astype(np.float32)
        k, v = (rng.normal(size=(S, H * d)).astype(np.float32) for _ in range(2))
        want = jhalo.halo_gat_attention(*map(jnp.asarray, (q, k, v)),
                                        [jnp.asarray(a[r]) for a in jg[1:10]], jg.num_edges, H)
        plan = halo.rank_gat_plan(g, r, "cpu")
        assert plan.layout.num_nodes == g.nodes_per_part and plan.layout.num_src == S
        out = halo.halo_gat_attention(*map(torch.tensor, (q, k, v)), plan, H)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), **OUT_TOL)


def test_dryrun_multichip_on_cpu_ranks():
    """``entry.dryrun_multichip`` trains one step of the halo GCN, of the
    fused halo GAT (dropout 0.6), of the sampled SAGE and of the 2-D batch
    step on 4 spawned gloo ranks: finite losses near ln 7 (7 classes,
    weights at scale 0.1 and 0.05); and of the MinCut step: a finite loss
    (its pooled graph is not normalized: clusters of ~700 nodes put it far
    from ln 7) and a cut loss in [-1, 0]."""
    from tf_geometric_tpu_torch.entry import dryrun_multichip
    losses = dryrun_multichip(4, device="cpu")
    assert set(losses) == {"gcn", "gat", "sage", "mincut", "mincut_cut", "batch_2d"}
    for name in ("gcn", "gat", "sage", "batch_2d"):
        assert np.isfinite(losses[name]) and abs(losses[name] - np.log(7)) < 0.5, name
    assert np.isfinite(losses["mincut"]) and -1.0 <= losses["mincut_cut"] <= 0.0
