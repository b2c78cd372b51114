"""How the CSR SpMM kernels split rows, on the CPU.

Kernel A (``ops/csr_spmm.py``) walks no row longer than ``SPLIT_WIDTH``
edges: a hub's edges are cut into virtual rows, whose float32 partials
Kernel B adds into the hub's row. The H-head SpMM (``ops/spmm_heads.py``)
cuts its views into chunks of ``CHUNK`` entries and sums a long row's
entries chunk by chunk (``row_split`` is its plan; a chunk's row is read
from the view's ``row`` at the chunk's first entry). The H-head SDDMM gives
a lane group each ``CHUNK`` consecutive entries of the view, whatever their
rows, and reads each entry's row (``sddmm_entry_rows``: the view's ``row``,
or found from ``row_ptr`` for a view without it). The plans must cover
every entry of a row exactly once, in the row's order, and the products
that run on them must match the JAX package.

The graph: a hub of 3,000 edges, an empty row and rows of 1 to 40 edges,
made from a seed with numpy. Tolerances: float32 on both sides, the same
products summed in another order: rtol = atol = 1e-5. bfloat16: 2e-2 of
the row's scale |A|·|h|, since JAX sums bfloat16 products in bfloat16
(``ops/ell_bucketed.py:158-162``, ``ops/ell.py``) and rounds after every
add over the hub's 3,000 terms, where the port sums in float32 and rounds
once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_geometric_tpu.ops import spmm as jspmm
from tf_geometric_tpu.ops.ell import EllAdj, ell_spmm_multihead
from tf_geometric_tpu.ops.ell_bucketed import BucketedEllAdj, bucketed_spmm
from tf_geometric_tpu_torch.ops import spmm as tspmm
from tf_geometric_tpu_torch.ops.csr_spmm import SPLIT_WIDTH, CsrAdj, csr_spmm, serial_walks
from tf_geometric_tpu_torch.ops.gat_attention import CsrGatLayout
from tf_geometric_tpu_torch.ops.spmm_heads import (CHUNK, CsrView, build_csr_view, row_split,
                                                   sddmm_entry_rows, sddmm_heads_plain,
                                                   spmm_heads_launches, spmm_heads_plain,
                                                   spmm_multihead, view_entries)

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 2e-2
N, HUB, EMPTY = 160, 3_000, 1


def _graph(seed, self_loops=False):
    """Row 0 a hub of HUB edges, row EMPTY without edges, the other rows
    with 1 to 40 edges; columns uniform, values in [0.2, 1.5), edges
    shuffled."""
    rng = np.random.default_rng(seed)
    degrees = np.zeros(N, np.int64)
    degrees[0] = HUB
    others = np.arange(2, N)
    degrees[others] = (others - 2) % 40 + 1
    rows = np.repeat(np.arange(N), degrees)
    if self_loops:
        rows = np.concatenate([rows, np.setdiff1d(np.arange(N), [EMPTY])])
    cols = rng.integers(0, N, rows.shape[0])
    if self_loops:
        cols[-(N - 1):] = rows[-(N - 1):]
    perm = rng.permutation(rows.shape[0])
    ei = np.stack([rows[perm], cols[perm]]).astype(np.int32)
    ew = rng.uniform(0.2, 1.5, ei.shape[1]).astype(np.float32)
    return ei, ew, rng


def _dense_abs(ei, ew, shape):
    a = np.zeros(shape, np.float64)
    np.add.at(a, (ei[0], ei[1]), np.abs(ew))
    return a


def _assert_bf16_close(got, want, scale):
    """|got - want| within 2e-2 of the row's scale |A|·|h|."""
    assert np.all(np.abs(got - want) <= BF16_REL * scale + 1e-6)


# ---------------------------------------------------------------------------
# Kernel A's hub split: virtual rows of at most SPLIT_WIDTH edges
# ---------------------------------------------------------------------------

def _stored_rows(side):
    """Each stored edge's row, virtual rows mapped to the hub that owns them."""
    ptr = side.row_ptr.long()
    rows = torch.repeat_interleave(torch.arange(ptr.shape[0] - 1), ptr.diff())
    if side.num_virtual:
        owners = torch.repeat_interleave(side.owner_rows.long(), side.owner_ptr.long().diff())
        rows = torch.where(rows >= side.num_rows,
                           owners[(rows - side.num_rows).clamp(0, owners.shape[0] - 1)], rows)
    return rows


@pytest.mark.parametrize("side_name", ["fwd", "bwd"])
def test_csr_split_covers_each_edge_once_in_row_order(side_name):
    """Every edge is stored once; a row's edges, read in storage order (its
    virtual rows in ``owner_ptr`` order), are its edges in input order; no
    stored row exceeds SPLIT_WIDTH; a hub has ceil(degree / SPLIT_WIDTH)
    virtual rows."""
    ei, ew, _ = _graph(0)
    adj = CsrAdj.from_coo(ei, ew, (N, N), device="cpu")
    side = getattr(adj, side_name)
    keys = ei[0] if side_name == "fwd" else ei[1]
    rows = _stored_rows(side).numpy()
    eid = side.eid.numpy()
    assert np.array_equal(np.sort(eid), np.arange(ei.shape[1]))
    assert np.array_equal(rows, keys[eid])
    order = np.argsort(rows, kind="stable")
    assert np.array_equal(eid[order], np.argsort(keys, kind="stable"))
    deg = np.bincount(keys, minlength=N)
    stored = np.diff(side.row_ptr.numpy())
    assert stored.max() <= SPLIT_WIDTH
    hubs = np.nonzero(deg > SPLIT_WIDTH)[0]
    assert np.array_equal(side.owner_rows.numpy() if side.num_virtual else [], hubs)
    if side.num_virtual:
        np.testing.assert_array_equal(np.diff(side.owner_ptr.numpy()),
                                      -(-deg[hubs] // SPLIT_WIDTH))
    assert serial_walks(side) == (min(deg.max(), SPLIT_WIDTH),
                                  -(-deg.max() // SPLIT_WIDTH) if hubs.size else 0)


@pytest.mark.parametrize("split_diag", [False, True])
def test_csr_spmm_on_the_hub_graph_matches_jax(split_diag):
    """Forward and dh of ``csr_spmm`` at the default split against
    ``bucketed_spmm``, float32 and bfloat16."""
    ei, ew, rng = _graph(1, self_loops=split_diag)
    jadj = BucketedEllAdj.from_coo(ei, ew, (N, N), split_diag=split_diag, layout="bucketed")
    tadj = CsrAdj.from_coo(ei, ew, (N, N), split_diag=split_diag, device="cpu")
    assert tadj.fwd.num_virtual == -(-HUB // SPLIT_WIDTH)
    h = rng.normal(size=(N, 6)).astype(np.float32)
    ct = rng.normal(size=(N, 6)).astype(np.float32)
    abs_a = _dense_abs(ei, ew, (N, N))
    for dtype, jdtype in ((torch.float32, None), (torch.bfloat16, jnp.bfloat16)):
        want, vjp = jax.vjp(lambda x: bucketed_spmm(jadj, x, compute_dtype=jdtype),
                            jnp.asarray(h))
        (want_dh,) = vjp(jnp.asarray(ct))
        th = torch.tensor(h, requires_grad=True)
        got = csr_spmm(tadj, th, compute_dtype=dtype)
        (got_dh,) = torch.autograd.grad(got, th, torch.as_tensor(ct))
        pairs = ((got.detach().numpy(), np.asarray(want), abs_a @ np.abs(h)),
                 (got_dh.numpy(), np.asarray(want_dh), abs_a.T @ np.abs(ct)))
        for g, w, scale in pairs:
            if dtype == torch.float32:
                np.testing.assert_allclose(g, w, **TOL)
            else:
                _assert_bf16_close(g, w, scale)


# ---------------------------------------------------------------------------
# the H-head SpMM's chunks
# ---------------------------------------------------------------------------

def _views(ei):
    """The views the SpMM kernel runs on for this graph: the COO SpMM's
    forward and dh views (built on the device by a stable sort) and the
    multi-head SpMM's destination and source sides."""
    index = torch.as_tensor(ei).long()
    layout = CsrGatLayout.build(ei, N, device="cpu")
    return {"coo forward": build_csr_view(index[0], index[1], N, N),
            "coo dh": build_csr_view(index[1], index[0], N, N),
            "multihead dst": layout.dst, "multihead src": layout.src}


@pytest.mark.parametrize("name", ["coo forward", "coo dh", "multihead dst", "multihead src"])
def test_row_split_covers_each_entry_once_in_row_order(name):
    """Each row reads its entries before its first chunk boundary, then the
    chunks that start inside it, in order: together exactly the row's
    entries, in the view's order. A chunk belongs to the long row that holds
    its first entry; no piece exceeds CHUNK entries."""
    ei, _, _ = _graph(2)
    view = _views(ei)[name]
    ptr = view.row_ptr.long()
    plan = row_split(view.row_ptr)
    nnz = int(ptr[-1])
    # the kernel reads each chunk's row from the view's row of each entry
    assert view.row.dtype == torch.int32 and view.row.shape == view.nbr.shape
    np.testing.assert_array_equal(view.row[:nnz:CHUNK].long().numpy(), plan.chunk_row.numpy())
    covered = np.zeros(nnz, np.int64)
    for r in range(N):
        start, end = int(ptr[r]), int(ptr[r + 1])
        pieces = [(start, int(plan.direct_end[r]))]
        for c in range(int(plan.chunk_lo[r]), int(plan.chunk_hi[r])):
            assert int(plan.chunk_row[c]) == r
            pieces.append((c * CHUNK, min(end, (c + 1) * CHUNK)))
        walked = np.concatenate([np.arange(lo, hi) for lo, hi in pieces])
        assert np.array_equal(walked, np.arange(start, end))
        assert all(hi - lo <= CHUNK for lo, hi in pieces)
        covered[start:end] += 1
    assert np.all(covered == 1)
    long_rows = (ptr.diff() > CHUNK).numpy()
    hub_side = name in ("coo forward", "multihead dst")  # the hub is an in-degree
    assert long_rows.sum() == int(hub_side) and bool(long_rows[0]) == hub_side
    assert int((plan.chunk_hi - plan.chunk_lo).max()) == (-(-HUB // CHUNK) if hub_side else 0)
    assert spmm_heads_launches(view.nbr.shape[0]) == 2
    assert spmm_heads_launches(CHUNK) == 1


@pytest.mark.parametrize("heads", [1, 2])
def test_row_split_sums_match_the_plain_version(heads):
    """The kernel's plan, run in PyTorch: each chunk's float32 partial of
    its long row, then each row's entries before its first chunk boundary
    and its chunks' partials in order. It equals the plain SpMM."""
    ei, ew, rng = _graph(3)
    view = _views(ei)["coo forward"]
    w = torch.as_tensor(rng.uniform(0.2, 1.5, (ei.shape[1], heads)).astype(np.float32))
    d = 3
    src = torch.as_tensor(rng.normal(size=(N, heads * d)).astype(np.float32))
    rows, nbr, eid = view_entries(view)
    msg = (src[nbr].view(-1, heads, d) * w[eid][:, :, None]).reshape(-1, heads * d)
    ptr = view.row_ptr.long()
    plan = row_split(view.row_ptr)
    partial = {}
    for c, r in enumerate(plan.chunk_row.tolist()):
        if r >= 0 and ptr[r + 1] - ptr[r] > CHUNK:
            partial[c] = msg[c * CHUNK:min(int(ptr[r + 1]), (c + 1) * CHUNK)].sum(0)
    out = torch.stack([
        msg[int(ptr[r]):int(plan.direct_end[r])].sum(0)
        + sum((partial[c] for c in range(int(plan.chunk_lo[r]), int(plan.chunk_hi[r]))),
              torch.zeros(heads * d))
        for r in range(N)])
    torch.testing.assert_close(out, spmm_heads_plain(view, w, src, heads), **TOL)


def test_coo_spmm_on_the_hub_graph_matches_jax():
    """Forward, dh and dv of the COO SpMM against JAX's, float32 and a
    bfloat16 h (values float32, so JAX forms the product in float32) at
    width 8, and float32 at width 64 (the GIN width), with the SDDMM
    alone."""
    ei, ew, rng = _graph(4)
    for width, bf16 in ((8, False), (8, True), (64, False)):
        h = rng.normal(size=(N, width)).astype(np.float32)
        ct = rng.normal(size=(N, width)).astype(np.float32)
        hj = jnp.asarray(h).astype(jnp.bfloat16) if bf16 else jnp.asarray(h)
        want, vjp = jax.vjp(lambda v_, h_: jspmm.spmm(jnp.asarray(ei), v_, h_, N),
                            jnp.asarray(ew), hj)
        want_dv, want_dh = vjp(jnp.asarray(ct, dtype=want.dtype))
        tv = torch.tensor(ew, requires_grad=True)
        th = torch.tensor(h).to(torch.bfloat16 if bf16 else torch.float32).requires_grad_()
        got = tspmm.spmm(torch.as_tensor(ei), tv, th, N)
        got_dv, got_dh = torch.autograd.grad(got, (tv, th), torch.as_tensor(ct).to(got.dtype))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got_dv.numpy(), np.asarray(want_dv), **TOL)
        if bf16:
            scale = _dense_abs(ei, ew, (N, N)).T @ np.abs(ct)
            _assert_bf16_close(got_dh.float().numpy(),
                               np.asarray(want_dh.astype(jnp.float32)), scale)
        else:
            np.testing.assert_allclose(got_dh.numpy(), np.asarray(want_dh), **TOL)
            # the SDDMM alone: <ct[row_e], h[col_e]> for each edge
            want_s = jspmm.sddmm(jnp.asarray(ei), jnp.asarray(ct), jnp.asarray(h))
            got_s = tspmm.sddmm(torch.as_tensor(ei), torch.as_tensor(ct), torch.as_tensor(h))
            np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


@pytest.mark.parametrize("heads,d", [(1, 4), (4, 2), (8, 8), (8, 32), (1, 64)])
def test_spmm_multihead_on_the_hub_graph_matches_jax(heads, d):
    """Forward, d_att and dV against ``ell_spmm_multihead`` on the hub graph,
    float32; the forward in bfloat16 too."""
    ei, _, rng = _graph(5)
    e = ei.shape[1]
    att = rng.random((e, heads)).astype(np.float32)
    v = rng.normal(size=(N, heads * d)).astype(np.float32)
    ct = rng.normal(size=(N, heads * d)).astype(np.float32)
    ell = EllAdj.from_coo(ei, np.ones(e, np.float32), (N, N))
    want, vjp = jax.vjp(lambda a, vv: ell_spmm_multihead(ell, a, vv, d),
                        jnp.asarray(att), jnp.asarray(v))
    want_datt, want_dv = vjp(jnp.asarray(ct))
    layout = CsrGatLayout.build(ei, N, device="cpu")
    ta = torch.tensor(att, requires_grad=True)
    tv = torch.tensor(v, requires_grad=True)
    got = spmm_multihead(layout, ta, tv, d)
    d_att, dv = torch.autograd.grad(got, (ta, tv), torch.as_tensor(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(want_dv), **TOL)
    np.testing.assert_allclose(d_att.numpy(), np.asarray(want_datt), **TOL)
    want16 = ell_spmm_multihead(ell, jnp.asarray(att), jnp.asarray(v).astype(jnp.bfloat16), d)
    got16 = spmm_multihead(layout, torch.as_tensor(att), torch.tensor(v).to(torch.bfloat16), d)
    scale = np.repeat(_dense_abs(ei, np.ones(e, np.float32), (N, N)) @ np.ones((N, 1)),
                      heads * d, axis=1) * np.abs(v).max()
    _assert_bf16_close(got16.float().numpy(), np.asarray(want16.astype(jnp.float32)), scale)


# ---------------------------------------------------------------------------
# the H-head SDDMM's chunks
# ---------------------------------------------------------------------------

LONGEST = 2_839  # the self-looped arxiv graph's longest row


def _chunk_graph(seed):
    """Row 0 of LONGEST edges, rows 1 and 5 empty, row 2 of one edge, the
    others of 0 to 130 edges (so long rows start at every offset of a
    chunk); columns uniform, edges shuffled."""
    rng = np.random.default_rng(seed)
    degrees = rng.integers(0, 131, N)
    degrees[:6] = [LONGEST, 0, 1, 2, 65, 0]
    rows = np.repeat(np.arange(N), degrees)
    cols = rng.integers(0, N, rows.shape[0])
    perm = rng.permutation(rows.shape[0])
    return np.stack([rows[perm], cols[perm]]).astype(np.int32), rng


def _chunk_views(ei):
    """Views the SDDMM runs on: with ``row`` (the COO views, whose dropped
    edges sit past the stored entries, a ``CsrGatLayout`` side) and without
    (the COO view stripped of it, and a ``CsrAdj`` forward side as
    ``ops/ell.py`` hands it over, its hubs split into virtual rows)."""
    index = torch.as_tensor(np.concatenate([ei, [[N, N], [0, 1]]], axis=1)).long()
    coo = build_csr_view(index[0], index[1], N, N)
    adj = CsrAdj.from_coo(ei, np.ones(ei.shape[1], np.float32), (N, N), device="cpu")
    return {"coo forward": coo, "coo dh": build_csr_view(index[1], index[0], N, N),
            "multihead dst": CsrGatLayout.build(ei, N, device="cpu").dst,
            "no row": CsrView(coo.row_ptr, coo.nbr, coo.eid),
            "csr adj side": CsrView(adj.fwd.row_ptr, adj.fwd.col, adj.fwd.eid.int())}


@pytest.mark.parametrize("name", ["coo forward", "coo dh", "multihead dst", "no row",
                                  "csr adj side"])
def test_sddmm_chunks_cover_each_entry_once(name):
    """The rows the SDDMM kernel reads (``sddmm_entry_rows``) are the view's
    rows of its stored entries, and the row count past them (dropped edges,
    which the kernel skips); so its chunks of CHUNK consecutive entries hold
    each stored entry once, in rows of 0 to LONGEST entries. The SDDMM
    computed chunk by chunk from those rows, as the kernel does, equals the
    plain version at (H, d) = (8, 8), (8, 32) and (1, 64)."""
    ei, rng = _chunk_graph(6)
    view = _chunk_views(ei)[name]
    ptr = view.row_ptr.long()
    rows_count, nnz, entries = ptr.shape[0] - 1, int(ptr[-1]), view.nbr.shape[0]
    entry_row = sddmm_entry_rows(view)
    assert entry_row.dtype == torch.int32 and entry_row.shape == view.nbr.shape
    stored, _, _ = view_entries(view)
    np.testing.assert_array_equal(entry_row[:nnz].long().numpy(), stored.numpy())
    assert bool((entry_row[nnz:] == rows_count).all())
    lens = ptr.diff()
    if name in ("coo forward", "no row", "multihead dst"):
        assert int(lens.max()) == LONGEST and int((lens == 0).sum()) >= 2
    assert entries - nnz == (2 if name in ("coo forward", "no row") else 0)
    for heads, d in ((8, 8), (8, 32), (1, 64)):
        a = torch.as_tensor(rng.normal(size=(rows_count, heads * d)).astype(np.float32))
        b = torch.as_tensor(rng.normal(size=(N, heads * d)).astype(np.float32))
        got = torch.zeros(ei.shape[1] + 2, heads)
        for lo in range(0, entries, CHUNK):
            j = torch.arange(lo, min(entries, lo + CHUNK))
            r = entry_row[j].long()
            j, r = j[r < rows_count], r[r < rows_count]
            prod = a[r] * b[view.nbr[j].long()]
            got[view.eid[j].long()] = prod.view(-1, heads, d).sum(-1)
        want = sddmm_heads_plain(view, a, b, heads, torch.zeros(ei.shape[1] + 2, heads))
        torch.testing.assert_close(got, want, **TOL)
