"""The port's COO SpMM / SDDMM (``ops/spmm.py``) and multi-head SpMM
(``ops/spmm_heads.spmm_multihead``), through the plain versions that CPU
tensors take, against the JAX package's ``ops.spmm`` (via ``jax.vjp``) and
``ell_spmm_multihead`` on ``EllAdj.from_coo``, on the CPU.

Tolerances: float32 sums taken in another order, rtol = atol = 1e-5; a
bfloat16 ``h`` is held at rtol = atol = 2e-2 where the two sides round the
product differently (JAX sums bfloat16 products for bfloat16 weights, the
port sums in float32), and exactly where both form the same float32 sums.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_geometric_tpu.ops import spmm as jspmm
from tf_geometric_tpu.ops.ell import EllAdj, ell_spmm_multihead
from tf_geometric_tpu.sparse import SparseMatrix as JSparse
from tf_geometric_tpu_torch.ops import spmm as tspmm
from tf_geometric_tpu_torch.ops.gat_attention import CsrGatLayout
from tf_geometric_tpu_torch.ops.spmm_heads import (build_csr_view, launch_sddmm_heads,
                                                   launch_spmm_heads, spmm_heads_plain,
                                                   spmm_multihead)
from tf_geometric_tpu_torch.sparse import SparseMatrix as TSparse

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _edges(seed, num_rows=14, num_cols=11, e=60, sinks=5, bad_cols=3):
    """Unsorted edges with duplicates, ``sinks`` padded edges (row = col =
    out of range) and ``bad_cols`` in-range rows with out-of-range cols."""
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, num_rows, e), rng.integers(0, num_cols, e)])
    ei[:, 5:10] = ei[:, :5]  # duplicates
    pad = np.full((2, sinks), max(num_rows, num_cols))
    bad = np.stack([rng.integers(0, num_rows, bad_cols), num_cols + rng.integers(0, 4, bad_cols)])
    ei = np.concatenate([ei, pad, bad], axis=1)
    ei = ei[:, rng.permutation(ei.shape[1])]
    return ei.astype(np.int64), rng


def _jax_spmm(ei, v, h, num_rows, ct):
    out, vjp = jax.vjp(lambda v_, h_: jspmm.spmm(jnp.asarray(ei), v_, h_, num_rows),
                       jnp.asarray(v), jnp.asarray(h))
    dv, dh = vjp(jnp.asarray(ct, dtype=out.dtype))
    return np.asarray(out.astype(jnp.float32)), np.asarray(dh.astype(jnp.float32)), \
        np.asarray(dv.astype(jnp.float32))


def _port_spmm(ei, v, h, num_rows, ct, h_dtype=torch.float32):
    tv = torch.tensor(v, requires_grad=True)
    th = torch.tensor(h).to(h_dtype).requires_grad_()
    out = tspmm.spmm(torch.as_tensor(ei), tv, th, num_rows)
    dv, dh = torch.autograd.grad(out, (tv, th), torch.as_tensor(ct).to(out.dtype))
    return out, dh, dv


@pytest.mark.parametrize("num_rows,num_cols,width", [(14, 11, 5), (11, 14, 16), (9, 9, 1)])
def test_coo_spmm_matches_jax(num_rows, num_cols, width):
    """Forward, dh and dv on unsorted edges with duplicates, sink edges and
    out-of-range cols on in-range rows; the sinks' dv is exactly 0."""
    ei, rng = _edges(num_rows * 7 + width, num_rows, num_cols)
    v = rng.normal(size=ei.shape[1]).astype(np.float32)
    h = rng.normal(size=(num_cols, width)).astype(np.float32)
    ct = rng.normal(size=(num_rows, width)).astype(np.float32)
    want = _jax_spmm(ei, v, h, num_rows, ct)
    got = _port_spmm(ei, v, h, num_rows, ct)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, **TOL)
    sinks = ei[0] >= num_rows
    assert np.all(got[2].numpy()[sinks] == 0.0)


def test_coo_spmm_bf16_h_promotes_like_jax():
    """A bfloat16 ``h`` with float32 values gives a float32 result formed in
    float32, as JAX promotes the product; the forward equals JAX's bit for
    bit up to summation order."""
    ei, rng = _edges(3)
    v = rng.normal(size=ei.shape[1]).astype(np.float32)
    h = rng.normal(size=(11, 8)).astype(np.float32)
    h_bf16 = np.asarray(jnp.asarray(h).astype(jnp.bfloat16))
    out, vjp = jax.vjp(lambda v_, h_: jspmm.spmm(jnp.asarray(ei), v_, h_, 14),
                       jnp.asarray(v), jnp.asarray(h_bf16))
    assert out.dtype == jnp.float32
    ct = rng.normal(size=(14, 8)).astype(np.float32)
    want_dv, want_dh = vjp(jnp.asarray(ct))
    got, dh, dv = _port_spmm(ei, v, h_bf16.astype(np.float32), 14, ct, torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    # the port's dh reaches h in h's dtype (PyTorch casts a gradient to its input's)
    assert dh.dtype == torch.bfloat16 and dv.dtype == torch.float32
    np.testing.assert_allclose(dh.float().numpy(), np.asarray(want_dh).astype(np.float32),
                               **BF16_TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(want_dv), **TOL)


def test_coo_spmm_backward_gives_jax_gradient_dtypes():
    """The backward forms dh and dv in the types JAX's VJP gives them
    (float32 for a bfloat16 h with float32 values) before autograd casts dh."""
    ei, rng = _edges(4)
    v = torch.tensor(rng.normal(size=ei.shape[1]).astype(np.float32))
    h = torch.tensor(rng.normal(size=(11, 4)).astype(np.float32)).to(torch.bfloat16)
    seen = {}

    class Spy(tspmm._Spmm):
        @staticmethod
        def backward(ctx, dy):
            grads = tspmm._Spmm.backward(ctx, dy)
            seen["dv"], seen["dh"] = grads[1].dtype, grads[2].dtype
            return grads

    out = Spy.apply(torch.as_tensor(ei), v.requires_grad_(), h.requires_grad_(), 14, False)
    out.sum().backward()
    assert seen == {"dv": torch.float32, "dh": torch.float32}


def test_coo_spmm_bf16_values_and_h():
    ei, rng = _edges(5)
    v = rng.normal(size=ei.shape[1]).astype(np.float32)
    h = rng.normal(size=(11, 6)).astype(np.float32)
    want = np.asarray(jspmm.spmm(jnp.asarray(ei), jnp.asarray(v).astype(jnp.bfloat16),
                                 jnp.asarray(h).astype(jnp.bfloat16), 14).astype(jnp.float32))
    got = tspmm.spmm(torch.as_tensor(ei), torch.tensor(v).to(torch.bfloat16),
                     torch.tensor(h).to(torch.bfloat16), 14)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


def test_coo_spmm_empty_matrix():
    """No edges: a zero result and zero gradients of the right shapes."""
    ei = np.zeros((2, 0), np.int64)
    h = np.ones((4, 3), np.float32)
    out, dh, dv = _port_spmm(ei, np.zeros(0, np.float32), h, 5, np.ones((5, 3), np.float32))
    want = _jax_spmm(ei, np.zeros(0, np.float32), h, 5, np.ones((5, 3), np.float32))
    assert out.shape == (5, 3) and dh.shape == (4, 3) and dv.shape == (0,)
    for g, w in zip((out, dh, dv), want):
        np.testing.assert_array_equal(g.detach().numpy(), w)


def test_coo_sddmm_matches_jax():
    ei, rng = _edges(6)
    a = rng.normal(size=(14, 7)).astype(np.float32)
    b = rng.normal(size=(11, 7)).astype(np.float32)
    want = np.asarray(jspmm.sddmm(jnp.asarray(ei), jnp.asarray(a), jnp.asarray(b)))
    got = tspmm.sddmm(torch.as_tensor(ei), torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_csr_view_keeps_edge_order_and_drops_out_of_range_rows():
    keys = torch.tensor([2, 0, 2, 5, -1, 0, 2])
    nbrs = torch.tensor([1, 9, 0, 1, 1, 3, 4])
    view = build_csr_view(keys, nbrs, 3, 5)
    assert view.row_ptr.tolist() == [0, 2, 2, 5]
    assert view.eid[:5].tolist() == [1, 5, 0, 2, 6]       # stable: edge order per row
    assert view.nbr[:5].tolist() == [4, 3, 1, 0, 4]       # 9 clamped to 4
    assert view.row_ptr.dtype == view.nbr.dtype == view.eid.dtype == torch.int32
    assert build_csr_view(keys, nbrs, 3, 0).row_ptr.tolist() == [0, 0, 0, 0]


def test_sparse_matrix_products_match_jax():
    """``@`` (matmul with and without feature chunks) and ``rmatmul_dense``."""
    ei, rng = _edges(8, 12, 12, sinks=2, bad_cols=0)
    v = rng.normal(size=ei.shape[1]).astype(np.float32)
    ta = TSparse(torch.as_tensor(ei), torch.as_tensor(v), (12, 12))
    ja = JSparse(jnp.asarray(ei), jnp.asarray(v), (12, 12))
    h = rng.normal(size=(12, 5)).astype(np.float32)
    np.testing.assert_allclose((ta @ torch.as_tensor(h)).numpy(),
                               np.asarray(ja @ jnp.asarray(h)), **TOL)
    hr = rng.normal(size=(3, 12)).astype(np.float32)
    th = torch.tensor(hr, requires_grad=True)
    got = ta.rmatmul_dense(th)
    want, vjp = jax.vjp(ja.rmatmul_dense, jnp.asarray(hr))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    ct = rng.normal(size=(3, 12)).astype(np.float32)
    (g,) = torch.autograd.grad(got, th, torch.as_tensor(ct))
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]), **TOL)


def _multihead_case(seed, n, e, heads, d):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, size=(2, e))
    ei[:, :3] = n  # padded edges, dropped by both layouts
    att = rng.random((e, heads)).astype(np.float32)
    v = rng.normal(size=(n, heads * d)).astype(np.float32)
    ct = rng.normal(size=(n, heads * d)).astype(np.float32)
    return ei, att, v, ct


@pytest.mark.parametrize("heads,d", [(1, 5), (2, 4), (4, 3), (8, 2)])
def test_spmm_multihead_matches_jax(heads, d):
    """Forward, d_att and dV against ``ell_spmm_multihead`` on
    ``EllAdj.from_coo``; padded edges get d_att = 0 on both sides."""
    n, e = 16, 70
    ei, att, v, ct = _multihead_case(heads * 10 + d, n, e, heads, d)
    ell = EllAdj.from_coo(ei, np.ones(e, np.float32), (n, n))
    want, vjp = jax.vjp(lambda a, vv: ell_spmm_multihead(ell, a, vv, d),
                        jnp.asarray(att), jnp.asarray(v))
    want_datt, want_dv = vjp(jnp.asarray(ct))
    layout = CsrGatLayout.build(ei, n, device="cpu")
    ta = torch.tensor(att, requires_grad=True)
    tv = torch.tensor(v, requires_grad=True)
    got = spmm_multihead(layout, ta, tv, d)
    d_att, dv = torch.autograd.grad(got, (ta, tv), torch.as_tensor(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(want_dv), **TOL)
    np.testing.assert_allclose(d_att.numpy(), np.asarray(want_datt), **TOL)
    assert np.all(d_att.numpy()[:3] == 0.0)


def test_spmm_multihead_bf16_values_match_jax():
    """bfloat16 values: the weights are cast to bfloat16 first, as the JAX
    function casts them; the port sums in float32."""
    n, e, heads, d = 12, 40, 2, 4
    ei, att, v, _ = _multihead_case(9, n, e, heads, d)
    ell = EllAdj.from_coo(ei, np.ones(e, np.float32), (n, n))
    want = ell_spmm_multihead(ell, jnp.asarray(att), jnp.asarray(v).astype(jnp.bfloat16), d)
    layout = CsrGatLayout.build(ei, n, device="cpu")
    got = spmm_multihead(layout, torch.as_tensor(att), torch.tensor(v).to(torch.bfloat16), d)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)


def test_spmm_heads_plain_handles_wide_heads_and_empty_rows():
    """A row without entries reads 0; heads wider than one pass of lanes."""
    view = build_csr_view(torch.tensor([0, 0, 2]), torch.tensor([1, 2, 0]), 4, 3)
    w = torch.tensor([[1.0, 2.0], [0.5, -1.0], [3.0, 0.0]])
    src = torch.arange(3 * 2 * 300, dtype=torch.float32).reshape(3, 600)
    out = spmm_heads_plain(view, w, src, 2)
    want = torch.zeros(4, 600)
    want[0, :300] = 1.0 * src[1, :300] + 0.5 * src[2, :300]
    want[0, 300:] = 2.0 * src[1, 300:] - 1.0 * src[2, 300:]
    want[2, :300] = 3.0 * src[0, :300]
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_spmm_heads_wrappers_refuse_cpu_tensors():
    view = build_csr_view(torch.tensor([0, 1]), torch.tensor([1, 0]), 2, 2)
    w, h, out = torch.ones(2, 1), torch.ones(2, 4), torch.zeros(2, 1)
    before = (launch_spmm_heads.launches, launch_sddmm_heads.launches)
    with pytest.raises(ValueError, match="CUDA"):
        launch_spmm_heads(view, w, h, 1)
    with pytest.raises(ValueError, match="CUDA"):
        launch_sddmm_heads(view, h, h, 1, out)
    assert (launch_spmm_heads.launches, launch_sddmm_heads.launches) == before


def test_spmm_ops_raise_off_the_cpu():
    """On a device with no kernel (meta tensors stand in for one), the COO
    ops and the multi-head SpMM raise instead of running the plain versions."""
    ei = torch.tensor([[0, 1], [1, 0]], device="meta")
    h = torch.ones(2, 4, device="meta")
    with pytest.raises(NotImplementedError, match="kernel"):
        tspmm.spmm(ei, torch.ones(2, device="meta"), h, 2)
    with pytest.raises(NotImplementedError, match="kernel"):
        tspmm.sddmm(ei, h, h)
    layout = CsrGatLayout.build([[0, 1], [1, 0]], 2, device="cpu")
    with pytest.raises(NotImplementedError, match="kernel"):
        spmm_multihead(layout, torch.ones(2, 2, device="meta"), h, 2)
