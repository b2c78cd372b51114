"""The port's fused GAT attention (``ops/gat_attention.py``: ``CsrGatLayout``,
the plain versions of the three passes, the autograd function) against the
JAX package's ``gat_attention_bucketed`` and its custom VJP, on the CPU.

Tolerances, as the JAX package's own tests of that kernel use: forward
rtol = atol = 1e-4 and gradients 2e-3 in float32 (same formulas, summed in
another order; the backward recomputes the weights from lse); bfloat16
compute 2e-2 (the JAX kernel rounds products and sums to bfloat16, the port
sums in float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_geometric_tpu import _segment_core as jseg
from tf_geometric_tpu.ops import ell_attention_bucketed as jatt
from tf_geometric_tpu_torch.nn.conv.gat import _segment_attention
from tf_geometric_tpu_torch.ops.gat_attention import (CsrGatLayout, gat_attention_csr,
                                                      gat_backward_dst_plain,
                                                      gat_forward_plain)
from tf_geometric_tpu_torch.ops.spmm_heads import CHUNK

F32_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=2e-3, atol=2e-3)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# the destination pass's per-edge weights against the segment path's:
# float32 rounding of the same softmax (its 1e-16 and the segment path's 1e-8
# in the denominator agree to rounding)
W_TOL = dict(rtol=1e-5, atol=1e-6)
# (heads, head width): the halo GAT's two layers and the bench's 8-head GAT
SPLIT_SHAPES = [(8, 8), (1, 64), (8, 32)]


def _skewed_graph(rng, n, H, d, hub_deg=40, num_pad=3):
    """tests/test_ell_attention_bucketed.py's mix: one hub destination,
    empty rows (n-2, n-1), self-loops on a prefix; plus padding edges
    (row = col = n) at the end."""
    rows = np.concatenate([np.full(hub_deg, 2), rng.integers(3, n - 2, 60),
                           np.arange(min(5, n))])
    cols = np.concatenate([rng.integers(0, n, hub_deg + 60), np.arange(min(5, n))])
    order = np.argsort(rows, kind="stable")
    ei = np.stack([rows, cols])[:, order]
    ei = np.concatenate([ei, np.full((2, num_pad), n)], axis=1).astype(np.int32)
    Q, K, V, dy = (rng.normal(size=(n, H * d)).astype(np.float32) for _ in range(4))
    return ei, Q, K, V, dy


def _jax_grads(fn, Q, K, V, dy):
    """(out, dQ, dK, dV) of ``fn`` under one jit (faster to compile than
    the JAX kernel's unrolled slot loops run op by op)."""
    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out,) + vjp(g.astype(out.dtype))

    return [np.asarray(t, np.float32) for t in run(*map(jnp.asarray, (Q, K, V, dy)))]


def _port_grads(layout, Q, K, V, dy, H, **kwargs):
    q, k, v = (torch.tensor(a, requires_grad=True) for a in (Q, K, V))
    out = gat_attention_csr(layout, q, k, v, H, **kwargs)
    out.backward(torch.as_tensor(dy).to(out.dtype))
    return [t.detach().float().numpy() for t in (out, q.grad, k.grad, v.grad)]


def _assert_all(got, want, fwd_tol, grad_tol):
    for name, g, w, tol in zip(("out", "dQ", "dK", "dV"), got, want,
                               (fwd_tol, grad_tol, grad_tol, grad_tol)):
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


def _bucketed(jlayout, H, d, cd=None, mask=None):
    """``gat_attention_bucketed`` at compute dtype ``cd`` (None: the
    package's default); with an [E, H] edge-order mask, its fused VJP with
    the mask handed to its slot and tail lanes (sentinel lanes read 0), its
    output in float32."""
    if mask is None:
        return lambda q, k, v: jatt.gat_attention_bucketed(jlayout, q, k, v, H, compute_dtype=cd)
    padded = np.concatenate([mask, np.zeros((1, H), np.float32)])
    keep_slots = tuple(jnp.asarray(padded[np.asarray(g.slot_eid)]) for g in jlayout.fwd.groups)
    keep_tail = jnp.asarray(padded[np.asarray(jlayout.fwd.tail_eid)])

    def fn(q, k, v):
        if cd is not None:
            q, k, v = (t.astype(cd) for t in (q, k, v))
        return jatt._fused_vjp(jlayout, H, d, q, k, v, keep_slots, keep_tail,
                               jnp.ones((), jnp.float32),
                               jnp.zeros((0,), jnp.int32)).astype(jnp.float32)
    return fn


# (heads, head width) cases, each on the skewed graph with small caps (the
# hub overflows into the JAX layout's tail lanes): one small shape and the
# halo GAT's two layers and the bench's 8-head GAT (SPLIT_SHAPES), through
# the port's two backward passes (the destination pass hands its per-edge
# weights to the source pass's weighted gather)
@pytest.mark.parametrize("layout_mode,H,d,caps", [
    ("auto", 4, 8, None), ("bucketed", 4, 8, None), ("classic", 4, 8, None),
    ("classic", 2, 20, None)] + [("bucketed", H, d, [2, 8]) for H, d in SPLIT_SHAPES])
def test_attention_matches_jax_bucketed(rng, layout_mode, H, d, caps):
    n = 25
    ei, Q, K, V, dy = _skewed_graph(rng, n, H, d, hub_deg=40 if caps is None else 30)
    jlayout = jatt.build_gat_layout_bucketed(ei, n, caps=caps, layout=layout_mode)
    want = _jax_grads(_bucketed(jlayout, H, d), Q, K, V, dy)
    layout = CsrGatLayout.build(ei, n, device="cpu")
    got = _port_grads(layout, Q, K, V, dy, H)
    _assert_all(got, want, F32_TOL, GRAD_TOL)
    assert np.abs(got[0][-2:]).max() == 0.0  # empty rows aggregate to exactly zero
    assert all(np.isfinite(g).all() for g in got)


@pytest.mark.parametrize("H,d,with_keep", [(4, 8, False)] + [
    (H, d, keep) for H, d in SPLIT_SHAPES for keep in (False, True)])
def test_attention_bf16_compute_matches_jax(rng, H, d, with_keep):
    n = 25
    ei, Q, K, V, dy = _skewed_graph(rng, n, H, d, hub_deg=30)
    E = ei.shape[1]
    jlayout = jatt.build_gat_layout_bucketed(ei, n, caps=[2, 8], layout="bucketed")
    kwargs = dict(compute_dtype=torch.bfloat16)
    mask = None
    if with_keep:
        mask = (rng.random((E, H)) < 0.7).astype(np.float32) / 0.7
        kwargs.update(training=True, edge_drop_rate=0.3, keep_mask=torch.as_tensor(mask))
    want = _jax_grads(_bucketed(jlayout, H, d, jnp.bfloat16, mask), Q, K, V, dy)
    got = _port_grads(CsrGatLayout.build(ei, n, device="cpu"), Q, K, V, dy, H, **kwargs)
    _assert_all(got, want, BF16_TOL, BF16_TOL)


@pytest.mark.parametrize("H,d", [(2, 4)] + SPLIT_SHAPES)
def test_dropout_mask_matches_jax_fused_vjp(rng, H, d):
    """One [E, H] edge-order mask, handed to JAX's custom VJP through its
    slot and tail lanes (sentinel lanes read 0) and to the port as is."""
    n, rate = 21, 0.3
    ei, Q, K, V, dy = _skewed_graph(rng, n, H, d, hub_deg=30)
    E = ei.shape[1]
    mask = (rng.random((E, H)) < 1 - rate).astype(np.float32) / (1 - rate)
    # small caps so that the hub overflows into the JAX layout's tail lanes
    jlayout = jatt.build_gat_layout_bucketed(ei, n, caps=[2, 8], layout="bucketed")
    assert jlayout.fwd.tail_prow.shape[0] > 0
    want = _jax_grads(_bucketed(jlayout, H, d, mask=mask), Q, K, V, dy)
    layout = CsrGatLayout.build(ei, n, device="cpu")
    got = _port_grads(layout, Q, K, V, dy, H, edge_drop_rate=rate, training=True,
                      keep_mask=torch.as_tensor(mask))
    _assert_all(got, want, F32_TOL, GRAD_TOL)
    # a mask is drawn from a generator; without either, training raises
    q = torch.as_tensor(Q)
    drawn = gat_attention_csr(layout, q, q, q, H, edge_drop_rate=rate, training=True,
                              generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn).all()
    with pytest.raises(ValueError):
        gat_attention_csr(layout, q, q, q, H, edge_drop_rate=rate, training=True)
    with pytest.raises(ValueError, match="keep_mask"):
        gat_attention_csr(layout, q, q, q, H, edge_drop_rate=rate, training=True,
                          keep_mask=torch.ones(E - 1, H))


@pytest.mark.parametrize("H,d", [(8, 8), (1, 64)])
@pytest.mark.parametrize("with_keep", [False, True])
def test_forward_out_and_lse_on_short_rows_match_jax(rng, H, d, with_keep):
    """The forward on rows of 0, 1 and 2 edges (where the kernel's edge
    groups hold no edge, or one each) and a hub: ``out`` against
    ``gat_attention_bucketed`` (its fused VJP's forward under a mask),
    ``lse`` against a JAX segment log-sum-exp of the same scores (0 on a row
    without edges, as the kernel writes it)."""
    n = 25
    rows = np.concatenate([[1, 2, 2], np.full(30, 3), rng.integers(4, n - 2, 40)])
    cols = rng.integers(0, n, rows.shape[0])
    ei = np.stack([rows, cols])[:, rng.permutation(rows.shape[0])].astype(np.int32)
    E = ei.shape[1]
    Q, K, V = (rng.normal(size=(n, H * d)).astype(np.float32) for _ in range(3))
    mask = (rng.random((E, H)) < 0.7).astype(np.float32) / 0.7 if with_keep else None
    jlayout = jatt.build_gat_layout_bucketed(ei, n, caps=[2, 8], layout="bucketed")
    want = np.asarray(jax.jit(_bucketed(jlayout, H, d, mask=mask))(*map(jnp.asarray, (Q, K, V))))
    s = jnp.asarray((Q[rows] * K[cols]).reshape(-1, H, d).sum(-1) / np.sqrt(d))
    seg = jnp.asarray(rows)
    m = jax.ops.segment_max(s, seg, n)
    total = jax.ops.segment_sum(jnp.exp(s - m[seg]), seg, n)
    has = np.bincount(rows, minlength=n)[:, None] > 0
    want_lse = np.where(has, np.asarray(m + jnp.log(total + 1e-16)), 0.0)
    layout = CsrGatLayout.build(ei, n, device="cpu")
    keep = None if mask is None else torch.as_tensor(mask)
    out, lse = gat_forward_plain(layout.dst, *map(torch.as_tensor, (Q, K, V)), H, keep)
    np.testing.assert_allclose(out.numpy(), want, **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **F32_TOL)
    assert not out.numpy()[[0, n - 2, n - 1]].any() and not lse.numpy()[0].any()


@pytest.mark.parametrize("with_keep", [False, True])
def test_plain_backward_matches_autograd_of_segment_path(rng, with_keep):
    """The plain backward formulas (weights recomputed from lse, D = <dy,
    out>) against torch autograd of the segment path on the same edges."""
    n, H, d = 19, 2, 4
    ei, Q, K, V, dy = _skewed_graph(rng, n, H, d, hub_deg=25)
    E = ei.shape[1]
    keep = (torch.as_tensor(rng.random((E, H)) < 0.7).float() / 0.7) if with_keep else None
    layout = CsrGatLayout.build(ei, n, device="cpu")
    got = _port_grads(layout, Q, K, V, dy, H, training=with_keep,
                      edge_drop_rate=0.3 if with_keep else 0.0, keep_mask=keep)
    q, k, v = (torch.tensor(a, requires_grad=True) for a in (Q, K, V))
    eit = torch.as_tensor(ei).long()
    out = _segment_attention(q, k, v, eit[0], eit[1], n, H, keep).reshape(n, H * d)
    out.backward(torch.as_tensor(dy))
    want = [t.detach().numpy() for t in (out, q.grad, k.grad, v.grad)]
    _assert_all(got, want, F32_TOL, GRAD_TOL)


def test_layout_drops_padding_and_splits_hubs():
    ei = np.array([[0, 0, 0, 1, 3, 2], [1, 2, 0, 0, 3, 9]])  # (3, 3) and (2, 9) pad
    layout = CsrGatLayout.build(ei, 3, hub_degree=2, device="cpu")
    assert layout.num_edges == 6 and layout.num_nodes == 3
    np.testing.assert_array_equal(layout.dst.row_ptr.numpy(), [0, 3, 4, 4])
    np.testing.assert_array_equal(layout.dst.nbr.numpy(), [1, 2, 0, 0])
    np.testing.assert_array_equal(layout.dst.eid.numpy(), [0, 1, 2, 3])
    np.testing.assert_array_equal(layout.dst.hubs.numpy(), [0])
    np.testing.assert_array_equal(layout.src.row_ptr.numpy(), [0, 2, 3, 4])
    np.testing.assert_array_equal(layout.src.nbr.numpy(), [0, 1, 0, 0])
    np.testing.assert_array_equal(layout.src.eid.numpy(), [2, 3, 0, 1])
    assert layout.src.hubs.numel() == 0
    assert all(t.dtype == torch.int32 for t in layout.dst[:4] + layout.src[:4])


def test_contract_errors():
    layout = CsrGatLayout.build(np.array([[0, 1], [1, 0]]), 2, device="cpu")
    q = torch.ones(2, 8)
    with pytest.raises(NotImplementedError):
        gat_attention_csr(layout, q, q, torch.ones(2, 4), 2)
    with pytest.raises(ValueError):
        gat_attention_csr(layout, torch.ones(3, 8), torch.ones(3, 8), torch.ones(3, 8), 2)
    with pytest.raises(ValueError):
        gat_attention_csr(layout, q, q, q, 3)
    # the passes take their plain versions on CPU tensors only
    with pytest.raises(NotImplementedError, match="no GAT attention kernel"):
        gat_attention_csr(layout, q.to("meta"), q.to("meta"), q.to("meta"), 2)


@pytest.mark.parametrize("H,d", SPLIT_SHAPES)
@pytest.mark.parametrize("with_keep", [False, True])
def test_dst_pass_weights_match_jax_segment_vjp(rng, H, d, with_keep):
    """The destination pass's ``w`` [E, 2H] against an independent JAX
    computation: ``a·keep`` is the segment softmax of the scores times the
    mask, and ``ds`` is ``jax.vjp`` of scores → ``segment_softmax`` →
    weighted ``segment_sum``, divided by √d (the port's ds is the gradient of
    the unscaled dot product). Edges outside the layout (padding) get 0."""
    n = 25
    ei, Q, K, V, dy = _skewed_graph(rng, n, H, d, hub_deg=30)
    E = ei.shape[1]
    mask = ((rng.random((E, H)) < 0.7).astype(np.float32) / 0.7 if with_keep
            else np.ones((E, H), np.float32))
    ok = (ei[0] < n) & (ei[1] < n)
    rows, cols, keep = ei[0][ok], ei[1][ok], mask[ok]
    s = (Q[rows] * K[cols]).reshape(-1, H, d).sum(-1) / np.sqrt(d)

    def aggregate(scores):
        a = jseg.segment_softmax(scores, jnp.asarray(rows), n)
        msg = (a * keep)[:, :, None] * jnp.asarray(V[cols]).reshape(-1, H, d)
        return jseg.segment_sum(msg, jnp.asarray(rows), n)

    _, vjp = jax.vjp(aggregate, jnp.asarray(s))
    (ds,) = vjp(jnp.asarray(dy).reshape(n, H, d))
    a = np.asarray(jseg.segment_softmax(jnp.asarray(s), jnp.asarray(rows), n))
    layout = CsrGatLayout.build(ei, n, device="cpu")
    q, k, v, g = map(torch.as_tensor, (Q, K, V, dy))
    keep_t = torch.as_tensor(mask) if with_keep else None
    out, lse = gat_forward_plain(layout.dst, q, k, v, H, keep_t)
    _, _, w = gat_backward_dst_plain(layout.dst, q, k, v, out, lse, g, H, keep_t)
    w = w.numpy()
    assert w.shape == (E, 2 * H)
    np.testing.assert_allclose(w[ok, :H], a * keep, err_msg="a*keep", **W_TOL)
    np.testing.assert_allclose(w[ok, H:], np.asarray(ds) / np.sqrt(d), err_msg="ds", **W_TOL)
    assert not w[~ok].any()


def test_source_side_hubs_split_at_chunk():
    """The source side's hubs are its rows of more than ``CHUNK`` entries
    (the source pass's lane groups walk at most that many), whatever the
    destination side's ``hub_degree``."""
    n = 80
    src_hub = np.stack([np.arange(n), np.full(n, 7)])          # source 7: n entries
    src_short = np.stack([np.arange(CHUNK), np.full(CHUNK, 9)])  # source 9: 64
    layout = CsrGatLayout.build(np.concatenate([src_hub, src_short], 1), n, device="cpu")
    assert layout.src.hub_degree == CHUNK == 64 and layout.dst.hub_degree == 256
    np.testing.assert_array_equal(layout.src.hubs.numpy(), [7])
    assert layout.dst.hubs.numel() == 0
    assert layout.dst.num_edges == layout.src.num_edges == layout.num_edges == n + CHUNK
    small = CsrGatLayout.build(src_hub, n, hub_degree=10, device="cpu")
    assert small.src.hub_degree == CHUNK and small.dst.hub_degree == 10
    np.testing.assert_array_equal(small.src.hubs.numpy(), [7])
