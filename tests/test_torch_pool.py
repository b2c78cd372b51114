"""The port's hierarchical pooling against the JAX package on the CPU:
``cluster_pool``, ``diff_pool`` (and its batched coarsening),
``min_cut_pool`` (coarsening and losses), ``sag_pool`` and ``asap`` on both
their fixed-k and ``ratio`` paths, ``set2set``, the ``segment_max``
gradient on tied inputs, the ``DiffPool``, ``MinCutPool``, ``SAGPool``,
``ASAP`` and ``Set2Set`` layers with the flax layers' weights, the five
pooling demos' models (``demo/demo_{diff_pool,min_cut_pool,sag_pool_h,asap,
set2set}.py``) end to end, bench workloads 14-16, and the executed
reference's goldens.

Inputs are padded batches made from a seed with numpy: padded nodes carry
the graph id ``num_graphs`` and zero features, padded edges the sink row and
column ``N`` and weight 0, as ``data/padding.py`` pads them; the
``mode="drop"`` scatters of JAX (cluster_pool's dense S, ASAP's reverse
map) get out-of-range ids.

Tolerances: outputs of a pool function at float32 rtol = atol = 1e-5
(index arrays exact); a layer's or model's loss and step-1 gradients at
atol 1e-5 + rtol 1e-4 (sums in another order through two levels). The
goldens use test_reference_parity.py's own tolerances (rtol 1e-4, atol
1e-5; set2set 2e-4 / 1e-5; asap 5e-4 / 5e-5; min_cut_losses 1e-4 /
1e-5). Dropout is compared with the keep masks flax draws, taken from
its ``bernoulli`` call.
"""
import importlib
import os
import sys
import types

import flax.linen as fnn
import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_geometric_tpu import layers as jlayers
from tf_geometric_tpu.nn.conv.gcn import gcn as jax_gcn
from tf_geometric_tpu.nn.pool.asap import asap as jax_asap
from tf_geometric_tpu.nn.pool.cluster_pool import cluster_pool as jax_cluster_pool
from tf_geometric_tpu.nn.pool.common_pool import max_pool as jax_max_pool
from tf_geometric_tpu.nn.pool.diff_pool import diff_pool as jax_diff_pool
from tf_geometric_tpu.nn.pool.diff_pool import diff_pool_coarsen as jax_diff_pool_coarsen
from tf_geometric_tpu.nn.pool.min_cut_pool import min_cut_pool as jax_min_cut_pool
from tf_geometric_tpu.nn.pool.min_cut_pool import \
    min_cut_pool_coarsen as jax_min_cut_pool_coarsen
from tf_geometric_tpu.nn.pool.min_cut_pool import \
    min_cut_pool_compute_losses as jax_min_cut_losses
from tf_geometric_tpu.nn.pool.sag_pool import sag_pool as jax_sag_pool
from tf_geometric_tpu.nn.pool.set2set import set2set as jax_set2set
from tf_geometric_tpu.sparse.matrix import SparseMatrix as JSparseMatrix
from tf_geometric_tpu_torch import bench, layers
from tf_geometric_tpu_torch import nn as tnn
from tf_geometric_tpu_torch.convert import (lstm_cell_state_dict_from_keras,
                                            pool_model_state_dict_from_flax)
from tf_geometric_tpu_torch.ops import spmm as port_spmm
from tf_geometric_tpu_torch.sparse import SparseMatrix

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "demo"))

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "golden_reference")
GOLDEN_TOL = dict(rtol=1e-4, atol=1e-5)
ASAP_NAMES = ("attention_gcn_kernel", "attention_gcn_bias", "attention_query_kernel",
              "attention_query_bias", "attention_score_kernel", "attention_score_bias",
              "le_conv_self_kernel", "le_conv_self_bias", "le_conv_aggr_self_kernel",
              "le_conv_aggr_self_bias", "le_conv_aggr_neighbor_kernel",
              "le_conv_aggr_neighbor_bias")


def _golden(name):
    d = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))
    return ({k[3:]: d[k] for k in d.files if k.startswith("in_")},
            {k[4:]: d[k] for k in d.files if k.startswith("out_")})


def _edges_to_dense(edge_index, edge_weight, n):
    dense = np.zeros((n, n), np.float64)
    ei = np.asarray(edge_index)
    np.add.at(dense, (ei[0], ei[1]), np.asarray(edge_weight, np.float64))
    return dense.astype(np.float32)


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(got, want, what, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer) or want.dtype == bool:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64), err_msg=what)
    else:
        np.testing.assert_allclose(got, want, **tol, err_msg=what)


def _padded_batch(seed, sizes=(7, 10, 9, 12), f=6, edges_per_node=2, pad_nodes=5, pad_edges=6):
    """A padded batch: (x, edge_index, edge_weight, node_graph_index, G)."""
    rng = np.random.default_rng(seed)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    eis = [rng.integers(0, s, size=(2, edges_per_node * s)) + offsets[g]
           for g, s in enumerate(sizes)]
    n_real, g = int(offsets[-1]), len(sizes)
    n = n_real + pad_nodes
    ei = np.concatenate(eis + [np.full((2, pad_edges), n)], axis=1).astype(np.int32)
    ew = rng.uniform(0.5, 1.5, ei.shape[1]).astype(np.float32)
    ew[-pad_edges:] = 0.0
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[n_real:] = 0.0
    ngi = np.concatenate([np.full(s, i) for i, s in enumerate(sizes)]
                         + [np.full(pad_nodes, g)]).astype(np.int32)
    return x, ei, ew, ngi, g


def _cotangents(outs, seed):
    rng = np.random.default_rng(seed)
    return [None if not np.issubdtype(_np(o).dtype, np.floating)
            else rng.normal(size=_np(o).shape).astype(np.float32) for o in outs]


def _dot(outs, cots, lib):
    total = 0.0
    for o, c in zip(outs, cots):
        if c is not None:
            total = total + lib.sum(o * (jnp.asarray(c) if lib is jnp else torch.as_tensor(c)))
    return total


def _t(a, grad=False):
    t = torch.as_tensor(np.asarray(a))
    return t.float().requires_grad_() if grad else t


def _compare_vjp(jax_fn, port_fn, inputs, seed, what, tol=TOL, grad_tol=GRAD_TOL):
    """Outputs of ``jax_fn(*inputs)`` and ``port_fn(*tensors)``, then the
    gradients of ``Σ out · cot`` (float outputs, random cotangents) with
    respect to every input."""
    def as_tuple(out):
        return out if isinstance(out, tuple) else (out,)

    want = as_tuple(jax_fn(*[jnp.asarray(a) for a in inputs]))
    ts = [_t(a, grad=True) for a in inputs]
    got = as_tuple(port_fn(*ts))
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"{what} output {i}", tol)
    cots = _cotangents(want, seed)
    want_grads = jax.grad(lambda *a: _dot(as_tuple(jax_fn(*a)), cots, jnp),
                          argnums=tuple(range(len(inputs))))(*[jnp.asarray(a) for a in inputs])
    _dot(got, cots, torch).backward()
    for i, (t, w) in enumerate(zip(ts, want_grads)):
        # an input the outputs do not use has no gradient here, zeros in JAX
        _close(torch.zeros_like(t) if t.grad is None else t.grad, w, f"{what} grad {i}",
               grad_tol)


def _jgcn_fn(w, b=None, act=None):
    def fn(inputs, training=None, cache=None):
        x, ei, ew = inputs
        n = x.shape[0]
        return jax_gcn(x, JSparseMatrix(jnp.asarray(ei), None if ew is None else jnp.asarray(ew),
                                        (n, n)), w, b, activation=act)
    return fn


def _tgcn_fn(w, b=None, act=None):
    def fn(inputs, cache=None):
        x, ei, ew = inputs
        n = x.shape[0]
        return tnn.gcn(x, SparseMatrix(ei, ew, (n, n), device="cpu"), w, b, activation=act)
    return fn


# ---------------------------------------------------------------------------
# segment_max ties, cluster_pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data", [[1.0, 1.0, 0.0, 2.0], [0.0, 0.0, 0.0, 2.0],
                                  [-1.0, -1.0, -3.0, 2.0], [3.0, 3.0, 3.0, 3.0]])
def test_max_pool_gradient_splits_ties_as_jax(data):
    """JAX splits a max's cotangent evenly among tied members
    (``jax.grad(segment_max([1, 1, 0, 2], [0, 0, 0, 1]).sum())`` is ``[0.5,
    0.5, 0, 1]``), relu zeros included; graph 2 is empty."""
    ngi = np.array([0, 0, 0, 1], np.int32)
    want = jax.grad(lambda v: jax_max_pool(v, jnp.asarray(ngi), num_graphs=3).sum())(
        jnp.asarray(data))
    x = torch.tensor(data, requires_grad=True)
    tnn.max_pool(x, torch.as_tensor(ngi), num_graphs=3).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))


def test_max_pool_gradient_with_tied_relu_features_matches_jax():
    """Cluster features after a relu: whole columns of zeros tie."""
    x, _, _, ngi, g = _padded_batch(20)
    h = np.maximum(x, 0.0)
    h[:4, 2] = 0.7
    _compare_vjp(lambda v: jax_max_pool(v, jnp.asarray(ngi), num_graphs=g),
                 lambda v: tnn.max_pool(v, torch.as_tensor(ngi), num_graphs=g), [h], 21,
                 "max_pool ties")


def _assignment(seed, n, c, extra=True):
    """Node → cluster edges, with out-of-range nodes and clusters (JAX's
    ``mode="drop"``) when ``extra``."""
    rng = np.random.default_rng(seed)
    aei = np.stack([np.arange(n), rng.integers(0, c, n)])
    if extra:
        aei = np.concatenate([aei, [[n, -1, 2, 3], [0, 1, c, -2]]], axis=1)
    return aei.astype(np.int32), rng.random(aei.shape[1]).astype(np.float32)


@pytest.mark.parametrize("dense", [True, False])
def test_cluster_pool_matches_jax(dense):
    x, ei, ew, _, _ = _padded_batch(22)
    n, c = x.shape[0], 4
    aei, aew = _assignment(23, n, c)
    want = jax_cluster_pool(jnp.asarray(x), jnp.asarray(ei), jnp.asarray(ew), jnp.asarray(aei),
                            jnp.asarray(aew), c, num_nodes=n, dense_output_edges=dense)
    got = tnn.cluster_pool(torch.as_tensor(x), torch.as_tensor(ei), torch.as_tensor(ew),
                           torch.as_tensor(aei), torch.as_tensor(aew), c, num_nodes=n,
                           dense_output_edges=dense)
    _close(got[0], want[0], "pooled x")
    if dense:
        _close(got[1], want[1], "pooled edge index")
        _compare_vjp(
            lambda x_, ew_, aew_: jax_cluster_pool(x_, jnp.asarray(ei), ew_, jnp.asarray(aei),
                                                   aew_, c, num_nodes=n,
                                                   dense_output_edges=True)[::2],
            lambda x_, ew_, aew_: tnn.cluster_pool(x_, torch.as_tensor(ei), ew_,
                                                   torch.as_tensor(aei), aew_, c, num_nodes=n,
                                                   dense_output_edges=True)[::2],
            [x, ew, aew], 24, "cluster_pool")
    else:
        assert isinstance(got[1], np.ndarray)
        _close(got[1], want[1], "pooled edge index")
    _close(got[2], want[2], "pooled edge weight")


# ---------------------------------------------------------------------------
# DiffPool and MinCutPool
# ---------------------------------------------------------------------------

def _softmax_assign(seed, n, c):
    logits = np.random.default_rng(seed).normal(size=(n, c)).astype(np.float32)
    return np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)


def test_diff_pool_coarsen_matches_jax():
    """Padded nodes land on cluster ids ≥ G·C and padded edges on graph G:
    both drop out."""
    x, ei, ew, ngi, g = _padded_batch(25)
    assign = _softmax_assign(26, x.shape[0], 3).astype(np.float32)
    _compare_vjp(
        lambda h, w, s: jax_diff_pool_coarsen(h, jnp.asarray(ei), w, jnp.asarray(ngi), s,
                                              num_graphs=g),
        lambda h, w, s: tnn.diff_pool_coarsen(h, torch.as_tensor(ei), w, torch.as_tensor(ngi), s,
                                              num_graphs=g),
        [x, ew, assign], 27, "diff_pool_coarsen")


def test_min_cut_coarsen_and_losses_match_jax():
    x, ei, ew, ngi, g = _padded_batch(28)
    assign = _softmax_assign(29, x.shape[0], 4).astype(np.float32)
    _compare_vjp(
        lambda h, w, s: jax_min_cut_pool_coarsen(h, jnp.asarray(ei), w, jnp.asarray(ngi), s,
                                                 num_graphs=g),
        lambda h, w, s: tnn.min_cut_pool_coarsen(h, torch.as_tensor(ei), w,
                                                 torch.as_tensor(ngi), s, num_graphs=g),
        [x, ew, assign], 30, "min_cut_pool_coarsen")
    _compare_vjp(
        lambda w, s: jax_min_cut_losses(jnp.asarray(ei), w, jnp.asarray(ngi), s, num_graphs=g),
        lambda w, s: tnn.min_cut_pool_compute_losses(torch.as_tensor(ei), w,
                                                     torch.as_tensor(ngi), s, num_graphs=g),
        [ew, assign], 31, "min_cut_pool_compute_losses")


def _gnn_weights(seed, f, units, clusters):
    rng = np.random.default_rng(seed)
    return [rng.normal(scale=0.4, size=s).astype(np.float32)
            for s in ((f, units), (units,), (f, clusters), (clusters,), (units,))]


@pytest.mark.parametrize("with_bias", [True, False])
def test_diff_pool_matches_jax(with_bias):
    """Both GNNs are GCNs; the pooled edge weights, a function of S, carry
    the gradient of the assign GCN."""
    x, ei, ew, ngi, g = _padded_batch(32)
    ws = _gnn_weights(33, x.shape[1], 5, 3)

    def run(lib, gcn_fn, mod_fn, x_, wf, bf, wa, ba, bias):
        return mod_fn(x_, lib(ei), lib(ew), lib(ngi), gcn_fn(wf, bf, act=jax.nn.relu if
                                                            lib is jnp.asarray else torch.relu),
                      gcn_fn(wa, ba), 3, bias=bias if with_bias else None, num_graphs=g)

    _compare_vjp(lambda *a: run(jnp.asarray, _jgcn_fn, jax_diff_pool, *a),
                 lambda *a: run(torch.as_tensor, _tgcn_fn, tnn.diff_pool, *a),
                 [x] + ws, 34, "diff_pool")


@pytest.mark.parametrize("gnn_use_normed_edge", [True, False])
def test_min_cut_pool_matches_jax(gnn_use_normed_edge):
    x, ei, ew, ngi, g = _padded_batch(35)
    ws = _gnn_weights(36, x.shape[1], 5, 4)

    def run(lib, gcn_fn, mod_fn, x_, wf, bf, wa, ba, bias):
        act = jax.nn.relu if lib is jnp.asarray else torch.relu
        outs, (cut, orth) = mod_fn(x_, lib(ei), lib(ew), lib(ngi), gcn_fn(wf, bf, act=act),
                                   gcn_fn(wa, ba), 4, bias=bias, activation=act,
                                   gnn_use_normed_edge=gnn_use_normed_edge, return_losses=True,
                                   num_graphs=g)
        return tuple(outs) + (cut, orth)

    _compare_vjp(lambda *a: run(jnp.asarray, _jgcn_fn, jax_min_cut_pool, *a),
                 lambda *a: run(torch.as_tensor, _tgcn_fn, tnn.min_cut_pool, *a),
                 [x] + ws, 37, "min_cut_pool")
    # the three return forms
    t = [torch.as_tensor(a) for a in (x, ei, ew, ngi)] + [
        _tgcn_fn(torch.as_tensor(ws[0])), _tgcn_fn(torch.as_tensor(ws[2])), 4]
    plain = tnn.min_cut_pool(*t, num_graphs=g)
    outs, loss_func = tnn.min_cut_pool(*t, num_graphs=g, return_loss_func=True)
    outs2, losses = tnn.min_cut_pool(*t, num_graphs=g, return_losses=True)
    for a, b, c in zip(plain, outs, outs2):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert all(torch.equal(a, b) for a, b in zip(loss_func(), losses))
    with pytest.raises(ValueError):
        tnn.min_cut_pool(*t, return_loss_func=True, return_losses=True)


# ---------------------------------------------------------------------------
# SAGPool, ASAP, Set2Set
# ---------------------------------------------------------------------------

def test_sag_pool_fixed_k_matches_jax():
    """k = 8 is more than the smallest graph holds: invalid slots."""
    x, ei, ew, ngi, g = _padded_batch(38)
    w = np.random.default_rng(39).normal(size=(x.shape[1], 1)).astype(np.float32)

    def run(lib, gcn_fn, mod_fn, tanh, x_, w_):
        return mod_fn(x_, lib(ei), lib(ew), lib(ngi), gcn_fn(w_), k=8, score_activation=tanh,
                      num_graphs=g)

    _compare_vjp(lambda *a: run(jnp.asarray, _jgcn_fn, jax_sag_pool, jnp.tanh, *a),
                 lambda *a: run(torch.as_tensor, _tgcn_fn, tnn.sag_pool, torch.tanh, *a),
                 [x, w], 40, "sag_pool k")


def test_sag_pool_ratio_matches_jax():
    """The host-side path (outputs only: JAX selects on the host, outside
    its autodiff)."""
    x, ei, ew, ngi, _ = _padded_batch(41, pad_nodes=0, pad_edges=0)
    w = np.random.default_rng(42).normal(size=(x.shape[1], 1)).astype(np.float32)
    want = jax_sag_pool(jnp.asarray(x), ei, jnp.asarray(ew), ngi,
                        lambda a, training=None: a[0] @ jnp.asarray(w), ratio=0.5,
                        score_activation=jnp.tanh)
    got = tnn.sag_pool(torch.as_tensor(x), ei, torch.as_tensor(ew), ngi,
                       lambda a: a[0] @ torch.as_tensor(w), ratio=0.5,
                       score_activation=torch.tanh)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, f"sag_pool ratio output {i}")


def _asap_weights(seed, f, u):
    rng = np.random.default_rng(seed)
    shapes = {"f": f, "u": u, "2u": 2 * u, 1: 1}
    from tf_geometric_tpu_torch.layers.pool.pool_layers import _ASAP_PARAMS
    return [(rng.normal(scale=0.5, size=tuple(shapes[d] for d in shape))).astype(np.float32)
            for _, shape in _ASAP_PARAMS]


@pytest.mark.parametrize("k,sizes", [(3, (7, 10, 9, 12)), (8, (2, 10, 5, 12))])
def test_asap_fixed_k_matches_jax(k, sizes):
    """Fixed mode; with k = 8 two graphs hold fewer nodes than k, so their
    invalid slots take the reverse map's spare entry (JAX's ``mode="drop"``
    scatter at ``num_nodes + 1``). Padded edges and masked self-loops carry
    the row ``num_nodes``."""
    x, ei, ew, ngi, g = _padded_batch(43, sizes=sizes)
    ei[:, :3] = ei[0, :3]  # three self-loops, masked in fixed mode
    weights = _asap_weights(44, x.shape[1], 5)

    def run(lib, fn, act, x_, *w):
        return fn(x_, lib(ei), lib(ew), lib(ngi), *w, k=k, num_graphs=g,
                  le_conv_activation=act)

    _compare_vjp(lambda *a: run(jnp.asarray, jax_asap, jax.nn.sigmoid, *a),
                 lambda *a: run(torch.as_tensor, tnn.asap, torch.sigmoid, *a),
                 [x] + weights, 45, f"asap k={k}")


def test_asap_dropout_with_jax_mask_matches_jax():
    """Attention dropout: the port takes the keep mask JAX draws from its key."""
    x, ei, ew, ngi, g = _padded_batch(46)
    weights = _asap_weights(47, x.shape[1], 5)
    key = jax.random.PRNGKey(3)
    n_sl = ei.shape[1] + x.shape[0]
    keep = np.array(jax.random.bernoulli(key, 0.7, (n_sl, 1)))
    want = jax_asap(jnp.asarray(x), jnp.asarray(ei), jnp.asarray(ew), jnp.asarray(ngi),
                          *[jnp.asarray(w) for w in weights], k=3, num_graphs=g,
                          drop_rate=0.3, training=True, dropout_key=key)
    got = tnn.asap(torch.as_tensor(x), torch.as_tensor(ei), torch.as_tensor(ew),
                   torch.as_tensor(ngi), *[torch.as_tensor(w) for w in weights], k=3,
                   num_graphs=g, drop_rate=0.3, training=True, keep_mask=torch.as_tensor(keep))
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, f"asap dropout output {i}")
    with pytest.raises(ValueError):
        tnn.asap(torch.as_tensor(x), ei, ew, ngi, *[torch.as_tensor(w) for w in weights], k=3,
                 num_graphs=g, drop_rate=0.3, training=True)


@pytest.mark.parametrize("k,ratio", [(None, 0.5), (3, None)])
def test_asap_host_paths_match_jax(k, ratio):
    """``ratio``, and ``k`` without ``num_graphs``: selection on the host,
    self-loops removed (outputs only)."""
    x, ei, ew, ngi, _ = _padded_batch(48, pad_nodes=0, pad_edges=0)
    ei[:, :3] = ei[0, :3]
    weights = _asap_weights(49, x.shape[1], 5)
    want = jax_asap(jnp.asarray(x), ei, ew, ngi, *[jnp.asarray(w) for w in weights],
                          k=k, ratio=ratio)
    got = tnn.asap(torch.as_tensor(x), ei, ew, ngi, *[torch.as_tensor(w) for w in weights],
                   k=k, ratio=ratio)
    assert isinstance(got[1], np.ndarray)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, f"asap host output {i}")


def _keras_lstm_step(w, u, b, units):
    """One Keras-gate-order (i, f, c, o) LSTM step of a [1, in] input."""
    def step(x_t, state, lib):
        h, c = state
        z = x_t @ w + h @ u + b
        sig = jax.nn.sigmoid if lib is jnp else torch.sigmoid
        tanh = jnp.tanh if lib is jnp else torch.tanh
        i, f = sig(z[:, :units]), sig(z[:, units:2 * units])
        g, o = tanh(z[:, 2 * units:3 * units]), sig(z[:, 3 * units:])
        c = f * c + i * g
        return o * tanh(c), c
    return step


def test_set2set_matches_jax():
    """The LSTM is a callable (here a batched Keras-order cell, the same on
    both sides); padded nodes take no part."""
    x, _, _, ngi, g = _padded_batch(50)
    units = x.shape[1]
    rng = np.random.default_rng(51)
    w = rng.normal(scale=0.3, size=(2 * units, 4 * units)).astype(np.float32)
    u = rng.normal(scale=0.3, size=(units, 4 * units)).astype(np.float32)
    b = rng.normal(scale=0.1, size=4 * units).astype(np.float32)

    def lstm_for(lib, w_, u_, b_):
        step = _keras_lstm_step(w_, u_, b_, units)

        def lstm(h, state):
            if state is None:
                zeros = (jnp.zeros if lib is jnp else torch.zeros)((h.shape[0], units))
                state = (zeros, zeros)
            h_new, c_new = step(h, state, lib)
            return h_new, (h_new, c_new)
        return lstm

    _compare_vjp(lambda x_, w_, u_, b_: jax_set2set(x_, jnp.asarray(ngi),
                                                    lstm_for(jnp, w_, u_, b_), 3, num_graphs=g),
                 lambda x_, w_, u_, b_: tnn.set2set(x_, torch.as_tensor(ngi),
                                                    lstm_for(torch, w_, u_, b_), 3,
                                                    num_graphs=g),
                 [x, w, u, b], 52, "set2set")


# ---------------------------------------------------------------------------
# layers with the flax layers' weights
# ---------------------------------------------------------------------------

def _torch_params(module, flax_params):
    """Port layer parameters from a flax param dict of the same names."""
    for name, p in module.named_parameters():
        p.data = torch.tensor(np.asarray(flax_params[name], np.float32)).reshape(p.shape)
    return dict(module.named_parameters())


def _grads_close(params, flax_grads, what):
    for name, p in params.items():
        _close(p.grad, flax_grads[name], f"{what} grad {name}", GRAD_TOL)


@pytest.mark.parametrize("kind", ["diff", "min_cut"])
def test_diff_and_min_cut_layers_match_flax(kind):
    """The layers own their bias; GNNs injected as callables. MinCutPool
    returns its losses under ``return_losses``, where flax sows them."""
    x, ei, ew, ngi, g = _padded_batch(53)
    rng = np.random.default_rng(54)
    wf = rng.normal(scale=0.4, size=(x.shape[1], 5)).astype(np.float32)
    wa = rng.normal(scale=0.4, size=(x.shape[1], 3)).astype(np.float32)
    bias0 = rng.normal(size=5).astype(np.float32)
    jcls = jlayers.DiffPool if kind == "diff" else jlayers.MinCutPool
    flax_layer = jcls(feature_gnn=_jgcn_fn(jnp.asarray(wf), act=jax.nn.relu),
                      assign_gnn=_jgcn_fn(jnp.asarray(wa)), units=5, num_clusters=3,
                      activation=jax.nn.relu, num_graphs=g)
    args = [jnp.asarray(a) for a in (x, ei, ew, ngi)]
    params = {"bias": jnp.asarray(bias0)}
    cot = _cotangents([np.zeros((3 * g, 5), np.float32)], 55)[0]

    def jax_loss(p):
        if kind == "diff":
            out = flax_layer.apply({"params": p}, args)
            return jnp.sum(out[0] * cot), out
        out, state = flax_layer.apply({"params": p}, args, mutable=["losses"])
        cut, orth = state["losses"]["min_cut_losses"]
        return jnp.sum(out[0] * cot) + cut + 2 * orth, out

    (want_loss, want_out), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    tcls = layers.DiffPool if kind == "diff" else layers.MinCutPool
    layer = tcls(_tgcn_fn(torch.as_tensor(wf), act=torch.relu), _tgcn_fn(torch.as_tensor(wa)),
                 units=5, num_clusters=3, activation=torch.relu, num_graphs=g, device="cpu")
    tparams = _torch_params(layer, params)
    targs = [torch.as_tensor(a) for a in (x, ei, ew, ngi)]
    if kind == "diff":
        out = layer(targs)
        loss = torch.sum(out[0] * torch.as_tensor(cot))
    else:
        out, (cut, orth) = layer(targs, return_losses=True)
        loss = torch.sum(out[0] * torch.as_tensor(cot)) + cut + 2 * orth
    loss.backward()
    _close(loss, want_loss, f"{kind} loss", GRAD_TOL)
    for i, (a, b) in enumerate(zip(out, want_out)):
        _close(a, b, f"{kind} output {i}")
    _grads_close(tparams, want_grads, kind)
    with pytest.raises(ValueError):
        tcls(None, None, units=None, device="cpu")


def test_sag_pool_layer_matches_flax():
    x, ei, ew, ngi, g = _padded_batch(56)
    w = np.random.default_rng(57).normal(size=(x.shape[1], 1)).astype(np.float32)
    want = jlayers.SAGPool(score_gnn=_jgcn_fn(jnp.asarray(w)), k=4, score_activation=jnp.tanh,
                           num_graphs=g)([jnp.asarray(a) for a in (x, ei, ew, ngi)])
    got = layers.SAGPool(_tgcn_fn(torch.as_tensor(w)), k=4, score_activation=torch.tanh,
                         num_graphs=g)([torch.as_tensor(a) for a in (x, ei, ew, ngi)])
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, f"SAGPool output {i}")


def test_asap_layer_matches_flax():
    """The layer owns the 12 tensors under the flax names."""
    x, ei, ew, ngi, g = _padded_batch(58)
    flax_layer = jlayers.ASAP(units=5, k=3, num_graphs=g)
    args = [jnp.asarray(a) for a in (x, ei, ew, ngi)]
    params = flax_layer.init(jax.random.PRNGKey(0), args)["params"]
    cot = _cotangents([np.zeros((3 * g, x.shape[1]), np.float32)], 59)[0]
    want_out, vjp = jax.vjp(lambda p: flax_layer.apply({"params": p}, args)[0], params)
    want_grads = vjp(jnp.asarray(cot))[0]
    layer = layers.ASAP(x.shape[1], 5, k=3, num_graphs=g, device="cpu")
    assert sorted(n for n, _ in layer.named_parameters()) == sorted(params) == sorted(ASAP_NAMES)
    tparams = _torch_params(layer, params)
    out = layer([torch.as_tensor(a) for a in (x, ei, ew, ngi)])
    torch.sum(out[0] * torch.as_tensor(cot)).backward()
    _close(out[0], want_out, "ASAP output")
    _grads_close(tparams, want_grads, "ASAP")


def test_set2set_layer_matches_flax():
    """flax's OptimizedLSTMCell carries (c, h) from zeros; the port's
    ``torch.nn.LSTMCell`` (h, c), its weights mapped by
    ``pool_model_state_dict_from_flax``."""
    x, _, _, ngi, g = _padded_batch(60)
    flax_layer = jlayers.Set2Set(num_iterations=3, num_graphs=g)
    args = [jnp.asarray(x), jnp.asarray(ngi)]
    variables = flax_layer.init(jax.random.PRNGKey(1), args)
    cot = _cotangents([np.zeros((g, 2 * x.shape[1]), np.float32)], 61)[0]
    want_out, vjp = jax.vjp(lambda p: flax_layer.apply({"params": p}, args), variables["params"])
    want_grads = pool_model_state_dict_from_flax({"params": {"s": vjp(jnp.asarray(cot))[0]}})
    layer = layers.Set2Set(x.shape[1], num_iterations=3, num_graphs=g, device="cpu")
    state = pool_model_state_dict_from_flax({"params": {"s": variables["params"]}})
    layer.load_state_dict({k[2:]: v for k, v in state.items()})
    out = layer([torch.as_tensor(x), torch.as_tensor(ngi)])
    torch.sum(out * torch.as_tensor(cot)).backward()
    _close(out, want_out, "Set2Set output")
    for name, p in layer.named_parameters():
        if name != "cell.bias_ih":  # flax's input kernels have no bias
            _close(p.grad, want_grads["s." + name], f"Set2Set grad {name}", GRAD_TOL)


# ---------------------------------------------------------------------------
# the pooling demos' models and bench workloads 14-16
# ---------------------------------------------------------------------------

DEMOS = {"diff_pool": ("demo_diff_pool", "DiffPoolModel", False),
         "min_cut": ("demo_min_cut_pool", "MinCutPoolModel", True),
         "sag_pool": ("demo_sag_pool_h", "SAGPoolHModel", False),
         "asap": ("demo_asap", "ASAPModel", False),
         "set2set": ("demo_set2set", "Set2SetModel", False)}


class _RecordingBernoulli(types.SimpleNamespace):
    """flax's ``stochastic.random`` with ``bernoulli`` recording its masks."""

    def __init__(self):
        super().__init__(masks=[])

    def bernoulli(self, key, p, shape):
        mask = jax.random.bernoulli(key, p, shape)
        self.masks.append(np.array(mask))
        return mask


@pytest.fixture(scope="module")
def small_problem():
    return bench.build_graph_problem(batch=16, device="cpu")


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_demo_model_step_matches_jax(name, small_problem, monkeypatch):
    """One training step of each pooling demo's model on 16 padded graphs:
    the loss (cross-entropy, plus MinCutPool's cut and orth losses) and the
    gradient of every parameter, flax's weights carried over by
    ``pool_model_state_dict_from_flax``, dropout 0.4 with flax's own keep
    mask. DiffPool's second level takes the SpMM's value gradient (its two
    ``dv`` SDDMMs counted): the first level's assign GCN is reached through
    it as well as through Sᵀh."""
    pr = small_problem
    module, cls, sows = DEMOS[name]
    demo = importlib.import_module(module)
    model = getattr(demo, cls)(num_classes=pr.num_classes, num_graphs=pr.num_graphs)
    args = [jnp.asarray(t.numpy()) for t in (pr.x, pr.edge_index, pr.edge_weight,
                                             pr.node_graph_index)]
    variables = model.init({"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(6)},
                           *args)
    y = jnp.asarray(pr.y.numpy())
    recorder = _RecordingBernoulli()
    monkeypatch.setattr(flax_stochastic, "random", recorder)

    def jax_loss(params):
        rngs = {"dropout": jax.random.PRNGKey(7)}
        if sows:
            logits, state = model.apply({"params": params}, *args, training=True, rngs=rngs,
                                        mutable=["losses"])
            aux = demo._aux_loss(state)
        else:
            logits, aux = model.apply({"params": params}, *args, training=True, rngs=rngs), 0.0
        ce = -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None], 1))
        return ce + aux

    want, want_grads = jax.value_and_grad(jax_loss)(variables["params"])
    assert len(recorder.masks) == 1
    params = {k: v.requires_grad_() for k, v in
              pool_model_state_dict_from_flax(variables).items()}
    assert set(params) == set(dict(pr.models[name].named_parameters())), name
    calls = _count_x6(monkeypatch)
    loss = bench.pool_loss(params, pr, name, keep_mask=torch.as_tensor(recorder.masks[0]))
    loss.backward()
    assert calls["sddmm"] == (2 if name == "diff_pool" else 0), calls
    _close(loss, want, f"{name} loss", GRAD_TOL)
    want_t = pool_model_state_dict_from_flax({"params": want_grads})
    for k in sorted(params):
        if k.endswith("cell.bias_ih"):  # flax's input kernels have no bias
            continue
        _close(params[k].grad, want_t[k], f"{name} grad {k}", GRAD_TOL)


def _count_x6(monkeypatch):
    calls = {"spmm": 0, "sddmm": 0}
    spmm_heads, sddmm_heads = port_spmm.spmm_heads, port_spmm.sddmm_heads

    def count_spmm(*a, **k):
        calls["spmm"] += 1
        return spmm_heads(*a, **k)

    def count_sddmm(*a, **k):
        calls["sddmm"] += 1
        return sddmm_heads(*a, **k)

    monkeypatch.setattr(port_spmm, "spmm_heads", count_spmm)
    monkeypatch.setattr(port_spmm, "sddmm_heads", count_sddmm)
    return calls


@pytest.mark.parametrize("name", sorted(bench.POOL_WORKLOADS))
def test_pool_workloads_train_and_count_their_x6_calls(name, small_problem, monkeypatch):
    """A few Adam steps lower each workload's loss; a step makes the X6
    calls ``pool_x6_calls`` lists (forward and ``dh`` per GCN, ``dv`` in
    DiffPool's second level only), each over as many entries as listed."""
    pr, model = small_problem, bench.POOL_WORKLOADS[name]
    wl = bench.WORKLOADS[name]
    step = bench.make_step(lambda p: wl.loss(p, pr), wl.init(pr), wl.lr)
    losses = [float(step()) for _ in range(10)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], (name, losses)
    listed = bench.pool_x6_calls(pr, model)
    calls = _count_x6(monkeypatch)
    entries = []
    build = port_spmm.build_csr_view
    monkeypatch.setattr(port_spmm, "build_csr_view",
                        lambda keys, *a: entries.append(int(keys.shape[0])) or build(keys, *a))
    wl.loss(wl.init(pr), pr).backward()
    assert calls == {"spmm": 2 * len(listed), "sddmm": sum(c[4] for c in listed)}, calls
    assert sorted(entries) == sorted(e for c in listed for e in (c[0], c[0])), entries
    assert wl.bound_bytes(pr) == bench.pool_step_bytes(pr, model) > 0


def test_pool_workload_dropout_follows_the_generator(small_problem):
    """The dropout masks come from the problem's generator, reseeded with
    the weights: two runs from the initial weights give the same losses."""
    pr = small_problem
    wl = bench.WORKLOADS["sag_pool_graphs_fwd_bwd"]
    runs = []
    for _ in range(2):
        step = bench.make_step(lambda p: wl.loss(p, pr), wl.init(pr), wl.lr)
        runs.append([float(step()) for _ in range(3)])
    assert runs[0] == runs[1]
    pr.models["sag_pool"].train()
    with pytest.raises(ValueError):
        bench.pool_loss(wl.init(pr), pr._replace(generator=None), "sag_pool")


def test_pool_models_ask_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises((AssertionError, RuntimeError)):
        bench.build_graph_problem(batch=4)
    with pytest.raises((AssertionError, RuntimeError)):
        layers.ASAP(4, 4)


# ---------------------------------------------------------------------------
# the executed reference's goldens
# ---------------------------------------------------------------------------

def test_cluster_pool_golden_reference():
    inp, out = _golden("cluster_pool")
    px, pei, pew = tnn.cluster_pool(*[torch.as_tensor(inp[k]) for k in ("x", "ei", "ew", "aei",
                                                                      "aew")], 4, num_nodes=20)
    np.testing.assert_allclose(px.numpy(), out["px"], **GOLDEN_TOL)
    np.testing.assert_allclose(_edges_to_dense(pei, _np(pew), 4), out["adj"], **GOLDEN_TOL)


@pytest.mark.parametrize("name", ["diff_pool_coarsen", "min_cut_coarsen"])
def test_coarsen_golden_reference(name):
    inp, out = _golden(name)
    fn = tnn.diff_pool_coarsen if name == "diff_pool_coarsen" else tnn.min_cut_pool_coarsen
    px, pei, pew, pngi = fn(*[torch.as_tensor(inp[k]) for k in ("x", "ei", "ew", "ngi",
                                                               "assign")])
    np.testing.assert_allclose(px.numpy(), out["px"], **GOLDEN_TOL)
    np.testing.assert_array_equal(pngi.numpy(), out["pngi"])
    np.testing.assert_allclose(_edges_to_dense(pei, _np(pew), out["adj"].shape[0]), out["adj"],
                               **GOLDEN_TOL)


def test_min_cut_losses_golden_reference():
    inp, out = _golden("min_cut_losses")
    cut, orth = tnn.min_cut_pool_compute_losses(*[torch.as_tensor(inp[k]) for k in
                                                  ("ei", "ew", "ngi", "assign")])
    np.testing.assert_allclose(float(cut), out["cut"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(orth), out["orth"], rtol=1e-4, atol=1e-5)


def test_sag_pool_ratio_golden_reference():
    inp, out = _golden("sag_pool_ratio")
    w = torch.as_tensor(inp["w"])
    px, pei, pew, pngi = tnn.sag_pool(torch.as_tensor(inp["x"]), inp["ei"],
                                      torch.as_tensor(inp["ew"]), inp["ngi"],
                                      lambda a: a[0] @ w, ratio=0.5,
                                      score_activation=torch.tanh)
    np.testing.assert_allclose(px.numpy(), out["px"], **GOLDEN_TOL)
    np.testing.assert_array_equal(pngi, out["pngi"])
    np.testing.assert_allclose(_edges_to_dense(pei, _np(pew), px.shape[0]), out["adj"],
                               **GOLDEN_TOL)


def test_asap_golden_reference():
    inp, out = _golden("asap")
    names = ("att_gcn_w", "att_gcn_b", "att_q_w", "att_q_b", "att_s_w", "att_s_b", "le_s_w",
             "le_s_b", "le_as_w", "le_as_b", "le_an_w", "le_an_b")
    px, pei, pew, pngi = tnn.asap(torch.as_tensor(inp["x"]), inp["ei"], inp["ew"], inp["ngi"],
                                  *[torch.as_tensor(inp[k]) for k in names], ratio=0.5,
                                  drop_rate=0.0, training=False)
    np.testing.assert_allclose(px.numpy(), out["px"], rtol=5e-4, atol=5e-5)
    np.testing.assert_array_equal(pngi, out["pngi"])
    np.testing.assert_allclose(_edges_to_dense(pei, _np(pew), px.shape[0]), out["adj"],
                               rtol=5e-4, atol=5e-5)


def test_set2set_golden_reference():
    """The reference runs its Keras LSTM over the graphs as time steps of a
    batch of one, the state carried across iterations; the port's
    ``torch.nn.LSTMCell`` with the Keras weights
    (``lstm_cell_state_dict_from_keras``) is stepped the same way."""
    inp, out = _golden("set2set")
    units = inp["x"].shape[1]
    cell = torch.nn.LSTMCell(2 * units, units)
    cell.load_state_dict(lstm_cell_state_dict_from_keras(inp["W"], inp["U"], inp["b"]))

    def lstm(h, state):
        if state is None:
            state = (torch.zeros(1, units), torch.zeros(1, units))
        outs = []
        for t in range(h.shape[0]):
            state = cell(h[t:t + 1], state)
            outs.append(state[0])
        return torch.cat(outs), state

    with torch.no_grad():
        got = tnn.set2set(torch.as_tensor(inp["x"]), torch.as_tensor(inp["ngi"]), lstm, 3)
    np.testing.assert_allclose(got.numpy(), out["out"], rtol=2e-4, atol=1e-5)
