"""Four faults of the port found against the JAX package, each held against
it on the CPU:

1. ``sort_pool`` and ``lstm_graph_sage`` take ``training`` in JAX's
   positional slot (before ``num_graphs`` / ``max_neighbors``), so a
   positional call means the same on both sides;
2. ``Graph.convert_data_to_tensor(inplace=...)``: a converted copy leaves the
   graph as it was, and a field that is already a tensor keeps its autograd
   graph;
3. ``SparseMatrix.T``, ``m * s``, ``s * m``, ``m / s`` and ``-m``;
4. the top-level names ``BatchGraph``, ``HeteroGraph``, ``HeteroBatchGraph``
   and ``sparse.shape``.

Tolerances: float32 outputs rtol 1e-5, atol 1e-6; host arrays bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_geometric_tpu as jtfg
import tf_geometric_tpu_torch as ttfg
from tf_geometric_tpu import nn as jnn
from tf_geometric_tpu.data.graph import Graph as JGraph
from tf_geometric_tpu.sparse.matrix import SparseMatrix as JSparseMatrix
from tf_geometric_tpu_torch import nn as tnn
from tf_geometric_tpu_torch.data import Graph
from tf_geometric_tpu_torch.sparse import SparseMatrix

TOL = dict(rtol=1e-5, atol=1e-6)


def _sort_pool_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 3)).astype(np.float32)
    ei = np.array([[0, 1, 3, 4], [1, 2, 4, 5]], np.int32)
    ngi = np.array([0, 0, 0, 1, 1, 1], np.int32)
    return x, ei, ngi


@pytest.mark.parametrize("training", [True, False])
def test_sort_pool_positional_training_slot(training):
    """``sort_pool(x, ei, None, ngi, 2, None, -1, training)``: both graphs
    keep their top 2 nodes ([4, 3]), as JAX returns; before the fix the port
    read ``training`` as ``num_graphs``."""
    x, ei, ngi = _sort_pool_inputs()
    want = jnn.sort_pool(jnp.asarray(x), jnp.asarray(ei), None, jnp.asarray(ngi), 2, None, -1,
                         training)
    got = tnn.sort_pool(torch.as_tensor(x), torch.as_tensor(ei), None, torch.as_tensor(ngi), 2,
                        None, -1, training)
    assert tuple(got[0].shape) == (4, 3) == tuple(want[0].shape)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_array_equal(np.asarray(got[3]), np.asarray(want[3]))


def _lstm_inputs():
    x = np.random.default_rng(1).normal(size=(4, 3)).astype(np.float32)
    ei = np.array([[0, 0, 1, 2, 3], [1, 2, 2, 3, 0]], np.int32)
    ws = np.random.default_rng(2).normal(size=(3, 3)).astype(np.float32)
    wn = np.random.default_rng(3).normal(size=(3, 3)).astype(np.float32)
    return x, ei, ws, wn


@pytest.mark.parametrize("training", [True, False])
def test_lstm_graph_sage_positional_training_slot(training):
    """A positional ``training`` (after ``normalize``) leaves the output as
    the call without it; before the fix it became ``max_neighbors`` (True cut
    node 0 to one neighbour, max-abs 0.116; False made K = 0 and raised)."""
    x, ei, ws, wn = _lstm_inputs()
    torch.manual_seed(0)
    lstm = torch.nn.LSTM(3, 3, batch_first=True)
    args = (torch.as_tensor(x), torch.as_tensor(ei), lambda seq: lstm(seq)[0],
            torch.as_tensor(ws), torch.as_tensor(wn))
    with torch.no_grad():
        want = tnn.lstm_graph_sage(*args)
        got = tnn.lstm_graph_sage(*args, None, None, True, False, training)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_lstm_graph_sage_positional_training_matches_jax():
    """The same positional call on both packages, with one sequence
    function ``[N, K, F] -> [N, K, H]`` (a cumulative mix)."""
    x, ei, ws, wn = _lstm_inputs()
    scale = np.array([0.5, -1.0, 2.0], np.float32)

    def seq_fn(seq):
        return jnp.cumsum(seq * scale, axis=1) if isinstance(seq, jax.Array) else \
            torch.cumsum(seq * torch.as_tensor(scale), dim=1)

    want = jnn.lstm_graph_sage(jnp.asarray(x), jnp.asarray(ei), seq_fn, jnp.asarray(ws),
                               jnp.asarray(wn), None, None, True, False, True)
    got = tnn.lstm_graph_sage(torch.as_tensor(x), torch.as_tensor(ei), seq_fn,
                              torch.as_tensor(ws), torch.as_tensor(wn), None, None, True, False,
                              True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_convert_data_to_tensor_copy_leaves_graph():
    """``inplace=False`` returns a converted copy and leaves the graph's
    numpy fields as they were (JAX ``data/graph.py:117-130``)."""
    kwargs = dict(x=np.ones((3, 2), np.float32), edge_index=[[0, 1], [1, 2]])
    jg, g = JGraph(**kwargs), Graph(**kwargs)
    jcopy = jg.convert_data_to_tensor(inplace=False)
    copy = g.convert_data_to_tensor(inplace=False, device="cpu")
    assert copy is not g and jcopy is not jg
    for f in ("x", "edge_index", "edge_weight"):
        assert isinstance(getattr(g, f), np.ndarray) and isinstance(getattr(jg, f), np.ndarray)
        assert isinstance(getattr(copy, f), torch.Tensor)
        np.testing.assert_array_equal(getattr(copy, f).numpy(), np.asarray(getattr(jcopy, f)))
    assert copy.x.dtype == torch.float32 and copy.edge_index.dtype == torch.int32
    same = g.convert_data_to_tensor(device="cpu")
    assert same is g and isinstance(g.x, torch.Tensor)


def test_convert_data_to_tensor_keeps_autograd():
    """A field that is already a tensor is moved, not round-tripped through
    numpy: a tensor that requires grad stays in its graph."""
    w = torch.ones(3, 2, requires_grad=True)
    g = Graph(x=w * 2.0, edge_index=[[0, 1], [1, 2]])
    g.convert_data_to_tensor(device="cpu")
    assert g.x.requires_grad
    g.x.sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(), np.full((3, 2), 2.0, np.float32))


OPERATORS = {
    "T": lambda m: m.T,
    "mul": lambda m: m * 3.0,
    "rmul": lambda m: 3.0 * m,
    "truediv": lambda m: m / 4.0,
    "neg": lambda m: -m,
}


@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_sparse_matrix_operators_match_jax(op):
    """Each operator on the 2 x 2 matrix with values [1, 2] gives JAX's
    index, values and shape."""
    index = np.array([[0, 1], [1, 0]], np.int32)
    value = np.array([1.0, 2.0], np.float32)
    want = OPERATORS[op](JSparseMatrix(index, value, (2, 3)))
    got = OPERATORS[op](SparseMatrix(index, value, (2, 3), device="cpu"))
    assert isinstance(got, SparseMatrix)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(want.index))
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value), **TOL)
    np.testing.assert_allclose(got.to_dense().numpy(), np.asarray(want.to_dense()), **TOL)


@pytest.mark.parametrize("name", ["BatchGraph", "HeteroGraph", "HeteroBatchGraph"])
def test_top_level_containers(name):
    """The containers JAX exports at the top level (``__init__.py:17``)."""
    assert hasattr(jtfg, name) and hasattr(ttfg, name)
    assert getattr(ttfg, name) is getattr(ttfg.data, name)


def test_top_level_batch_graph_call():
    graphs = [ttfg.Graph(x=np.ones((2, 1), np.float32), edge_index=[[0], [1]])] * 2
    jgraphs = [jtfg.Graph(x=np.ones((2, 1), np.float32), edge_index=[[0], [1]])] * 2
    got, want = ttfg.BatchGraph.from_graphs(graphs), jtfg.BatchGraph.from_graphs(jgraphs)
    np.testing.assert_array_equal(np.asarray(got.edge_index), np.asarray(want.edge_index))
    np.testing.assert_array_equal(np.asarray(got.node_graph_index),
                                  np.asarray(want.node_graph_index))


def test_sparse_shape_alias():
    """``tfs.shape`` is ``sparse_shape`` on both packages, on a SparseMatrix
    and on a dense array."""
    assert ttfg.sparse.shape is ttfg.sparse.sparse_shape
    m = SparseMatrix(np.array([[0], [1]], np.int32), None, (2, 5), device="cpu")
    jm = JSparseMatrix(np.array([[0], [1]], np.int32), None, (2, 5))
    assert tuple(ttfg.sparse.shape(m)) == tuple(jtfg.sparse.shape(jm)) == (2, 5)
    assert tuple(ttfg.sparse.shape(torch.zeros(3, 4))) == (3, 4)
