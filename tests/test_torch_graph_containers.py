"""The port's graph containers and SparseMatrix helpers against the JAX
package on the CPU: ``Graph`` / ``BatchGraph`` ``to_directed``,
``sample_new_graph_by_node_index`` (a SparseMatrix ``x`` too),
``convert_data_to_numpy``, ``BatchGraph.from_graphs`` with sparse features,
``HeteroGraph`` and ``HeteroBatchGraph``, ``SparseMatrix.add_self_loop`` /
``to_scipy`` / ``from_scipy`` / ``sparse_shape``, the graph utils the
subgraphs and pools share (``compute_edge_mask_by_node_index``,
``reindex_sampled_edge_index``, ``convert_dense_adj_to_edge``,
``convert_dense_assign_to_edge``) and ``utils/tf_sparse_utils.py``; then the
executed reference's goldens of the data layer.

Tolerances: host-side outputs are compared bit for bit (same dtype, shape
and values); the goldens at test_reference_parity_data.py's own tolerances
(rtol 1e-5, atol 1e-6).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tf_geometric_tpu.data.graph import BatchGraph as JBatchGraph
from tf_geometric_tpu.data.graph import Graph as JGraph
from tf_geometric_tpu.data.graph import HeteroBatchGraph as JHeteroBatchGraph
from tf_geometric_tpu.data.graph import HeteroGraph as JHeteroGraph
from tf_geometric_tpu.sparse.matrix import SparseMatrix as JSparseMatrix
from tf_geometric_tpu.sparse.matrix import sparse_shape as jax_sparse_shape
from tf_geometric_tpu.utils import graph_utils as jgu
from tf_geometric_tpu.utils import tf_sparse_utils as jtsu
from tf_geometric_tpu_torch.data import BatchGraph, Graph, HeteroBatchGraph, HeteroGraph
from tf_geometric_tpu_torch.sparse import SparseMatrix, sparse_shape
from tf_geometric_tpu_torch.utils import graph_utils as tgu
from tf_geometric_tpu_torch.utils import tf_sparse_utils as ttsu

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "golden_reference")
GOLDEN_TOL = dict(rtol=1e-5, atol=1e-6)
MERGE_MODES = ("sum", "mean", "max", "min", "first")


def _golden(name):
    d = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))
    return ({k[3:]: d[k] for k in d.files if k.startswith("in_")},
            {k[4:]: d[k] for k in d.files if k.startswith("out_")})


def _same(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _graph(seed, n=12, e=40, f=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, f)).astype(np.float32),
            rng.integers(0, n, size=(2, e)).astype(np.int32),
            rng.uniform(0.5, 1.5, e).astype(np.float32),
            rng.integers(0, 3, n).astype(np.int32))


def _sparse_x(seed, n, f=5, nnz=30):
    rng = np.random.default_rng(seed)
    index = np.stack([rng.integers(0, n, nnz), rng.integers(0, f, nnz)]).astype(np.int32)
    value = rng.normal(size=nnz).astype(np.float32)
    return (JSparseMatrix(index, value, (n, f)),
            SparseMatrix(index, value, (n, f), device="cpu"))


def _same_sparse(got, want, what):
    assert tuple(got.shape) == tuple(want.shape), (what, got.shape, want.shape)
    _same(got.index.numpy(), np.asarray(want.index).astype(np.int64), what + " index")
    _same(got.value, np.asarray(want.value), what + " value")


def _batch(seed, count=4, sparse=False):
    rng = np.random.default_rng(seed)
    jg, tg = [], []
    for gid in range(count):
        n, e = int(rng.integers(4, 10)), int(rng.integers(3, 16))
        ei = rng.integers(0, n, size=(2, e)).astype(np.int32)
        ew = rng.uniform(0.5, 1.5, e).astype(np.float32)
        y = [int(rng.integers(0, 2))]
        if sparse:
            jx, tx = _sparse_x(seed * 10 + gid, n)
        else:
            jx = tx = rng.normal(size=(n, 3)).astype(np.float32)
        jg.append(JGraph(jx, ei, y, ew))
        tg.append(Graph(tx, ei, y, ew))
    return JBatchGraph.from_graphs(jg), BatchGraph.from_graphs(tg)


# ---------------------------------------------------------------------------
# Graph / BatchGraph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("merge_mode", MERGE_MODES)
@pytest.mark.parametrize("inplace", [True, False])
def test_graph_to_directed_matches_jax(merge_mode, inplace):
    x, ei, ew, _ = _graph(1)
    want = JGraph(x, ei, edge_weight=ew).to_directed(merge_mode, inplace=inplace)
    graph = Graph(x, ei, edge_weight=ew)
    got = graph.to_directed(merge_mode, inplace=inplace)
    assert (got is graph) == inplace
    _same(got.edge_index, want.edge_index, "edge_index")
    _same(got.edge_weight, want.edge_weight, "edge_weight")
    _same(got.x, want.x, "x")


@pytest.mark.parametrize("merge_mode", MERGE_MODES)
def test_batch_graph_to_directed_matches_jax(merge_mode):
    """The edge graph ids ride along, merged with "max"."""
    jb, tb = _batch(2)
    want = jb.to_directed(merge_mode, inplace=False)
    got = tb.to_directed(merge_mode, inplace=False)
    assert isinstance(got, BatchGraph) and got.graphs is tb.graphs
    for f in ("edge_index", "edge_weight", "edge_graph_index", "node_graph_index"):
        _same(getattr(got, f), getattr(want, f), f)


@pytest.mark.parametrize("sparse_x", [False, True])
def test_graph_sample_new_graph_by_node_index_matches_jax(sparse_x):
    x, ei, ew, y = _graph(3)
    keep = np.array([1, 3, 4, 7, 9, 11], np.int64)
    jx, tx = _sparse_x(4, x.shape[0]) if sparse_x else (x, x)
    want = JGraph(jx, ei, y, ew).sample_new_graph_by_node_index(keep)
    got = Graph(tx, ei, y, ew).sample_new_graph_by_node_index(torch.as_tensor(keep))
    if sparse_x:
        _same_sparse(got.x, want.x, "x")
    else:
        _same(got.x, want.x, "x")
    for f in ("edge_index", "edge_weight", "y"):
        _same(getattr(got, f), getattr(want, f), f)


def test_batch_graph_sample_new_graph_by_node_index_matches_jax():
    jb, tb = _batch(5)
    keep = np.array([0, 2, 3, 5, 8, 9, 13, 14, 20], np.int64)
    keep = keep[keep < tb.num_nodes]
    want = jb.sample_new_graph_by_node_index(keep)
    got = tb.sample_new_graph_by_node_index(keep)
    assert isinstance(got, BatchGraph)
    for f in ("x", "edge_index", "edge_weight", "y", "node_graph_index", "edge_graph_index"):
        _same(getattr(got, f), getattr(want, f), f)


def test_batch_graph_with_sparse_features_matches_jax():
    """``from_graphs`` stacks SparseMatrix features with ``sparse.concat``;
    ``to_graphs`` splits them back."""
    jb, tb = _batch(6, sparse=True)
    assert isinstance(tb.x, SparseMatrix)
    _same_sparse(tb.x, jb.x, "x")
    for f in ("edge_index", "edge_weight", "y", "node_graph_index", "edge_graph_index"):
        _same(getattr(tb, f), getattr(jb, f), f)
    for i, (g, h) in enumerate(zip(tb.to_graphs(), jb.to_graphs())):
        _same_sparse(g.x, h.x, f"graph {i} x")
        _same(g.edge_index, h.edge_index, f"graph {i} edge_index")


@pytest.mark.parametrize("inplace", [True, False])
def test_convert_data_to_numpy(inplace):
    x, ei, ew, y = _graph(7)
    graph = Graph(torch.as_tensor(x), torch.as_tensor(ei), torch.as_tensor(y),
                  torch.as_tensor(ew))
    graph.cache["k"] = 1
    got = graph.convert_data_to_numpy(inplace=inplace)
    assert (got is graph) == inplace and got.cache == {"k": 1}
    for f, want in (("x", x), ("edge_index", ei), ("edge_weight", ew), ("y", y)):
        _same(getattr(got, f), want, f)
    if not inplace:
        assert isinstance(graph.x, torch.Tensor)


# ---------------------------------------------------------------------------
# hetero containers
# ---------------------------------------------------------------------------

def _hetero(seed):
    rng = np.random.default_rng(seed)
    na, nb = int(rng.integers(3, 7)), int(rng.integers(3, 7))
    x = {"a": rng.normal(size=(na, 3)).astype(np.float32),
         "b": rng.normal(size=(nb, 2)).astype(np.float32)}
    ab = np.stack([rng.integers(0, na, 9), rng.integers(0, nb, 9)]).astype(np.int32)
    aa = rng.integers(0, na, size=(2, 5)).astype(np.int32)
    edges = {("a", "ab", "b"): ab, ("a", "aa", "a"): aa}
    weights = {("a", "ab", "b"): rng.uniform(0.5, 1.5, 9).astype(np.float32)}
    y = {"a": rng.integers(0, 2, na).astype(np.int32)}
    return x, edges, y, weights


@pytest.mark.parametrize("inplace", [True, False])
def test_hetero_add_reversed_edges_matches_jax(inplace):
    args = _hetero(8)
    want = JHeteroGraph(*args).add_reversed_edges(inplace=inplace)
    graph = HeteroGraph(*args)
    got = graph.add_reversed_edges(inplace=inplace)
    assert (got is graph) == inplace
    assert got.edge_types == want.edge_types
    for t in want.edge_types:
        _same(got.edge_index_dict[t], want.edge_index_dict[t], f"edge_index {t}")
        _same(got.edge_weight_dict[t], want.edge_weight_dict[t], f"edge_weight {t}")
    assert got.num_nodes_dict == want.num_nodes_dict
    if not inplace:
        assert len(graph.edge_types) == 2
    # a second call mirrors the mirrors too, as in JAX
    assert got.add_reversed_edges().edge_types == want.add_reversed_edges().edge_types


def test_hetero_batch_graph_from_graphs_matches_jax():
    """Per-type offsets; a graph lacking a node or edge type (the third
    lacks "b" and its edges) is skipped for that type."""
    parts = [_hetero(s) for s in (9, 10)]
    x, _, y, _ = _hetero(11)
    parts.append(({"a": x["a"]}, {("a", "aa", "a"): np.array([[0, 1], [1, 2]], np.int32)},
                  {"a": y["a"]}, None))
    want = JHeteroBatchGraph.from_graphs([JHeteroGraph(*p) for p in parts])
    got = HeteroBatchGraph.from_graphs([HeteroGraph(*p) for p in parts])
    assert got.num_graphs == want.num_graphs == 3
    assert got.node_types == want.node_types and got.edge_types == want.edge_types
    for t in want.node_types:
        _same(got.x_dict[t], want.x_dict[t], f"x {t}")
        _same(got.node_graph_index_dict[t], want.node_graph_index_dict[t], f"ngi {t}")
    for t in want.y_dict:
        _same(got.y_dict[t], want.y_dict[t], f"y {t}")
    for t in want.edge_types:
        for d in ("edge_index_dict", "edge_weight_dict", "edge_graph_index_dict"):
            _same(getattr(got, d)[t], getattr(want, d)[t], f"{d} {t}")
    got.graphs = None
    assert got.num_graphs == 3


# ---------------------------------------------------------------------------
# SparseMatrix helpers
# ---------------------------------------------------------------------------

def test_sparse_matrix_add_self_loop_matches_jax():
    rng = np.random.default_rng(12)
    index = rng.integers(0, 6, size=(2, 10)).astype(np.int32)
    value = rng.normal(size=10).astype(np.float32)
    want = JSparseMatrix(index, value, (6, 6)).add_self_loop(2.0)
    got = SparseMatrix(index, value, (6, 6), device="cpu").add_self_loop(2.0)
    _same_sparse(got, want, "add_self_loop")


def test_sparse_matrix_scipy_round_trip():
    """``to_scipy`` drops out-of-range (padded) entries, as JAX's does;
    ``from_scipy`` keeps scipy's COO order."""
    rng = np.random.default_rng(13)
    index = np.concatenate([rng.integers(0, 7, size=(2, 12)), [[7, 2], [1, 9]]],
                           axis=1).astype(np.int32)
    value = rng.normal(size=14).astype(np.float32)
    want = JSparseMatrix(index, value, (7, 9)).to_scipy()
    got = SparseMatrix(index, value, (7, 9), device="cpu").to_scipy()
    assert got.shape == want.shape == (7, 9)
    for f in ("row", "col", "data"):
        _same(getattr(got, f), getattr(want, f), f)
    mat = sp.random(8, 5, density=0.4, random_state=14, format="csr", dtype=np.float64)
    back = SparseMatrix.from_scipy(mat, device="cpu")
    _same_sparse(back, JSparseMatrix.from_scipy(mat), "from_scipy")
    np.testing.assert_array_equal(back.to_scipy().toarray(),
                                  mat.toarray().astype(np.float32))


def test_sparse_shape_matches_jax():
    x = SparseMatrix(np.zeros((2, 0), np.int32), None, (4, 6), device="cpu")
    assert sparse_shape(x) == jax_sparse_shape(JSparseMatrix(np.zeros((2, 0), np.int32), None,
                                                             (4, 6))) == (4, 6)
    dense = np.zeros((3, 5), np.float32)
    assert sparse_shape(torch.as_tensor(dense)) == jax_sparse_shape(jnp.asarray(dense)) == (3, 5)


# ---------------------------------------------------------------------------
# graph utils and tf_sparse_utils
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_nodes", [None, 12])
def test_compute_edge_mask_by_node_index_matches_jax(num_nodes):
    """Padded ends (id = num_nodes, negative) and an out-of-range node id
    select nothing, as JAX clips then masks."""
    _, ei, _, _ = _graph(15)
    ei = np.concatenate([ei, [[12, 3, -1], [3, 12, 4]]], axis=1).astype(np.int32)
    keep = np.array([0, 3, 4, 5, 8, 11], np.int32)
    want = np.asarray(jgu.compute_edge_mask_by_node_index(ei, keep, num_nodes=num_nodes))
    got = tgu.compute_edge_mask_by_node_index(torch.as_tensor(ei), keep, num_nodes=num_nodes)
    _same(got, want, "mask")
    # a node id past num_nodes writes the spare entry: the mask is unchanged
    got_oob = tgu.compute_edge_mask_by_node_index(ei, np.append(keep, 40), num_nodes=12)
    _same(got_oob, np.asarray(jgu.compute_edge_mask_by_node_index(ei, keep, num_nodes=12)),
          "mask with an out-of-range node id")


def test_reindex_and_dense_edge_conversions_match_jax():
    rng = np.random.default_rng(16)
    _, ei, _, _ = _graph(16)
    keep = np.array([2, 5, 7, 8], np.int64)
    _same(tgu.reindex_sampled_edge_index(ei, keep), jgu.reindex_sampled_edge_index(ei, keep),
          "reindex")
    dense = rng.normal(size=(6, 5)).astype(np.float32)
    dense[np.abs(dense) < 0.6] = 0.0
    for threshold in (0.0, 0.9):
        want = jgu.convert_dense_adj_to_edge(dense, threshold)
        got = tgu.convert_dense_adj_to_edge(torch.as_tensor(dense), threshold)
        _same(got[0], want[0], "dense adj index")
        _same(got[1], want[1], "dense adj weight")
    assign = rng.random((7, 3)).astype(np.float32)
    ngi = np.array([0, 0, 1, 1, 1, 2, 2], np.int32)
    for graph_index in (None, ngi):
        want = jgu.convert_dense_assign_to_edge(assign, graph_index)
        got = tgu.convert_dense_assign_to_edge(
            torch.as_tensor(assign), None if graph_index is None else torch.as_tensor(graph_index))
        _same(got[0], np.asarray(want[0]).astype(np.int64), "assign index")
        _same(got[1], np.asarray(want[1]), "assign weight")


@pytest.mark.parametrize("axis", [0, 1])
def test_sparse_gather_sub_matches_jax(axis):
    jx, tx = _sparse_x(17, 9, f=7, nnz=25)
    sub = np.array([6, 1, 4, 0], np.int64)
    for fn in ("sparse_gather_sub", "sparse_tensor_gather_sub"):
        want = getattr(jtsu, fn)(jx, sub, axis=axis)
        got = getattr(ttsu, fn)(tx, torch.as_tensor(sub), axis=axis)
        _same_sparse(got, want, f"{fn} axis {axis}")
    # the gathered values keep their gradient
    value = tx.value.clone().requires_grad_()
    ttsu.sparse_gather_sub(SparseMatrix(tx.index, value, tx.shape), sub, axis=axis).value.sum() \
        .backward()
    assert value.grad is not None and float(value.grad.sum()) > 0


@pytest.mark.parametrize("width,splits", [(12, None), (12, 1), (12, 3), (10, 3), (10, 4),
                                          (7, 2)])
def test_compute_num_or_size_splits_matches_jax(width, splits):
    want = jtsu.compute_num_or_size_splits(width, splits)
    assert ttsu.compute_num_or_size_splits(width, splits) == want


def test_compute_num_or_size_splits_rejects_what_jax_rejects():
    with pytest.raises(ValueError):
        jtsu.compute_num_or_size_splits(10, 6)
    with pytest.raises(ValueError):
        ttsu.compute_num_or_size_splits(10, 6)


# ---------------------------------------------------------------------------
# the executed reference's goldens
# ---------------------------------------------------------------------------

def _dense(ei, ew, n):
    d = np.zeros((n, n), np.float32)
    np.add.at(d, (np.asarray(ei)[0], np.asarray(ei)[1]), np.asarray(ew))
    return d


@pytest.mark.parametrize("merge_mode", ["sum", "mean", "max", "min"])
def test_to_directed_golden_reference(merge_mode):
    inp, out = _golden(f"data_to_directed_{merge_mode}")
    g = Graph(x=inp["x"], edge_index=inp["ei"], edge_weight=inp["ew"])
    g = g.to_directed(merge_mode=merge_mode, inplace=False)
    np.testing.assert_allclose(_dense(g.edge_index, g.edge_weight, 10), out["adj"],
                               **GOLDEN_TOL)


def test_subgraph_sample_golden_reference():
    inp, out = _golden("data_subgraph_sample")
    sub = Graph(x=inp["x"], edge_index=inp["ei"], edge_weight=inp["ew"]) \
        .sample_new_graph_by_node_index(inp["keep"])
    for key, got in (("x", sub.x), ("ei", sub.edge_index), ("ew", sub.edge_weight)):
        np.testing.assert_allclose(np.asarray(got), out[key], **GOLDEN_TOL, err_msg=key)


def test_hetero_reversed_edges_golden_reference():
    inp, out = _golden("data_hetero_reversed_edges")
    g = HeteroGraph(x_dict={"a": inp["xa"], "b": inp["xb"]},
                    edge_index_dict={("a", "ab", "b"): inp["ei"]})
    g = g.add_reversed_edges(inplace=False)
    rev_key = [k for k in g.edge_index_dict if "r." in str(k)][0]
    np.testing.assert_array_equal(g.edge_index_dict[rev_key], out["rev"])
    assert len(g.edge_index_dict) == int(out["nkeys"])
