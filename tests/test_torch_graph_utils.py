"""The host side of the port's ``utils/graph_utils.py`` (negative sampling,
the link-prediction split, ``convert_x_to_3d``, the scipy and networkx
views, the neighbour samplers) against the JAX package's on the CPU, bit
for bit: the same seed gives the same arrays, and a ``Generator`` passed in
is left in the state JAX leaves it in. The samplers are held against JAX in
both native branches (the port's and JAX's library on, and both off)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tf_geometric_tpu.native as jnative
import tf_geometric_tpu.utils.graph_utils as J
import tf_geometric_tpu_torch.native as tnative
import tf_geometric_tpu_torch.utils.graph_utils as T

N = 300


def _graph(seed=0, n=N, e=2000):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]).astype(np.int64)


def _assert_same(got, want):
    if want is None:
        assert got is None
        return
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype,
                                                                   got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _same_next_draws(g1, g2):
    assert g1.integers(0, 10 ** 9, 8).tolist() == g2.integers(0, 10 ** 9, 8).tolist()
    assert g1.random() == g2.random()


def test_block_draws_read_the_scalar_stream():
    """The premise of the blocked rejection loops: ``integers(0, n, size=m)``
    gives the values of m calls ``integers(0, n)``, and blocks split
    anywhere join into one stream."""
    g1, g2 = np.random.default_rng(1), np.random.default_rng(1)
    scalar = [int(g1.integers(0, 169_343)) for _ in range(1000)]
    blocks = np.concatenate([g2.integers(0, 169_343, size=m) for m in (1, 7, 500, 492)])
    assert scalar == blocks.tolist()
    _same_next_draws(g1, g2)


@pytest.mark.parametrize("num_samples", [0, 1, 40, 2000])
@pytest.mark.parametrize("mode,replace", [("undirected", True), ("undirected", False),
                                          ("directed", True), ("directed", False),
                                          ("other", False)])
def test_negative_sampling_matches_jax(num_samples, mode, replace):
    ei = _graph()
    want = J.negative_sampling(num_samples, N, ei, replace=replace, mode=mode, rng=7)
    _assert_same(T.negative_sampling(num_samples, N, ei, replace=replace, mode=mode, rng=7), want)
    g1, g2 = np.random.default_rng(5), np.random.default_rng(5)
    want = J.negative_sampling(num_samples, N, ei, replace=replace, mode=mode, rng=g1)
    _assert_same(T.negative_sampling(num_samples, N, ei, replace=replace, mode=mode, rng=g2),
                 want)
    _same_next_draws(g1, g2)


@pytest.mark.parametrize("case", ["no_edges", "tries_run_out", "torch_edges"])
def test_negative_sampling_edge_cases_match_jax(case):
    """No graph; a 4-node graph whose free pairs run out before 10 distinct
    samples (the ``max_tries`` cap ends the loop); edges as a tensor."""
    if case == "no_edges":
        args = (50, 20, None)
    elif case == "tries_run_out":
        full = np.array([[i, j] for i in range(4) for j in range(4)]).T
        args = (10, 4, full[:, :10])
    else:
        args = (100, N, _graph(3))
    g1, g2 = np.random.default_rng(11), np.random.default_rng(11)
    want = J.negative_sampling(*args, replace=False, rng=g1)
    port_args = args if case != "torch_edges" else (*args[:2], torch.as_tensor(args[2]))
    _assert_same(T.negative_sampling(*port_args, replace=False, rng=g2), want)
    _same_next_draws(g1, g2)


@pytest.mark.parametrize("with_edges", [True, False])
def test_negative_sampling_with_start_node_matches_jax(with_edges):
    ei = _graph(1) if with_edges else None
    start = np.random.default_rng(2).integers(0, N, 700)
    want = J.negative_sampling_with_start_node(start, N, ei, rng=3)
    _assert_same(T.negative_sampling_with_start_node(start, N, ei, rng=3), want)
    g1, g2 = np.random.default_rng(4), np.random.default_rng(4)
    want = J.negative_sampling_with_start_node(start, N, ei, rng=g1)
    _assert_same(T.negative_sampling_with_start_node(start, N, ei, rng=g2), want)
    _same_next_draws(g1, g2)


def test_negative_sampling_with_start_node_on_a_dense_graph_matches_jax():
    """Most draws rejected: a 12-node graph with 85% of the pairs taken, and
    each node's pair with the next node left free."""
    rng = np.random.default_rng(12)
    pairs = np.array([[i, j] for i in range(12) for j in range(i + 1, 12)
                      if j != (i + 1) % 12 and i != (j + 1) % 12 and rng.random() < 0.85])
    start = np.random.default_rng(5).integers(0, 12, 40)
    g1, g2 = np.random.default_rng(6), np.random.default_rng(6)
    want = J.negative_sampling_with_start_node(start, 12, pairs.T, rng=g1)
    _assert_same(T.negative_sampling_with_start_node(start, 12, pairs.T, rng=g2), want)
    _same_next_draws(g1, g2)


def test_negative_sampling_with_start_node_raises_without_a_non_neighbour():
    ei = np.stack([np.zeros(9, np.int64), np.arange(1, 10)])
    for fn in (J.negative_sampling_with_start_node, T.negative_sampling_with_start_node):
        with pytest.raises(ValueError, match="no non-neighbor exists for start node 0"):
            fn(np.array([1, 0, 2]), 10, ei, rng=0)


@pytest.mark.parametrize("mode", ["undirected", "directed"])
@pytest.mark.parametrize("weighted", [True, False])
def test_extract_unique_edge_matches_jax(mode, weighted):
    ei = _graph(4, n=40, e=500)
    w = np.random.default_rng(0).random(500).astype(np.float32) if weighted else None
    got, want = T.extract_unique_edge(ei, w, mode=mode), J.extract_unique_edge(ei, w, mode=mode)
    _assert_same(got[0], want[0])
    _assert_same(got[1], want[1])


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("kwargs", [dict(test_size=0.15, random_state=0),
                                    dict(test_size=0.3, random_state=np.int64(7)),
                                    dict(test_size=25, train_size=0.5, random_state=1),
                                    dict(test_size=None, train_size=100, random_state=2),
                                    dict(test_size=0.2, shuffle=False)])
def test_edge_train_test_split_matches_jax(kwargs, weighted):
    """The split of sklearn's ``train_test_split`` (JAX calls it; the port
    does not import sklearn), with weights and without."""
    ei = _graph(5)
    w = np.random.default_rng(1).random(ei.shape[1]).astype(np.float32) if weighted else None
    kwargs = dict(kwargs)
    test_size = kwargs.pop("test_size")
    got = T.edge_train_test_split(ei, test_size, w, **kwargs)
    want = J.edge_train_test_split(ei, test_size, w, **kwargs)
    for g, wnt in zip(got, want):
        _assert_same(g, wnt)


def test_edge_train_test_split_random_state_objects_match_jax():
    """A ``RandomState`` is drawn from (and left where sklearn leaves it);
    None draws from numpy's global one."""
    ei = _graph(6)
    r1, r2 = np.random.RandomState(3), np.random.RandomState(3)
    for g, wnt in zip(T.edge_train_test_split(ei, 0.25, random_state=r1),
                      J.edge_train_test_split(ei, 0.25, random_state=r2)):
        _assert_same(g, wnt)
    assert r1.randint(0, 10 ** 9) == r2.randint(0, 10 ** 9)
    state = np.random.get_state()
    try:
        np.random.seed(8)
        got = T.edge_train_test_split(ei, 0.1)
        np.random.seed(8)
        want = J.edge_train_test_split(ei, 0.1)
    finally:
        np.random.set_state(state)
    for g, wnt in zip(got, want):
        _assert_same(g, wnt)


@pytest.mark.parametrize("kwargs", [dict(test_size=0.0), dict(test_size=1.5),
                                    dict(test_size=0.6, train_size=0.6),
                                    dict(test_size=10 ** 6), dict(test_size="a"),
                                    dict(test_size=True), dict(test_size=None, train_size=0),
                                    dict(test_size=1200, train_size=1000),
                                    dict(test_size=0.5, random_state=np.random.default_rng(0))])
def test_edge_train_test_split_refuses_what_sklearn_refuses(kwargs):
    ei = _graph(7)
    kwargs = dict(kwargs)
    test_size = kwargs.pop("test_size")
    with pytest.raises(ValueError):
        J.edge_train_test_split(ei, test_size, **kwargs)
    with pytest.raises(ValueError):
        T.edge_train_test_split(ei, test_size, **kwargs)


def test_edge_train_test_split_refuses_stratify():
    with pytest.raises(ValueError, match="stratify"):
        T.edge_train_test_split(_graph(), 0.2, stratify=np.zeros(10))


@pytest.mark.parametrize("k,pad", [(None, True), (2, True), (9, True), (9, False), (2, False)])
def test_convert_x_to_3d_matches_jax(k, pad):
    rng = np.random.default_rng(0)
    source_index = rng.integers(0, 12, 60)
    x = rng.normal(size=(60, 5)).astype(np.float32)
    _assert_same(T.convert_x_to_3d(torch.as_tensor(x), source_index, k=k, pad=pad),
                 J.convert_x_to_3d(x, source_index, k=k, pad=pad))


@pytest.mark.parametrize("weighted,num_nodes", [(True, None), (False, 50)])
def test_to_scipy_sparse_matrix_matches_jax(weighted, num_nodes):
    ei = _graph(8, n=40, e=300)
    w = np.random.default_rng(0).random(300).astype(np.float32) if weighted else None
    got = T.to_scipy_sparse_matrix(ei, w, num_nodes)
    want = J.to_scipy_sparse_matrix(ei, w, num_nodes)
    assert sp.isspmatrix_csr(got) and got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.toarray(), want.toarray())


@pytest.mark.parametrize("directed", [False, True])
def test_convert_edge_to_nx_graph_matches_jax(directed):
    ei = _graph(9, n=20, e=60)
    props = [np.arange(60, dtype=np.float32), None, np.arange(60) % 3]
    got = T.convert_edge_to_nx_graph(ei, props, convert_to_directed=directed)
    want = J.convert_edge_to_nx_graph(ei, props, convert_to_directed=directed)
    assert got.is_directed() == want.is_directed() == directed
    assert sorted(got.edges(data=True)) == sorted(want.edges(data=True))
    assert sorted(T.convert_edge_to_nx_graph(ei).edges()) == sorted(
        J.convert_edge_to_nx_graph(ei).edges())


# ---------------------------------------------------------------------------
# the samplers, in both native branches
# ---------------------------------------------------------------------------

@pytest.fixture(params=["native", "numpy"])
def branch(request, monkeypatch):
    """Both packages with their native library (the fixed-k draw in C++),
    or both without it (the ``rng.random`` branch)."""
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    else:
        assert jnative.available() and tnative.available()
    return request.param


def _sampler_graph():
    """Edges from 280 of the 300 nodes (the rest isolated), weighted."""
    rng = np.random.default_rng(10)
    ei = np.stack([rng.integers(0, 280, 3000), rng.integers(0, N, 3000)])
    ei[0, -1] = N - 1  # the largest id as a row, so both count N nodes
    return ei, rng.random(3000).astype(np.float32)


SAMPLE_CASES = [dict(k=4, padding=True), dict(k=3), dict(ratio=0.3), dict(),
                dict(k=4, padding=True, sampled=True), dict(k=2, sampled=True),
                dict(ratio=0.5, sampled=True), dict(sampled=True)]


@pytest.mark.parametrize("case", SAMPLE_CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()) or "all")
def test_random_neighbor_sampler_sample_matches_jax(branch, case):
    ei, w = _sampler_graph()
    case = dict(case)
    if case.pop("sampled", False):
        case["sampled_node_index"] = np.random.default_rng(1).permutation(N)[:150]
    got_s = T.RandomNeighborSampler(ei, w, rng=3)
    want_s = J.RandomNeighborSampler(ei, w, rng=3)
    for _ in range(2):  # the second call draws on from the sampler's rng
        got, want = got_s.sample(**case), want_s.sample(**case)
        _assert_same(got[0], want[0])
        _assert_same(got[1], want[1])
    _same_next_draws(got_s.rng, want_s.rng)


@pytest.mark.parametrize("sampled", [False, True])
def test_random_neighbor_sampler_dense_matches_jax(branch, sampled):
    ei, w = _sampler_graph()
    index = np.random.default_rng(2).permutation(N)[:100] if sampled else None
    got_s, want_s = T.RandomNeighborSampler(ei, w, rng=4), J.RandomNeighborSampler(ei, w, rng=4)
    for k in (5, 2):
        got, want = got_s.sample_dense(k, index), want_s.sample_dense(k, index)
        assert got[0].flags.c_contiguous and got[1].flags.c_contiguous
        _assert_same(got[0], want[0])
        _assert_same(got[1], want[1])
    src = np.arange(N)
    _assert_same(got_s._draw_fixed_k(src, 3)[0], want_s._draw_fixed_k(src, 3)[0])
    _assert_same(got_s._sample_fixed_k(src[:50], 3, True)[0],
                 want_s._sample_fixed_k(src[:50], 3, True)[0])


def test_dense_and_flat_fixed_k_draws_agree(branch):
    """From one draw state, ``sample(k, padding=True)`` is ``sample_dense(k)``
    flattened source-major (the JAX docstring's identity)."""
    ei, w = _sampler_graph()
    s = T.RandomNeighborSampler(ei, w, rng=5)
    state = s.rng.bit_generator.state
    (row, col), weight = s.sample(k=6, padding=True)
    s.rng.bit_generator.state = state
    idx, dw = s.sample_dense(6)
    np.testing.assert_array_equal(row, np.repeat(np.arange(N), 6))
    np.testing.assert_array_equal(col, idx.T.reshape(-1))
    np.testing.assert_array_equal(weight, dw.T.reshape(-1))
    assert (dw[:, 280:-1] == 0).all() and (idx[:, 280:-1] == np.arange(280, N - 1)).all()


@pytest.mark.parametrize("sampled", [False, True])
def test_uniform_neighbor_sampler_matches_jax(sampled):
    ei, w = _sampler_graph()
    index = np.random.default_rng(3).permutation(N)[:120] if sampled else None
    got_s, want_s = T.UniformNeighborSampler(ei, w, rng=6), J.UniformNeighborSampler(ei, w, rng=6)
    for p in (0.3, 0.8):
        got, want = got_s.sample(p, index), want_s.sample(p, index)
        _assert_same(got[0], want[0])
        _assert_same(got[1], want[1])
