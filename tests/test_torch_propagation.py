"""The port's propagation family (SGC, TAGCN, APPNP with ``mlp_encode``,
SSGC, ChebyNet, LEConv, DropEdge, MapReduceGNN, the Laplacian helpers of
``utils/graph_utils.py`` and ``l2_loss``) against the JAX package and the
executed reference's goldens, on the CPU, and bench workloads 10-12
(``sgc/appnp/ssgc_arxiv_fwd_bwd``) for 3 Adam steps against the same steps
written with the JAX functions and optax.

Dropout: ``jax.random`` and torch draw different streams, so the tests
derive JAX's keep masks from its keys (the splits ``appnp``, ``ssgc``,
``mlp_encode`` and ``drop_edge`` make) and hand them to the port.

Tolerances: forward and gradients 1e-4 (float32, sums in another order;
the propagation hops chain up to 10 SpMMs); the goldens use
``tests/test_reference_parity*.py``'s own tolerances; 3-step losses 1e-4.
"""
import importlib
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tf_geometric_tpu.layers as jlayers
import tf_geometric_tpu.nn as jnn
import tf_geometric_tpu_torch.layers as tlayers
import tf_geometric_tpu_torch.nn as tnn
from tf_geometric_tpu.layers.base import l2_loss as jax_l2_loss
from tf_geometric_tpu.nn.kernel.map_reduce import sum_reducer as jax_sum_reducer
from tf_geometric_tpu.utils import graph_utils as jgu
from tf_geometric_tpu_torch import bench
from tf_geometric_tpu_torch.convert import propagation_state_dict_from_flax
from tf_geometric_tpu_torch.nn.kernel.map_reduce import sum_reducer as torch_sum_reducer
from tf_geometric_tpu_torch.utils import graph_utils as tgu

tdrop = importlib.import_module("tf_geometric_tpu_torch.nn.sampling.drop_edge")
jdrop = importlib.import_module("tf_geometric_tpu.nn.sampling.drop_edge")

TOL = dict(rtol=1e-4, atol=1e-4)
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "golden_reference")


def _graph(seed, n=40, e=160, f=8, sym=True, loops=False):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, size=(2, e)).astype(np.int32)
    if not loops:
        same = ei[0] == ei[1]
        ei[1, same] = (ei[0, same] + 1) % n
    ew = rng.uniform(0.5, 1.5, e).astype(np.float32)
    if sym:
        ei = np.concatenate([ei, ei[::-1]], axis=1)
        ew = np.concatenate([ew, ew])
    x = rng.normal(size=(n, f)).astype(np.float32)
    return x, ei, ew, rng


def _w(rng, *shape):
    return (rng.normal(size=shape) * 0.5).astype(np.float32)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **tol, err_msg=what)


# ---------------------------------------------------------------------------
# utils/graph_utils.py
# ---------------------------------------------------------------------------

def test_mask_self_loop_edge_matches_jax():
    x, ei, ew, _ = _graph(1, loops=True)
    ei[:, :3] = [[2, 5, 7], [2, 5, 7]]
    for weight in (None, ew):
        want = jgu.mask_self_loop_edge(jnp.asarray(ei), 40, None if weight is None
                                       else jnp.asarray(weight))
        got = tgu.mask_self_loop_edge(torch.as_tensor(ei), 40, None if weight is None
                                      else torch.as_tensor(weight))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert (got[1] is None) == (want[1] is None)
        if weight is not None:
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("normalization_type", [None, "sym", "rw"])
def test_get_laplacian_matches_jax(normalization_type):
    x, ei, ew, _ = _graph(2)
    ei = ei.copy()
    ei[:, -4:] = 40  # padded edges
    for weight in (None, ew):
        want = jgu.get_laplacian(ei, 40, weight, normalization_type, fill_weight=1.5)
        got = tgu.get_laplacian(ei, 40, weight, normalization_type, fill_weight=1.5)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        _close(got[1], want[1], dict(rtol=1e-6, atol=1e-6))
    with pytest.raises(ValueError):
        tgu.get_laplacian(ei, 40, ew, "bogus")


@pytest.mark.parametrize("add_self_loop", [False, True])
def test_adj_norm_edge_matches_jax_and_caches(add_self_loop):
    _, ei, ew, _ = _graph(3)
    want = jgu.adj_norm_edge(ei, 40, ew, add_self_loop=add_self_loop)
    cache = {}
    got = tgu.adj_norm_edge(ei, 40, ew, add_self_loop=add_self_loop, cache=cache)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1], want[1], dict(rtol=1e-6, atol=1e-6))
    assert tgu.adj_norm_edge(None, 40, cache=cache, add_self_loop=add_self_loop) is got


@pytest.mark.parametrize("seed,weighted", [(4, True), (18, False)])
def test_laplacian_max_eigenvalue_matches_jax(seed, weighted):
    """"sym" only: ``eigsh`` assumes a symmetric matrix, and ARPACK's start
    vector carries over from call to call, so on the non-symmetric "rw"
    operator the JAX class itself answers differently on each call."""
    _, ei, ew, _ = _graph(seed, loops=True)
    ew = ew if weighted else None
    want = jgu.LaplacianMaxEigenvalue(ei, 40, ew)(normalization_type="sym")
    got = tgu.LaplacianMaxEigenvalue(torch.as_tensor(ei), 40, ew)(normalization_type="sym")
    assert got == pytest.approx(want, rel=1e-5, abs=1e-6)


# ---------------------------------------------------------------------------
# the functional ops against JAX: forward and gradients
# ---------------------------------------------------------------------------

def _jax_grads(fn, args):
    out, vjp = jax.vjp(fn, *args)
    cot = np.random.default_rng(99).normal(size=out.shape).astype(np.float32)
    return out, vjp(jnp.asarray(cot)), cot


def _torch_grads(out, leaves, cot):
    (out * torch.as_tensor(cot)).sum().backward()
    return [leaf.grad for leaf in leaves]


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("op", ["sgc", "tagcn"])
def test_sgc_and_tagcn_match_jax(op, cached):
    x, ei, ew, rng = _graph(5)
    k = 2 if op == "sgc" else 3
    kernel = _w(rng, 8 if op == "sgc" else 8 * (k + 1), 6)
    bias = _w(rng, 6)
    jfn, tfn = getattr(jnn, op), getattr(tnn, op)

    def jax_fn(xx, kk, bb):
        return jfn(xx, jnp.asarray(ei), jnp.asarray(ew), k, kk, bb, jax.nn.relu,
                   cache={} if cached else None)

    want, (gx, gk, gb), cot = _jax_grads(jax_fn, (jnp.asarray(x), jnp.asarray(kernel),
                                                  jnp.asarray(bias)))
    leaves = [_t(x, True), _t(kernel, True), _t(bias, True)]
    got = tfn(leaves[0], torch.as_tensor(ei), torch.as_tensor(ew), k, leaves[1], leaves[2],
              torch.relu, cache={} if cached else None)
    _close(got, want, what="forward")
    for g, w in zip(_torch_grads(got, leaves, cot), (gx, gk, gb)):
        _close(g, w, what="gradient")


def _jax_ppr_masks(key, value_len, n, units, dense_rate, edge_rate, last_rate=0.0):
    """The keep masks that ``appnp``/``ssgc`` draw from ``key`` (training,
    cached ELL path): the edge mask over the normalized values, then one
    mask per dense layer (None where that layer's rate is 0)."""
    edge_key, mlp_key = jax.random.split(key)
    edge = (np.asarray(jax.random.bernoulli(edge_key, 1.0 - edge_rate, (value_len,)))
            if edge_rate > 0 else None)
    keys = jax.random.split(mlp_key, len(units))
    dense = []
    for i, u in enumerate(units):
        rate = dense_rate if i < len(units) - 1 else last_rate
        dense.append(np.asarray(jax.random.bernoulli(keys[i], 1.0 - rate, (n, u)))
                     if rate > 0 else None)
    return edge, dense


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("op", ["appnp", "ssgc"])
def test_appnp_and_ssgc_match_jax(op, training):
    x, ei, ew, rng = _graph(6)
    kernels = [_w(rng, 8, 12), _w(rng, 12, 5)]
    biases = [_w(rng, 12), _w(rng, 5)]
    rates = dict(dense_drop_rate=0.4, last_dense_drop_rate=0.3, edge_drop_rate=0.5)
    key = jax.random.PRNGKey(7)
    jfn, tfn = getattr(jnn, op), getattr(tnn, op)
    k = 10 if op == "appnp" else 5

    def jax_fn(xx, k0, k1, b0, b1):
        return jfn(xx, jnp.asarray(ei), jnp.asarray(ew), [k0, k1], [b0, b1], k=k, alpha=0.1,
                   cache={}, training=training, dropout_key=key if training else None, **rates)

    args = [x] + kernels + biases
    want, grads, cot = _jax_grads(jax_fn, [jnp.asarray(a) for a in args])
    # the normalized adjacency's values: the edges and the N self-loops
    edge, dense = (_jax_ppr_masks(key, ei.shape[1] + 40, 40, (12, 5), 0.4, 0.5, 0.3)
                   if training else (None, None))
    leaves = [_t(a, True) for a in args]
    got = tfn(leaves[0], torch.as_tensor(ei), torch.as_tensor(ew), leaves[1:3], leaves[3:5],
              k=k, alpha=0.1, cache={}, training=training, edge_keep_mask=edge,
              dense_keep_masks=dense, **rates)
    _close(got, want, what="forward")
    for g, w in zip(_torch_grads(got, leaves, cot), grads):
        _close(g, w, what="gradient")


def test_appnp_uncached_coo_dropout_matches_jax():
    """Without a cache the edge dropout falls on the COO values."""
    x, ei, ew, rng = _graph(7)
    kernels, biases = [_w(rng, 8, 4)], [_w(rng, 4)]
    key = jax.random.PRNGKey(3)
    want = jnn.appnp(jnp.asarray(x), jnp.asarray(ei), jnp.asarray(ew), kernels, biases, k=4,
                     edge_drop_rate=0.5, training=True, dropout_key=key)
    edge, _ = _jax_ppr_masks(key, ei.shape[1] + 40, 40, (4,), 0.0, 0.5)
    got = tnn.appnp(_t(x), torch.as_tensor(ei), torch.as_tensor(ew),
                    [_t(kernels[0])], [_t(biases[0])], k=4, edge_drop_rate=0.5, training=True,
                    edge_keep_mask=edge)
    _close(got, want)


def test_mlp_encode_dropout_schedule_matches_jax():
    x, _, _, rng = _graph(8)
    kernels = [_w(rng, 8, 7), _w(rng, 7, 6), _w(rng, 6, 3)]
    biases = [_w(rng, 7), None, _w(rng, 3)]
    key = jax.random.PRNGKey(11)
    want = importlib.import_module("tf_geometric_tpu.nn.conv.appnp").mlp_encode(
        jnp.asarray(x), kernels, biases, jax.nn.relu, 0.5, 0.25, True, key)
    keys = jax.random.split(key, 3)
    masks = [np.asarray(jax.random.bernoulli(keys[i], 1.0 - r, (40, u)))
             for i, (r, u) in enumerate(((0.5, 7), (0.5, 6), (0.25, 3)))]
    got = tnn.mlp_encode(_t(x), [_t(k) for k in kernels],
                         [None if b is None else _t(b) for b in biases], torch.relu, 0.5, 0.25,
                         True, keep_masks=masks)
    _close(got, want)
    # eval mode and no kernels: no dropout, the identity
    _close(tnn.mlp_encode(_t(x), None, None, torch.relu, 0.5, 0.5, False), x)


@pytest.mark.parametrize("normalization_type,dynamic", [("sym", False), ("rw", False),
                                                        ("sym", True), (None, False)])
def test_chebynet_matches_jax(normalization_type, dynamic):
    x, ei, ew, rng = _graph(9, loops=True)
    kernels = [_w(rng, 8, 4) for _ in range(3)]
    bias = _w(rng, 4)
    jcheb = importlib.import_module("tf_geometric_tpu.nn.conv.chebynet")
    want_edges = jcheb.chebynet_norm_edge(ei, 40, ew, normalization_type, dynamic)
    cache = {}
    got_edges = tnn.chebynet_norm_edge(ei, 40, ew, normalization_type, dynamic, cache=cache,
                                       device="cpu")
    np.testing.assert_array_equal(got_edges[0].numpy(), np.asarray(want_edges[0]))
    _close(got_edges[1], want_edges[1], dict(rtol=1e-5, atol=1e-6))
    assert tnn.chebynet_norm_edge(None, 40, None, normalization_type, dynamic, cache=cache,
                                  device="cpu") is got_edges

    def jax_fn(xx, k0, k1, k2, bb):
        return jnn.chebynet(xx, jnp.asarray(ei), jnp.asarray(ew), 3, [k0, k1, k2], bb,
                            jax.nn.relu, normalization_type, dynamic)

    args = [x] + kernels + [bias]
    want, grads, cot = _jax_grads(jax_fn, [jnp.asarray(a) for a in args])
    leaves = [_t(a, True) for a in args]
    got = tnn.chebynet(leaves[0], ei, ew, 3, leaves[1:4], leaves[4], torch.relu,
                       normalization_type, dynamic)
    _close(got, want, what="forward")
    for g, w in zip(_torch_grads(got, leaves, cot), grads):
        _close(g, w, what="gradient")


def test_chebynet_cache_normed_edge_on_a_graph():
    from tf_geometric_tpu_torch.data import Graph
    x, ei, ew, _ = _graph(10)
    graph = Graph(x, ei, edge_weight=ew)
    tnn.chebynet_cache_normed_edge(graph, "rw", device="cpu")
    key = importlib.import_module("tf_geometric_tpu_torch.nn.conv.chebynet").compute_cache_key(
        "rw", False)
    first = graph.cache[key]
    tnn.chebynet_cache_normed_edge(graph, "rw", override=True, device="cpu")
    assert graph.cache[key] is not first
    torch.testing.assert_close(graph.cache[key][1], first[1])


def test_le_conv_matches_jax():
    x, ei, ew, rng = _graph(11, sym=False)
    ei = ei.copy()
    ei[0, -3:] = 40  # padded edges
    args = [x] + [_w(rng, *s) for s in ((8, 5), (5,), (8, 5), (5,), (8, 5), (5,))]

    def jax_fn(*a):
        return jnn.le_conv(a[0], jnp.asarray(ei), jnp.asarray(ew), *a[1:],
                           activation=jax.nn.sigmoid)

    want, grads, cot = _jax_grads(jax_fn, [jnp.asarray(a) for a in args])
    leaves = [_t(a, True) for a in args]
    got = tnn.le_conv(leaves[0], torch.as_tensor(ei), torch.as_tensor(ew), *leaves[1:],
                      activation=torch.sigmoid)
    _close(got, want, what="forward")
    for g, w in zip(_torch_grads(got, leaves, cot), grads):
        _close(g, w, what="gradient")
    # no weight: ones
    _close(tnn.le_conv(_t(x), ei, None, *[_t(a) for a in args[1:]]),
           jnn.le_conv(jnp.asarray(x), jnp.asarray(ei), None, *args[1:]))


# ---------------------------------------------------------------------------
# DropEdge
# ---------------------------------------------------------------------------

def test_drop_edge_with_jax_masks_matches_jax():
    _, ei, ew, _ = _graph(12)
    attr2 = np.arange(ei.shape[1] * 2, dtype=np.float32).reshape(-1, 2)
    key = jax.random.PRNGKey(5)
    want = jdrop.drop_edge([jnp.asarray(ei), jnp.asarray(ew), jnp.asarray(attr2)], rate=0.4,
                           training=True, key=key, num_nodes=40)
    keep = np.asarray(jax.random.bernoulli(key, 0.6, (ei.shape[1],)))
    got = tnn.drop_edge([torch.as_tensor(ei), torch.as_tensor(ew), torch.as_tensor(attr2)],
                        rate=0.4, training=True, keep_mask=keep, num_nodes=40)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_drop_edge_force_undirected_hash_matches_jax():
    _, ei, _, _ = _graph(13)
    key = jax.random.PRNGKey(6)
    (want,) = jdrop.drop_edge([jnp.asarray(ei)], rate=0.5, force_undirected=True,
                              training=True, key=key)
    base = int(jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max))
    keep = tdrop._undirected_keep(torch.as_tensor(ei[0]), torch.as_tensor(ei[1]), base, 0.5)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want)[0] != ei.max() + 1)
    (got,) = tnn.drop_edge([ei], rate=0.5, training=True, keep_mask=keep)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_drop_edge_generator_paths_and_contract():
    _, ei, ew, _ = _graph(14)
    gen = torch.Generator().manual_seed(0)
    got_index, got_w = tnn.drop_edge([torch.as_tensor(ei), torch.as_tensor(ew)], rate=0.5,
                                     force_undirected=True, training=True, generator=gen)
    kept = {(int(r), int(c)) for r, c in got_index.t() if r < 40}
    assert kept and all((c, r) in kept for r, c in kept)  # both directions together
    assert ((got_w == 0) == (got_index[0] == 40)).all()
    index, _ = tnn.drop_edge([torch.as_tensor(ei), torch.as_tensor(ew)], rate=0.5,
                             training=True, generator=gen)
    assert 0 < int((index[0] == 40).sum()) < ei.shape[1]
    inputs = [ei, ew]
    assert tnn.drop_edge(inputs, rate=0.5, training=False) is inputs
    with pytest.raises(ValueError, match="generator"):
        tnn.drop_edge(inputs, rate=0.5, training=True)
    with pytest.raises(ValueError, match="between 0 and 1"):
        tnn.drop_edge(inputs, rate=1.5, training=True)
    layer = tlayers.DropEdge(rate=0.5, num_nodes=40)
    assert layer.eval()(inputs) is inputs
    keep = np.arange(ei.shape[1]) % 2 == 0
    got = layer.train()([torch.as_tensor(ei), torch.as_tensor(ew)], keep_mask=keep)
    assert (got[0][:, ~keep] == 40).all() and (got[1][keep] == torch.as_tensor(ew)[keep]).all()


# ---------------------------------------------------------------------------
# layers, parameters carried over by convert.py
# ---------------------------------------------------------------------------

LAYERS = {
    "SGC": (lambda: jlayers.SGC(units=6, k=2), lambda f: tlayers.SGC(f, 6, k=2, device="cpu")),
    "TAGCN": (lambda: jlayers.TAGCN(units=6, k=3),
              lambda f: tlayers.TAGCN(f, 6, k=3, device="cpu")),
    "APPNP": (lambda: jlayers.APPNP(units_list=[12, 5], k=6),
              lambda f: tlayers.APPNP(f, [12, 5], k=6, device="cpu")),
    "SSGC": (lambda: jlayers.SSGC(units_list=[12, 5], k=4),
             lambda f: tlayers.SSGC(f, [12, 5], k=4, device="cpu")),
    "ChebyNet": (lambda: jlayers.ChebyNet(units=6, k=3, normalization_type="rw"),
                 lambda f: tlayers.ChebyNet(f, 6, k=3, normalization_type="rw", device="cpu")),
    "LEConv": (lambda: jlayers.LEConv(units=6), lambda f: tlayers.LEConv(f, 6, device="cpu")),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_flax_with_carried_params(name):
    x, ei, ew, _ = _graph(15)
    make_flax, make_torch = LAYERS[name]
    flax_layer = make_flax()
    variables = flax_layer.init(jax.random.PRNGKey(0), [jnp.asarray(x), jnp.asarray(ei),
                                                        jnp.asarray(ew)])
    want = flax_layer.apply(variables, [jnp.asarray(x), jnp.asarray(ei), jnp.asarray(ew)])
    layer = make_torch(8).eval()
    state = propagation_state_dict_from_flax(variables)
    assert set(state) == {n for n, _ in layer.named_parameters()}
    layer.load_state_dict(state)
    got = layer([_t(x), torch.as_tensor(ei), torch.as_tensor(ew)])
    _close(got, want)
    for key_filter in ("kernel", "bias"):
        assert float(tlayers.l2_loss(layer, 5e-4, key_filter)) == pytest.approx(
            float(jax_l2_loss(variables["params"], 5e-4, key_filter)), rel=1e-5)


def test_appnp_layer_training_takes_masks_and_generator():
    x, ei, ew, _ = _graph(16)
    layer = tlayers.APPNP(8, [12, 5], k=3, dense_drop_rate=0.5, edge_drop_rate=0.5,
                          generator=torch.Generator().manual_seed(0), device="cpu").train()
    inputs = [_t(x), torch.as_tensor(ei), torch.as_tensor(ew)]
    edge = np.arange(ei.shape[1] + 40) % 3 > 0
    dense = [np.ones((40, 12), bool), None]
    kernels, biases = layer._dense()
    want = tnn.appnp(inputs[0], inputs[1], inputs[2], kernels, biases, k=3,
                     dense_drop_rate=0.5, edge_drop_rate=0.5, cache={}, training=True,
                     edge_keep_mask=edge, dense_keep_masks=dense)
    got = layer(inputs, cache={}, edge_keep_mask=edge, dense_keep_masks=dense)
    torch.testing.assert_close(got, want)
    a = layer(inputs, cache={}, generator=torch.Generator().manual_seed(1))
    b = layer(inputs, cache={}, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b)
    with pytest.raises(ValueError, match="edge dropout"):
        layer(inputs, cache={})


def test_map_reduce_gnn_matches_jax():
    x, ei, ew, _ = _graph(17)

    class JaxMean(jlayers.MapReduceGNN):
        def map(self, repeated_x, neighbor_x, edge_weight=None):
            return neighbor_x * edge_weight[:, None] + repeated_x

        def reduce(self, neighbor_msg, node_index, num_nodes=None):
            return jax_sum_reducer(neighbor_msg, node_index, num_nodes)

        def update(self, x, reduced_neighbor_msg):
            return x * 0.5 + reduced_neighbor_msg

    class TorchMean(tlayers.MapReduceGNN):
        def map(self, repeated_x, neighbor_x, edge_weight=None):
            return neighbor_x * edge_weight[:, None] + repeated_x

        def reduce(self, neighbor_msg, node_index, num_nodes=None):
            return torch_sum_reducer(neighbor_msg, node_index, num_nodes)

        def update(self, x, reduced_neighbor_msg):
            return x * 0.5 + reduced_neighbor_msg

    want = JaxMean().apply({}, [jnp.asarray(x), jnp.asarray(ei), jnp.asarray(ew)])
    got = TorchMean()([_t(x), torch.as_tensor(ei), torch.as_tensor(ew)])
    _close(got, want, dict(rtol=1e-5, atol=1e-5))
    with pytest.raises(NotImplementedError):
        tlayers.MapReduceGNN()([_t(x), torch.as_tensor(ei)])


def test_l2_loss_over_a_params_dict():
    params = {"kernel_0": torch.ones(2, 3), "bias_0": torch.ones(3), "w.kernel": torch.ones(4)}
    assert float(tlayers.l2_loss(params, 2.0)) == pytest.approx(2.0 * 0.5 * 10)
    assert float(tlayers.l2_loss(params, 1.0, "bias")) == pytest.approx(1.5)


# ---------------------------------------------------------------------------
# the executed reference's goldens
# ---------------------------------------------------------------------------

def _golden(name):
    data = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))
    return ({k[3:]: data[k] for k in data.files if k.startswith("in_")},
            {k[4:]: data[k] for k in data.files if k.startswith("out_")})


def _golden_out(name, inp, cached):
    cache = {} if cached else None
    x, ei, ew = _t(inp["x"]), torch.as_tensor(inp["ei"]), torch.as_tensor(inp["ew"])
    if name == "appnp":
        return tnn.appnp(x, ei, ew, [_t(inp["w0"]), _t(inp["w1"])],
                         [_t(inp["b0"]), _t(inp["b1"])], k=10, alpha=0.1, cache=cache)
    if name == "sgc_k2":
        return tnn.sgc(x, ei, ew, 2, _t(inp["w"]), _t(inp["b"]), torch.relu, cache=cache)
    if name == "ssgc_k5":
        return tnn.ssgc(x, ei, ew, [_t(inp["w0"]), _t(inp["w1"])],
                        [_t(inp["b0"]), _t(inp["b1"])], k=5, alpha=0.1, cache=cache)
    if name == "tagcn_k3":
        return tnn.tagcn(x, ei, ew, 3, _t(inp["w"]), _t(inp["b"]), torch.relu, cache=cache)
    if name.startswith("chebynet"):
        norm = "rw" if name == "chebynet_rw" else "sym"
        return tnn.chebynet(x, ei, ew, 3, [_t(inp[f"w{i}"]) for i in range(3)], _t(inp["b"]),
                            torch.relu, norm, name.endswith("dynamic"), cache=cache)
    return tnn.le_conv(x, ei, ew, *[_t(inp[k]) for k in ("ws", "bs", "was", "bas", "wan", "ban")],
                       activation=torch.sigmoid)


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("name,tol", [
    ("appnp", {}), ("sgc_k2", {}), ("ssgc_k5", {}), ("tagcn_k3", {}), ("chebynet_sym", {}),
    ("chebynet_rw", {}), ("chebynet_sym_dynamic", dict(rtol=5e-4, atol=5e-5)), ("le_conv", {})])
def test_propagation_golden_reference(name, tol, cached):
    inp, out = _golden(name)
    got = _golden_out(name, inp, cached)
    np.testing.assert_allclose(got.detach().numpy(), out["out"],
                               **(tol or dict(rtol=1e-4, atol=1e-5)))


def test_lambda_max_golden_reference():
    inp, out = _golden("data_lambda_max")
    lam = tgu.LaplacianMaxEigenvalue(inp["ei"], 20, inp["ew"])(normalization_type="sym")
    np.testing.assert_allclose(np.float32(lam), out["lam"], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# bench workloads 10-12: 3 Adam steps against the same steps in JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_problem():
    return bench.build_problem(2_000, 14_000, device="cpu", spmm_bf16=False)


def _jax_workload_loss(name, problem, jcache):
    x = jnp.asarray(problem.x.numpy())
    y = jnp.asarray(problem.y.numpy())
    ei = jnp.asarray(problem.edge_index.numpy())
    l2 = bench.PROPAGATION_L2[name]

    def loss(params, key):
        if name == "sgc_arxiv_fwd_bwd":
            logits = jnn.sgc(x, ei, None, bench.SGC_K, params["kernel"], params["bias"],
                             cache=jcache)
        else:
            kernels = [params["kernel_0"], params["kernel_1"]]
            biases = [params["bias_0"], params["bias_1"]]
            kw = dict(k=bench.PPR_K, alpha=bench.PPR_ALPHA, dense_drop_rate=bench.PPR_DROP,
                      edge_drop_rate=bench.PPR_DROP, cache=jcache, training=True)
            if name == "appnp_arxiv_fwd_bwd":
                logits = jnn.appnp(x, ei, None, kernels, biases, dropout_key=key, **kw)
            else:
                in_key, key = jax.random.split(key)
                keep = jax.random.bernoulli(in_key, 1.0 - bench.PPR_DROP, x.shape)
                xd = jnp.where(keep, x / (1.0 - bench.PPR_DROP), 0.0)
                logits = jnn.ssgc(xd, ei, None, kernels, biases, dropout_key=key, **kw)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        return ce + jax_l2_loss(params, l2)

    return loss


def _port_masks(name, key, problem):
    """The keep masks the JAX loss draws from ``key``."""
    n = problem.x.shape[0]
    masks = {}
    if name == "ssgc_arxiv_fwd_bwd":
        in_key, key = jax.random.split(key)
        masks["input"] = torch.as_tensor(np.asarray(
            jax.random.bernoulli(in_key, 1.0 - bench.PPR_DROP, tuple(problem.x.shape))))
    masks["edge"], masks["dense"] = _jax_ppr_masks(
        key, problem.num_edges_normed, n, (bench.PPR_HIDDEN, bench.NUM_CLASSES), bench.PPR_DROP,
        bench.PPR_DROP)
    return masks


@pytest.mark.parametrize("name", ["sgc_arxiv_fwd_bwd", "appnp_arxiv_fwd_bwd",
                                  "ssgc_arxiv_fwd_bwd"])
def test_propagation_workload_three_steps_match_jax(name, small_problem):
    wl = bench.WORKLOADS[name]
    params = wl.init(small_problem)
    jparams = {k: jnp.asarray(v.detach().numpy()) for k, v in params.items()}
    jloss = _jax_workload_loss(name, small_problem, {})
    opt = optax.adam(wl.lr)
    state = opt.init(jparams)
    torch_opt = torch.optim.Adam(list(params.values()), lr=wl.lr)
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    for step in range(3):
        jl, grads = jax.value_and_grad(jloss)(jparams, keys[step])
        updates, state = opt.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        torch_opt.zero_grad()
        if name == "sgc_arxiv_fwd_bwd":
            loss = wl.loss(params, small_problem)
        else:
            loss = (bench.appnp_loss if name == "appnp_arxiv_fwd_bwd" else bench.ssgc_loss)(
                params, small_problem, _port_masks(name, keys[step], small_problem))
        loss.backward()
        if step == 0:
            for k, v in params.items():
                _close(v.grad, grads[k], what=f"step-1 gradient {k}")
        torch_opt.step()
        assert float(loss) == pytest.approx(float(jl), rel=1e-4, abs=1e-4), step
