"""The port's graph-classification slice against the JAX package on the CPU:
``BatchGraph``, the padding, the batch generator and both synthetic graph
sets (bit for bit), the pools (``mean/sum/max/min_pool``, ``topk_pool``,
``topk_pool_fixed`` with ties, ``induced_subgraph_fixed``, ``sort_pool``),
``gin`` and the ``GIN`` layer with carried weights, the executed
reference's goldens, and both models of
``benchmarks/graph_classification_throughput.py`` end to end (the loss and
every parameter gradient of one step at a batch of 16 graphs).

Tolerances: the data layer is compared exactly. Float32 formulas summed in
another order: rtol = atol = 1e-5, and 1e-4 for the models' gradients,
whose sums run over three GIN layers and the readout. The goldens use
test_reference_parity.py's own tolerances (rtol 1e-4, atol 1e-5;
test_reference_parity_data.py's rtol 1e-5, atol 1e-6 for the batch union).
"""
import os
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_geometric_tpu.datasets as jdatasets
from tf_geometric_tpu.data.graph import BatchGraph as JBatchGraph
from tf_geometric_tpu.data.graph import Graph as JGraph
from tf_geometric_tpu.data import padding as jpadding
from tf_geometric_tpu.datasets.synthetic_citation import \
    synthetic_graph_classification_hard as jax_hard
from tf_geometric_tpu.layers import GIN as FlaxGIN
from tf_geometric_tpu import nn as jnn
from tf_geometric_tpu.nn.pool._subgraph import induced_subgraph_fixed as jax_subgraph_fixed
from tf_geometric_tpu.nn.pool.sort_pool import sort_pool as jax_sort_pool
from tf_geometric_tpu.nn.pool.topk_pool import topk_pool as jax_topk_pool
from tf_geometric_tpu.nn.pool.topk_pool import topk_pool_fixed as jax_topk_fixed
from tf_geometric_tpu_torch import bench, layers
from tf_geometric_tpu_torch import nn as tnn
from tf_geometric_tpu_torch.convert import gin_classifier_state_dict_from_flax
from tf_geometric_tpu_torch.data import (BatchGraph, Graph, PaddingSpec, bucket_size,
                                         pad_batch_graph, padded_batch_generator)
from tf_geometric_tpu_torch.datasets import (synthetic_graph_classification,
                                             synthetic_graph_classification_hard)
from tf_geometric_tpu_torch.nn.pool._subgraph import induced_subgraph_fixed

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "demo"))
import demo_utils  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
GOLDEN_TOL = dict(rtol=1e-4, atol=1e-5)
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "golden_reference")
FIELDS = ("x", "edge_index", "edge_weight", "y", "node_graph_index", "edge_graph_index")


def _golden(name):
    d = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))
    return ({k[3:]: d[k] for k in d.files if k.startswith("in_")},
            {k[4:]: d[k] for k in d.files if k.startswith("out_")})


def _assert_same_arrays(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _random_graphs(seed, count=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n, e = int(rng.integers(3, 9)), int(rng.integers(0, 15))
        out.append((rng.normal(size=(n, 3)).astype(np.float32),
                    rng.integers(0, n, size=(2, e)).astype(np.int32),
                    rng.uniform(0.5, 1.5, e).astype(np.float32) if e % 2 else None,
                    [int(rng.integers(0, 3))]))
    return out


def _both(graphs):
    return ([JGraph(x=x, edge_index=ei, edge_weight=ew, y=y) for x, ei, ew, y in graphs],
            [Graph(x=x, edge_index=ei, edge_weight=ew, y=y) for x, ei, ew, y in graphs])


# ---------------------------------------------------------------------------
# data, bit for bit
# ---------------------------------------------------------------------------

def test_batch_graph_union_and_split_match_jax():
    jgs, tgs = _both(_random_graphs(1))
    jb, tb = JBatchGraph.from_graphs(jgs), BatchGraph.from_graphs(tgs)
    assert tb.num_graphs == jb.num_graphs == 5
    for f in FIELDS:
        _assert_same_arrays(getattr(tb, f), getattr(jb, f), f)
    for jg, tg in zip(jb.to_graphs(), tb.to_graphs()):
        for f in ("x", "edge_index", "edge_weight", "y"):
            _assert_same_arrays(getattr(tg, f), getattr(jg, f), f)
    tb.graphs = None  # num_graphs from the graph ids
    assert tb.num_graphs == 5
    with pytest.raises(ValueError, match="mixed labeling"):
        BatchGraph.from_graphs([tgs[0], Graph(x=tgs[1].x, edge_index=tgs[1].edge_index)])


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 2432, 12160, 100_000])
def test_bucket_size_matches_jax(n):
    assert bucket_size(n) == jpadding.bucket_size(n)
    assert bucket_size(n, 64, 1.5) == jpadding.bucket_size(n, 64, 1.5)


def test_pad_batch_graph_matches_jax():
    """Padded nodes get zero features and graph id num_graphs; padded edges
    are row = col = capacity with weight 0."""
    jgs, tgs = _both(_random_graphs(2))
    jb, tb = JBatchGraph.from_graphs(jgs), BatchGraph.from_graphs(tgs)
    spec = jpadding.PaddingSpec(64, 96, 5)
    jp = jpadding.pad_batch_graph(jb, spec)
    tp = pad_batch_graph(tb, PaddingSpec(64, 96, 5))
    for f in FIELDS:
        _assert_same_arrays(getattr(tp, f), getattr(jp, f), f)
    assert tp.cache == jp.cache
    assert np.all(tp.edge_index[:, tb.num_edges:] == 64)
    assert np.all(tp.node_graph_index[tb.num_nodes:] == 5)
    with pytest.raises(ValueError):
        pad_batch_graph(tb, PaddingSpec(4, 96, 5))
    with pytest.raises(ValueError, match="num_graphs"):
        pad_batch_graph(tb, PaddingSpec(64, 96))
    jg1 = jpadding.PaddingSpec.for_graph(jgs[0])
    tg1 = PaddingSpec.for_graph(tgs[0])
    assert (tg1.num_nodes, tg1.num_edges) == (jg1.num_nodes, jg1.num_edges)


def _offline_jax_set(monkeypatch, num_graphs=600, seed=0):
    """demo_utils.load_graph_classification_data's offline set: its TU
    loader is made to raise, so it takes the synthetic fallback without
    trying the network."""
    class NoTU:
        def __init__(self, *args, **kwargs):
            raise OSError("TU files are not on disk")

    monkeypatch.setattr(jdatasets, "TUDataset", NoTU)
    monkeypatch.delenv("TFG_HARD_GRAPH_CLS", raising=False)
    return demo_utils.load_graph_classification_data("NCI1", num_fallback_graphs=num_graphs,
                                                     seed=seed)


@pytest.mark.parametrize("seed", [0, 5])
def test_offline_graph_set_is_bit_identical(monkeypatch, seed):
    jgraphs, jc = _offline_jax_set(monkeypatch, 600, seed)
    tgraphs, tc = synthetic_graph_classification(600, seed=seed)
    assert tc == jc == 2 and len(tgraphs) == len(jgraphs) == 600
    for jg, tg in zip(jgraphs, tgraphs):
        for f in ("x", "edge_index", "edge_weight", "y"):
            _assert_same_arrays(getattr(tg, f), getattr(jg, f), f)


@pytest.mark.parametrize("seed", [0, 3])
def test_hard_graph_set_is_bit_identical(seed):
    jgraphs, jc = jax_hard(num_graphs=40, seed=seed)
    tgraphs, tc = synthetic_graph_classification_hard(num_graphs=40, seed=seed)
    assert tc == jc
    for jg, tg in zip(jgraphs, tgraphs):
        for f in ("x", "edge_index", "edge_weight", "y"):
            _assert_same_arrays(getattr(tg, f), getattr(jg, f), f)


@pytest.mark.parametrize("shuffle,infinite", [(False, True), (True, True), (True, False)])
def test_padded_batch_generator_matches_jax(monkeypatch, shuffle, infinite):
    jgraphs, _ = _offline_jax_set(monkeypatch, 70)
    tgraphs, _ = synthetic_graph_classification(70)
    jgen = demo_utils.padded_batch_generator(jgraphs, 16, shuffle=shuffle, infinite=infinite,
                                             seed=3)
    tgen = padded_batch_generator(tgraphs, 16, shuffle=shuffle, infinite=infinite, seed=3)
    for _ in range(6 if infinite else 5):
        (jb, jreal), (tb, treal) = next(jgen), next(tgen)
        assert jreal == treal
        for f in FIELDS:
            _assert_same_arrays(getattr(tb, f), getattr(jb, f), f)
    spec = demo_utils.batch_padding_spec(jgraphs, 16)
    assert (tb.num_nodes, tb.num_edges) == (spec.num_nodes, spec.num_edges)


def test_benchmark_batch_shape():
    """The benchmark's first batch of 128 offline graphs pads to 2,560 nodes
    and 12,928 edges, as the JAX script prints it."""
    pr = bench.build_graph_problem(device="cpu")
    assert tuple(pr.x.shape) == (2560, 4) and tuple(pr.edge_index.shape) == (2, 12928)
    assert pr.real_edges == int((pr.edge_index[0] < 2560).sum())
    assert int((pr.node_graph_index < 128).sum()) == sum(
        g.num_nodes for g in synthetic_graph_classification()[0][:128])


# ---------------------------------------------------------------------------
# pools and ops
# ---------------------------------------------------------------------------

def _padded_batch(seed, num_graphs=4, cap=40):
    """A padded batch with an empty graph (id 2) and padded nodes."""
    rng = np.random.default_rng(seed)
    sizes = [6, 9, 0, 7][:num_graphs]
    ngi = np.concatenate([np.full(s, g) for g, s in enumerate(sizes)]
                         + [np.full(cap - sum(sizes), num_graphs)]).astype(np.int32)
    x = rng.normal(size=(cap, 5)).astype(np.float32)
    x[sum(sizes):] = 0.0
    return x, ngi


@pytest.mark.parametrize("name", ["mean_pool", "sum_pool", "max_pool", "min_pool"])
def test_common_pools_match_jax(name):
    x, ngi = _padded_batch(1)
    want = getattr(jnn, name)(jnp.asarray(x), jnp.asarray(ngi), num_graphs=4)
    got = getattr(tnn, name)(torch.as_tensor(x), torch.as_tensor(ngi), num_graphs=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    layer = {"mean_pool": layers.MeanPool, "sum_pool": layers.SumPool,
             "max_pool": layers.MaxPool, "min_pool": layers.MinPool}[name](num_graphs=4)
    np.testing.assert_allclose(layer([torch.as_tensor(x), torch.as_tensor(ngi)]).numpy(),
                               np.asarray(want), **TOL)
    # without num_graphs: max + 1 of the ids, the padding's id included
    np.testing.assert_allclose(getattr(tnn, name)(torch.as_tensor(x), torch.as_tensor(ngi)).numpy(),
                               np.asarray(getattr(jnn, name)(jnp.asarray(x), jnp.asarray(ngi))),
                               **TOL)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_topk_pool_fixed_with_ties_matches_jax(k):
    """Scores with many exact ties (relu zeros, repeated values, -0.0)
    select the same nodes in the same order as JAX's stable lexsort."""
    rng = np.random.default_rng(k)
    _, ngi = _padded_batch(2)
    score = np.maximum(rng.normal(size=ngi.shape[0]), 0.0).astype(np.float32)
    score[::5] = 0.75
    score[1] = -0.0
    idx, valid = jax_topk_fixed(jnp.asarray(ngi), jnp.asarray(score), 4, k)
    tidx, tvalid = tnn.topk_pool_fixed(torch.as_tensor(ngi), torch.as_tensor(score), 4, k)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))


def test_topk_pool_host_matches_jax():
    _, ngi = _padded_batch(3)
    score = np.random.default_rng(3).normal(size=ngi.shape[0]).astype(np.float32)
    for k, ratio in ((2, None), (None, 0.5)):
        np.testing.assert_array_equal(tnn.topk_pool(torch.as_tensor(ngi), score, k, ratio),
                                      jax_topk_pool(ngi, score, k, ratio))
    with pytest.raises(ValueError):
        tnn.topk_pool(ngi, score)


def test_induced_subgraph_fixed_matches_jax():
    rng = np.random.default_rng(4)
    x, ngi = _padded_batch(4)
    ei = rng.integers(0, 22, size=(2, 50))
    ei[:, -4:] = 40  # padded edges
    ew = rng.uniform(0.5, 1.5, 50).astype(np.float32)
    idx, valid = jax_topk_fixed(jnp.asarray(ngi), jnp.asarray(x[:, 0]), 4, 3)
    want = jax_subgraph_fixed(jnp.asarray(x), jnp.asarray(ei), jnp.asarray(ew),
                              jnp.asarray(ngi), idx, valid, 4)
    got = induced_subgraph_fixed(torch.as_tensor(x), torch.as_tensor(ei), torch.as_tensor(ew),
                                 torch.as_tensor(ngi), torch.as_tensor(np.array(idx)).long(),
                                 torch.as_tensor(np.array(valid)), 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k,ratio", [(3, None), (16, None), (None, 0.5)])
def test_sort_pool_matches_jax(k, ratio):
    rng = np.random.default_rng(5)
    x, ngi = _padded_batch(5)
    x = np.maximum(x, 0.0)  # relu'd features: ties in the sort column
    ei = rng.integers(0, 22, size=(2, 60))
    if k:  # padded edges (the host-side ratio path takes real edges only)
        ei[:, -4:] = 40
    ew = rng.uniform(0.5, 1.5, 60).astype(np.float32)
    want = jax_sort_pool(jnp.asarray(x), jnp.asarray(ei), jnp.asarray(ew), jnp.asarray(ngi),
                         k=k, ratio=ratio, num_graphs=4 if k else None)
    tx = torch.tensor(x, requires_grad=True)
    got = layers.SortPool(k=k, ratio=ratio, num_graphs=4 if k else None)(
        [tx, torch.as_tensor(ei), torch.as_tensor(ew), torch.as_tensor(ngi)])
    for g, w in zip(got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # the gather carries gradients back to x
    weights = rng.normal(size=tuple(got[0].shape)).astype(np.float32)
    (got[0] * torch.as_tensor(weights)).sum().backward()
    if k:
        want_dx = np.asarray(jax.grad(lambda xx: jnp.sum(jax_sort_pool(
            xx, jnp.asarray(ei), jnp.asarray(ew), jnp.asarray(ngi), k=k,
            num_graphs=4)[0] * weights))(jnp.asarray(x)))
    else:  # the host-side selection is not traceable: scatter the weights by hand
        want_dx = np.zeros_like(x)
        np.add.at(want_dx, jax_topk_pool(ngi, x[:, -1], ratio=ratio), weights)
    np.testing.assert_array_equal(tx.grad.numpy(), want_dx)


class MLP(fnn.Module):
    """benchmarks/graph_classification_throughput.py's MLP (the class name
    names its flax scopes, ``MLP_i``)."""
    units: int

    @fnn.compact
    def __call__(self, h, training=False):
        h = fnn.Dense(self.units)(h)
        return fnn.Dense(self.units)(jax.nn.relu(h))


@pytest.mark.parametrize("train_eps,eps", [(False, 0.0), (False, 0.3), (True, 0.2)])
def test_gin_layer_with_flax_weights(train_eps, eps):
    """The GIN layer with carried MLP weights and ε: output, and the
    gradients of the input, the MLP and a trained ε."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(12, 4)).astype(np.float32)
    ei = rng.integers(0, 12, size=(2, 30))
    ei[:, :3] = 12  # padded edges
    flayer = FlaxGIN(mlp_model=MLP(8), eps=eps, train_eps=train_eps)
    variables = flayer.init(jax.random.PRNGKey(0), [jnp.asarray(x), jnp.asarray(ei)])

    def jax_loss(params, x_):
        return jnp.sum(flayer.apply({"params": params}, [x_, jnp.asarray(ei)]) ** 2)

    want, (want_dp, want_dx) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        variables["params"], jnp.asarray(x))
    tlayer = layers.GIN(bench.GinMlp(4, 8, device="cpu"), eps=eps, train_eps=train_eps,
                        device="cpu")
    mlp = variables["params"]["mlp_model"]
    state = {f"mlp_model.dense{j}.{leaf}": torch.tensor(
        np.asarray(mlp[f"Dense_{j}"][key]).T.copy() if key == "kernel"
        else np.asarray(mlp[f"Dense_{j}"][key]))
        for j in (0, 1) for leaf, key in (("weight", "kernel"), ("bias", "bias"))}
    if train_eps:
        state["eps"] = torch.tensor(np.asarray(variables["params"]["eps"]))
    tlayer.load_state_dict(state)
    tx = torch.tensor(x, requires_grad=True)
    loss = (tlayer([tx, torch.as_tensor(ei)]) ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), **GRAD_TOL)
    dmlp = want_dp["mlp_model"]
    np.testing.assert_allclose(tlayer.mlp_model.dense0.weight.grad.numpy(),
                               np.asarray(dmlp["Dense_0"]["kernel"]).T, **GRAD_TOL)
    np.testing.assert_allclose(tlayer.mlp_model.dense1.bias.grad.numpy(),
                               np.asarray(dmlp["Dense_1"]["bias"]), **GRAD_TOL)
    if train_eps:
        np.testing.assert_allclose(tlayer.eps.grad.numpy(), np.asarray(want_dp["eps"]),
                                   **GRAD_TOL)


# ---------------------------------------------------------------------------
# the executed reference's goldens
# ---------------------------------------------------------------------------

def test_gin_golden_reference():
    inp, out = _golden("gin")

    def mlp(h):
        t = {k: torch.as_tensor(inp[k]) for k in ("w0", "b0", "w1", "b1")}
        return torch.relu(h @ t["w0"] + t["b0"]) @ t["w1"] + t["b1"]

    got = tnn.gin(torch.as_tensor(inp["x"]), torch.as_tensor(inp["ei"]), mlp, eps=0.3)
    np.testing.assert_allclose(got.numpy(), out["out"], **GOLDEN_TOL)


def test_common_pools_golden_reference():
    inp, out = _golden("common_pools")
    x, gi = torch.as_tensor(inp["x"]), torch.as_tensor(inp["ngi"])
    for key in ("mean", "sum", "max", "min"):
        np.testing.assert_allclose(getattr(tnn, key + "_pool")(x, gi).numpy(), out[key],
                                   **GOLDEN_TOL, err_msg=key)


@pytest.mark.parametrize("name,k,ratio", [("topk_pool_k3", 3, None),
                                          ("topk_pool_ratio", None, 0.5)])
def test_topk_pool_golden_reference(name, k, ratio):
    inp, out = _golden(name)
    idx = tnn.topk_pool(torch.as_tensor(inp["ngi"]), torch.as_tensor(inp["score"]), k, ratio)
    np.testing.assert_allclose(np.sort(idx), out["idx"], **GOLDEN_TOL)


def _edges_to_dense(edge_index, edge_weight, num_rows):
    dense = np.zeros((int(num_rows), int(num_rows)), np.float64)
    np.add.at(dense, (edge_index[0], edge_index[1]), np.asarray(edge_weight))
    return dense.astype(np.float32)


def test_sort_pool_golden_reference():
    inp, out = _golden("sort_pool")
    px, pei, pew, pngi = tnn.sort_pool(torch.as_tensor(inp["x"]), torch.as_tensor(inp["ei"]),
                                       torch.as_tensor(inp["ew"]), torch.as_tensor(inp["ngi"]),
                                       ratio=0.5, sort_index=-1)
    np.testing.assert_allclose(px.numpy(), out["px"], **GOLDEN_TOL)
    np.testing.assert_allclose(pngi.astype(np.int32), out["pngi"], **GOLDEN_TOL)
    np.testing.assert_allclose(_edges_to_dense(pei, pew.numpy(), px.shape[0]), out["adj"],
                               **GOLDEN_TOL)


def test_batch_graph_union_golden_reference():
    inp, out = _golden("data_batch_graph_union")
    graphs = [Graph(x=inp[f"x{i}"], edge_index=inp[f"ei{i}"], edge_weight=inp[f"ew{i}"],
                    y=inp[f"y{i}"]) for i in range(3)]
    bg = BatchGraph.from_graphs(graphs)
    got = {"x": bg.x, "ei": bg.edge_index, "ew": bg.edge_weight,
           "ngi": bg.node_graph_index.astype(np.int32), "egi": bg.edge_graph_index.astype(np.int32)}
    for i, g in enumerate(bg.to_graphs()):
        got[f"rx{i}"], got[f"rei{i}"] = g.x, g.edge_index
    assert set(got) == set(out)
    for key in sorted(out):
        np.testing.assert_allclose(np.asarray(got[key]), out[key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# both benchmark models, end to end
# ---------------------------------------------------------------------------

class _FlaxGINSum(fnn.Module):
    num_classes: int
    num_graphs: int

    @fnn.compact
    def __call__(self, x, edge_index, edge_weight, node_graph_index):
        h = x
        for _ in range(bench.GIN_LAYERS):
            h = jax.nn.relu(FlaxGIN(mlp_model=MLP(bench.GIN_UNITS))([h, edge_index]))
        h = jnn.sum_pool(h, node_graph_index, num_graphs=self.num_graphs)
        return fnn.Dense(self.num_classes)(h)


class _FlaxGINSort(fnn.Module):
    num_classes: int
    num_graphs: int

    @fnn.compact
    def __call__(self, x, edge_index, edge_weight, node_graph_index):
        h = x
        for _ in range(bench.GIN_LAYERS):
            h = jax.nn.relu(FlaxGIN(mlp_model=MLP(bench.GIN_UNITS))([h, edge_index]))
        pooled = jax_sort_pool(h, edge_index, edge_weight, node_graph_index,
                               k=bench.GIN_SORT_K, num_graphs=self.num_graphs)
        return fnn.Dense(self.num_classes)(pooled[0].reshape(self.num_graphs, -1))


@pytest.mark.parametrize("readout", ["sum", "sort"])
def test_benchmark_model_step_matches_jax(readout):
    """One step's loss and the gradient of every parameter, the port's
    ``GinClassifier`` with the flax model's weights against the flax model,
    on the benchmark's batch cut to 16 graphs."""
    batch = 16
    pr = bench.build_graph_problem(batch=batch, device="cpu")
    args = [jnp.asarray(t.numpy()) for t in (pr.x, pr.edge_index, pr.edge_weight,
                                             pr.node_graph_index)]
    model = (_FlaxGINSum if readout == "sum" else _FlaxGINSort)(pr.num_classes, batch)
    variables = model.init(jax.random.PRNGKey(0), *args)
    y = jnp.asarray(pr.y.numpy())

    def jax_loss(params):
        logits = model.apply({"params": params}, *args)
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None], 1))

    want, want_grads = jax.value_and_grad(jax_loss)(variables["params"])
    params = {k: v.requires_grad_() for k, v in
              gin_classifier_state_dict_from_flax(variables).items()}
    loss = bench.gin_loss(params, pr, readout)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    want_t = gin_classifier_state_dict_from_flax({"params": want_grads})
    assert set(want_t) == set(params)
    for k in sorted(params):
        np.testing.assert_allclose(params[k].grad.numpy(), want_t[k].numpy(), **GRAD_TOL,
                                   err_msg=k)


def test_benchmark_models_train_and_ask_for_the_card():
    """A few Adam steps lower both losses; the bench's problem and models
    ask for the card by default."""
    pr = bench.build_graph_problem(batch=32, device="cpu")
    for name in bench.GIN_READOUTS:
        wl = bench.WORKLOADS[name]
        step = bench.make_step(lambda p: wl.loss(p, pr), wl.init(pr), wl.lr)
        losses = [float(step()) for _ in range(12)]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], (name, losses)
    assert bench.gin_step_bytes(pr) > 0
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises((AssertionError, RuntimeError)):
        bench.build_graph_problem(batch=4)
    with pytest.raises((AssertionError, RuntimeError)):
        layers.GIN(bench.GinMlp(4, 8, device="cpu"), train_eps=True)
