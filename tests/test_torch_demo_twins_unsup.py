"""The unsupervised and link-prediction demo twins
(``tf_geometric_tpu_torch/demos``: ``demo_gae``, ``demo_dgi``) against the
JAX scripts (``demo/demo_gae.py``, ``demo_dgi.py``) on the CPU.

Each JAX script's ``main`` runs on a small synthetic citation graph (300
nodes, 50 features, 4 classes; ``load_cora`` replaced) for three steps
(``TFG_DEMO_SMOKE_STEPS``), recorded by ``tests/_jax_demo_capture.py``:
its initial weights, dropout masks (GAE), permutations (DGI), losses and
gradients. The twin's ``main`` then runs on the same graph from those
weights with those draws, and the test holds, within rtol = atol = 1e-4:
the eval-mode embeddings at the initial weights, the three steps' losses
(a 3-step trajectory), every step-1 gradient; and the final metric (the
GAE's test AUC within 1e-3, DGI's logistic-regression accuracy within
0.01). Also bit for bit: the GAE's split, test negatives, per-step
negatives and directed train graph. And DGI's own logistic regression
against scikit-learn's on the same embeddings: at least 99% of the test
predictions equal, the accuracy within 0.01.
"""
import os
import sys
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._jax_demo_capture import named_grads, record_jax, record_port_adam
from tf_geometric_tpu_torch import bench, convert
from tf_geometric_tpu_torch.datasets.synthetic_citation import synthetic_citation_graph
from tf_geometric_tpu_torch.demos import demo_dgi, demo_gae

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "demo"))

import demo_dgi as jdemo_dgi  # noqa: E402
import demo_gae as jdemo_gae  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 3
GRAPH = dict(num_nodes=300, num_features=50, num_classes=4, seed=3)
SPLITS = (np.arange(0, 40), np.arange(40, 100), np.arange(100, 300))


@pytest.fixture(autouse=True)
def offline(tmp_path, monkeypatch):
    monkeypatch.setenv("TFG_TPU_DATA_ROOT", str(tmp_path))
    for var in ("TFG_HARD_PROTOCOL", "TFG_HARD_SEED", "BENCH_DATASET", "TFG_DEMO_SMOKE_STEPS"):
        monkeypatch.delenv(var, raising=False)

    def no_download(*args, **kwargs):
        raise OSError("no download in the tests")

    import tf_geometric_tpu.data.dataset as jdataset
    monkeypatch.setattr(jdataset, "download_file", no_download)
    monkeypatch.setattr(urllib.request, "urlopen", no_download)


def _graphs():
    from tf_geometric_tpu.datasets.synthetic_citation import \
        synthetic_citation_graph as jsynthetic
    jgraph = jsynthetic(**GRAPH)
    jgraph.convert_data_to_tensor()
    pgraph = synthetic_citation_graph(**GRAPH)
    pgraph.convert_data_to_tensor(device="cpu")
    return ((jgraph, tuple(jnp.asarray(s, jnp.int32) for s in SPLITS)),
            (pgraph, tuple(torch.as_tensor(s) for s in SPLITS)))


def _jax_train_graph(jgraph):
    """The JAX demo's set-up: the split, the test negatives and the directed
    train graph."""
    from tf_geometric_tpu.data.graph import Graph as JGraph
    from tf_geometric_tpu.utils.graph_utils import edge_train_test_split, negative_sampling
    edge_index = np.asarray(jgraph.edge_index)
    train, test, _, _ = edge_train_test_split(edge_index, test_size=0.15, random_state=0)
    test_neg = negative_sampling(test.shape[1], jgraph.num_nodes, edge_index=edge_index,
                                 replace=False, rng=0)
    directed = JGraph(x=np.asarray(jgraph.x), edge_index=train).to_directed()
    return train, test, test_neg, directed


def _check_grads(got, want):
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), **TOL, err_msg=k)


def test_gae_host_data_bit_for_bit():
    (jgraph, _), (pgraph, _) = _graphs()
    train, test, test_neg, directed = _jax_train_graph(jgraph)
    problem = bench.gae_problem(pgraph.x.numpy(), pgraph.edge_index.numpy(), device="cpu")
    np.testing.assert_array_equal(problem.train_index, train)
    np.testing.assert_array_equal(problem.test_index, test)
    np.testing.assert_array_equal(problem.test_neg, test_neg)
    np.testing.assert_array_equal(problem.edge_index.numpy(), np.asarray(directed.edge_index))
    np.testing.assert_array_equal(problem.edge_weight.numpy(), np.asarray(directed.edge_weight))
    from tf_geometric_tpu.utils.graph_utils import negative_sampling
    for step in range(STEPS):
        np.testing.assert_array_equal(
            bench.gae_negatives(problem, step),
            negative_sampling(train.shape[1], jgraph.num_nodes, edge_index=train, rng=step))


def test_gae_twin_matches_jax_script(monkeypatch):
    jdata, pdata = _graphs()
    monkeypatch.setenv("TFG_DEMO_SMOKE_STEPS", str(STEPS))
    rec = record_jax(monkeypatch)
    monkeypatch.setattr(jdemo_gae, "load_cora", lambda: jdata)
    jauc = float(jdemo_gae.main())
    assert len(rec.losses) == STEPS and len(rec.bernoulli) == STEPS
    init = rec.init_params[0]
    _, _, _, directed = _jax_train_graph(jdata[0])
    jz = jdemo_gae.GAEEncoder().apply({"params": init}, jnp.asarray(directed.x),
                                      jnp.asarray(directed.edge_index),
                                      jnp.asarray(directed.edge_weight))

    seen, adam = {}, record_port_adam(monkeypatch)
    real_build, real_step = demo_gae.build_model, demo_gae.train_step

    def build(problem, seed=0):
        model, optimizer = real_build(problem, seed)
        model.load_state_dict(convert.gae_encoder_state_dict_from_flax({"params": init}))
        model.eval()
        with torch.no_grad():
            seen["z"] = model(problem.x, problem.edge_index, problem.edge_weight).numpy()
        seen["model"] = model
        return model, optimizer

    masks = iter(rec.bernoulli)

    def step(model, optimizer, problem, i, keep_mask=None, negatives=None):
        return real_step(model, optimizer, problem, i, torch.as_tensor(next(masks)))

    monkeypatch.setattr(demo_gae, "load_cora", lambda device="cuda": pdata)
    monkeypatch.setattr(demo_gae, "build_model", build)
    monkeypatch.setattr(demo_gae, "train_step", step)
    stats = {}
    auc = demo_gae.main(device="cpu", stats=stats)
    np.testing.assert_allclose(seen["z"], np.asarray(jz), **TOL)
    np.testing.assert_allclose(torch.stack(stats["losses"]).numpy(), rec.losses, **TOL)
    _check_grads(named_grads(seen["model"], adam),
                 convert.gae_encoder_state_dict_from_flax({"params": rec.grads[0]}))
    assert auc == pytest.approx(jauc, abs=1e-3)


def test_dgi_twin_matches_jax_script(monkeypatch):
    jdata, pdata = _graphs()
    monkeypatch.setenv("TFG_DEMO_SMOKE_STEPS", str(STEPS))
    rec = record_jax(monkeypatch)
    monkeypatch.setattr(jdemo_dgi, "load_cora", lambda: jdata)
    jacc = float(jdemo_dgi.main())
    assert len(rec.losses) == STEPS and len(rec.permutation) == STEPS
    assert rec.adam_lr == [demo_dgi.LEARNING_RATE]
    init = rec.init_params[0]
    jgraph = jdata[0]
    jh = jdemo_dgi.DGIEncoder().apply({"params": init["enc"]}, jnp.asarray(jgraph.x),
                                      jnp.asarray(jgraph.edge_index),
                                      jnp.asarray(jgraph.edge_weight))

    seen, adam = {}, record_port_adam(monkeypatch)
    real_build, real_step = demo_dgi.build_model, demo_dgi.train_step

    def build(in_features, seed=0, device="cuda"):
        model, optimizer = real_build(in_features, seed, device)
        model.load_state_dict(convert.dgi_state_dict_from_flax(init["enc"], init["disc"]))
        seen["h"], seen["model"] = demo_dgi.embed(model, pdata[0]).numpy(), model
        return model, optimizer

    perms = iter(rec.permutation)

    def step(model, optimizer, graph, generator=None, perm=None):
        return real_step(model, optimizer, graph, perm=torch.as_tensor(next(perms)).long())

    monkeypatch.setattr(demo_dgi, "load_cora", lambda device="cuda": pdata)
    monkeypatch.setattr(demo_dgi, "build_model", build)
    monkeypatch.setattr(demo_dgi, "train_step", step)
    stats = {}
    acc = demo_dgi.main(device="cpu", stats=stats)
    np.testing.assert_allclose(seen["h"], np.asarray(jh), **TOL)
    np.testing.assert_allclose(torch.stack(stats["losses"]).numpy(), rec.losses, **TOL)
    want = convert.dgi_state_dict_from_flax(rec.grads[0]["enc"], rec.grads[0]["disc"])
    _check_grads(named_grads(seen["model"], adam), want)
    assert acc == pytest.approx(jacc, abs=0.01)


def test_dgi_logistic_regression_matches_sklearn():
    """On the DGI encoder's embeddings of the Cora-shaped synthetic set (at
    its initial weights), the twin's logistic regression predicts as
    scikit-learn's ``LogisticRegression(max_iter=500)``."""
    from sklearn.linear_model import LogisticRegression
    from tf_geometric_tpu_torch.datasets.synthetic_citation import FakePlanetoidDataset
    graph, (train, _, test) = FakePlanetoidDataset("cora").load_data()
    graph.convert_data_to_tensor(device="cpu")
    model, _ = demo_dgi.build_model(graph.num_features, 0, "cpu")
    h = demo_dgi.embed(model, graph).numpy()
    y = graph.y.numpy()
    train, test = np.asarray(train), np.asarray(test)
    clf = LogisticRegression(max_iter=500).fit(h[train], y[train])
    want = clf.predict(h[test])
    got = demo_dgi._logistic_regression(torch.as_tensor(h[train]), torch.as_tensor(y[train]),
                                        torch.as_tensor(h[test])).numpy()
    assert (got == want).mean() >= 0.99
    assert abs((got == y[test]).mean() - (want == y[test]).mean()) <= 0.01
    # two classes take scikit-learn's single logistic vector
    two = y[train] < 2
    clf2 = LogisticRegression(max_iter=500).fit(h[train][two], y[train][two])
    got2 = demo_dgi._logistic_regression(torch.as_tensor(h[train][two]),
                                         torch.as_tensor(y[train][two]),
                                         torch.as_tensor(h[test])).numpy()
    assert (got2 == clf2.predict(h[test])).mean() >= 0.99
