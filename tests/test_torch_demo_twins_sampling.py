"""The sampling and heterogeneous demo twins
(``tf_geometric_tpu_torch/demos``: ``demo_device_sampling``,
``demo_graph_sage``, ``demo_graph_sage_func``, ``demo_hetero_rgcn``)
against the JAX scripts (``demo/``) on the CPU.

Each JAX script's ``main`` runs for three training steps
(``TFG_DEMO_SMOKE_STEPS``: three steps, or one epoch over the three
training graphs), recorded by ``tests/_jax_demo_capture.py``; the twin's
``main`` then runs from the same weights with the same draws, and the test
holds, within rtol = atol = 1e-4, the eval-mode logits at the initial
weights, the three steps' losses (a 3-step trajectory), every step-1
gradient, and the final metric (test accuracy within one test node,
micro-F1 within 1e-6).

- Device sampling: on a small synthetic citation graph (``load_cora``
  replaced); the numpy-initialized weights bit for bit; JAX's draw integers
  (its ``jax.random.randint`` calls, training and evaluation) handed to the
  twin's steps and evaluations (``draw_fixed_k_from_ints``).
- GraphSAGE (layers and functional): the five synthetic multi-label graphs
  and every host draw bit for bit (the samplers' streams are the JAX
  package's), JAX's dropout masks handed to ``SageNet``, the functional
  demo's numpy init bit for bit.
- Hetero R-GCN: the synthetic academic ``HeteroGraph`` and the numpy init
  bit for bit.
"""
import os
import sys
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._jax_demo_capture import named_grads, record_jax, record_port_adam
from tf_geometric_tpu_torch import convert
from tf_geometric_tpu_torch.datasets.synthetic_citation import synthetic_citation_graph
from tf_geometric_tpu_torch.demos import (demo_device_sampling, demo_graph_sage,
                                          demo_graph_sage_func, demo_hetero_rgcn)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "demo"))

import demo_device_sampling as jdemo_device_sampling  # noqa: E402
import demo_graph_sage as jdemo_graph_sage  # noqa: E402
import demo_graph_sage_func as jdemo_graph_sage_func  # noqa: E402
import demo_hetero_rgcn as jdemo_hetero_rgcn  # noqa: E402

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


def _numpy_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


def _check_grads(got, want):
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), **TOL, err_msg=k)


# ---------------------------------------------------------------------------
# device sampling
# ---------------------------------------------------------------------------

def _jax_fixed_k_logits(jgraph, params, ints, monkeypatch):
    """The JAX demo's forward at ``params`` on the draw of the integers
    ``ints`` (``jax.random.randint`` answering with them in turn)."""
    import jax
    from tf_geometric_tpu.nn import DeviceNeighborSampler, mean_graph_sage_fixed_k
    given = iter(ints)
    with monkeypatch.context() as m:
        m.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(next(given)))
        sampler = DeviceNeighborSampler(jgraph.edge_index, jgraph.edge_weight,
                                        num_nodes=int(jgraph.x.shape[0]))
        (i0, w0), (i1, w1) = (sampler.sample(None, k)
                              for k in jdemo_device_sampling.NUM_SAMPLED_NEIGHBORS)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    h = mean_graph_sage_fixed_k(jnp.asarray(jgraph.x), i0, w0, p["s0"], p["n0"], bias=p["b0"],
                                activation=jax.nn.relu)
    h = mean_graph_sage_fixed_k(h, i1, w1, p["s1"], p["n1"], bias=p["b1"],
                                activation=jax.nn.relu)
    return np.asarray(h @ p["wd"] + p["bd"])


def test_device_sampling_twin_matches_jax_script(monkeypatch):
    from tf_geometric_tpu.datasets.synthetic_citation import \
        synthetic_citation_graph as jsynthetic
    jgraph = jsynthetic(**GRAPH)
    jgraph.convert_data_to_tensor()
    pgraph = synthetic_citation_graph(**GRAPH)
    pgraph.convert_data_to_tensor(device="cpu")
    monkeypatch.setenv("TFG_DEMO_SMOKE_STEPS", str(STEPS))
    rec = record_jax(monkeypatch)
    monkeypatch.setattr(jdemo_device_sampling, "load_cora",
                        lambda: (jgraph, tuple(jnp.asarray(s, jnp.int32) for s in SPLITS)))
    jacc = float(jdemo_device_sampling.main())
    # the draws in call order: step 0 (2), the evaluation at step 0 (2),
    # steps 1 and 2 (2 each), the final evaluation (2, the same key)
    r = rec.randint
    assert len(rec.losses) == STEPS and len(r) == 2 * STEPS + 4
    train_ints, eval_ints = [r[0:2], r[4:6], r[6:8]], r[2:4]
    for a, b in zip(eval_ints, r[8:10]):
        np.testing.assert_array_equal(a, b)
    init = rec.init_params[0]
    assert rec.adam_lr == [demo_device_sampling.LEARNING_RATE]

    seen, adam = {}, record_port_adam(monkeypatch)
    real_build, real_step, real_predict = (demo_device_sampling.build,
                                           demo_device_sampling.train_step,
                                           demo_device_sampling.predict)

    def tensors(pair):
        return [torch.as_tensor(a) for a in pair]

    def build(graph, seed=0, device="cuda"):
        sampler, p, optimizer = real_build(graph, seed, device)
        _numpy_equal({k: v.detach().numpy() for k, v in p.named_parameters()}, init)
        with torch.no_grad():
            seen["logits"] = demo_device_sampling.forward(p, sampler, graph.x,
                                                          ints=tensors(eval_ints)).numpy()
        seen["p"] = p
        return sampler, p, optimizer

    steps = iter(train_ints)
    monkeypatch.setattr(demo_device_sampling, "load_cora",
                        lambda device="cuda": (pgraph, tuple(torch.as_tensor(s) for s in SPLITS)))
    monkeypatch.setattr(demo_device_sampling, "build", build)
    monkeypatch.setattr(demo_device_sampling, "train_step",
                        lambda p, opt, sampler, graph, mask, generator=None:
                        real_step(p, opt, sampler, graph, mask, ints=tensors(next(steps))))
    monkeypatch.setattr(demo_device_sampling, "predict",
                        lambda p, sampler, x: real_predict(p, sampler, x, tensors(eval_ints)))
    stats = {}
    acc = demo_device_sampling.main(device="cpu", stats=stats)
    np.testing.assert_allclose(seen["logits"],
                               _jax_fixed_k_logits(jgraph, init, eval_ints, monkeypatch), **TOL)
    np.testing.assert_allclose(torch.stack(stats["losses"]).numpy(), rec.losses, **TOL)
    _check_grads(named_grads(seen["p"], adam), rec.grads[0])
    assert stats["evals"] == 2
    assert acc == pytest.approx(jacc, abs=1.0 / len(SPLITS[2]) + 1e-6)


# ---------------------------------------------------------------------------
# GraphSAGE on host draws
# ---------------------------------------------------------------------------

def _jax_draws(graph):
    from tf_geometric_tpu.utils.graph_utils import RandomNeighborSampler
    sampler = RandomNeighborSampler(graph.edge_index, rng=0)
    return [sampler.sample(k=k, padding=True) for k in jdemo_graph_sage.NUM_SAMPLED_NEIGHBORS]


def test_graph_sage_graphs_and_draws_bit_for_bit():
    want = jdemo_graph_sage.load_graphs()
    got = demo_graph_sage.load_graphs()
    for gs, jgs in zip(got, want):
        assert len(gs) == len(jgs)
        for g, jg in zip(gs, jgs):
            for f in ("x", "edge_index", "y"):
                np.testing.assert_array_equal(np.asarray(getattr(g, f)),
                                              np.asarray(getattr(jg, f)), err_msg=f)
    # two successive draws of a graph's sampler, as the JAX sampler's
    from tf_geometric_tpu.utils.graph_utils import RandomNeighborSampler
    graph = got[2][0]
    demo_graph_sage.attach_samplers([graph])
    jsampler = RandomNeighborSampler(graph.edge_index, rng=0)
    for _ in range(2):
        for k, (ei, ew) in zip(jdemo_graph_sage.NUM_SAMPLED_NEIGHBORS,
                               demo_graph_sage.sample_edges(graph, "cpu")):
            jei, jew = jsampler.sample(k=k, padding=True)
            np.testing.assert_array_equal(ei.numpy(), np.asarray(jei))
            np.testing.assert_array_equal(ew.numpy(), np.asarray(jew))


def test_graph_sage_twin_matches_jax_script(monkeypatch):
    monkeypatch.setenv("TFG_DEMO_SMOKE_STEPS", "1")  # one epoch: three steps
    rec = record_jax(monkeypatch)
    jf1 = float(jdemo_graph_sage.main())
    assert len(rec.losses) == STEPS and len(rec.bernoulli) == STEPS
    init = rec.init_params[0]
    state = convert.pool_model_state_dict_from_flax({"params": init})

    seen, adam = {}, record_port_adam(monkeypatch)
    real_cls, masks = demo_graph_sage.SageNet, iter(rec.bernoulli)

    def make(in_features, num_classes, seed=0, device="cuda"):
        net = real_cls(in_features, num_classes, seed, device)
        net.load_state_dict(state)
        forward = net.forward

        def fed(x, edge_lists, keep_mask=None):
            return forward(x, edge_lists, torch.as_tensor(next(masks)) if net.training else None)
        net.forward = fed
        seen["net"] = net
        return net

    monkeypatch.setattr(demo_graph_sage, "SageNet", make)
    stats = {}
    f1 = demo_graph_sage.main(device="cpu", stats=stats)
    np.testing.assert_allclose(torch.stack(stats["losses"]).numpy(), rec.losses, **TOL)
    _check_grads(named_grads(seen["net"], adam),
                 convert.pool_model_state_dict_from_flax({"params": rec.grads[0]}))
    assert f1 == pytest.approx(jf1, abs=1e-6)

    # eval-mode logits at the initial weights on one test-graph draw
    graph = demo_graph_sage.load_graphs()[2][0]
    draws = _jax_draws(graph)
    jlogits = jdemo_graph_sage.SageNet(num_classes=8).apply(
        {"params": init}, jnp.asarray(graph.x),
        tuple(tuple(jnp.asarray(a) for a in d) for d in draws))
    net = real_cls(graph.x.shape[1], 8, device="cpu").eval()
    net.load_state_dict(state)
    with torch.no_grad():
        got = net(torch.as_tensor(graph.x), [tuple(torch.as_tensor(a) for a in d)
                                             for d in draws])
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits), **TOL)


def test_graph_sage_func_twin_matches_jax_script(monkeypatch):
    monkeypatch.setenv("TFG_DEMO_SMOKE_STEPS", "1")
    rec = record_jax(monkeypatch)
    jf1 = float(jdemo_graph_sage_func.main())
    assert len(rec.losses) == STEPS
    init = rec.init_params[0]

    seen, adam = {}, record_port_adam(monkeypatch)
    real_cls = demo_graph_sage_func.SageParams

    def make(*args, **kwargs):
        seen["p"] = p = real_cls(*args, **kwargs)
        _numpy_equal({k: v.detach().numpy() for k, v in p.named_parameters()}, init)
        return p

    monkeypatch.setattr(demo_graph_sage_func, "SageParams", make)
    stats = {}
    f1 = demo_graph_sage_func.main(device="cpu", stats=stats)
    np.testing.assert_allclose(torch.stack(stats["losses"]).numpy(), rec.losses, **TOL)
    _check_grads(named_grads(seen["p"], adam), rec.grads[0])
    assert f1 == pytest.approx(jf1, abs=1e-6)

    # the functional forward at the initial weights on one test-graph draw
    import jax
    from tf_geometric_tpu.nn import mean_graph_sage
    graph = demo_graph_sage.load_graphs()[2][0]
    (ei0, ew0), (ei1, ew1) = _jax_draws(graph)
    p = {k: jnp.asarray(v) for k, v in init.items()}
    h = mean_graph_sage(jnp.asarray(graph.x), ei0, ew0, p["sage0_self"], p["sage0_neigh"],
                        activation=jax.nn.relu)
    h = mean_graph_sage(h, ei1, ew1, p["sage1_self"], p["sage1_neigh"], activation=jax.nn.relu)
    want = np.asarray(h @ p["fc_w"] + p["fc_b"])
    fresh = real_cls(graph.x.shape[1], 8, device="cpu")
    with torch.no_grad():
        got = demo_graph_sage_func.forward(fresh, torch.as_tensor(graph.x), [
            (torch.as_tensor(ei0), torch.as_tensor(ew0)),
            (torch.as_tensor(ei1), torch.as_tensor(ew1))])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# hetero R-GCN
# ---------------------------------------------------------------------------

def test_hetero_synthetic_graph_bit_for_bit():
    hg, target, splits = demo_hetero_rgcn.load_data()
    jhg, jtarget, jsplits = jdemo_hetero_rgcn.load_data()
    assert target == jtarget == "paper"
    assert hg.node_types == list(jhg.node_types) and hg.edge_types == list(jhg.edge_types)
    for t in hg.node_types:
        np.testing.assert_array_equal(hg.x_dict[t], np.asarray(jhg.x_dict[t]))
    for t in hg.edge_types:
        np.testing.assert_array_equal(hg.edge_index_dict[t], np.asarray(jhg.edge_index_dict[t]))
    np.testing.assert_array_equal(hg.y_dict[target], np.asarray(jhg.y_dict[target]))
    for s, js in zip(splits, jsplits):
        np.testing.assert_array_equal(s, js)


def test_hetero_twin_matches_jax_script(monkeypatch):
    monkeypatch.setenv("TFG_DEMO_SMOKE_STEPS", str(STEPS))
    rec = record_jax(monkeypatch)
    jacc = float(jdemo_hetero_rgcn.main())
    assert len(rec.losses) == STEPS and rec.adam_lr == [demo_hetero_rgcn.LEARNING_RATE]
    init = rec.init_params[0]

    seen, adam = {}, record_port_adam(monkeypatch)
    real_cls = demo_hetero_rgcn.HeteroParams

    def make(*args, **kwargs):
        seen["p"] = p = real_cls(*args, **kwargs)
        _numpy_equal({k: v.detach().numpy() for k, v in p.params.items()}, init)
        return p

    monkeypatch.setattr(demo_hetero_rgcn, "HeteroParams", make)
    stats = {}
    acc = demo_hetero_rgcn.main(device="cpu", stats=stats)
    np.testing.assert_allclose(torch.stack(stats["losses"]).numpy(), rec.losses, **TOL)
    _check_grads(named_grads(seen["p"], adam),
                 convert.numpy_params_state_dict(rec.grads[0], "params."))
    assert acc == pytest.approx(jacc, abs=1e-6)

    # the logits at the initial weights against the JAX layers'
    hg, target, splits = jdemo_hetero_rgcn.load_data()
    num_nodes = {t: hg.num_nodes_of(t) for t in hg.node_types}
    ei = {t: np.asarray(v, np.int64) for t, v in hg.edge_index_dict.items()}
    x = {t: jnp.asarray(np.asarray(hg.x_dict[t], np.float32)) for t in hg.node_types}
    p = {k: jnp.asarray(v) for k, v in init.items()}
    h = jdemo_hetero_rgcn.hetero_gcn_layer(p, x, ei, num_nodes, "l0")
    h = jdemo_hetero_rgcn.hetero_gcn_layer(p, h, ei, num_nodes, "l1")
    want = np.asarray(h[target] @ p["head"])
    problem = demo_hetero_rgcn.HeteroProblem(*demo_hetero_rgcn.load_data(), device="cpu")
    fresh = real_cls(demo_hetero_rgcn.load_data()[0], problem.num_classes, device="cpu")
    with torch.no_grad():
        got = demo_hetero_rgcn.forward(fresh, problem)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
