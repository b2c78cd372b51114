"""The port's demo twins (``tf_geometric_tpu_torch/demos``) against the JAX
demos (``demo/demo_utils.py``, ``demo_gcn.py``, ``demo_gat.py``) on the CPU.

- The training loop: both ``train_node_classifier``s on a model whose
  logits are its parameters (``kernel`` [N, C], so the L2 applies), 60
  steps, patience 5, ``eval_every`` 2, no dropout: the same early-stop step
  and the same test accuracy at the best validation point.
- The GCN and GAT demo models on a Cora-shaped ``HardCitationDataset`` with
  the flax weights carried across (``convert.gcn_state_dict_from_flax`` /
  ``gat_state_dict_from_flax``): three Adam steps, each loss and the step-1
  gradients within rtol = atol = 1e-4, at dropout rate 0 and with the keep
  masks JAX draws (recorded from its ``bernoulli`` calls and handed to the
  port; the GAT's attention mask permuted into the cached layout's edge
  order).
- The graph-classification loop: both ``run_graph_classification``s on a
  GCN, mean-pool and dense model with the flax weights carried across, on
  the synthetic fallback set with its default 90/10 split: each step's
  loss within 1e-4 and the same test accuracy.
- ``load_planetoid`` (files on disk, the hard protocol, the fallback), the
  GCN demo's own ``load_cora``, ``load_graph_classification_data`` on TU
  files and its synthetic fallback, ``train_test_split`` against
  scikit-learn's, and the ``main``s run on the CPU.

Every test points ``TFG_TPU_DATA_ROOT`` at ``tmp_path`` and makes the JAX
package's download raise, so a JAX loader without its files falls back as
it does offline and nothing is fetched.
"""
import inspect
import os
import re
import sys
import urllib.request

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "demo"))

import demo_gat as jdemo_gat  # noqa: E402
import demo_gcn as jdemo_gcn  # noqa: E402
import demo_utils as jdemo_utils  # noqa: E402
from tests.test_datasets import _write_planetoid_fixture, _write_tu_fixture  # noqa: E402
from tf_geometric_tpu.datasets.synthetic_citation import \
    HardCitationDataset as JHardCitationDataset  # noqa: E402
from tf_geometric_tpu.layers.conv.gcn import GCN as JGCN  # noqa: E402
from tf_geometric_tpu.nn import mean_pool as jmean_pool  # noqa: E402
from tf_geometric_tpu_torch import convert  # noqa: E402
from tf_geometric_tpu_torch.datasets.synthetic_citation import (  # noqa: E402
    FakePlanetoidDataset, HardCitationDataset)
from tf_geometric_tpu_torch.demos import demo_gat, demo_gcn, demo_utils  # noqa: E402
from tf_geometric_tpu_torch.layers import GCN  # noqa: E402
from tf_geometric_tpu_torch.nn import mean_pool  # noqa: E402
from tf_geometric_tpu_torch.utils.graph_utils import add_self_loop_edge  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def data_root(tmp_path, monkeypatch):
    monkeypatch.setenv("TFG_TPU_DATA_ROOT", str(tmp_path))
    for var in ("TFG_HARD_PROTOCOL", "TFG_HARD_SEED", "BENCH_DATASET", "TFG_DEMO_SMOKE_STEPS",
                "TFG_ADAM_EPS", "TFG_HARD_MODEL", "TFG_HARD_GRAPH_CLS"):
        monkeypatch.delenv(var, raising=False)

    def no_download(*args, **kwargs):
        raise OSError("no download in the tests")

    import tf_geometric_tpu.data.dataset as jdataset
    monkeypatch.setattr(jdataset, "download_file", no_download)
    monkeypatch.setattr(urllib.request, "urlopen", no_download)
    return str(tmp_path)


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

def _loop_problem(n=120, c=4, seed=0):
    """Logits that are parameters: the training nodes' rows random, the
    validation and test rows leaning towards their labels with noise, so
    the L2 shrinkage moves their accuracy and loss."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n).astype(np.int32)
    w = rng.normal(size=(n, c)).astype(np.float32)
    w[40:] += 1.5 * np.eye(c, dtype=np.float32)[y[40:]]
    splits = (np.arange(0, 40), np.arange(40, 80), np.arange(80, n))
    return w, y, splits


class _LogitParams(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.kernel = torch.nn.Parameter(torch.tensor(w))


def _stop_lines(text):
    return [ln for ln in text.splitlines() if re.match(r"(early stop|best valid)", ln)]


@pytest.mark.parametrize("seed", [0, 1])
def test_train_loop_early_stop_matches_jax(seed, capsys):
    w, y, splits = _loop_problem(seed=seed)
    kwargs = dict(num_steps=60, learning_rate=5e-2, l2_coef=5e-2, patience=5, eval_every=2,
                  log_every=1000, seed=seed)
    want = jdemo_utils.train_node_classifier(
        lambda p, training, key: p["kernel"], {"kernel": jnp.asarray(w)}, jnp.asarray(y),
        tuple(jnp.asarray(s, jnp.int32) for s in splits), **kwargs)
    want_lines = _stop_lines(capsys.readouterr().out)
    module = _LogitParams(w)
    stats = {}
    got = demo_utils.train_node_classifier(
        lambda training, generator: module.kernel, module, torch.as_tensor(y),
        tuple(torch.as_tensor(s) for s in splits), stats=stats, **kwargs)
    got_lines = _stop_lines(capsys.readouterr().out)
    assert got_lines == want_lines
    assert any(ln.startswith("early stop") for ln in got_lines)
    assert got == pytest.approx(float(want), abs=1e-7)
    assert stats["stop_step"] == int(re.search(r"step (\d+)", got_lines[0]).group(1))
    assert stats["steps"] == stats["stop_step"] + 1 == len(stats["losses"])


def test_train_loop_without_patience_returns_final_test_accuracy():
    w, y, splits = _loop_problem()
    kwargs = dict(num_steps=7, learning_rate=5e-2, l2_coef=5e-2, log_every=3)
    want = jdemo_utils.train_node_classifier(
        lambda p, training, key: p["kernel"], {"kernel": jnp.asarray(w)}, jnp.asarray(y),
        tuple(jnp.asarray(s, jnp.int32) for s in splits), **kwargs)
    module = _LogitParams(w)
    got = demo_utils.train_node_classifier(
        lambda training, generator: module.kernel, module, torch.as_tensor(y),
        tuple(torch.as_tensor(s) for s in splits), **kwargs)
    assert got == pytest.approx(float(want), abs=1e-7)


def test_demo_steps_cap(monkeypatch):
    monkeypatch.setenv("TFG_DEMO_SMOKE_STEPS", "3")
    assert demo_utils.demo_steps(200) == jdemo_utils.demo_steps(200) == 3
    monkeypatch.delenv("TFG_DEMO_SMOKE_STEPS")
    assert demo_utils.demo_steps(200) == jdemo_utils.demo_steps(200) == 200


def test_masked_softmax_loss_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(10, 3)).astype(np.float32)
    y = rng.integers(0, 3, 10).astype(np.int32)
    params = {"Dense_0": {"kernel": rng.normal(size=(4, 3)).astype(np.float32),
                          "bias": rng.normal(size=3).astype(np.float32)}}
    idx = np.array([0, 2, 5, 7])
    want = jdemo_utils.masked_softmax_loss(jax.tree_util.tree_map(jnp.asarray, params),
                                           jnp.asarray(logits), jnp.asarray(y),
                                           jnp.asarray(idx), 5e-3)
    flat = {f"Dense_0.{k}": torch.tensor(v) for k, v in params["Dense_0"].items()}
    got = demo_utils.masked_softmax_loss(flat, torch.tensor(logits), torch.tensor(y),
                                         torch.tensor(idx), 5e-3)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# the GCN and GAT demo models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cora_hard():
    graph, splits = JHardCitationDataset("cora", seed=0).load_data()
    return graph, splits


class _Recorder:
    """``jax.random.bernoulli`` recording the masks it draws, in call order."""

    def __init__(self):
        self.real = jax.random.bernoulli
        self.masks = []

    def __call__(self, key, p=0.5, shape=None):
        mask = self.real(key, p, shape)
        self.masks.append(np.array(mask))
        return mask


def _flax_params(model, args, kwargs):
    key = jax.random.PRNGKey(0)
    return model.init({"params": key, "dropout": key}, *args, **kwargs)["params"]


def _run_both(jax_model, jax_args, jax_kwargs, port_model, port_call, masks_for_port, y, train,
              lr, num_masks, monkeypatch):
    """Three Adam steps on both sides from the same weights; returns the
    losses and the step-1 gradients of each."""
    recorder = _Recorder()
    monkeypatch.setattr(jax.random, "bernoulli", recorder)
    params = _flax_params(jax_model, jax_args, jax_kwargs)
    port_model.load_state_dict(convert.gcn_state_dict_from_flax({"params": params}))
    jy, jtrain = jnp.asarray(y), jnp.asarray(train, jnp.int32)
    ty, ttrain = torch.as_tensor(y).long(), torch.as_tensor(np.asarray(train, np.int64))
    opt = optax.adam(lr)
    opt_state = opt.init(params)
    topt = torch.optim.Adam(port_model.parameters(), lr=lr)
    port_model.train()
    out = {"jax": [], "port": [], "jax_grads": None, "port_grads": None}
    for step in range(3):
        recorder.masks.clear()

        def loss_fn(p):
            logits = jax_model.apply({"params": p}, *jax_args, **jax_kwargs, training=True,
                                     rngs={"dropout": jax.random.PRNGKey(10 + step)})
            return jdemo_utils.masked_softmax_loss(p, logits, jy, jtrain, 5e-4)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        assert len(recorder.masks) == num_masks
        topt.zero_grad()
        logits = port_call(masks_for_port(recorder.masks) if num_masks else None)
        tloss = demo_utils.masked_softmax_loss(port_model, logits, ty, ttrain, 5e-4)
        tloss.backward()
        if step == 0:
            out["jax_grads"] = convert.gcn_state_dict_from_flax({"params": grads})
            out["port_grads"] = {k: p.grad.clone() for k, p in port_model.named_parameters()}
        topt.step()
        out["jax"].append(float(loss))
        out["port"].append(float(tloss.detach()))
    return out


def _check(out):
    np.testing.assert_allclose(out["port"], out["jax"], **TOL)
    assert sorted(out["port_grads"]) == sorted(out["jax_grads"])
    for k, g in out["port_grads"].items():
        np.testing.assert_allclose(g.numpy(), out["jax_grads"][k].numpy(), **TOL, err_msg=k)


@pytest.mark.parametrize("dropping", [False, True])
def test_gcn_demo_model_matches_jax(cora_hard, dropping, monkeypatch):
    jgraph, (train, _, _) = cora_hard
    rate = jdemo_gcn.DROP_RATE if dropping else 0.0
    monkeypatch.setattr(jdemo_gcn, "DROP_RATE", rate)
    x, ei = np.asarray(jgraph.x), np.asarray(jgraph.edge_index)
    n, c = x.shape[0], int(np.max(jgraph.y)) + 1
    jgraph.cache = {}
    JGCN(units=16).build_cache_for_graph(jgraph)
    jmodel = jdemo_gcn.GCNModel(num_classes=c)
    jargs = (jnp.asarray(x), jgraph.adj())
    port_graph = HardCitationDataset("cora", seed=0).load_data()[0]
    port_graph.convert_data_to_tensor(device="cpu")
    model, adj, cache = demo_gcn.build_model(port_graph, c, device="cpu")
    model.drop_rate = rate
    _check(_run_both(
        jmodel, jargs, dict(cache=jgraph.cache), model,
        lambda masks: model(port_graph.x, adj, cache, keep_masks=masks or (None, None)),
        lambda masks: (torch.as_tensor(masks[0]), torch.as_tensor(masks[1])),
        jgraph.y, train, demo_gcn.LEARNING_RATE, 2 if dropping else 0, monkeypatch))
    assert n == 2708 and ei.shape[0] == 2


@pytest.mark.parametrize("dropping", [False, True])
def test_gat_demo_model_matches_jax(cora_hard, dropping, monkeypatch):
    jgraph, (train, _, _) = cora_hard
    rate = jdemo_gat.DROP_RATE if dropping else 0.0
    monkeypatch.setattr(jdemo_gat, "DROP_RATE", rate)
    x, ei = np.asarray(jgraph.x), np.asarray(jgraph.edge_index)
    n, c = x.shape[0], int(np.max(jgraph.y)) + 1
    jmodel = jdemo_gat.GATModel(num_classes=c)
    port_graph = HardCitationDataset("cora", seed=0).load_data()[0]
    port_graph.convert_data_to_tensor(device="cpu")
    model, cache = demo_gat.build_model(port_graph, c, device="cpu")
    model.drop_rate = model.GAT_0.edge_drop_rate = rate
    # JAX draws the attention mask over the self-looped edge list as given;
    # the port's cached layout sorts it by destination (stable)
    ei_sl, _ = add_self_loop_edge(ei, n)
    order = np.argsort(np.asarray(ei_sl)[0], kind="stable")

    def masks_for_port(masks):
        keep = masks[1].astype(np.float32)[order] / (1.0 - rate)
        return torch.as_tensor(masks[0]), torch.as_tensor(keep), torch.as_tensor(masks[2])

    _check(_run_both(
        jmodel, (jnp.asarray(x), jnp.asarray(ei)), {}, model,
        lambda masks: model(port_graph.x, port_graph.edge_index, cache,
                            keep_masks=masks or (None, None, None)),
        masks_for_port, jgraph.y, train, demo_gat.LEARNING_RATE, 3 if dropping else 0,
        monkeypatch))
    assert f"gat_edges_{n}" in cache


# ---------------------------------------------------------------------------
# loaders and the mains
# ---------------------------------------------------------------------------

def _assert_same_load(got, want):
    (graph, splits), (jgraph, jsplits) = got, want
    for f in ("x", "edge_index", "edge_weight", "y"):
        np.testing.assert_array_equal(getattr(graph, f).numpy(), np.asarray(getattr(jgraph, f)))
    for s, js in zip(splits, jsplits):
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_load_planetoid_reads_files_as_jax(data_root):
    _write_planetoid_fixture(data_root, "citeseer")
    got = demo_utils.load_planetoid("citeseer", device="cpu")
    assert got[0].x.shape == (8, 6) and got[0].x.device.type == "cpu"
    _assert_same_load(got, jdemo_utils.load_planetoid("citeseer"))


def test_load_cora_hard_protocol_matches_jax(monkeypatch):
    monkeypatch.setenv("TFG_HARD_PROTOCOL", "1")
    monkeypatch.setenv("TFG_HARD_SEED", "2")
    monkeypatch.setenv("BENCH_DATASET", "citeseer")
    _assert_same_load(demo_utils.load_cora(device="cpu"), jdemo_utils.load_cora())


def test_load_planetoid_falls_back_without_files(capsys):
    graph, splits = demo_utils.load_planetoid("cora", device="cpu")
    assert "synthetic cora-shaped" in capsys.readouterr().out
    want, want_splits = FakePlanetoidDataset("cora").load_data()
    np.testing.assert_array_equal(graph.x.numpy(), want.x)
    np.testing.assert_array_equal(splits[2].numpy(), np.asarray(want_splits[2]))


def test_load_graph_classification_data_matches_jax(data_root):
    _write_tu_fixture(data_root, "FAKETU")
    graphs, num_classes = demo_utils.load_graph_classification_data("FAKETU")
    jgraphs, jnum_classes = jdemo_utils.load_graph_classification_data("FAKETU")
    assert num_classes == jnum_classes == 2 and len(graphs) == len(jgraphs) == 2
    for g, jg in zip(graphs, jgraphs):
        for f in ("x", "edge_index", "y"):
            np.testing.assert_array_equal(np.asarray(getattr(g, f)), np.asarray(getattr(jg, f)))


def test_train_test_split_matches_sklearn():
    from sklearn.model_selection import train_test_split
    items = list(range(37))
    assert demo_utils.train_test_split(items, 0.1, 0) == tuple(
        train_test_split(items, test_size=0.1, random_state=0))


def test_load_cora_of_the_gcn_demo_matches_jax(monkeypatch):
    # the GCN demo's own loader reads Cora whatever the environment says
    monkeypatch.setenv("TFG_HARD_PROTOCOL", "1")
    monkeypatch.setenv("BENCH_DATASET", "citeseer")
    _assert_same_load(demo_gcn.load_cora(device="cpu"), jdemo_gcn.load_cora())


def test_demo_mains_default_to_the_jax_steps():
    assert (inspect.signature(demo_gcn.main).parameters["num_steps"].default
            == inspect.signature(jdemo_gcn.main).parameters["num_steps"].default == 201)


def _assert_same_graphs(got, want):
    (graphs, num_classes), (jgraphs, jnum_classes) = got, want
    assert num_classes == jnum_classes and len(graphs) == len(jgraphs)
    for g, jg in zip(graphs, jgraphs):
        for f in ("x", "edge_index", "edge_weight", "y"):
            a, b = np.asarray(getattr(g, f)), np.asarray(getattr(jg, f))
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("seed", [0, 5])
def test_load_graph_classification_fallback_matches_jax(seed, capsys):
    got = demo_utils.load_graph_classification_data("MISSING", seed=seed)
    want = jdemo_utils.load_graph_classification_data("MISSING", seed=seed)
    out = capsys.readouterr().out
    assert "unavailable" in out and out.count("unavailable") == 2
    _assert_same_graphs(got, want)
    assert len(got[0]) == 600


GC_BATCH, GC_UNITS, GC_STEPS = 16, 8, 6


class _JaxMeanPoolNet(fnn.Module):
    num_classes: int
    num_graphs: int

    @fnn.compact
    def __call__(self, x, edge_index, edge_weight, node_graph_index, training=False):
        h = JGCN(units=GC_UNITS, activation=jax.nn.relu)([x, edge_index, edge_weight])
        h = jmean_pool(h, node_graph_index, num_graphs=self.num_graphs)
        return fnn.Dense(self.num_classes)(h)


class _PortMeanPoolNet(torch.nn.Module):
    def __init__(self, num_classes, num_graphs, in_features=4):
        super().__init__()
        self.num_graphs = num_graphs
        self.GCN_0 = GCN(in_features, GC_UNITS, activation=torch.relu, device="cpu")
        self.Dense_0 = torch.nn.Linear(GC_UNITS, num_classes)

    def forward(self, x, edge_index, edge_weight, node_graph_index):
        h = self.GCN_0([x, edge_index, edge_weight])
        # padded nodes carry the graph id num_graphs: pooled, then dropped
        return self.Dense_0(mean_pool(h, node_graph_index, self.num_graphs + 1)[:-1])


def _recording_value_and_grad(losses):
    """``jax.value_and_grad`` that records each loss it computes, also
    inside ``jit`` (the JAX loop's step is jitted)."""
    real = jax.value_and_grad

    def value_and_grad(fn, *args, **kwargs):
        inner = real(fn, *args, **kwargs)

        def run(*a, **k):
            loss, grads = inner(*a, **k)
            jax.debug.callback(lambda v: losses.append(float(v)), loss, ordered=True)
            return loss, grads
        return run
    return value_and_grad


@pytest.mark.parametrize("seed", [0, 1])
def test_run_graph_classification_on_cpu(seed, monkeypatch):
    """Both loops on the synthetic fallback set with its default split (540
    training graphs, 60 test graphs: the last test batch is partial), from
    the same flax weights: JAX initializes on the first shuffled batch, the
    port skips it; the same batches follow."""
    from sklearn.model_selection import train_test_split
    graphs, num_classes = jdemo_utils.load_graph_classification_data("NCI1", seed=seed)
    train_graphs, test_graphs = train_test_split(graphs, test_size=0.1, random_state=0)
    assert len(test_graphs) % GC_BATCH != 0
    first, _ = next(jdemo_utils.padded_batch_generator(train_graphs, GC_BATCH, seed=seed))
    key = jax.random.PRNGKey(seed)
    params = _JaxMeanPoolNet(num_classes, GC_BATCH).init(
        {"params": key, "dropout": key}, *(jnp.asarray(a) for a in (
            first.x, first.edge_index, first.edge_weight, first.node_graph_index)))

    jax_losses = []
    with monkeypatch.context() as m:
        m.setattr(jax, "value_and_grad", _recording_value_and_grad(jax_losses))
        want = jdemo_utils.run_graph_classification(_JaxMeanPoolNet, batch_size=GC_BATCH,
                                                    num_steps=GC_STEPS, seed=seed)

    def make_model(c, num_graphs):
        model = _PortMeanPoolNet(c, num_graphs)
        model.load_state_dict(convert.pool_model_state_dict_from_flax(params))
        return model

    stats = {}
    got = demo_utils.run_graph_classification(make_model, batch_size=GC_BATCH,
                                              num_steps=GC_STEPS, seed=seed, device="cpu",
                                              stats=stats)
    assert len(jax_losses) == GC_STEPS
    np.testing.assert_allclose(torch.stack(stats["losses"]).numpy(), jax_losses, **TOL)
    assert got == float(want)


@pytest.mark.parametrize("demo", [demo_gcn, demo_gat])
def test_demo_main_runs_on_cpu(demo):
    acc = demo.main(device="cpu", num_steps=2)
    assert 0.0 <= acc <= 1.0
