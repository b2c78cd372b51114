"""The node-classification demo twins of the propagation family
(``tf_geometric_tpu_torch/demos``: ``demo_sgc``, ``demo_tagcn``,
``demo_chebynet``; ``demo_appnp`` and ``demo_ssgc`` in
``test_torch_demo_twins_ppr.py``) against the JAX scripts (``demo/``) on
the CPU; ``test_torch_demo_twins_gcn.py`` runs the same check on the GCN
variants with this file's helpers.

Each JAX script's ``main`` runs on a small synthetic citation graph (300
nodes, 50 features, 4 classes; ``load_cora`` replaced) for three steps
(``TFG_DEMO_SMOKE_STEPS``), recorded by ``tests/_jax_demo_capture.py``;
the twin's ``main`` then runs on the same graph from the script's initial
weights (carried across by ``convert``) with the keep masks JAX drew (edge
and dropout masks, DropEdge's included), and the test holds, within
rtol = atol = 1e-4: the eval-mode logits at the initial weights, each of
the three steps' losses, every step-1 gradient; and the final test
accuracy within one test node.
"""
import os
import re
import sys
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._jax_demo_capture import record_jax
from tf_geometric_tpu_torch import convert
from tf_geometric_tpu_torch.datasets.synthetic_citation import synthetic_citation_graph
from tf_geometric_tpu_torch.demos import (demo_appnp, demo_chebynet, demo_drop_edge_gcn,
                                          demo_sgc, demo_sparse_node_features, demo_ssgc,
                                          demo_tagcn, demo_utils)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "demo"))

import demo_appnp as jdemo_appnp  # noqa: E402
import demo_chebynet as jdemo_chebynet  # noqa: E402
import demo_drop_edge_gcn as jdemo_drop_edge_gcn  # noqa: E402
import demo_sgc as jdemo_sgc  # noqa: E402
import demo_sparse_node_features as jdemo_sparse_node_features  # noqa: E402
import demo_ssgc as jdemo_ssgc  # noqa: E402
import demo_tagcn as jdemo_tagcn  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 3
GRAPH = dict(num_nodes=300, num_features=50, num_classes=4, seed=3)
SPLITS = (np.arange(0, 40), np.arange(40, 100), np.arange(100, 300))


def _flax(conv):
    return lambda params: conv({"params": params})


def _pair(masks):
    return tuple(torch.as_tensor(m) for m in masks)


# name: (JAX script, twin, converter of the script's params, the masks a
# training step draws, and their form on the port)
NODE_TWINS = {
    "appnp": (jdemo_appnp, demo_appnp, _flax(convert.propagation_state_dict_from_flax), 2,
              _pair),
    "ssgc": (jdemo_ssgc, demo_ssgc, _flax(convert.propagation_state_dict_from_flax), 0, None),
    "sgc": (jdemo_sgc, demo_sgc, _flax(convert.propagation_state_dict_from_flax), 0, None),
    "tagcn": (jdemo_tagcn, demo_tagcn, _flax(convert.tagcn_model_state_dict_from_flax), 2,
              _pair),
    "chebynet": (jdemo_chebynet, demo_chebynet, _flax(convert.chebynet_state_dict_from_flax),
                 0, None),
}


@pytest.fixture(autouse=True)
def offline(tmp_path, monkeypatch):
    monkeypatch.setenv("TFG_TPU_DATA_ROOT", str(tmp_path))
    for var in ("TFG_HARD_PROTOCOL", "TFG_HARD_SEED", "BENCH_DATASET", "TFG_DEMO_SMOKE_STEPS",
                "TFG_ADAM_EPS", "TFG_HARD_MODEL"):
        monkeypatch.delenv(var, raising=False)

    def no_download(*args, **kwargs):
        raise OSError("no download in the tests")

    import tf_geometric_tpu.data.dataset as jdataset
    monkeypatch.setattr(jdataset, "download_file", no_download)
    monkeypatch.setattr(urllib.request, "urlopen", no_download)


def _graphs():
    """The small graph on both sides: the JAX one (arrays, int32 splits) and
    the port's (CPU tensors, int64 splits), bit for bit."""
    from tf_geometric_tpu.datasets.synthetic_citation import \
        synthetic_citation_graph as jsynthetic
    jgraph = jsynthetic(**GRAPH)
    jgraph.convert_data_to_tensor()
    pgraph = synthetic_citation_graph(**GRAPH)
    pgraph.convert_data_to_tensor(device="cpu")
    np.testing.assert_array_equal(pgraph.x.numpy(), np.asarray(jgraph.x))
    np.testing.assert_array_equal(pgraph.edge_index.numpy(), np.asarray(jgraph.edge_index))
    return ((jgraph, tuple(jnp.asarray(s, jnp.int32) for s in SPLITS)),
            (pgraph, tuple(torch.as_tensor(s) for s in SPLITS)))


def _run_jax(jmod, jdata, monkeypatch):
    """The JAX script's ``main`` for ``STEPS`` steps on ``jdata``; returns
    the records, its result and the eval logits at the initial weights."""
    rec = record_jax(monkeypatch)
    seen = {}
    real = jmod.train_node_classifier

    def train(forward, params, y, splits, **kwargs):
        seen["logits"] = np.asarray(forward(params, False, None))
        return real(forward, params, y, splits, **kwargs)

    monkeypatch.setattr(jmod, "load_cora", lambda: jdata)
    monkeypatch.setattr(jmod, "train_node_classifier", train)
    return rec, float(jmod.main()), seen["logits"]


def _run_port(pmod, pdata, conv, init, masks, to_masks, monkeypatch):
    """The twin's ``main`` on ``pdata`` from ``init`` (JAX's weights, via
    ``conv``), each training step handed the next of ``masks``; returns its
    result, stats, eval logits at the initial weights and step-1 grads."""
    seen = {}
    real_build, real_step = pmod.build_model, demo_utils.train_step

    def build(graph, num_classes, seed=0, device="cuda"):
        model, forward = real_build(graph, num_classes, seed, device)
        model.load_state_dict(conv(init))
        model.eval()
        with torch.no_grad():
            seen["logits"] = forward(False, None).numpy()
        return model, forward

    step_masks = iter(masks)

    def step(module, optimizer, forward, y, train_index, l2_coef, generator=None,
             keep_masks=None):
        m = next(step_masks)
        loss = real_step(module, optimizer, forward, y, train_index, l2_coef, generator,
                         to_masks(m) if m else None)
        seen.setdefault("grads", {k: p.grad.clone() for k, p in module.named_parameters()})
        return loss

    monkeypatch.setattr(demo_utils, "load_cora", lambda device="cuda": pdata)
    monkeypatch.setattr(pmod, "load_cora", lambda device="cuda": pdata, raising=False)
    monkeypatch.setattr(pmod, "build_model", build)
    monkeypatch.setattr(demo_utils, "train_step", step)
    stats = {}
    acc = pmod.main(device="cpu", stats=stats)
    return acc, stats, seen


def check_twin(spec, monkeypatch):
    """The check of the module docstring for one twin, ``spec`` as a value
    of ``NODE_TWINS``."""
    jmod, pmod, conv, num_masks, to_masks = spec
    jdata, pdata = _graphs()
    monkeypatch.setenv("TFG_DEMO_SMOKE_STEPS", str(STEPS))
    rec, jacc, jlogits = _run_jax(jmod, jdata, monkeypatch)
    assert len(rec.losses) == STEPS and len(rec.bernoulli) == STEPS * num_masks
    masks = [rec.bernoulli[i * num_masks:(i + 1) * num_masks] for i in range(STEPS)]
    acc, stats, seen = _run_port(pmod, pdata, conv, rec.init_params[0], masks, to_masks,
                                 monkeypatch)
    np.testing.assert_allclose(seen["logits"], jlogits, **TOL)
    np.testing.assert_allclose(torch.stack(stats["losses"]).numpy(), rec.losses, **TOL)
    want = conv(rec.grads[0])
    assert sorted(seen["grads"]) == sorted(want)
    for k, g in seen["grads"].items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), **TOL, err_msg=k)
    assert acc == pytest.approx(jacc, abs=1.0 / len(SPLITS[2]) + 1e-6)


@pytest.mark.parametrize("name", ["sgc", "tagcn", "chebynet"])
def test_node_twin_matches_jax_script(name, monkeypatch):
    check_twin(NODE_TWINS[name], monkeypatch)


def test_twin_constants_are_the_scripts():
    """The constants each twin names are the literals its JAX script
    passes (the scripts inline them)."""
    def literal(module, name):
        with open(module.__file__, encoding="utf-8") as f:
            return float(re.search(rf"\b{name}=([0-9.e-]+)", f.read()).group(1))
    assert (literal(jdemo_sgc, "k"), literal(jdemo_sgc, "learning_rate"),
            literal(jdemo_sgc, "l2_coef")) == (demo_sgc.K, demo_sgc.LEARNING_RATE,
                                               demo_sgc.L2_COEF)
    assert (literal(jdemo_appnp, "k"), literal(jdemo_appnp, "alpha"),
            literal(jdemo_appnp, "dense_drop_rate"), literal(jdemo_appnp, "edge_drop_rate")) == (
        demo_appnp.K, demo_appnp.ALPHA, demo_appnp.DROP_RATE, demo_appnp.DROP_RATE)
    assert (literal(jdemo_ssgc, "k"), literal(jdemo_ssgc, "alpha")) == (demo_ssgc.K,
                                                                       demo_ssgc.ALPHA)
    assert (literal(jdemo_tagcn, "units"), literal(jdemo_tagcn, "k")) == (demo_tagcn.HIDDEN,
                                                                         demo_tagcn.K)
    assert literal(jdemo_chebynet, "k") == demo_chebynet.K
    assert (jdemo_drop_edge_gcn.NUM_LAYERS, jdemo_drop_edge_gcn.HIDDEN) == (
        demo_drop_edge_gcn.NUM_LAYERS, demo_drop_edge_gcn.HIDDEN)
    assert literal(jdemo_drop_edge_gcn, "rate") == demo_drop_edge_gcn.DROP_RATE
    assert literal(jdemo_sparse_node_features, "scale") == demo_sparse_node_features.INIT_SCALE
