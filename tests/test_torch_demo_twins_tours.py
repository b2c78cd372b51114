"""The two API tours and the ModelNet twin (``tf_geometric_tpu_torch/demos``:
``demo_elegant_api``, ``tutorial_intro``, ``demo_model_net_dataset``)
against the JAX scripts (``demo/demo_elegant_api.py``, ``tutorial_intro.py``,
``demo/demo_model_net_dataset.py``) on the CPU.

The tours draw their graph's features from numpy's global stream, unseeded;
each side runs after ``np.random.seed`` of the same seed. Held: the graph
bit for bit, the functional GCN (and the decorated one), the readout and
the GAT layer from the script's init (its flax variables carried across by
``convert.gat_state_dict_from_flax``) within 1e-5, the printed lines
equal. The tutorial's GCN: its weights are the same numpy draws on both
sides; the first 3 losses and the step-1 gradients within 1e-4, the
100-step test accuracy within 0.005 (5 of its 1,000 test nodes: after 100
Adam steps a node whose two top logits are within float32 rounding of each
other may flip, since the port sums the products in another order). The
ModelNet twin: without the files, the 300 synthetic meshes and the 90/10
split bit for bit, then 3 steps of the script's loop (its initial weights
and dropout masks, recorded by ``tests/_jax_demo_capture.py``): each loss
and every step-1 gradient within 1e-4, the test accuracy within one graph.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

import tf_geometric_tpu
from tests._jax_demo_capture import named_grads, record_jax, record_port_adam
from tests.test_torch_demo_twins_node import TOL, offline  # noqa: F401
from tf_geometric_tpu_torch import convert
from tf_geometric_tpu_torch.demos import (demo_elegant_api, demo_model_net_dataset, demo_utils,
                                          tutorial_intro)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "demo"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import demo_elegant_api as jdemo_elegant_api  # noqa: E402
import demo_model_net_dataset as jdemo_model_net_dataset  # noqa: E402
import tutorial_intro as jtutorial_intro  # noqa: E402

TIGHT = dict(rtol=1e-5, atol=1e-5)
SEED = 11
ACC_BOUND = 0.005


def _record_tour(monkeypatch):
    """The JAX package's ``nn.gcn`` and ``nn.mean_pool`` outputs and the
    ``layers.GAT`` variables and output, as the scripts call them (the
    decorated GCN inside ``jit`` through a debug callback)."""
    rec = {"gcn": [], "mean_pool": []}
    real_gcn, real_pool = tf_geometric_tpu.nn.gcn, tf_geometric_tpu.nn.mean_pool
    real_gat = tf_geometric_tpu.layers.GAT

    def gcn(*args, **kwargs):
        out = real_gcn(*args, **kwargs)
        jax.debug.callback(lambda v: rec["gcn"].append(np.array(v)), out)
        return out

    def mean_pool(*args, **kwargs):
        out = real_pool(*args, **kwargs)
        rec["mean_pool"].append(np.array(out))
        return out

    class GAT:
        def __init__(self, **kwargs):
            self.layer = real_gat(**kwargs)

        def init(self, *args, **kwargs):
            rec["gat_vars"] = self.layer.init(*args, **kwargs)
            return rec["gat_vars"]

        def apply(self, *args, **kwargs):
            out = self.layer.apply(*args, **kwargs)
            rec["gat"] = np.array(out)
            return out

    monkeypatch.setattr(tf_geometric_tpu.nn, "gcn", gcn)
    monkeypatch.setattr(tf_geometric_tpu.nn, "mean_pool", mean_pool)
    monkeypatch.setattr(tf_geometric_tpu.layers, "GAT", GAT)
    return rec


def _gat_from(rec, module, monkeypatch):
    """``module.gat_layer`` loading the script's GAT variables."""
    real = module.gat_layer

    def gat_layer(in_features, device="cuda"):
        layer = real(in_features, device)
        layer.load_state_dict(convert.gat_state_dict_from_flax(rec["gat_vars"]))
        return layer
    monkeypatch.setattr(module, "gat_layer", gat_layer)


def _check_tour(rec, stats):
    graph = stats["graph"]
    assert graph.x.dtype == np.float32
    np.random.seed(SEED)
    np.testing.assert_array_equal(graph.x, np.random.randn(5, 20).astype(np.float32))
    from tf_geometric_tpu.data.graph import Graph as JGraph
    jgraph = JGraph(x=graph.x, edge_index=demo_elegant_api.TOUR_EDGES).to_directed()
    np.testing.assert_array_equal(graph.edge_index, np.asarray(jgraph.edge_index))
    np.testing.assert_array_equal(graph.edge_weight, np.asarray(jgraph.edge_weight))
    np.testing.assert_allclose(stats["gcn"].detach().numpy(), rec["gcn"][0], **TIGHT)
    np.testing.assert_allclose(stats["gat"].detach().numpy(), rec["gat"], **TIGHT)


def test_elegant_api_twin_matches_jax(monkeypatch, capsys):
    rec = _record_tour(monkeypatch)
    np.random.seed(SEED)
    assert jdemo_elegant_api.main() is True
    jax.effects_barrier()
    want = capsys.readouterr().out.splitlines()
    _gat_from(rec, demo_elegant_api, monkeypatch)
    stats = {}
    np.random.seed(SEED)
    assert demo_elegant_api.main(device="cpu", stats=stats) is True
    assert capsys.readouterr().out.splitlines() == want
    assert len(rec["gcn"]) == 2
    _check_tour(rec, stats)
    np.testing.assert_allclose(stats["jitted"].numpy(), rec["gcn"][1], **TIGHT)


def test_tutorial_twin_matches_jax(monkeypatch, capsys):
    rec = _record_tour(monkeypatch)
    jrec = record_jax(monkeypatch)
    np.random.seed(SEED)
    jacc = jtutorial_intro.main()
    jax.effects_barrier()
    want = capsys.readouterr().out.splitlines()
    _gat_from(rec, tutorial_intro, monkeypatch)
    adam = record_port_adam(monkeypatch)
    stats = {}
    np.random.seed(SEED)
    acc = tutorial_intro.main(device="cpu", stats=stats)
    got = capsys.readouterr().out.splitlines()
    assert got[:-1] == want[:-1]  # the accuracy line aside
    _check_tour(rec, stats)
    np.testing.assert_allclose(stats["readout"].numpy(), rec["mean_pool"][0], **TIGHT)

    assert len(jrec.losses) == tutorial_intro.NUM_STEPS == len(stats["losses"])
    np.testing.assert_allclose(torch.stack(stats["losses"][:3]).numpy(), jrec.losses[:3], **TOL)
    grads = named_grads(stats["model"], adam)
    assert sorted(grads) == sorted(jrec.grads[0]) == ["w0", "w1"]
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jrec.grads[0][k]), **TOL, err_msg=k)
    assert acc == pytest.approx(jacc, abs=ACC_BOUND)


def test_model_net_meshes_and_split_match_jax():
    from sklearn.model_selection import train_test_split
    jgraphs, jc, jsplit = jdemo_model_net_dataset.load_model_net_graphs()
    graphs, c, split = demo_model_net_dataset.load_model_net_graphs()
    assert (c, split, jsplit) == (jc, None, None) and len(graphs) == len(jgraphs) == 300
    for g, jg in zip(graphs, jgraphs):
        for field in ("x", "edge_index", "y"):
            got, want = np.asarray(getattr(g, field)), np.asarray(getattr(jg, field))
            assert got.dtype == want.dtype, field
            np.testing.assert_array_equal(got, want)
    ids = list(range(300))
    assert ([list(s) for s in demo_utils.train_test_split(ids, test_size=0.1, random_state=0)]
            == [list(s) for s in train_test_split(ids, test_size=0.1, random_state=0)])


def test_model_net_twin_matches_jax_script(monkeypatch):
    steps = 3
    rec = record_jax(monkeypatch)
    jacc = jdemo_model_net_dataset.main(num_steps=steps)
    jax.effects_barrier()
    assert len(rec.losses) == steps and len(rec.bernoulli) == 2 * steps
    init = convert.pool_model_state_dict_from_flax({"params": rec.init_params[0]})
    masks = iter(rec.bernoulli)
    real = demo_model_net_dataset.MeanPoolNetwork

    class Replayed(real):
        def forward(self, *args):
            keep = [torch.as_tensor(next(masks)) for _ in range(2)] if self.training else None
            return super().forward(*args, keep_masks=keep)

    def make(in_features, c, g, device="cuda"):
        model = Replayed(in_features, c, g, device=device)
        model.load_state_dict(init)
        seen["model"] = model
        return model

    seen = {}
    monkeypatch.setattr(demo_model_net_dataset, "MeanPoolNetwork", make)
    adam = record_port_adam(monkeypatch)
    stats = {}
    acc = demo_model_net_dataset.main(num_steps=steps, device="cpu", stats=stats)
    np.testing.assert_allclose(torch.stack(stats["losses"]).numpy(), rec.losses, **TOL)
    want = convert.pool_model_state_dict_from_flax({"params": rec.grads[0]})
    got = named_grads(seen["model"], adam)
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), **TOL, err_msg=k)
    assert acc == pytest.approx(float(jacc), abs=1.0 / 30 + 1e-6)
