"""The graph-classification demo twins ``demo_asap``, ``demo_set2set`` and
``demo_topk_pool`` (``tf_geometric_tpu_torch/demos``) against the JAX
demos (``demo/``) on the CPU, and the round trip of every ``convert``
function the demo twins load JAX's weights through.

The models: on a padded batch of the hard-mode graph set at each demo's
batch size (16 for ASAP, 32 otherwise), from the flax init carried across
by ``convert``, the eval-mode logits, and the loss and every step-1
gradient in training mode with the dropout mask JAX draws, within
rtol = atol = 1e-4 (``tests/test_torch_graph_demos.py``'s check). The
round trips: each converter's ``state_dict`` loads into the twin's model
with every parameter equal to its JAX leaf (a dense kernel transposed).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_graph_demos import (TOL, _logits, _loss_jax, _loss_port, _Masks,
                                          _port_call, hard_split)  # noqa: F401
from tf_geometric_tpu_torch import convert
from tf_geometric_tpu_torch.demos import (demo_asap, demo_dgi, demo_drop_edge_gcn, demo_gae,
                                          demo_graph_sage, demo_set2set, demo_tagcn,
                                          demo_topk_pool, demo_utils)
from tf_geometric_tpu_torch.layers import ChebyNet

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "demo"))

import demo_asap as jdemo_asap  # noqa: E402
import demo_dgi as jdemo_dgi  # noqa: E402
import demo_drop_edge_gcn as jdemo_drop_edge_gcn  # noqa: E402
import demo_gae as jdemo_gae  # noqa: E402
import demo_graph_sage as jdemo_graph_sage  # noqa: E402
import demo_set2set as jdemo_set2set  # noqa: E402
import demo_tagcn as jdemo_tagcn  # noqa: E402
import demo_topk_pool as jdemo_topk_pool  # noqa: E402

# name: (JAX model, port model, converter, the keep mask's form, batch size)
DEMOS = {
    "asap": (jdemo_asap.ASAPModel, demo_asap.ASAPModel, convert.pool_model_state_dict_from_flax,
             "keep_mask", demo_asap.BATCH_SIZE),
    "set2set": (jdemo_set2set.Set2SetModel, demo_set2set.Set2SetModel,
                convert.pool_model_state_dict_from_flax, "keep_mask", 32),
    "topk_pool": (jdemo_topk_pool.TopKPoolModel, demo_topk_pool.TopKPoolModel,
                  convert.topk_pool_model_state_dict_from_flax, "keep_masks", 32),
}


def _batch(split, size):
    train, _, num_classes = split
    padded, real = next(demo_utils.padded_batch_generator(train, size, seed=0))
    args = tuple(np.asarray(a) for a in (padded.x, padded.edge_index, padded.edge_weight,
                                         padded.node_graph_index))
    y = np.zeros(size, np.int64)
    y[:real] = np.asarray(padded.y).flatten()[:real]
    mask = np.zeros(size, np.float32)
    mask[:real] = 1.0
    return args, y, mask, num_classes


@pytest.mark.parametrize("name", list(DEMOS))
def test_graph_demo_twin_matches_jax(name, hard_split, monkeypatch):  # noqa: F811
    jcls, pcls, conv, form, size = DEMOS[name]
    args, y, mask, c = _batch(hard_split, size)
    jmodel = jcls(num_classes=c, num_graphs=size)
    key = jax.random.PRNGKey(0)
    jargs = tuple(jnp.asarray(a) for a in args)
    params = jmodel.init({"params": key, "dropout": key}, *jargs)["params"]
    model = pcls(args[0].shape[1], c, size, device="cpu")
    model.load_state_dict(conv({"params": params}))

    model.eval()
    with torch.no_grad():
        got = _port_call(model, form, args, None)
    np.testing.assert_allclose(_logits(got).numpy(), np.asarray(jmodel.apply({"params": params},
                                                                              *jargs)), **TOL)

    rec = _Masks()
    monkeypatch.setattr(jax.random, "bernoulli", rec)

    def loss_fn(p):
        return _loss_jax(jmodel.apply({"params": p}, *jargs, training=True,
                                      rngs={"dropout": jax.random.PRNGKey(7)}), y, mask)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    assert len(rec.masks) == 1
    model.train()
    tloss = _loss_port(_logits(_port_call(model, form, args, rec.masks)), y, mask)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(loss), **TOL)
    want = conv({"params": grads})
    got_grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in model.named_parameters()}
    assert sorted(got_grads) == sorted(want)
    for k, g in got_grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), **TOL, err_msg=k)


def _flax_init(module, *args, **kwargs):
    key = jax.random.PRNGKey(0)
    return module.init({"params": key, "dropout": key}, *args, **kwargs)["params"]


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _small_graph(n=12, f=5):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, f)).astype(np.float32)
    ei = np.stack([np.arange(n), (np.arange(n) + 1) % n]).astype(np.int32)
    return x, np.concatenate([ei, ei[::-1]], axis=1), np.ones(2 * n, np.float32)


ROUND_TRIPS = ("tagcn", "chebynet", "dgi", "gae", "drop_edge_gcn", "sage_net", "topk_pool",
               "numpy")


def _round_trip_case(which):
    """(flax params, port module, converter output) of converter
    ``which``, built when the test runs (not at collection)."""
    x, ei, ew = _small_graph()
    jx, jei, jew = jnp.asarray(x), jnp.asarray(ei), jnp.asarray(ew)
    n, f, c = x.shape[0], x.shape[1], 3
    if which == "tagcn":
        p = _flax_init(jdemo_tagcn.TAGCNModel(num_classes=c), jx, jei, jew)
        return p, demo_tagcn.TAGCNModel(f, c, device="cpu"), \
            convert.tagcn_model_state_dict_from_flax({"params": p})
    if which == "chebynet":
        from tf_geometric_tpu.data.graph import Graph as JGraph
        from tf_geometric_tpu.layers import ChebyNet as JChebyNet
        jlayer, jgraph = JChebyNet(units=c, k=3), JGraph(x=x, edge_index=ei)
        jlayer.build_cache_for_graph(jgraph)
        p = jlayer.init(jax.random.PRNGKey(0), [jx, jei, jew], cache=jgraph.cache)["params"]
        return p, ChebyNet(f, c, k=3, device="cpu"), \
            convert.chebynet_state_dict_from_flax({"params": p})
    if which == "dgi":
        enc = _flax_init(jdemo_dgi.DGIEncoder(), jx, jei, jew)
        disc = jdemo_dgi.Discriminator().init(jax.random.PRNGKey(1), jnp.ones((1, 64)),
                                              jnp.ones((n, 64)))["params"]
        return {"enc": enc, "disc": disc}, demo_dgi.DGIModel(f, device="cpu"), \
            convert.dgi_state_dict_from_flax(enc, disc)
    if which == "gae":
        p = _flax_init(jdemo_gae.GAEEncoder(), jx, jei, jew)
        return {"gcn0": p["GCN_0"], "gcn1": p["GCN_1"]}, demo_gae.GAEEncoder(f, device="cpu"), \
            convert.gae_encoder_state_dict_from_flax({"params": p})
    if which == "drop_edge_gcn":
        p = _flax_init(jdemo_drop_edge_gcn.DropEdgeGCNModel(num_classes=c, num_nodes=n), jx, jei,
                       jew)
        return p, demo_drop_edge_gcn.DropEdgeGCNModel(f, c, n, device="cpu"), \
            convert.gcn_state_dict_from_flax({"params": p})
    if which == "sage_net":
        p = _flax_init(jdemo_graph_sage.SageNet(num_classes=c), jx, ((jei, jew), (jei, jew)))
        return p, demo_graph_sage.SageNet(f, c, device="cpu"), \
            convert.pool_model_state_dict_from_flax({"params": p})
    if which == "topk_pool":
        p = _flax_init(jdemo_topk_pool.TopKPoolModel(num_classes=c, num_graphs=1), jx, jei, jew,
                       jnp.zeros(n, jnp.int32))
        return p, demo_topk_pool.TopKPoolModel(f, c, 1, device="cpu"), \
            convert.topk_pool_model_state_dict_from_flax({"params": p})
    raw = {"w0": np.ones((n, 4), np.float32), "b0": np.zeros(4, np.float32)}
    return raw, None, convert.numpy_params_state_dict(raw, "params.")


@pytest.mark.parametrize("name", ROUND_TRIPS)
def test_converters_round_trip(name):
    params, module, state = _round_trip_case(name)
    leaves = _leaves(params)
    if module is None:
        assert sorted(state) == sorted(f"params.{k}" for k in leaves)
        for k, v in leaves.items():
            np.testing.assert_array_equal(state[f"params.{k}"].numpy(), v)
        return
    module.load_state_dict(state)
    got = {k: v.detach().numpy() for k, v in module.state_dict().items()}
    assert len(got) == len(leaves)
    for k, v in leaves.items():
        # a flax Dense kernel [in, out] is a Linear weight [out, in]
        port_key = k.replace(".kernel", ".weight") if k.startswith("Dense_") else k
        want = v.T if k.startswith("Dense_") and k.endswith("kernel") else v
        np.testing.assert_array_equal(got[port_key], want, err_msg=f"{name}: {k}")
