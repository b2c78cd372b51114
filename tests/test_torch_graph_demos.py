"""The graph-classification demo twins (``tf_geometric_tpu_torch/demos``:
``demo_mean_pool``, ``demo_gin``, ``demo_sag_pool_h``, ``demo_sort_pool``,
``demo_diff_pool``, ``demo_min_cut_pool``) against the JAX demos
(``demo/``) on the CPU, at the demos' widths on a padded batch of 32
graphs of the hard-mode set (``synthetic_graph_classification_hard``):

- the logits in eval mode, and the loss and every step-1 gradient in
  training mode with the dropout masks JAX draws (recorded from its
  ``jax.random.bernoulli`` calls), from the flax init carried across by
  ``convert``, within rtol = atol = 1e-4;
- MinCutPool's auxiliary losses against the JAX demo's ``_aux_loss`` of its
  sown collection;
- three steps of both ``run_graph_classification`` loops for GIN and
  MinCut (the head-to-head's split and label noise, JAX's masks fed to the
  port step by step): each step's loss within 1e-4;
- ``init_like_flax``'s draws have flax's scales.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_geometric_tpu_torch import convert
from tf_geometric_tpu_torch.datasets.synthetic_citation import (
    flip_graph_labels, synthetic_graph_classification_hard)
from tf_geometric_tpu_torch.demos import (demo_diff_pool, demo_gin, demo_mean_pool,
                                          demo_min_cut_pool, demo_sag_pool_h, demo_sort_pool,
                                          demo_utils)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "demo"))

import demo_diff_pool as jdemo_diff_pool  # noqa: E402
import demo_gin as jdemo_gin  # noqa: E402
import demo_mean_pool as jdemo_mean_pool  # noqa: E402
import demo_min_cut_pool as jdemo_min_cut_pool  # noqa: E402
import demo_sag_pool_h as jdemo_sag_pool_h  # noqa: E402
import demo_sort_pool as jdemo_sort_pool  # noqa: E402
import demo_utils as jdemo_utils  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
BATCH = 32

# name: (JAX model, port model, converter, the keep masks' form on the port)
DEMOS = {
    "mean_pool": (jdemo_mean_pool.MeanPoolNetwork, demo_mean_pool.MeanPoolNetwork,
                  convert.pool_model_state_dict_from_flax, "keep_masks"),
    "gin": (jdemo_gin.GINModel, demo_gin.GINModel,
            convert.gin_classifier_state_dict_from_flax, "keep_masks"),
    "sag_pool": (jdemo_sag_pool_h.SAGPoolHModel, demo_sag_pool_h.SAGPoolHModel,
                 convert.pool_model_state_dict_from_flax, "keep_mask"),
    "sort_pool": (jdemo_sort_pool.SortPoolModel, demo_sort_pool.SortPoolModel,
                  convert.pool_model_state_dict_from_flax, "keep_masks"),
    "diff_pool": (jdemo_diff_pool.DiffPoolModel, demo_diff_pool.DiffPoolModel,
                  convert.pool_model_state_dict_from_flax, "keep_mask"),
    "min_cut_pool": (jdemo_min_cut_pool.MinCutPoolModel, demo_min_cut_pool.MinCutPoolModel,
                     convert.pool_model_state_dict_from_flax, "keep_mask"),
}
# dropout masks one training forward draws, by demo
NUM_MASKS = {"mean_pool": 2, "gin": 1, "sag_pool": 1, "sort_pool": 1, "diff_pool": 1,
             "min_cut_pool": 1}


@pytest.fixture(scope="module")
def hard_split():
    """The head-to-head's split: the hard set (seed 0), 90/10 with
    ``random_state=0``, label noise on the training part."""
    graphs, num_classes = synthetic_graph_classification_hard(seed=0)
    train, test = demo_utils.train_test_split(graphs, test_size=0.1, random_state=0)
    flip_graph_labels(train)
    return train, test, num_classes


@pytest.fixture(scope="module")
def batch(hard_split):
    train, _, num_classes = hard_split
    padded, real = next(demo_utils.padded_batch_generator(train, BATCH, seed=0))
    args = tuple(np.asarray(a) for a in (padded.x, padded.edge_index, padded.edge_weight,
                                         padded.node_graph_index))
    y = np.zeros(BATCH, np.int64)
    y[:real] = np.asarray(padded.y).flatten()[:real]
    mask = np.zeros(BATCH, np.float32)
    mask[:real] = 1.0
    return args, y, mask, num_classes


class _Masks:
    """``jax.random.bernoulli`` recording the masks it draws (eagerly, or
    through ordered debug callbacks inside ``jit``)."""

    def __init__(self, traced=False):
        self.real, self.traced, self.masks = jax.random.bernoulli, traced, []

    def __call__(self, key, p=0.5, shape=None):
        mask = self.real(key, p, shape)
        if self.traced:
            jax.debug.callback(lambda m: self.masks.append(np.array(m)), mask, ordered=True)
        else:
            self.masks.append(np.array(mask))
        return mask


def _logits(out):
    return out[0] if isinstance(out, tuple) else out


def _port_call(model, form, args, masks):
    kwargs = {}
    if masks is not None:
        masks = [torch.as_tensor(m) for m in masks]
        kwargs = {form: masks if form == "keep_masks" else masks[0]}
    return model(*(torch.as_tensor(a) for a in args), **kwargs)


def _loss_jax(logits, y, mask):
    import optax
    ce = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y))
    return jnp.sum(ce * mask) / jnp.maximum(mask.sum(), 1.0)


def _loss_port(logits, y, mask):
    ce = torch.nn.functional.cross_entropy(logits, torch.as_tensor(y), reduction="none")
    mask = torch.as_tensor(mask)
    return (ce * mask).sum() / mask.sum().clamp_min(1.0)


@pytest.mark.parametrize("name", list(DEMOS))
def test_graph_demo_model_matches_jax(name, batch, monkeypatch):
    jcls, pcls, conv, form = DEMOS[name]
    args, y, mask, c = batch
    jmodel = jcls(num_classes=c, num_graphs=BATCH)
    key = jax.random.PRNGKey(0)
    jargs = tuple(jnp.asarray(a) for a in args)
    mutable = ["losses"] if name == "min_cut_pool" else False
    params = jmodel.init({"params": key, "dropout": key}, *jargs)["params"]
    model = pcls(args[0].shape[1], c, BATCH, device="cpu")
    model.load_state_dict(conv({"params": params}))

    # eval-mode logits
    model.eval()
    want = jmodel.apply({"params": params}, *jargs, mutable=mutable) if mutable \
        else jmodel.apply({"params": params}, *jargs)
    with torch.no_grad():
        got = _port_call(model, form, args, None)
    np.testing.assert_allclose(_logits(got).numpy(), np.asarray(_logits(want)), **TOL)

    # training-mode loss and step-1 gradients with JAX's masks
    rec = _Masks()
    monkeypatch.setattr(jax.random, "bernoulli", rec)

    def loss_fn(p):
        out = jmodel.apply({"params": p}, *jargs, training=True,
                           rngs={"dropout": jax.random.PRNGKey(7)}, mutable=mutable)
        if mutable:
            logits, state = out
            return _loss_jax(logits, y, mask) + jdemo_min_cut_pool._aux_loss(state)
        return _loss_jax(out, y, mask)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    assert len(rec.masks) == NUM_MASKS[name]
    model.train()
    out = _port_call(model, form, args, rec.masks)
    tloss = _loss_port(_logits(out), y, mask)
    if name == "min_cut_pool":
        tloss = tloss + demo_min_cut_pool._aux_loss(out[1])
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(loss), **TOL)
    want_grads = conv({"params": grads})
    got_grads = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got_grads) == sorted(want_grads)
    for k, g in got_grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[k].numpy(), **TOL, err_msg=k)


def test_min_cut_aux_losses_match_jax(batch):
    args, _, _, c = batch
    jmodel = jdemo_min_cut_pool.MinCutPoolModel(num_classes=c, num_graphs=BATCH)
    key = jax.random.PRNGKey(3)
    jargs = tuple(jnp.asarray(a) for a in args)
    params = jmodel.init({"params": key, "dropout": key}, *jargs)["params"]
    _, state = jmodel.apply({"params": params}, *jargs, mutable=["losses"])
    model = demo_min_cut_pool.MinCutPoolModel(args[0].shape[1], c, BATCH, device="cpu").eval()
    model.load_state_dict(convert.pool_model_state_dict_from_flax({"params": params}))
    with torch.no_grad():
        _, (cut, orth) = model(*(torch.as_tensor(a) for a in args))
    jcut, jorth = jdemo_min_cut_pool._find_sown(state["losses"], "min_cut_losses")
    np.testing.assert_allclose([float(cut), float(orth)], [float(jcut), float(jorth)], **TOL)
    np.testing.assert_allclose(float(demo_min_cut_pool._aux_loss((cut, orth))),
                               float(jdemo_min_cut_pool._aux_loss(state)), **TOL)


def _recording_value_and_grad(losses):
    real = jax.value_and_grad

    def value_and_grad(fn, *args, **kwargs):
        inner = real(fn, *args, **kwargs)

        def run(*a, **k):
            loss, grads = inner(*a, **k)
            jax.debug.callback(lambda v: losses.append(float(v)), loss, ordered=True)
            return loss, grads
        return run
    return value_and_grad


@pytest.mark.parametrize("name", ["gin", "min_cut_pool"])
def test_run_graph_classification_trajectory_matches_jax(name, hard_split, monkeypatch):
    monkeypatch.setenv("TFG_HARD_GRAPH_CLS", "1")
    jcls, pcls, conv, form = DEMOS[name]
    train, test, _ = hard_split
    steps, lr = 3, 3e-3 if name == "gin" else 5e-3
    extra = dict(extra_loss_from_state=jdemo_min_cut_pool._aux_loss) \
        if name == "min_cut_pool" else {}
    first, _ = next(jdemo_utils.padded_batch_generator(train, BATCH, seed=0))
    key = jax.random.PRNGKey(0)
    c = 2
    params = jcls(num_classes=c, num_graphs=BATCH).init(
        {"params": key, "dropout": key}, *(jnp.asarray(a) for a in (
            first.x, first.edge_index, first.edge_weight, first.node_graph_index)))["params"]

    losses, rec = [], _Masks(traced=True)
    with monkeypatch.context() as m:
        m.setattr(jax, "value_and_grad", _recording_value_and_grad(losses))
        m.setattr(jax.random, "bernoulli", rec)
        jdemo_utils.run_graph_classification(
            lambda nc, g: jcls(num_classes=nc, num_graphs=g), batch_size=BATCH,
            num_steps=steps, learning_rate=lr, seed=0, split=(train, test), **extra)
    assert len(losses) == steps and len(rec.masks) == steps * NUM_MASKS[name]
    step_masks = iter(rec.masks)

    def make_model(nc, g):
        model = pcls(train[0].x.shape[1], nc, g, device="cpu")
        model.load_state_dict(conv({"params": params}))
        forward = model.forward

        def fed(*a):
            masks = [next(step_masks) for _ in range(NUM_MASKS[name])] if model.training \
                else None
            if masks is None:
                return forward(*a)
            masks = [torch.as_tensor(m) for m in masks]
            return forward(*a, **{form: masks if form == "keep_masks" else masks[0]})
        model.forward = fed
        return model

    stats = {}
    demo_utils.run_graph_classification(
        make_model, batch_size=BATCH, num_steps=steps, learning_rate=lr, seed=0,
        split=(train, test), device="cpu", stats=stats,
        extra_loss_from_state=demo_min_cut_pool._aux_loss if extra else None)
    np.testing.assert_allclose(torch.stack(stats["losses"]).numpy(), losses, **TOL)


def test_init_like_flax_scales():
    model = demo_mean_pool.MeanPoolNetwork(4, 2, BATCH, seed=1, device="cpu")
    w = model.Dense_0.weight
    std = (1.0 / w.shape[1]) ** 0.5 / 0.87962566103423978
    assert float(w.detach().abs().max()) <= 2.0 * std + 1e-6
    assert float(model.Dense_0.bias.detach().abs().max()) == 0.0
    k = model.GCN_1.kernel
    assert float(k.detach().abs().max()) <= (6.0 / (k.shape[0] + k.shape[1])) ** 0.5
    again = demo_mean_pool.MeanPoolNetwork(4, 2, BATCH, seed=1, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    big = demo_utils.init_like_flax(torch.nn.Linear(400, 300), seed=0).weight
    np.testing.assert_allclose(float(big.detach().std()), (1.0 / 400) ** 0.5, rtol=0.02)


@pytest.mark.parametrize("name", list(DEMOS))
def test_launches_a_step_are_chip_smokes(name):
    """A training step of each graph twin on chip_smoke.py's check batch (the
    shared split's first padded batch) makes the launches phase 20 holds
    the card to, counted on the CPU."""
    import chip_smoke
    from tests.test_torch_bench_twins import count_launches
    from tf_geometric_tpu_torch.benchmarks.graph_classification import \
        head_to_head_graph_port as gh2h
    train, _ = gh2h.shared_split()
    batch, real = next(demo_utils.padded_batch_generator(train, gh2h.BATCH, seed=0))
    args = tuple(torch.as_tensor(np.asarray(a)) for a in (
        batch.x, batch.edge_index, batch.edge_weight, batch.node_graph_index))
    y = torch.as_tensor(np.asarray(batch.y).flatten()[:real]).long()
    make, _, aux = gh2h.make_model(name, train[0].x.shape[1], 0, "cpu")
    net = make(2, gh2h.BATCH).train()
    with count_launches() as counts:
        out = net(*args)
        loss = torch.nn.functional.cross_entropy(_logits(out)[:real], y)
        if aux:
            loss = loss + aux(out[1])
        loss.backward()
    assert dict(counts) == chip_smoke.H2H_GRAPH_STEP_LAUNCHES[name]
