"""The two card paths of the host samplers, small, on the CPU, against the
JAX package:

- bench workload 18 (``sage_reddit_dense_fwd_bwd``), the twin of
  ``benchmarks/sage_sampling_throughput.py`` with ``SAGE_BENCH_MODE=dense``:
  both packages' ``RandomNeighborSampler(edge_index, rng=0)`` give the same
  draws bit for bit (native draw, and both libraries off), and the port's
  loss and step-1 gradients match the JAX script's step on those draws
  (float32, rtol 1e-4);
- the flat and the dense fixed-k forms of one draw through ``mean_graph_sage``
  and ``mean_graph_sage_fixed_k`` agree (outputs and gradients, 1e-4), as
  the JAX sampler's docstring says they must;
- the graph auto-encoder of ``demo/demo_gae.py``: the port's split, test
  negatives and per-step negatives equal the demo's, and the loss and
  step-1 gradients of the port's encoder equal the demo's flax model's
  (weights carried over, dropout off and with flax's own keep mask; rtol 1e-4).
"""
import importlib
import os
import sys
import types

import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tf_geometric_tpu.native as jnative
import tf_geometric_tpu_torch.native as tnative
from tf_geometric_tpu.data.graph import Graph as JGraph
from tf_geometric_tpu.nn import mean_graph_sage as jmean_graph_sage
from tf_geometric_tpu.nn import mean_graph_sage_fixed_k as jmean_graph_sage_fixed_k
from tf_geometric_tpu.utils import graph_utils as jgu
from tf_geometric_tpu_torch import bench
from tf_geometric_tpu_torch.nn.conv.graph_sage import mean_graph_sage, mean_graph_sage_fixed_k
from tf_geometric_tpu_torch.utils.graph_utils import RandomNeighborSampler

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "demo"))

SAGE_N, SAGE_E, SAGE_F = 1500, 12000, 24
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(params=["native", "numpy"])
def branch(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    else:
        assert jnative.available() and tnative.available()
    return request.param


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=GRAD_TOL["rtol"],
                               atol=max(GRAD_TOL["atol"], 1e-4 * float(np.abs(want).max())),
                               err_msg=what)


def _jax_dense_step(params0, draws):
    """Loss and gradients of the JAX script's dense-mode step
    (``sage_sampling_throughput.py``: two ``mean_graph_sage_fixed_k`` layers
    with relu, ``h @ wd``, mean softmax cross-entropy) on the given draws."""
    rng = np.random.default_rng(0)
    np.stack([rng.integers(0, SAGE_N, SAGE_E), rng.integers(0, SAGE_N, SAGE_E)])
    xs = jnp.asarray(rng.normal(size=(SAGE_N, SAGE_F)).astype(np.float32))
    ys = jnp.asarray(rng.integers(0, 41, SAGE_N).astype(np.int32))
    params = {k: jnp.asarray(v, jnp.float32) for k, v in params0.items()}

    def loss_fn(p, e0, w0, e1, w1):
        h = jmean_graph_sage_fixed_k(xs, e0, w0, p["s0"], p["n0"], activation=jax.nn.relu)
        h = jmean_graph_sage_fixed_k(h, e1, w1, p["s1"], p["n1"], activation=jax.nn.relu)
        return optax.softmax_cross_entropy_with_integer_labels(h @ p["wd"], ys).mean()

    args = [jnp.asarray(a) for pair in draws for a in pair]
    return jax.value_and_grad(loss_fn)(params, *args)


def test_host_sage_step_matches_the_jax_dense_step(branch):
    problem = bench.build_host_sage_problem(SAGE_N, SAGE_E, SAGE_F, device="cpu")
    wl = bench.WORKLOADS[bench.HOST_SAGE_WORKLOAD]
    assert wl.problem == "reddit_host" and wl.edges(problem) == SAGE_N * 35
    rng = np.random.default_rng(0)
    edge_index = np.stack([rng.integers(0, SAGE_N, SAGE_E),
                           rng.integers(0, SAGE_N, SAGE_E)]).astype(np.int32)
    jsampler = jgu.RandomNeighborSampler(edge_index, rng=0)
    want_draws = [jsampler.sample_dense(k=k) for k in bench.SAGE_FANOUTS]

    params = wl.init(problem)
    got_draws = bench.host_sage_draws(problem)
    for (gi, gw), (wi, ww) in zip(got_draws, want_draws):
        assert gi.dtype == torch.int32 and gw.dtype == torch.float32
        np.testing.assert_array_equal(gi.numpy(), wi)
        np.testing.assert_array_equal(gw.numpy(), ww)
    # the next draws follow on from the sampler's generator, as in the script
    np.testing.assert_array_equal(problem.sampler.sample_dense(3)[0],
                                  jsampler.sample_dense(3)[0])

    want_loss, want_grads = _jax_dense_step(problem.params0, want_draws)
    wl.init(problem)  # reseeds the sampler: the loss draws the same slots again
    loss = wl.loss(params, problem)
    loss.backward()
    _close(loss, want_loss, "loss")
    for k in want_grads:
        _close(params[k].grad, want_grads[k], f"grad {k}")
    assert len(problem.timing["draw_ms"]) == 2 and problem.timing["copy"] == []
    rates = bench.host_sage_rates(problem, 1)
    assert rates["copy_ms"] is None and rates["copy_bytes"] == 8 * SAGE_N * 35


def test_host_sage_runs_repeat_from_the_initial_weights():
    problem = bench.build_host_sage_problem(400, 3000, 8, device="cpu")
    wl = bench.WORKLOADS[bench.HOST_SAGE_WORKLOAD]
    runs = []
    for _ in range(2):
        step = bench.make_step(lambda p: wl.loss(p, problem), wl.init(problem), wl.lr)
        runs.append([float(step()) for _ in range(3)])
    assert runs[0] == runs[1] and np.isfinite(runs[0]).all() and runs[0][-1] < runs[0][0]
    assert bench.host_sage_step_bytes(problem) > 0


@pytest.mark.parametrize("k,width", [(25, 16), (3, 40)])
def test_flat_and_dense_forms_of_one_draw_agree(branch, k, width):
    """``sample(k, padding=True)`` into ``mean_graph_sage`` and
    ``sample_dense(k)`` into ``mean_graph_sage_fixed_k``, from one draw
    state: the same outputs and gradients, in both packages."""
    rng = np.random.default_rng(k)
    n = 800
    edge_index = np.stack([rng.integers(0, n - 30, 6000), rng.integers(0, n, 6000)])
    edge_index[0, -1] = n - 1
    x = rng.normal(size=(n, 32)).astype(np.float32)
    ws, wn = (rng.normal(scale=0.2, size=(32, width)).astype(np.float32) for _ in range(2))
    sampler = RandomNeighborSampler(edge_index, rng=1)
    state = sampler.rng.bit_generator.state
    flat_index, flat_weight = sampler.sample(k=k, padding=True)
    sampler.rng.bit_generator.state = state
    idx, w = sampler.sample_dense(k)

    outs, grads = [], []
    for fn, a, b in ((mean_graph_sage, flat_index, flat_weight),
                     (mean_graph_sage_fixed_k, idx, w)):
        leaves = [torch.tensor(v, requires_grad=True) for v in (x, ws, wn)]
        out = fn(leaves[0], torch.as_tensor(a), torch.as_tensor(b), leaves[1], leaves[2],
                 activation=torch.relu)
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        outs.append(out.detach().numpy())
        grads.append([leaf.grad.numpy() for leaf in leaves])
    _close(outs[1], outs[0], "dense vs flat output")
    for g1, g0, name in zip(grads[1], grads[0], ("x", "self kernel", "neighbor kernel")):
        _close(g1, g0, f"dense vs flat gradient of {name}")
    jflat = jmean_graph_sage(x, flat_index, flat_weight, ws, wn, activation=jax.nn.relu)
    jdense = jmean_graph_sage_fixed_k(x, idx, w, ws, wn, activation=jax.nn.relu)
    _close(outs[0], jflat, "flat vs JAX")
    _close(outs[1], jdense, "dense vs JAX")


# ---------------------------------------------------------------------------
# the graph auto-encoder (demo/demo_gae.py)
# ---------------------------------------------------------------------------

GAE_N, GAE_E = 2000, 12000


@pytest.fixture(scope="module")
def gae_problem():
    return bench.build_gae_problem(GAE_N, GAE_E, device="cpu")


def test_gae_split_and_negatives_match_the_demo(gae_problem):
    from tf_geometric_tpu.datasets.synthetic_citation import synthetic_ogbn_arxiv_like
    pr = gae_problem
    graph = synthetic_ogbn_arxiv_like(GAE_N, GAE_E)
    edge_index = np.asarray(graph.edge_index)
    train, test, _, _ = jgu.edge_train_test_split(edge_index, test_size=0.15, random_state=0)
    np.testing.assert_array_equal(pr.train_index, train)
    np.testing.assert_array_equal(pr.test_index, test)
    np.testing.assert_array_equal(
        pr.test_neg, jgu.negative_sampling(test.shape[1], GAE_N, edge_index=edge_index,
                                           replace=False, rng=0))
    jtrain = JGraph(x=np.asarray(graph.x), edge_index=train).to_directed()
    np.testing.assert_array_equal(pr.edge_index.numpy(), np.asarray(jtrain.edge_index))
    np.testing.assert_array_equal(pr.edge_weight.numpy(), np.asarray(jtrain.edge_weight))
    for step in (0, 3):
        np.testing.assert_array_equal(
            bench.gae_negatives(pr, step),
            jgu.negative_sampling(train.shape[1], GAE_N, edge_index=train, rng=step))


class _RecordingBernoulli(types.SimpleNamespace):
    """flax's ``stochastic.random`` with ``bernoulli`` recording its masks."""

    def __init__(self):
        super().__init__(masks=[])

    def bernoulli(self, key, p, shape):
        mask = jax.random.bernoulli(key, p, shape)
        self.masks.append(np.array(mask))
        return mask


@pytest.mark.parametrize("dropout", [False, True])
def test_gae_loss_and_gradients_match_the_demo(gae_problem, dropout, monkeypatch):
    """One step of ``demo_gae.py``'s model on the same split and negatives:
    dropout off (``training=False``), or on with flax's own keep mask."""
    demo = importlib.import_module("demo_gae")
    pr = gae_problem
    x, ei, ew = (jnp.asarray(t.numpy()) for t in (pr.x, pr.edge_index, pr.edge_weight))
    model = demo.GAEEncoder()
    variables = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
                           x, ei, ew)
    neg = bench.gae_negatives(pr, 0)
    pos = jnp.asarray(pr.train_index)
    recorder = _RecordingBernoulli()
    monkeypatch.setattr(flax_stochastic, "random", recorder)

    def jax_loss(params):
        z = model.apply({"params": params}, x, ei, ew, training=dropout,
                        rngs={"dropout": jax.random.PRNGKey(1)})
        pos_logits = demo.predict_edge(z, pos)
        neg_logits = demo.predict_edge(z, jnp.asarray(neg))
        return (jnp.mean(optax.sigmoid_binary_cross_entropy(pos_logits, 1.0))
                + jnp.mean(optax.sigmoid_binary_cross_entropy(neg_logits, 0.0)))

    want, want_grads = jax.value_and_grad(jax_loss)(variables["params"])
    assert len(recorder.masks) == int(dropout)
    encoder = bench.init_gae_model(pr)
    names = {"GCN_0": "gcn0", "GCN_1": "gcn1"}
    encoder.load_state_dict({f"{names[layer]}.{leaf}": torch.tensor(np.asarray(v))
                             for layer, leaves in variables["params"].items()
                             for leaf, v in leaves.items()})
    if not dropout:
        encoder.eval()
    keep = torch.as_tensor(recorder.masks[0]) if dropout else None
    loss = bench.gae_loss(encoder, pr, neg, keep_mask=keep)
    loss.backward()
    _close(loss, want, "loss")
    for layer, leaves in want_grads.items():
        for leaf, g in leaves.items():
            _close(getattr(getattr(encoder, names[layer]), leaf).grad, g, f"{layer} {leaf}")


def test_gae_trains_and_scores_on_the_cpu(gae_problem):
    pr = gae_problem
    encoder = bench.init_gae_model(pr)
    opt = torch.optim.Adam(encoder.parameters(), lr=bench.GAE_LR)
    losses = []
    for step in range(4):
        opt.zero_grad()
        loss = bench.gae_loss(encoder, pr, bench.gae_negatives(pr, step))
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    auc = bench.gae_test_auc(encoder, pr)
    assert 0.0 <= auc <= 1.0 and encoder.training
