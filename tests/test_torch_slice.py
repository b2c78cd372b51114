"""The slices end to end: the port's bench workloads 1, 1b and 3 (GAT)
against a JAX/optax step written as ``bench.py`` writes it, from the same numpy
weights, on the same synthetic arxiv-shaped graph (shrunk), and workload 4
(the sampled GraphSAGE) against the step of
``benchmarks/sage_sampling_throughput.py`` on its Reddit-shaped graph
(shrunk) with the same draws, on the CPU, in float32, over 3 Adam steps.

Tolerance rtol = 1e-4 throughout; the two sides differ only in the order of
float32 sums. The free-running parameters are not compared element by
element: Adam divides each gradient entry by its own magnitude, so an entry
whose gradient sits at float32 rounding level, or a ReLU input within
rounding of 0, turns a 1e-7 difference into an update difference of up to
2·lr, and a few entries of W0 (0.3% in workload 1b) move apart that way.
So the parameters are held in two well-conditioned pieces instead: at each
step's JAX parameters the port's gradient matches JAX's (rtol 1e-4, atol
1e-4 of the largest entry), and the port's optimizer fed JAX's gradients
lands on JAX's parameters (rtol 1e-4, atol 1e-6). The free-running losses
must match as well.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_geometric_tpu.datasets.synthetic_citation import \
    synthetic_ogbn_arxiv_like as jax_arxiv
from tf_geometric_tpu.ops import config as jconfig
from tf_geometric_tpu.sparse import SparseMatrix as JSparse
from tf_geometric_tpu_torch import bench
from tf_geometric_tpu_torch.convert import bench_params_from_numpy
from tf_geometric_tpu_torch.datasets import synthetic_ogbn_arxiv_like as torch_arxiv

jgcn = importlib.import_module("tf_geometric_tpu.nn.conv.gcn")

N, E = 2000, 12000
STEPS = 3


def test_synthetic_arxiv_is_bit_identical():
    a, b = jax_arxiv(), torch_arxiv()
    for field in ("x", "edge_index", "edge_weight", "y"):
        va, vb = np.asarray(getattr(a, field)), np.asarray(getattr(b, field))
        assert va.dtype == vb.dtype and va.shape == vb.shape
        assert np.array_equal(va, vb), field
    assert (b.num_nodes, b.num_edges, b.num_features) == (169_343, 1_166_243, 128)


def _jax_run(workload, monkeypatch):
    """bench.py:82-143 (workload 1) and :261-276 (1b), float32, 3 steps."""
    monkeypatch.setattr(jconfig, "ell_compute_dtype", None)
    graph = jax_arxiv(num_nodes=N, num_edges=E)
    n, f = graph.x.shape
    cache = {}
    normed = jgcn.gcn_norm_adj(JSparse(graph.edge_index, graph.edge_weight, (n, n)),
                               cache=cache)
    adj = jgcn.maybe_compile_ell(normed, cache,
                                 jgcn.compute_cache_key("both", True, True, True, False))
    x, y = jnp.asarray(graph.x), jnp.asarray(graph.y)
    px = jgcn.precompute_propagated_features(
        x, JSparse(graph.edge_index, graph.edge_weight, (n, n)), cache=cache)
    rng = np.random.default_rng(0)
    params = {
        "w0": jnp.asarray(rng.normal(scale=0.05, size=(f, bench.HIDDEN)), jnp.float32),
        "b0": jnp.zeros(bench.HIDDEN),
        "w1": jnp.asarray(rng.normal(scale=0.05, size=(bench.HIDDEN, bench.NUM_CLASSES)),
                          jnp.float32),
        "b1": jnp.zeros(bench.NUM_CLASSES),
    }

    def loss_fn(p):
        if workload == "gcn_arxiv_fwd_bwd":
            h = jax.nn.relu(px @ p["w0"] + p["b0"])
        else:
            h = jax.nn.relu(adj.matmul(x @ p["w0"]) + p["b0"])
        logits = adj.matmul(h @ p["w1"]) + p["b1"]
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    optimizer = optax.adam(1e-2)
    state = optimizer.init(params)
    trace = []  # (params before the step, grads, loss)
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    for _ in range(STEPS):
        loss, grads = value_and_grad(params)
        trace.append(({k: np.array(v) for k, v in params.items()},
                      {k: np.array(v) for k, v in grads.items()}, float(loss)))
        updates, state = optimizer.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return trace, {k: np.array(v) for k, v in params.items()}


@pytest.mark.parametrize("workload", sorted(bench.GCN_WORKLOADS))
def test_workload_matches_jax_optax(workload, monkeypatch):
    trace, want_final = _jax_run(workload, monkeypatch)
    problem = bench.build_problem(N, E, device="cpu", spmm_bf16=False)
    assert problem.adj.fwd.num_virtual > 0  # the hub merge runs in the step
    loss_fn = bench.WORKLOADS[workload][0]

    # free-running losses
    params = bench.init_params(problem.x.shape[1], device="cpu")
    for k, v in trace[0][0].items():
        np.testing.assert_array_equal(params[k].detach().numpy(), v, err_msg=k)
    step = bench.make_step(lambda p: loss_fn(p, problem, dense_bf16=False), params)
    losses = [float(step()) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, [t[2] for t in trace], rtol=1e-4, atol=1e-6)
    assert losses[-1] < losses[0]

    # the gradient at each step's JAX parameters
    for t, (jparams, jgrads, jloss) in enumerate(trace):
        p = bench.bench_params_from_numpy(jparams, device="cpu")
        loss = loss_fn(p, problem, dense_bf16=False)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-4)
        for k, g in jgrads.items():
            np.testing.assert_allclose(p[k].grad.numpy(), g, rtol=1e-4,
                                       atol=1e-4 * np.abs(g).max(), err_msg=f"step {t} {k}")

    # the port's Adam fed JAX's gradients: sum(p * g) has gradient g exactly
    params = bench.bench_params_from_numpy(trace[0][0], device="cpu")
    grads = {}
    step = bench.make_step(
        lambda p: sum((p[k] * torch.as_tensor(grads[k])).sum() for k in p), params)
    for _, jgrads, _ in trace:
        grads.update(jgrads)
        step()
    for k, v in want_final.items():
        np.testing.assert_allclose(params[k].detach().numpy(), v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_bf16_default_path_runs_on_cpu_tensors():
    """The bench's default policy (bf16 SpMM and dense x@W0) through the
    plain versions: finite, falling, and within bf16 error of float32."""
    bf16 = bench.build_problem(N, E, device="cpu", spmm_bf16=True)
    f32 = bench.build_problem(N, E, device="cpu", spmm_bf16=False)
    runs = []
    for problem, dense_bf16 in ((bf16, True), (f32, False)):
        params = bench.init_params(problem.x.shape[1], device="cpu")
        step = bench.make_step(
            lambda p: bench.canonical_loss(p, problem, dense_bf16=dense_bf16), params)
        runs.append([float(step()) for _ in range(STEPS)])
    assert all(np.isfinite(runs[0])) and runs[0][-1] < runs[0][0]
    # logits carry ~2^-8 relative error; the mean loss moves far less than 1e-2
    np.testing.assert_allclose(runs[0], runs[1], rtol=0, atol=1e-2)


def test_entry_matches_jax_entry():
    import __graft_entry__
    from tf_geometric_tpu_torch.entry import entry
    jfn, jargs = __graft_entry__.entry()
    want = np.asarray(jfn(*jargs))
    fn, args = entry(device="cpu")
    got = fn(*args)
    assert got.shape == want.shape == (512, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_bench_params_from_numpy():
    rng = np.random.default_rng(0)
    raw = {"w0": rng.normal(size=(3, 2)), "b0": np.zeros(2),
           "w1": rng.normal(size=(2, 4)), "b1": np.zeros(4)}
    p = bench_params_from_numpy(raw, device="cpu")
    assert all(t.dtype == torch.float32 and t.requires_grad and t.is_leaf
               for t in p.values())
    np.testing.assert_array_equal(p["w1"].detach().numpy(), raw["w1"].astype(np.float32))
    with pytest.raises(KeyError):
        bench_params_from_numpy({"w0": raw["w0"]}, device="cpu")


def _jax_gat_run():
    """bench.py:343-384 (workload 3) in float32, 3 Adam(1e-3) steps."""
    from tf_geometric_tpu.nn.conv.gat import _gat_edge_cache, gat as jax_gat
    graph = jax_arxiv(num_nodes=N, num_edges=E)
    n, f = graph.x.shape
    sorted_ei, _, layout = _gat_edge_cache(jnp.asarray(graph.edge_index), n, {})
    x, y = jnp.asarray(graph.x), jnp.asarray(graph.y)
    rng = np.random.default_rng(0)
    rng.normal(scale=0.05, size=(f, bench.HIDDEN))           # the GCN's w0
    rng.normal(scale=0.05, size=(bench.HIDDEN, bench.NUM_CLASSES))  # and w1
    units = bench.GAT_UNITS
    params = {
        "wq": jnp.asarray(rng.normal(scale=0.05, size=(f, units)), jnp.float32),
        "bq": jnp.zeros(units),
        "wk": jnp.asarray(rng.normal(scale=0.05, size=(f, units)), jnp.float32),
        "bk": jnp.zeros(units),
        "wv": jnp.asarray(rng.normal(scale=0.05, size=(f, units)), jnp.float32),
        "wd": jnp.asarray(rng.normal(scale=0.05, size=(units, bench.NUM_CLASSES)),
                          jnp.float32),
        "bd": jnp.zeros(bench.NUM_CLASSES),
    }

    def loss_fn(p):
        h = jax_gat(x, None, p["wq"], p["bq"], jax.nn.relu, p["wk"], p["bk"], jax.nn.relu,
                    p["wv"], num_heads=bench.GAT_HEADS, num_nodes=n, ell_layout=layout,
                    sorted_edge_index=sorted_ei)
        logits = h @ p["wd"] + p["bd"]
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    optimizer = optax.adam(1e-3)
    state = optimizer.init(params)
    trace = []
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    for _ in range(STEPS):
        loss, grads = value_and_grad(params)
        trace.append(({k: np.array(v) for k, v in params.items()},
                      {k: np.array(v) for k, v in grads.items()}, float(loss)))
        updates, state = optimizer.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return trace, {k: np.array(v) for k, v in params.items()}


def test_gat_workload_matches_jax_optax(monkeypatch):
    """The GAT bench step in float32 at 2,000 nodes: free-running losses
    within 1e-5, the gradient at each step's JAX parameters within 2e-3
    (rtol, and atol 2e-3 of the largest entry; the backward recomputes the
    softmax weights from lse), and the port's Adam fed JAX's gradients."""
    monkeypatch.setattr(jconfig, "ell_compute_dtype", None)
    trace, want_final = _jax_gat_run()
    problem = bench.build_problem(N, E, device="cpu", spmm_bf16=False)
    assert problem.gat_layout.num_edges == E + N
    wl = bench.WORKLOADS["gat_arxiv_fwd_bwd"]

    params = wl.init(problem)
    for k, v in trace[0][0].items():
        np.testing.assert_array_equal(params[k].detach().numpy(), v, err_msg=k)
    step = bench.make_step(lambda p: wl.loss(p, problem), params, wl.lr)
    losses = [float(step()) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, [t[2] for t in trace], rtol=0, atol=1e-5)
    assert losses[-1] < losses[0]

    for t, (jparams, jgrads, jloss) in enumerate(trace):
        p = bench.bench_params_from_numpy(jparams, device="cpu",
                                          names=bench.GAT_BENCH_PARAM_NAMES)
        loss = wl.loss(p, problem)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), jloss, rtol=0, atol=1e-5)
        for k, g in jgrads.items():
            np.testing.assert_allclose(p[k].grad.numpy(), g, rtol=2e-3,
                                       atol=2e-3 * np.abs(g).max(), err_msg=f"step {t} {k}")

    params = bench.bench_params_from_numpy(trace[0][0], device="cpu",
                                           names=bench.GAT_BENCH_PARAM_NAMES)
    grads = {}
    step = bench.make_step(
        lambda p: sum((p[k] * torch.as_tensor(grads[k])).sum() for k in p), params, wl.lr)
    for _, jgrads, _ in trace:
        grads.update(jgrads)
        step()
    for k, v in want_final.items():
        np.testing.assert_allclose(params[k].detach().numpy(), v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the sampled GraphSAGE step (benchmarks/sage_sampling_throughput.py, device mode)
# ---------------------------------------------------------------------------

SAGE_N, SAGE_E, SAGE_F, SAGE_FANOUTS = 2000, 20000, 64, (5, 3)


def _sage_ints(step):
    """The random integers of each step's two draws, made with numpy."""
    rng = np.random.default_rng(1000 + step)
    return [rng.integers(0, np.iinfo(np.int32).max, (k, SAGE_N)).astype(np.int32)
            for k in SAGE_FANOUTS]


def _jax_sage_run(monkeypatch):
    """sage_sampling_throughput.py:37-84 (device mode) at a small size, the
    draws' ``jax.random.randint`` returning ``_sage_ints(step)``, 3 Adam
    steps."""
    from tf_geometric_tpu.nn import DeviceNeighborSampler, mean_graph_sage_fixed_k
    rng = np.random.default_rng(0)
    edge_index = np.stack([rng.integers(0, SAGE_N, SAGE_E),
                           rng.integers(0, SAGE_N, SAGE_E)]).astype(np.int32)
    x = jnp.asarray(rng.normal(size=(SAGE_N, SAGE_F)).astype(np.float32))
    y = jnp.asarray(rng.integers(0, 41, SAGE_N).astype(np.int32))
    h, half = bench.SAGE_HIDDEN, bench.SAGE_HIDDEN // 2
    params = {
        "s0": jnp.asarray(rng.normal(scale=0.05, size=(SAGE_F, half)), jnp.float32),
        "n0": jnp.asarray(rng.normal(scale=0.05, size=(SAGE_F, half)), jnp.float32),
        "s1": jnp.asarray(rng.normal(scale=0.05, size=(h, half)), jnp.float32),
        "n1": jnp.asarray(rng.normal(scale=0.05, size=(h, half)), jnp.float32),
        "wd": jnp.asarray(rng.normal(scale=0.05, size=(h, 41)), jnp.float32),
    }
    sampler = DeviceNeighborSampler(edge_index, num_nodes=SAGE_N)
    queue = []
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, minval, maxval, dtype=jnp.int32:
                        jnp.asarray(queue.pop(0), dtype))

    def loss_fn(p, e0, w0, e1, w1):
        hh = mean_graph_sage_fixed_k(x, e0, w0, p["s0"], p["n0"], activation=jax.nn.relu)
        hh = mean_graph_sage_fixed_k(hh, e1, w1, p["s1"], p["n1"], activation=jax.nn.relu)
        return optax.softmax_cross_entropy_with_integer_labels(hh @ p["wd"], y).mean()

    optimizer = optax.adam(1e-2)
    state = optimizer.init(params)
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    trace = []
    for t in range(STEPS):
        queue[:] = _sage_ints(t)
        draws = [sampler.sample(jax.random.PRNGKey(t), k) for k in SAGE_FANOUTS]
        loss, grads = value_and_grad(params, *draws[0], *draws[1])
        trace.append(({k: np.array(v) for k, v in params.items()},
                      {k: np.array(v) for k, v in grads.items()}, float(loss)))
        updates, state = optimizer.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return trace, {k: np.array(v) for k, v in params.items()}


def test_synthetic_reddit_is_bit_identical_to_the_benchmark_graph():
    from tf_geometric_tpu_torch.datasets import synthetic_reddit_like
    rng = np.random.default_rng(0)
    edge_index = np.stack([rng.integers(0, 500, 3000),
                           rng.integers(0, 500, 3000)]).astype(np.int32)
    x = rng.normal(size=(500, 12)).astype(np.float32)
    y = rng.integers(0, 41, 500).astype(np.int32)
    graph = synthetic_reddit_like(500, 3000, 12)
    for want, got in ((edge_index, graph.edge_index), (x, graph.x), (y, graph.y)):
        assert want.dtype == got.dtype and np.array_equal(want, got)
    # the benchmark's weights come next from the same generator
    problem = bench.build_sage_problem(500, 3000, 12, device="cpu")
    np.testing.assert_array_equal(problem.params0["s0"], rng.normal(scale=0.05, size=(12, 128)))


def test_sage_workload_matches_jax_optax(monkeypatch):
    """Three SAGE steps in float32 at 2,000 nodes, both packages drawing
    from the same integers: free-running losses within rtol 1e-4, the
    gradient at each step's JAX parameters within rtol 1e-4 (atol 1e-4 of
    the largest entry), and the port's Adam fed JAX's gradients."""
    trace, want_final = _jax_sage_run(monkeypatch)
    problem = bench.build_sage_problem(SAGE_N, SAGE_E, SAGE_F, device="cpu",
                                       fanouts=SAGE_FANOUTS)
    wl = bench.WORKLOADS["sage_reddit_fwd_bwd"]
    assert wl.edges(problem) == SAGE_N * sum(SAGE_FANOUTS)
    tds = importlib.import_module("tf_geometric_tpu_torch.nn.sampling.device_sampler")
    queue = []

    def fixed_ints(generator, k, num_rows, device):
        r = queue.pop(0)
        assert r.shape == (k, num_rows)
        return torch.as_tensor(r)

    monkeypatch.setattr(tds, "_random_ints", fixed_ints)

    params = wl.init(problem)
    for k, v in trace[0][0].items():
        np.testing.assert_array_equal(params[k].detach().numpy(), v, err_msg=k)
    step = bench.make_step(lambda p: wl.loss(p, problem), params, wl.lr)
    losses = []
    for t in range(STEPS):
        queue[:] = _sage_ints(t)
        losses.append(float(step()))
    np.testing.assert_allclose(losses, [t[2] for t in trace], rtol=1e-4, atol=1e-6)
    assert losses[-1] < losses[0]

    for t, (jparams, jgrads, jloss) in enumerate(trace):
        p = bench.bench_params_from_numpy(jparams, device="cpu",
                                          names=bench.SAGE_BENCH_PARAM_NAMES)
        queue[:] = _sage_ints(t)
        loss = wl.loss(p, problem)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-4)
        for k, g in jgrads.items():
            np.testing.assert_allclose(p[k].grad.numpy(), g, rtol=1e-4,
                                       atol=1e-4 * np.abs(g).max(), err_msg=f"step {t} {k}")

    params = bench.bench_params_from_numpy(trace[0][0], device="cpu",
                                           names=bench.SAGE_BENCH_PARAM_NAMES)
    grads = {}
    step = bench.make_step(
        lambda p: sum((p[k] * torch.as_tensor(grads[k])).sum() for k in p), params, wl.lr)
    for _, jgrads, _ in trace:
        grads.update(jgrads)
        step()
    for k, v in want_final.items():
        np.testing.assert_allclose(params[k].detach().numpy(), v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_sage_step_draws_fresh_and_reseeds_at_init():
    """Each step draws anew from the problem's generator, and making the
    initial weights reseeds it, so two runs from them see the same draws."""
    problem = bench.build_sage_problem(300, 2000, 8, device="cpu", fanouts=(4, 2))
    wl = bench.WORKLOADS["sage_reddit_fwd_bwd"]
    runs = []
    for _ in range(2):
        step = bench.make_step(lambda p: wl.loss(p, problem), wl.init(problem), wl.lr)
        runs.append([float(step()) for _ in range(3)])
    assert runs[0] == runs[1] and np.isfinite(runs[0]).all()
    first = problem.sampler.sample(problem.generator, 4)[0]
    assert not torch.equal(first, problem.sampler.sample(problem.generator, 4)[0])
