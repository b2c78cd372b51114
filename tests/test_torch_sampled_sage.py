"""The port's node-partitioned sampled SAGE
(``tf_geometric_tpu_torch/parallel/sampled_sage.py``) against the JAX
package's (``tf_geometric_tpu/parallel/sampled_sage.py``) on the CPU.

- ``build_csr_shards`` bit for bit, and its refusal of a node count the
  part count does not divide.
- ``_sampled_mean_layer`` on each of P = 4 ranks, in one process (the
  all-gather replaced by the concatenation of every rank's projected
  table), against the JAX layer under ``shard_map`` on a 4-device sub-mesh
  of conftest's 8 virtual CPU devices, the draws fed the same random
  integers: float32 rtol = atol = 1e-5 (the same products summed in
  another order); with a bfloat16 exchange 2e-2 (the table rounded to
  bfloat16 on both sides; the port rounds the aggregated sum once more).
- The whole step on 4 spawned gloo ranks against the JAX step, the port's
  draws fed the integers the JAX step draws (``jax.random.randint`` under
  the keys it folds, computed outside the step): 3 steps' losses (rtol
  1e-5) and the step-1 gradients before Adam against JAX's over P (the JAX
  step ``psum``s gradients that ``shard_map`` already summed; rtol 1e-5,
  atol 1e-6); the bfloat16 exchange at 2e-2. JAX's gradients are read from
  optax's first moment after one step from a fresh state (mu = 0.1·g).
- The ring graph (every node has exactly one neighbour, so every draw
  gives the exact mean) against a dense numpy oracle, the port drawing from
  its own generators.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as JP

from tf_geometric_tpu.parallel import build_mesh as jbuild_mesh
from tf_geometric_tpu.parallel import sampled_sage as jss
from tf_geometric_tpu_torch.convert import sampled_sage_params_from_jax
from tf_geometric_tpu_torch.parallel import sampled_sage as ss
from tf_geometric_tpu_torch.parallel.runner import ShardJob, params_to_numpy, run_ranks
from tf_geometric_tpu_torch.parallel.sharded import GraphMesh

P, N, F_IN, HIDDEN, CLASSES, K = 4, 256, 12, 8, 5, (4, 3)
STEPS = 3
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
INT32_MAX = np.iinfo(np.int32).max


def _graph(seed=0, weighted=True):
    """A random graph whose last 12 nodes have no edges of their own (their
    draws point at themselves), weights in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    e = 1500
    ei = np.stack([rng.integers(0, N - 12, e), rng.integers(0, N, e)]).astype(np.int32)
    ew = rng.uniform(0.5, 1.5, e).astype(np.float32) if weighted else None
    x = rng.normal(size=(N, F_IN)).astype(np.float32)
    y = rng.integers(0, CLASSES, N).astype(np.int32)
    mask = (rng.random(N) < 0.7).astype(np.float32)
    return ei, ew, x, y, mask


def _ring_graph(n=N):
    rows = np.arange(n, dtype=np.int64)
    return np.stack([rows, (rows + 1) % n]).astype(np.int32)


def _jax_ints(key, device: int, layer: int, k: int, n_local: int) -> np.ndarray:
    """The integers the JAX step's draw asks for on ``device`` in ``layer``
    (its keys: ``fold_in(fold_in(key, device), layer)``)."""
    sub = jax.random.fold_in(jax.random.fold_in(key, device), layer)
    return np.array(jax.random.randint(sub, (k, n_local), 0, INT32_MAX, dtype=jnp.int32))


def _rank_csr(shards, r):
    return {name: torch.as_tensor(a[r]) for name, a in shards.items()}


# ---------------------------------------------------------------------------
# build_csr_shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted,parts", [(False, 4), (True, 4), (True, 8), (False, 1)])
def test_build_csr_shards_matches_jax(weighted, parts):
    ei, ew, *_ = _graph(1, weighted)
    got = ss.build_csr_shards(ei, N, parts, edge_weight=ew)
    want = jss.build_csr_shards(ei, N, parts, edge_weight=ew)
    assert sorted(got) == sorted(want)
    for name in got:
        assert got[name].dtype == np.asarray(want[name]).dtype, name
        np.testing.assert_array_equal(got[name], np.asarray(want[name]), err_msg=name)
    assert got["sorted_col"].shape[1] % 128 == 0


@pytest.mark.parametrize("num_nodes,parts", [(10, 4), (N + 1, 4), (6, 5)])
def test_build_csr_shards_refuses_indivisible_nodes(num_nodes, parts):
    ei = _ring_graph(num_nodes)
    with pytest.raises(ValueError, match="divisible"):
        ss.build_csr_shards(ei, num_nodes, parts)
    with pytest.raises(ValueError, match="divisible"):
        jss.build_csr_shards(ei, num_nodes, parts)


@pytest.mark.parametrize("layers,hidden", [(2, 8), (3, 16)])
def test_init_params_match_jax(layers, hidden):
    """The port's ``init_params`` draws JAX's weights from the same numpy
    generator, in the port's layout (``sampled_sage_params_from_jax``)."""
    k = (2,) * layers
    want = jss.make_sampled_sage_step(jbuild_mesh({"graph": P}), {}, F_IN, CLASSES, k=k,
                                      hidden=hidden)[1](np.random.default_rng(4))
    got = ss.make_sampled_sage_step(GraphMesh(None, 0, P), {}, F_IN, CLASSES, k=k,
                                    hidden=hidden)[1](np.random.default_rng(4), "cpu")
    ref = sampled_sage_params_from_jax(want, "cpu")
    assert len(got) == layers + 1
    for a, b in zip(got, ref):
        for u, v in zip(a, b):
            assert u.requires_grad and u.dtype == torch.float32
            assert torch.equal(u, v)


# ---------------------------------------------------------------------------
# one layer, each rank in this process
# ---------------------------------------------------------------------------

def _jax_layer(shards, x, kernels, k, key, exchange):
    """JAX's ``_sampled_mean_layer`` under ``shard_map`` on P devices."""
    mesh = jbuild_mesh({"graph": P})
    names = sorted(shards)
    self_k, nb_k, bias = map(jnp.asarray, kernels)

    def local(x_local, *csr_flat):
        csr = {n: a[0] for n, a in zip(names, csr_flat)}
        dev_key = jax.random.fold_in(jax.random.fold_in(key, jax.lax.axis_index("graph")), 0)
        return jss._sampled_mean_layer(x_local, dev_key, csr, k, self_k, nb_k, bias, "graph",
                                       jax.nn.relu)

    fn = shard_map(local, mesh=mesh, in_specs=(JP("graph", None),) + (JP("graph", None),)
                   * len(names), out_specs=JP("graph", None))
    old = jss.exchange_dtype
    jss.set_exchange_dtype(exchange)
    try:
        return np.asarray(jax.jit(fn)(jnp.asarray(x), *(jnp.asarray(shards[n]) for n in names)))
    finally:
        jss.set_exchange_dtype(old)


class _ConcatGather:
    """The all-gather of one rank in one process: every rank's projected
    table in rank order, this rank's slice the given tensor."""

    def __init__(self, tables):
        self.tables = tables

    def apply(self, hw_local, mesh):
        parts = list(self.tables)
        parts[mesh.rank] = hw_local
        return torch.cat(parts)


@pytest.mark.parametrize("weighted,exchange", [(True, None), (False, None),
                                               (True, "bfloat16")])
def test_sampled_mean_layer_matches_jax(monkeypatch, weighted, exchange):
    ei, ew, x, *_ = _graph(2, weighted)
    shards = ss.build_csr_shards(ei, N, P, edge_weight=ew)
    rng = np.random.default_rng(3)
    kernels = (rng.normal(size=(F_IN, HIDDEN // 2)).astype(np.float32),
               rng.normal(size=(F_IN, HIDDEN // 2)).astype(np.float32),
               rng.normal(size=HIDDEN).astype(np.float32))
    k, key, n_local = K[0], jax.random.PRNGKey(5), N // P
    want = _jax_layer(shards, x, kernels, k, key, getattr(jnp, exchange) if exchange else None)
    dtype = getattr(torch, exchange) if exchange else None
    xs = torch.as_tensor(x).view(P, n_local, F_IN)
    self_k, nb_k, bias = map(torch.as_tensor, kernels)
    tables = [(xs[r] @ nb_k).to(dtype) if dtype else xs[r] @ nb_k for r in range(P)]
    monkeypatch.setattr(ss, "_AllGather", _ConcatGather(tables))
    ss.set_exchange_dtype(dtype)
    try:
        got = torch.cat([ss._sampled_mean_layer(
            xs[r], _rank_csr(shards, r), k, self_k, nb_k, bias, GraphMesh(None, r, P),
            torch.relu, ints=torch.as_tensor(_jax_ints(key, r, 0, k, n_local)))
            for r in range(P)])
    finally:
        ss.set_exchange_dtype(None)
    np.testing.assert_allclose(got.numpy(), want, **(BF16_TOL if exchange else LAYER_TOL))


def test_sampled_mean_layer_refuses_ids_outside_the_table(monkeypatch):
    """On the CPU path a drawn id past the gathered table raises (the
    kernel needs ids below the table's rows; JAX would clip)."""
    ei, _, x, *_ = _graph(4, weighted=False)
    shards = ss.build_csr_shards(ei, N, P)
    csr = _rank_csr(shards, 0)
    csr["sorted_col"] = csr["sorted_col"] + N   # every neighbour id out of range
    n_local = N // P
    xs = torch.as_tensor(x[:n_local])
    w = torch.zeros(F_IN, HIDDEN // 2)
    monkeypatch.setattr(ss, "_AllGather", _ConcatGather([xs @ w] * P))
    with pytest.raises(ValueError, match="outside the gathered table"):
        ss._sampled_mean_layer(xs, csr, 2, w, w, torch.zeros(HIDDEN), GraphMesh(None, 0, P),
                               None, ints=torch.zeros((2, n_local), dtype=torch.int32))


# ---------------------------------------------------------------------------
# the whole step on 4 spawned ranks
# ---------------------------------------------------------------------------

def _jax_run(shards, x, y, mask, params, exchange):
    """STEPS free-running JAX steps from ``params`` (keys PRNGKey(i)):
    losses and the step-1 gradients (optax's first moment over 0.1)."""
    mesh = jbuild_mesh({"graph": P})
    old = jss.exchange_dtype
    jss.set_exchange_dtype(exchange)
    try:
        step, _, optimizer = jss.make_sampled_sage_step(
            mesh, {n: jnp.asarray(a) for n, a in shards.items()}, num_features=F_IN,
            num_classes=CLASSES, k=K, hidden=HIDDEN)
        state = optimizer.init(params)
        losses, grads = [], None
        for i in range(STEPS):
            params, state, loss = step(params, state, jax.random.PRNGKey(i), jnp.asarray(x),
                                       jnp.asarray(y), jnp.asarray(mask))
            if i == 0:
                mu = state[0].mu
                grads = [(m["self"], m["nb"], m["bias"]) for m in mu[:-1]] + [
                    (mu[-1]["w"], mu[-1]["b"])]
                grads = [tuple(np.asarray(g) / 0.1 for g in layer) for layer in grads]
            losses.append(float(loss))
    finally:
        jss.set_exchange_dtype(old)
    return losses, grads


@pytest.fixture(scope="module")
def sage_runs():
    """The f32 and bf16-exchange cases through JAX and through the port on 4
    spawned gloo ranks, and the ring graph through the port (one spawn)."""
    ei, ew, x, y, mask = _graph(6)
    shards = ss.build_csr_shards(ei, N, P, edge_weight=ew)
    jparams = jss.make_sampled_sage_step(jbuild_mesh({"graph": P}), {
        n: jnp.asarray(a) for n, a in shards.items()}, F_IN, CLASSES, k=K,
        hidden=HIDDEN)[1](np.random.default_rng(1))
    port_params = params_to_numpy(sampled_sage_params_from_jax(jparams, "cpu"))
    ref = {label: _jax_run(shards, x, y, mask, jparams, exchange)
           for label, exchange in (("f32", None), ("bf16", jnp.bfloat16))}
    ring = _ring_graph()
    ring_shards = ss.build_csr_shards(ring, N, P)
    ring_params = ss.init_sampled_sage_params(np.random.default_rng(7), F_IN, CLASSES,
                                              len(K), HIDDEN)
    n_local = N // P
    jobs = []
    for r in range(P):
        rows = slice(r * n_local, (r + 1) * n_local)
        ints = [[_jax_ints(jax.random.PRNGKey(i), r, li, k, n_local) for li, k in enumerate(K)]
                for i in range(STEPS)]
        plan = {name: a[r] for name, a in shards.items()}
        base = ShardJob("f32", "sage", port_params, x[rows], y[rows], mask[rows], plan,
                        {"k": K, "ints": ints}, STEPS)
        jobs.append([base,
                     base._replace(name="bf16", options=dict(base.options,
                                                             exchange_dtype="bfloat16")),
                     ShardJob("ring", "sage", ring_params, x[rows], y[rows],
                              np.ones(n_local, np.float32),
                              {name: a[r] for name, a in ring_shards.items()},
                              {"k": K, "seed": 3}, 1)])
    results = run_ranks(jobs, backend="gloo", device="cpu", timeout_s=300)
    by_name = [{res["name"]: res for res in rank} for rank in results]
    return ref, by_name, (x, ring_params)


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_sampled_sage_step_matches_jax(sage_runs, case):
    ref, ranks, _ = sage_runs
    losses, grads = ref[case]
    loss_tol, grad_tol = (LOSS_TOL, GRAD_TOL) if case == "f32" else (BF16_TOL, BF16_TOL)
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[case]["losses"], losses, **loss_tol, err_msg=f"rank {r}")
        for li, (got, want) in enumerate(zip(res[case]["grads"], grads)):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w / P, **grad_tol,
                                           err_msg=f"rank {r} layer {li}")
    for res in ranks[1:]:   # the replicas stay identical
        for a, b in zip(res[case]["params"], ranks[0][case]["params"]):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)


def test_sampled_sage_step_matches_dense_oracle_on_ring(sage_runs):
    """On the ring every draw picks the one neighbour: the loss is the
    dense model's (weights ``init_sampled_sage_params(default_rng(7))``)."""
    _, ranks, (x, params) = sage_runs

    def layer(h, p):
        self_k, nb_k, bias = p
        return np.maximum(np.concatenate([h @ self_k, np.roll(h, -1, axis=0) @ nb_k], axis=1)
                          + bias, 0.0)

    h = x.astype(np.float64)
    for p in params[:-1]:
        h = layer(h, p)
    logits = h @ params[-1][0] + params[-1][1]
    labels = _graph(6)[3]
    z = logits - logits.max(axis=1, keepdims=True)
    ce = -z[np.arange(N), labels] + np.log(np.exp(z).sum(axis=1))
    for res in ranks:
        np.testing.assert_allclose(res["ring"]["losses"][0], ce.mean(), rtol=1e-5, atol=1e-6)
