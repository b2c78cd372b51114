"""The two parallel demo twins (``tf_geometric_tpu_torch/demos``:
``demo_distributed_gcn``, ``demo_distributed_mean_pool``) against the JAX
scripts on the CPU, each side on 4 workers: the JAX script on the first 4
of conftest's 8 virtual devices (``jax.devices`` replaced by a 4-device
list, which its ``build_mesh`` reads too), the twin on 4 gloo ranks
(``parallel.run_ranks``), 3 steps (``TFG_DEMO_SMOKE_STEPS``).

The graph-parallel GCN, on the small synthetic citation graph of
``test_torch_demo_twins_node.py``: the row partition of the normalized
adjacency bit for bit (the twin's partitioner fed the script's
normalization; the twin's normalization within 1e-6). The data-parallel
mean pool, on the synthetic NCI1 set: every step's per-rank blocks of
``shard_batch`` (features, edges, graph ids, labels, masks) bit for bit
with the arrays the script hands its step. For both: the losses within
rtol = atol = 1e-4; the step-1 gradient Adam is given equal to a
single-process oracle (the gradient of the global masked mean) within
1e-5; the script's (its devices' local gradients, summed by its ``psum``)
equal to it times a factor that the test measures and holds to the device
count, 4 (ROADMAP §3's reference fault: ``sharded.py:158`` and
``demo_distributed_mean_pool.py:77``); the test accuracy equal.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_demo_twins_node import GRAPH, SPLITS, TOL, _graphs, offline  # noqa: F401
from tf_geometric_tpu_torch.demos import demo_distributed_gcn, demo_distributed_mean_pool

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "demo"))

import demo_distributed_gcn as jdemo_distributed_gcn  # noqa: E402
import demo_distributed_mean_pool as jdemo_distributed_mean_pool  # noqa: E402

P = 4
STEPS = 3
ORACLE = dict(rtol=1e-5, atol=1e-5)


def _jax_on_p_devices(mp):
    """``jax.devices`` answering the first ``P`` devices, and
    ``jax.value_and_grad`` recording each device's loss and local gradient
    inside ``shard_map`` (unordered debug callbacks: ``P`` a step)."""
    real_devices, real_vg = jax.devices, jax.value_and_grad
    mp.setattr(jax, "devices", lambda *a, **k: real_devices(*a, **k)[:P])
    records = []

    def value_and_grad(fn, *args, **kwargs):
        inner = real_vg(fn, *args, **kwargs)

        def run(*a, **k):
            loss, grads = inner(*a, **k)
            jax.debug.callback(lambda v, g: records.append(
                (float(v), jax.tree_util.tree_map(np.array, g))), loss, grads)
            return loss, grads
        return run

    mp.setattr(jax, "value_and_grad", value_and_grad)
    return records


def _steps_of(records):
    """``(losses, summed step-1 gradient leaves)`` of the recorded runs."""
    jax.effects_barrier()
    assert len(records) == P * STEPS
    losses = []
    for s in range(STEPS):
        step = [v for v, _ in records[s * P:(s + 1) * P]]
        np.testing.assert_allclose(step, step[0], rtol=1e-6)
        losses.append(step[0])
    leaves = [jax.tree_util.tree_leaves(g) for _, g in records[:P]]
    return losses, [sum(parts) for parts in zip(*leaves)]


def _measured_factor(jax_leaves, oracle_leaves):
    """The least-squares factor between the script's gradient and the
    oracle's, over every element."""
    a = np.concatenate([np.ravel(g) for g in jax_leaves])
    b = np.concatenate([np.ravel(g) for g in oracle_leaves])
    return float(a @ b / (b @ b))


def _check_gradients(port_leaves, oracle_leaves, jax_leaves):
    assert len(port_leaves) == len(oracle_leaves) == len(jax_leaves)
    for got, want in zip(port_leaves, oracle_leaves):
        np.testing.assert_allclose(got, want, **ORACLE)
    factor = _measured_factor(jax_leaves, oracle_leaves)
    print(f"measured gradient factor: {factor!r}")
    assert factor == pytest.approx(P, rel=1e-4)
    for got, want in zip(port_leaves, jax_leaves):
        np.testing.assert_allclose(got, np.asarray(want) / factor, rtol=1e-4, atol=1e-6)
    return factor


@pytest.fixture(scope="module")
def gcn_runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("TFG_DEMO_SMOKE_STEPS", str(STEPS))
        jdata, pdata = _graphs()
        records = _jax_on_p_devices(mp)
        mp.setattr(jdemo_distributed_gcn, "load_cora", lambda: jdata)
        jacc = jdemo_distributed_gcn.main()
        jax_losses, jax_grads = _steps_of(records)
        mp.undo()
        mp.setenv("TFG_DEMO_SMOKE_STEPS", str(STEPS))
        mp.setattr(demo_distributed_gcn, "load_cora", lambda device="cuda": pdata)
        stats = {}
        acc = demo_distributed_gcn.main(device="cpu", stats=stats, world_size=P)
        yield dict(jdata=jdata, pdata=pdata, jacc=jacc, jax_losses=jax_losses,
                   jax_grads=jax_grads, acc=acc, stats=stats)
    finally:
        mp.undo()


def test_distributed_gcn_partition_matches_jax(gcn_runs):
    from tf_geometric_tpu.nn.conv.gcn import gcn_norm_adj as jgcn_norm_adj
    from tf_geometric_tpu.parallel.partition import partition_edges_by_row as jpartition
    from tf_geometric_tpu_torch.parallel.partition import partition_edges_by_row
    jgraph, _ = gcn_runs["jdata"]
    n = jgraph.num_nodes
    jnormed = jgcn_norm_adj(jgraph.adj())
    index, value = np.asarray(jnormed.index), np.asarray(jnormed.value)
    want = jpartition(index, value, n, P)
    got = partition_edges_by_row(index, value, n, P)
    for field in ("local_row", "global_col", "value"):
        np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(want, field)))
    assert (got.nodes_per_part, got.num_parts, got.num_nodes_padded) == (
        want.nodes_per_part, want.num_parts, want.num_nodes_padded)
    normed, part, x_pad, y_pad, _ = demo_distributed_gcn.problem(gcn_runs["pdata"][0], P)
    np.testing.assert_array_equal(normed.index.numpy(), index)
    np.testing.assert_allclose(normed.value.numpy(), value, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(part.local_row, np.asarray(want.local_row))
    np.testing.assert_array_equal(part.global_col, np.asarray(want.global_col))


def test_distributed_gcn_twin_matches_jax_and_oracle(gcn_runs):
    stats = gcn_runs["stats"]
    np.testing.assert_allclose(stats["losses"], gcn_runs["jax_losses"], **TOL)
    graph, (train, _, _) = gcn_runs["pdata"]
    n = graph.num_nodes
    normed, _, _, _, params = demo_distributed_gcn.problem(graph, P)
    adj = torch.zeros(n, n).index_put_((normed.index[0], normed.index[1]), normed.value,
                                       accumulate=True)
    leaves = [torch.tensor(a, requires_grad=True) for pair in params for a in pair]
    w0, b0, w1, b1 = leaves
    logits = adj @ (torch.relu(adj @ (graph.x @ w0) + b0) @ w1) + b1
    F.cross_entropy(logits[train], graph.y[train].long()).backward()
    oracle = [p.grad.numpy() for p in leaves]
    results = stats["results"]
    port = [g for pair in results[0]["grads"] for g in pair]
    for r in results[1:]:
        for a, b in zip(port, [g for pair in r["grads"] for g in pair]):
            np.testing.assert_array_equal(a, b)
    # JAX's params are [(w0, b0), (w1, b1)]: its tree leaves keep that order
    _check_gradients(port, oracle, gcn_runs["jax_grads"])
    assert gcn_runs["acc"] == pytest.approx(gcn_runs["jacc"], abs=1e-6)


@pytest.fixture(scope="module")
def mean_pool_runs():
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("TFG_DEMO_SMOKE_STEPS", str(STEPS))
        records = _jax_on_p_devices(mp)
        calls, real_jit = [], jax.jit

        def jit(fn, *args, **kwargs):
            compiled = real_jit(fn, *args, **kwargs)

            def run(*a, **k):
                if len(a) == 9:  # the training step: params, opt_state, 7 arrays
                    calls.append([np.array(v) for v in a[2:]])
                return compiled(*a, **k)
            return run

        mp.setattr(jax, "jit", jit)
        jacc = jdemo_distributed_mean_pool.main()
        jax_losses, jax_grads = _steps_of(records)
        mp.undo()
        mp.setenv("TFG_DEMO_SMOKE_STEPS", str(STEPS))
        stats = {}
        acc = demo_distributed_mean_pool.main(device="cpu", stats=stats, world_size=P)
        yield dict(jacc=jacc, jax_losses=jax_losses, jax_grads=jax_grads, calls=calls, acc=acc,
                   stats=stats)
    finally:
        mp.undo()


def test_distributed_mean_pool_blocks_match_jax(mean_pool_runs):
    calls, blocks = mean_pool_runs["calls"], mean_pool_runs["stats"]["blocks"]
    assert len(calls) == len(blocks) == STEPS
    for step, (want, per_rank) in enumerate(zip(calls, blocks)):
        assert len(per_rank) == P
        for k, w in enumerate(want):
            got = np.concatenate([rank[k] for rank in per_rank])
            assert got.dtype == w.dtype, (step, k)
            np.testing.assert_array_equal(got, w, err_msg=f"step {step}, array {k}")


def test_distributed_mean_pool_twin_matches_jax_and_oracle(mean_pool_runs):
    stats = mean_pool_runs["stats"]
    np.testing.assert_allclose(stats["losses"], mean_pool_runs["jax_losses"], **TOL)
    params = [torch.tensor(a, requires_grad=True) for a in stats["params"]]
    total, count = 0.0, 0.0
    for xd, rd, cd, vd, ngid, yd, md in stats["blocks"][0]:
        args = [torch.as_tensor(a) for a in (xd, rd, cd, vd, ngid)]
        logits = demo_distributed_mean_pool.local_forward(params, *args)
        ce = F.cross_entropy(logits, torch.as_tensor(yd).long(), reduction="none")
        total = total + (ce * torch.as_tensor(md)).sum()
        count += float(md.sum())
    (total / count).backward()
    oracle = [p.grad.numpy() for p in params]
    port = list(stats["results"][0]["grads"])
    # JAX's params dict {"b0", "bd", "w0", "wd"}: its leaves in sorted key order
    order = [1, 3, 0, 2]  # (w0, b0, wd, bd) -> b0, bd, w0, wd
    _check_gradients([port[i] for i in order], [oracle[i] for i in order],
                     mean_pool_runs["jax_grads"])
    assert mean_pool_runs["acc"] == pytest.approx(float(mean_pool_runs["jacc"]), abs=1e-6)
