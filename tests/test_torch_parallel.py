"""The port's graph-parallel runtime (``tf_geometric_tpu_torch/parallel``)
against the JAX package's on the CPU: partitioning and halo plans bit for
bit, and the sharded training steps over 4 spawned gloo ranks against the
JAX steps on a 4-device sub-mesh of the 8 virtual CPU devices, from the
same weights on the same partition (2,000 nodes, 16 features, hidden 16).

Both partitioners run C++ sweeps when their native library is built and
numpy otherwise; here both sides are pinned to the numpy branch
(``native.available`` returns False), and ``tests/test_torch_native.py``
holds the native branches against each other.

Steps, float32: losses of 3 free-running steps (rtol 1e-5, atol 1e-6); the
gradients of step 1, all-reduced, before Adam (rtol 1e-4, atol 1e-6). JAX's
gradients are read from optax's first moment after one step from a fresh
state (mu = 0.1·g). They are P = 4 times the gradient of the step's own
loss: under this JAX's ``shard_map`` the gradient of a replicated parameter
is already summed over the devices, and the JAX step ``psum``s it once more
(``tf_geometric_tpu/parallel/sharded.py:158``). The port gives the gradient
of the loss, as a single-device JAX oracle computes it; the steps are held
against JAX's gradients over P, and the GCN also against the oracle. Adam
all but cancels the factor (it divides by the gradient's magnitude), so the
losses agree. The parameters after 3 steps are held in two well-conditioned
pieces, as ``test_torch_slice.py`` holds them (Adam divides each gradient
entry by its magnitude, so rounding-level entries would drift apart
free-running): at each step's JAX parameters the port's gradients match
JAX's over P, and torch's Adam fed JAX's gradients lands on JAX's
parameters (rtol 1e-4, atol 1e-6). All cases run in one spawn of 4 ranks.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tf_geometric_tpu.native as jnative
import tf_geometric_tpu_torch.native as tnative
from tf_geometric_tpu.nn.conv.gcn import gcn_norm_adj as jgcn_norm_adj
from tf_geometric_tpu.parallel import halo as jhalo
from tf_geometric_tpu.parallel import partition as jpart
from tf_geometric_tpu.parallel import sharded as jsharded
from tf_geometric_tpu.sparse import SparseMatrix as JSparse
from tf_geometric_tpu_torch.parallel import halo, partition
from tf_geometric_tpu_torch.parallel.runner import ShardJob, run_ranks

N, F_IN, HIDDEN, CLASSES, P = 2000, 16, 16, 7, 4
STEPS = 3
GAT_DIMS = ((4, 4), (1, 8))
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
JAX_GRAD_SCALE = P  # the JAX steps' gradients over the gradient of their loss
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _community_graph(seed=0, n=N, communities=40, edges=12000):
    """Edges mostly inside 40 communities, a fifth across, a few nodes
    without edges; shuffled so that the partitioner has work to do."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, communities, n)
    members = [np.nonzero(comm == c)[0] for c in range(communities)]
    src = rng.integers(0, n - 20, edges)  # the last 20 nodes stay without edges
    inside = rng.random(edges) < 0.8
    dst = np.where(inside, [rng.choice(members[comm[s]]) for s in src],
                   rng.integers(0, n - 20, edges))
    x = rng.normal(size=(n, F_IN)).astype(np.float32)
    y = np.argmax(x @ rng.normal(size=(F_IN, CLASSES)), axis=1).astype(np.int32)
    return x, np.stack([dst, src]).astype(np.int64), y


@pytest.fixture
def jax_numpy_partitioner(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


@pytest.mark.parametrize("seed", [0, 1])
def test_orderings_match_jax(jax_numpy_partitioner, seed):
    _, ei, _ = _community_graph(seed)
    np.testing.assert_array_equal(partition.partition_order(ei, N, P),
                                  jpart.partition_order(ei, N, P))
    np.testing.assert_array_equal(partition.community_order(ei, N, seed=seed),
                                  jpart.community_order(ei, N, seed=seed))
    np.testing.assert_array_equal(partition.bandwidth_reduction_order(ei, N),
                                  jpart.bandwidth_reduction_order(ei, N))


@pytest.mark.parametrize("num_parts,pad", [(4, 128), (3, 64), (1, 16)])
def test_partition_edges_by_row_matches_jax(num_parts, pad):
    _, ei, _ = _community_graph()
    w = np.random.default_rng(2).random(ei.shape[1]).astype(np.float32)
    assert partition.nodes_per_part(N, num_parts) == jpart.nodes_per_part(N, num_parts)
    got = partition.partition_edges_by_row(ei, w, N, num_parts, pad)
    want = jpart.partition_edges_by_row(ei, w, N, num_parts, pad)
    for field in got._fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)


def test_apply_node_permutation_matches_jax(jax_numpy_partitioner):
    from tf_geometric_tpu.data.graph import Graph as JGraph
    from tf_geometric_tpu_torch.data import Graph
    x, ei, y = _community_graph()
    perm = partition.partition_order(ei, N, P)
    got, inv = partition.apply_node_permutation(Graph(x, ei, y), perm)
    want, jinv = jpart.apply_node_permutation(JGraph(x, ei.astype(np.int32), y), perm)
    np.testing.assert_array_equal(inv, jinv)
    for field in ("x", "edge_index", "y", "edge_weight"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)), err_msg=field)


def _problem():
    """The permuted graph's normalized GCN partition and its self-looped,
    unweighted GAT partition, both as the JAX package builds them."""
    x, ei, y = _community_graph()
    perm = partition.partition_order(ei, N, P)
    ei = perm[ei]
    inv = np.empty_like(perm)
    inv[perm] = np.arange(N)
    x, y = x[inv], y[inv]
    normed = jgcn_norm_adj(JSparse(ei.astype(np.int32), None, (N, N)))
    gcn_part = partition.partition_edges_by_row(np.asarray(normed.index),
                                                np.asarray(normed.value), N, P)
    loops = np.concatenate([ei, np.stack([np.arange(N), np.arange(N)])], axis=1)
    gat_part = partition.partition_edges_by_row(loops, None, N, P)
    return x, y, gcn_part, gat_part


# ---------------------------------------------------------------------------
# the sharded steps
# ---------------------------------------------------------------------------

def _init(rng, kind):
    def normal(*shape):
        return rng.normal(scale=0.1, size=shape).astype(np.float32)

    if kind == "gcn":
        return [(normal(F_IN, HIDDEN), np.zeros(HIDDEN, np.float32)),
                (normal(HIDDEN, CLASSES), np.zeros(CLASSES, np.float32))]
    if kind == "gat":
        hd = GAT_DIMS[0][0] * GAT_DIMS[0][1]
        return ((normal(F_IN, hd), np.zeros(hd, np.float32), normal(F_IN, hd),
                 np.zeros(hd, np.float32), normal(F_IN, hd), np.zeros(hd, np.float32)),
                (normal(hd, CLASSES), np.zeros(CLASSES, np.float32)))
    layers, fin = [], F_IN
    for h, d in GAT_DIMS:
        layers.append((normal(fin, h * d), np.zeros(h * d, np.float32), normal(fin, h * d),
                       np.zeros(h * d, np.float32), normal(fin, h * d),
                       np.zeros(h * d, np.float32)))
        fin = h * d
    return (layers, (normal(fin, CLASSES), np.zeros(CLASSES, np.float32)))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _jax_trace(mesh, step, params, args):
    """3 free-running steps (losses, parameters before each step) and the
    gradients at each of those parameters (one step from a fresh state).
    Parameters and state go in replicated over the mesh, as they come out,
    so the step compiles once."""
    from jax.sharding import NamedSharding, PartitionSpec
    run, opt = step
    replicated = NamedSharding(mesh, PartitionSpec())

    def init(p):
        return jax.device_put(opt.init(p), replicated)

    def grads_of(state):
        return _np_tree(jax.tree.map(lambda m: m / (1.0 - 0.9), state[0].mu))

    params = jax.device_put(params, replicated)
    trace, losses, grads = [params], [], []
    state = init(params)
    for t in range(STEPS):
        params, state, loss = run(params, state, *args)
        if t == 0:
            grads.append(grads_of(state))
        trace.append(params)
        losses.append(float(loss))
    for p in trace[1:STEPS]:
        grads.append(grads_of(run(p, init(p), *args)[1]))
    return [_np_tree(p) for p in trace], losses, grads


CASES = ("gcn_allgather", "gcn_halo_coo", "gcn_halo_ell", "gat_segment", "gat_fused")


@pytest.fixture(scope="module")
def sharded_runs():
    """Every case through JAX on a 4-device mesh and through the port on 4
    spawned gloo ranks (one spawn for all cases)."""
    x, y, gcn_part, gat_part = _problem()
    npp = gcn_part.nodes_per_part
    n_pad = gcn_part.num_nodes_padded
    x_p = np.zeros((n_pad, F_IN), np.float32)
    x_p[:N] = x
    y_p = np.zeros(n_pad, np.int32)
    y_p[:N] = y
    mask = np.zeros(n_pad, np.float32)
    mask[:N] = np.random.default_rng(4).random(N) < 0.6
    mesh = jsharded.build_mesh({"graph": P})
    rng = np.random.default_rng(5)
    coo, ell = jhalo.build_halo_spec(gcn_part), jhalo.build_halo_spec(gcn_part, layout="ell")
    gat_coo, gat_ell = jhalo.build_halo_spec(gat_part), jhalo.build_gat_halo_spec(gat_part)
    data = tuple(map(jnp.asarray, (x_p, y_p, mask)))
    edges = tuple(jnp.asarray(a.reshape(-1)) for a in
                  (gcn_part.local_row, gcn_part.global_col, gcn_part.value))
    key = jax.random.PRNGKey(0)
    jax_cases = {
        "gcn_allgather": ("gcn", jsharded.make_graph_parallel_gcn_step(
            mesh, hidden=HIDDEN, num_classes=CLASSES), (data[0],) + edges + data[1:]),
        "gcn_halo_coo": ("gcn", jsharded.make_graph_parallel_gcn_step(
            mesh, hidden=HIDDEN, num_classes=CLASSES, halo_spec=coo), data),
        "gcn_halo_ell": ("gcn", jsharded.make_graph_parallel_gcn_step(
            mesh, hidden=HIDDEN, num_classes=CLASSES, halo_spec=ell), data),
        "gat_segment": ("gat", jsharded.make_graph_parallel_gat_step(
            mesh, gat_coo, num_heads=GAT_DIMS[0][0], units=GAT_DIMS[0][1],
            num_classes=CLASSES), data),
        "gat_fused": ("gat_fused", jsharded.make_graph_parallel_gat_fused_step(
            mesh, gat_ell, layer_dims=GAT_DIMS, num_classes=CLASSES), (key,) + data),
    }
    ref = {}
    with mesh:
        for name, (kind, step, args) in jax_cases.items():
            params = _init(rng, kind)
            ref[name] = (params,) + _jax_trace(mesh, step, jax.tree.map(jnp.asarray, params),
                                               args)

    port_coo, port_ell = halo.build_halo_spec(gcn_part), halo.build_halo_spec(gcn_part,
                                                                             layout="ell")
    port_gat_coo, port_gat = halo.build_halo_spec(gat_part), halo.build_gat_halo_spec(gat_part)
    options = {"gcn_allgather": {},
               "gat_segment": {"num_heads": GAT_DIMS[0][0], "units": GAT_DIMS[0][1]},
               "gat_fused": {"layer_dims": GAT_DIMS}}
    options["gcn_halo_coo"] = options["gcn_halo_ell"] = options["gcn_allgather"]
    jobs = []
    for r in range(P):
        rows = slice(r * npp, (r + 1) * npp)
        plans = {"gcn_allgather": (gcn_part.local_row[r], gcn_part.global_col[r],
                                   gcn_part.value[r]),
                 "gcn_halo_coo": halo.rank_halo_plan(port_coo, r, "cpu"),
                 "gcn_halo_ell": halo.rank_halo_plan(port_ell, r, "cpu"),
                 "gat_segment": halo.rank_halo_plan(port_gat_coo, r, "cpu"),
                 "gat_fused": halo.rank_gat_plan(port_gat, r, "cpu")}
        kinds = {"gcn_allgather": "gcn", "gcn_halo_coo": "gcn", "gcn_halo_ell": "gcn",
                 "gat_segment": "gat", "gat_fused": "gat_fused"}
        mine = []
        for name in CASES:
            base = ShardJob(name, kinds[name], ref[name][0], x_p[rows], y_p[rows], mask[rows],
                            plans[name], options[name], STEPS)
            mine.append(base)
            mine.append(base._replace(name=name + "/replay",
                                      options=dict(options[name], replay=ref[name][1][:STEPS])))
        mine.append(ShardJob("gat_fused/dropout", "gat_fused", ref["gat_fused"][0], x_p[rows],
                             y_p[rows], mask[rows], plans["gat_fused"],
                             dict(options["gat_fused"], edge_drop_rate=0.6, feat_drop_rate=0.6,
                                  learning_rate=1e-2, seed=7), 5))
        jobs.append(mine)
    results = run_ranks(jobs, backend="gloo", device="cpu", timeout_s=300)
    by_name = [{res["name"]: res for res in rank} for rank in results]
    return ref, by_name


def _flat(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_losses_and_step1_grads(sharded_runs, case):
    ref, ranks = sharded_runs
    _, trace, losses, grads = ref[case]
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[case]["losses"], losses, **LOSS_TOL, err_msg=f"rank {r}")
        for i, (g, w) in enumerate(zip(_flat(res[case]["grads"]), _flat(grads[0]))):
            np.testing.assert_allclose(g, w / JAX_GRAD_SCALE, **GRAD_TOL,
                                       err_msg=f"rank {r} leaf {i}")
    # the ranks' replicas stay identical
    for res in ranks[1:]:
        for a, b in zip(_flat(res[case]["params"]), _flat(ranks[0][case]["params"])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_grads_at_jax_params(sharded_runs, case):
    """At each step's JAX parameters the port's all-reduced gradients are
    JAX's over P (the replay job loads them before each step)."""
    ref, ranks = sharded_runs
    _, _, _, grads = ref[case]
    got = ranks[0][case + "/replay"]["grads_trace"]
    assert len(got) == STEPS
    for t in range(STEPS):
        for i, (g, w) in enumerate(zip(_flat(got[t]), _flat(grads[t]))):
            np.testing.assert_allclose(g, w / JAX_GRAD_SCALE, **GRAD_TOL,
                                       err_msg=f"step {t} leaf {i}")


def test_gcn_step_grads_are_the_single_device_gradient(sharded_runs):
    """The sharded GCN's step-1 gradient (every mode) is the gradient of
    the same masked mean cross-entropy on one device (a JAX oracle over the
    whole graph); the JAX step's is P times it."""
    import optax
    ref, ranks = sharded_runs
    x, y, gcn_part, _ = _problem()
    npp, n_pad = gcn_part.nodes_per_part, gcn_part.num_nodes_padded
    x_p, y_p, mask = (np.zeros((n_pad, F_IN), np.float32), np.zeros(n_pad, np.int32),
                      np.zeros(n_pad, np.float32))
    x_p[:N], y_p[:N] = x, y
    mask[:N] = np.random.default_rng(4).random(N) < 0.6
    ok = gcn_part.local_row < npp
    rows = (gcn_part.local_row + np.arange(P)[:, None] * npp)[ok]
    adj = JSparse(np.stack([rows, gcn_part.global_col[ok]]), gcn_part.value[ok], (n_pad, n_pad))

    def loss(p):
        h = jax.nn.relu(adj.matmul(jnp.asarray(x_p) @ p[0][0]) + p[0][1])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            adj.matmul(h @ p[1][0]) + p[1][1], jnp.asarray(y_p))
        return jnp.sum(ce * mask) / mask.sum()

    for case in ("gcn_allgather", "gcn_halo_coo", "gcn_halo_ell"):
        oracle = _flat(_np_tree(jax.grad(loss)(jax.tree.map(jnp.asarray, ref[case][0]))))
        for i, (g, w, j) in enumerate(zip(_flat(ranks[0][case]["grads"]), oracle,
                                          _flat(ref[case][3][0]))):
            np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=f"{case} leaf {i}")
            np.testing.assert_allclose(j, JAX_GRAD_SCALE * w, **GRAD_TOL,
                                       err_msg=f"JAX {case} leaf {i}")


@pytest.mark.parametrize("case", CASES)
def test_adam_fed_jax_grads_lands_on_jax_params(sharded_runs, case):
    """The port's optimizer (``make_optimizer``: torch Adam at the step's
    rate) fed JAX's gradients follows JAX's parameters."""
    from tf_geometric_tpu_torch.convert import sharded_params_from_numpy
    from tf_geometric_tpu_torch.parallel.sharded import param_leaves
    ref, _ = sharded_runs
    params0, trace, _, _ = ref[case]
    lr = 5e-3 if case.startswith("gat") else 1e-2
    params = sharded_params_from_numpy(params0, "cpu")
    leaves = param_leaves(params)
    opt = torch.optim.Adam(leaves, lr=lr)
    for t in range(STEPS):
        # JAX's gradient at its step-t parameters, from the free chain: the
        # replay-consistent reference of test_sharded_step_grads_at_jax_params
        g = _flat(ref[case][3][t])
        for p, gt in zip(leaves, g):
            p.grad = torch.tensor(gt)
        opt.step()
        for i, (p, w) in enumerate(zip(leaves, _flat(trace[t + 1]))):
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {t} leaf {i}")


def test_fused_step_with_dropout_trains(sharded_runs):
    """At the production rates (attention and feature dropout 0.6) the fused
    step's loss is finite and falls over 5 steps, on every rank."""
    _, ranks = sharded_runs
    for res in ranks:
        losses = res["gat_fused/dropout"]["losses"]
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0]
    assert ranks[0]["gat_fused/dropout"]["losses"] == ranks[1]["gat_fused/dropout"]["losses"]
