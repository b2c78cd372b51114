"""The port's edge-partitioned MinCut/DiffPool step, 2-D batch step and mesh
(``tf_geometric_tpu_torch/parallel/sharded.py``) against the JAX package's
on the CPU.

MinCut, both variants: 4 spawned gloo ranks on ``test_torch_parallel``'s
2,000-node community graph, normalized without self-loops
(``adj_norm_edge(..., add_self_loop=False)``), C = 8, hidden 16, 7 classes,
a 60% training mask; the JAX step on a 4-device sub-mesh of conftest's 8
virtual CPU devices from the same weights on the same partition. The loss,
``ce``, ``cut`` and ``orth`` of 3 free-running steps, and of 3 steps each
taken from JAX's parameters before it, within rtol 1e-5, atol 1e-6; the
step-1 gradients (all-reduced, before Adam) within
rtol 1e-4, atol 1e-6 of a dense single-device ``jax.grad`` oracle over the
whole graph and of JAX's gradients over the factor measured here; ``cut``
and ``orth`` against the port's own ``min_cut_pool_compute_losses`` for the
same assignment on the whole graph.

The factors: the JAX steps ``psum`` gradients that ``shard_map`` has already
summed over the devices (ROADMAP §3), so JAX's MinCut gradient is P = 4
times the gradient of its loss, and its 2-D gradient, ``psum``-ed over both
axes, D·P = 4 times (D = P = 2). The tests measure each leaf's factor
against the oracle and hold it to the expected one (rtol 1e-4).

The 2-D step (D 2 × P 2): the loss of 3 steps against JAX's on a 2×2
sub-mesh, the step-1 gradients against the per-graph oracle of
``tests/test_parallel.py``'s ``test_batch_2d_step_matches_single_device``,
differentiated by ``jax.grad``. ``pack_batch_2d`` bit for bit with JAX's,
its refusals too. ``build_mesh``: each rank's groups, and its refusals.
All multi-rank cases run in one spawn of 4 ranks.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_geometric_tpu.parallel import sharded as jsharded
from tf_geometric_tpu.utils.graph_utils import adj_norm_edge as jadj_norm_edge
from tf_geometric_tpu_torch.nn.pool.min_cut_pool import min_cut_pool_compute_losses
from tf_geometric_tpu_torch.parallel import partition, sharded
from tf_geometric_tpu_torch.parallel.runner import ShardJob, run_ranks
from test_torch_parallel import CLASSES, F_IN, N, _community_graph

P, C, HIDDEN, STEPS = 4, 8, 16, 3
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
MINCUT_FACTOR = P            # JAX's MinCut gradient over the gradient of its loss
D2, P2, G2 = 2, 2, 4         # the 2-D mesh and graphs per data shard
BATCH_2D_FACTOR = D2 * P2    # JAX's 2-D gradient over the gradient of its loss
VARIANTS = ("min_cut", "diff")
# The pooled graph is not normalized: ~250-node clusters make pooled_x and
# pooled_adj sums of hundreds of rows. At the 0.1 of scaling.py the step
# starts at a cross-entropy of ~766 with gradients up to ~5e3, where float32
# rounding alone (JAX's sharded step against its own dense oracle: 3.6e-6
# on wa) passes atol 1e-6; at 0.02 the cross-entropy starts near chance.
WEIGHT_SCALE = 0.02


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def _mincut_problem():
    x, ei, y = _community_graph()
    index, value = jadj_norm_edge(ei.astype(np.int32), N, None, add_self_loop=False)
    index, value = np.asarray(index), np.asarray(value)
    part = partition.partition_edges_by_row(index, value, N, P)
    n_pad = part.num_nodes_padded
    x_p = np.zeros((n_pad, F_IN), np.float32)
    x_p[:N] = x
    y_p = np.zeros(n_pad, np.int32)
    y_p[:N] = y
    mask = np.zeros(n_pad, np.float32)
    mask[:N] = np.random.default_rng(4).random(N) < 0.6
    valid = np.zeros(n_pad, np.float32)
    valid[:N] = 1.0
    rng = np.random.default_rng(6)

    def normal(*shape):
        return rng.normal(scale=WEIGHT_SCALE, size=shape).astype(np.float32)

    params = ((normal(F_IN, HIDDEN), np.zeros(HIDDEN, np.float32)),
              (normal(F_IN, C), np.zeros(C, np.float32)),
              (normal(HIDDEN, HIDDEN), np.zeros(HIDDEN, np.float32)),
              (normal(2 * HIDDEN, CLASSES), np.zeros(CLASSES, np.float32)))
    return dict(x=x, y=y, index=index, value=value, part=part, x_p=x_p, y_p=y_p, mask=mask,
                valid=valid, params=params)


def _batch_graphs(seed=7, num_graphs=D2 * G2, features=6):
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(num_graphs):
        n = int(rng.integers(5, 12))
        e = int(rng.integers(8, 25))
        graphs.append((rng.normal(size=(n, features)).astype(np.float32),
                       rng.integers(0, n, size=(2, e)).astype(np.int32),
                       int(rng.integers(0, CLASSES))))
    return graphs


def _batch_2d_problem():
    graphs = _batch_graphs()
    shard_nodes = max(sum(g[0].shape[0] for g in graphs[d * G2:(d + 1) * G2])
                      for d in range(D2))
    shard_edges = max(sum(g[1].shape[1] for g in graphs[d * G2:(d + 1) * G2])
                      for d in range(D2))
    npc = -(-shard_nodes // P2)
    packed = sharded.pack_batch_2d(graphs, D2, P2, G2, npc, shard_edges)
    prng = np.random.default_rng(0)
    f = graphs[0][0].shape[1]
    params = (prng.normal(scale=0.1, size=(f, HIDDEN)).astype(np.float32),
              np.zeros(HIDDEN, np.float32),
              prng.normal(scale=0.1, size=(HIDDEN, CLASSES)).astype(np.float32),
              np.zeros(CLASSES, np.float32))
    return graphs, npc, shard_edges, packed, params


def _jax_run(mesh, step_opt, params, args):
    """3 free-running steps: losses (and MinCut's terms), the parameters
    before each step and the step-1 gradients, read from optax's first
    moment (mu = 0.1·g)."""
    from jax.sharding import NamedSharding, PartitionSpec
    run, opt = step_opt
    replicated = NamedSharding(mesh, PartitionSpec())
    params = jax.device_put(jax.tree.map(jnp.asarray, params), replicated)
    state = jax.device_put(opt.init(params), replicated)
    outs, trace, grads = [], [], None
    for t in range(STEPS):
        trace.append(_np_tree(params))
        params, state, out = run(params, state, *args)
        if t == 0:
            grads = _np_tree(jax.tree.map(lambda m: m / (1.0 - 0.9), state[0].mu))
        outs.append(np.asarray(jax.tree.leaves(out), np.float64))
    return np.stack(outs), grads, trace


@pytest.fixture(scope="module")
def runs():
    """MinCut (both variants) and the 2-D step through JAX and through the
    port on 4 spawned gloo ranks (one spawn)."""
    mc = _mincut_problem()
    part = mc["part"]
    npp = part.nodes_per_part
    mesh = jsharded.build_mesh({"graph": P})
    args = tuple(jnp.asarray(a) for a in (
        mc["x_p"], part.local_row.reshape(-1), part.global_col.reshape(-1),
        part.value.reshape(-1), mc["y_p"], mc["mask"], mc["valid"]))
    ref = {}
    with mesh:
        for variant in VARIANTS:
            step = jsharded.make_graph_parallel_mincut_step(
                mesh, num_clusters=C, hidden=HIDDEN, num_classes=CLASSES, variant=variant)
            ref[variant] = _jax_run(mesh, step, mc["params"], args)

    graphs, npc, epc, packed, params2d = _batch_2d_problem()
    x2, rows2, cols2, vals2, ngi2, y2, gmask2 = packed
    mesh2 = jsharded.build_mesh({"data": D2, "graph": P2})
    with mesh2:
        step = jsharded.make_batch_2d_step(mesh2, hidden=HIDDEN, num_classes=CLASSES,
                                           graphs_per_data_shard=G2)
        ref["batch_2d"] = _jax_run(mesh2, step, params2d, tuple(map(jnp.asarray, packed)))

    jobs = []
    for r in range(P):
        rows = slice(r * npp, (r + 1) * npp)
        edges = (part.local_row[r], part.global_col[r], part.value[r])
        mine = [ShardJob(variant, "mincut", mc["params"], mc["x_p"][rows], mc["y_p"][rows],
                         mc["mask"][rows], edges,
                         {"variant": variant, "valid": mc["valid"][rows]}, STEPS)
                for variant in VARIANTS]
        mine += [job._replace(name=job.name + "/replay",
                              options=dict(job.options, replay=ref[job.name][2]))
                 for job in mine]
        # the flat shard built on the rank, and the plain version (index_add)
        mine.append(mine[0]._replace(
            name="min_cut/prebuilt",
            plan=sharded.rank_adjacency(*edges, npp, P * npp, device="cpu")))
        mine.append(mine[0]._replace(name="min_cut/plain",
                                     options=dict(mine[0].options, plain=True)))
        d = r // P2
        cell, ecell = slice(r * npc, (r + 1) * npc), slice(r * epc, (r + 1) * epc)
        mine.append(ShardJob("batch_2d", "batch_2d", params2d, x2[cell],
                             y2[d * G2:(d + 1) * G2], gmask2[d * G2:(d + 1) * G2],
                             (rows2[ecell], cols2[ecell], vals2[ecell]),
                             {"data": D2, "ngi": ngi2[cell]}, STEPS))
        mine.append(mine[-1]._replace(name="batch_2d/replay", options=dict(
            mine[-1].options, replay=ref["batch_2d"][2])))
        jobs.append(mine)
    results = run_ranks(jobs, backend="gloo", device="cpu", timeout_s=300)
    by_name = [{res["name"]: res for res in rank} for rank in results]
    return mc, ref, by_name


def _mincut_oracle(mc, variant):
    """Dense single-device MinCut/DiffPool loss over the real graph, as
    ``tests/test_parallel.py`` writes it, with the training mask."""
    import optax
    adense = np.zeros((N, N), np.float32)
    np.add.at(adense, (mc["index"][0], mc["index"][1]), mc["value"])
    A = jnp.asarray(adense)
    m = jnp.asarray(mc["mask"][:N])

    def loss(p):
        (w0, b0), (wa, ba), (wc, bc), (wo, bo) = p
        xx = jnp.asarray(mc["x"])
        h1 = jax.nn.relu(A @ (xx @ w0) + b0)
        S = jax.nn.softmax(A @ (xx @ wa) + ba)
        pooled_x = S.T @ h1
        pooled_adj = S.T @ A @ S
        cut = orth = jnp.float32(0.0)
        if variant == "min_cut":
            all_sum = jnp.sum(A.sum(axis=1) * jnp.sum(S * S, axis=-1))
            cut = -jnp.trace(pooled_adj) / (all_sum + 1e-8)
            sts = S.T @ S
            sts_n = sts / (jnp.sqrt(jnp.sum(sts * sts)) + 1e-8)
            dev = sts_n - jnp.eye(C) / jnp.sqrt(jnp.float32(C))
            orth = jnp.sqrt(jnp.sum(dev * dev))
            pooled_adj = pooled_adj * (1.0 - jnp.eye(C))
        coarse = jax.nn.relu(pooled_adj @ (pooled_x @ wc) + bc)
        logits = jnp.concatenate([h1, S @ coarse], axis=-1) @ wo + bo
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(mc["y"]))
        ce = jnp.sum(ce * m) / jnp.sum(m)
        return ce + cut + orth, (ce, cut, orth)

    return loss


@pytest.mark.parametrize("variant", VARIANTS)
def test_mincut_losses_match_jax(runs, variant):
    """Every rank's (loss, ce, cut, orth) of 3 free-running steps are
    JAX's, and so are those of 3 steps each taken from JAX's parameters
    before it (the replay job); the ranks' replicas stay identical;
    ``diff`` has cut = orth = 0."""
    _, ref, ranks = runs
    outs = ref[variant][0]
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[variant + "/replay"]["terms"], outs, **LOSS_TOL,
                                   err_msg=f"rank {r} (loss, ce, cut, orth) per step")
        np.testing.assert_allclose(res[variant]["terms"], outs, **LOSS_TOL,
                                   err_msg=f"rank {r} free-running")
    for res in ranks[1:]:
        for a, b in zip(_flat(res[variant]["params"]), _flat(ranks[0][variant]["params"])):
            np.testing.assert_array_equal(a, b)
    if variant == "diff":
        assert all(t[2] == 0.0 and t[3] == 0.0 for t in ranks[0]["diff"]["terms"])


@pytest.mark.parametrize("variant", VARIANTS)
def test_mincut_step1_grads_are_the_oracle_and_jax_over_p(runs, variant):
    """The step-1 gradient of every leaf is the dense oracle's; JAX's is
    ``MINCUT_FACTOR`` times it, leaf by leaf."""
    mc, ref, ranks = runs
    (loss, terms), oracle = jax.value_and_grad(_mincut_oracle(mc, variant), has_aux=True)(
        jax.tree.map(jnp.asarray, mc["params"]))
    np.testing.assert_allclose(ref[variant][0][0], [loss, *terms], rtol=1e-4, atol=1e-5)
    for i, (g, w, j) in enumerate(zip(_flat(ranks[0][variant]["grads"]), _flat(_np_tree(oracle)),
                                      _flat(ref[variant][1]))):
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=f"leaf {i} vs oracle")
        np.testing.assert_allclose(g, j / MINCUT_FACTOR, **GRAD_TOL, err_msg=f"leaf {i} vs JAX")
        big = np.abs(w) > 1e-3 * np.abs(w).max()
        if big.any():
            np.testing.assert_allclose(np.median(j[big] / w[big]), MINCUT_FACTOR, rtol=1e-4,
                                       err_msg=f"leaf {i}: JAX's factor")


@pytest.mark.parametrize("name", ["min_cut/prebuilt", "min_cut/plain"])
def test_mincut_aggregation_paths_agree(runs, name):
    """The prebuilt host ``RankAdjacency`` and the plain ``index_add``
    version (``sharded_spmm_local``) give the step of the flat shard."""
    _, _, ranks = runs
    for res in ranks:
        np.testing.assert_allclose(res[name]["terms"], res["min_cut"]["terms"], **LOSS_TOL)
        for a, b in zip(_flat(res[name]["grads"]), _flat(res["min_cut"]["grads"])):
            np.testing.assert_allclose(a, b, **GRAD_TOL)


def test_mincut_losses_are_min_cut_pools(runs):
    """Step 1's cut and orth are ``min_cut_pool_compute_losses`` of the same
    assignment over the whole graph (one graph), computed by the port's
    single-process pooling code."""
    mc, _, ranks = runs
    (w0, b0), (wa, ba), _, _ = (tuple(torch.tensor(a) for a in leaf) for leaf in mc["params"])
    A = torch.sparse_coo_tensor(torch.tensor(mc["index"]).long(), torch.tensor(mc["value"]),
                                (N, N))
    S = torch.softmax(torch.sparse.mm(A, torch.tensor(mc["x"]) @ wa) + ba, dim=-1)
    cut, orth = min_cut_pool_compute_losses(
        torch.tensor(mc["index"]).long(), None, torch.zeros(N, dtype=torch.long), S,
        normed_edge_weight=torch.tensor(mc["value"]), num_graphs=1)
    np.testing.assert_allclose(ranks[0]["min_cut"]["terms"][0][2:], [float(cut), float(orth)],
                               **LOSS_TOL)


def test_batch_2d_step_matches_jax_and_the_per_graph_oracle(runs):
    """The 2-D step's 3-step losses are JAX's on a 2×2 mesh; its step-1
    gradients are the per-graph oracle's (the mean over graphs of each
    graph's cross-entropy), JAX's ``BATCH_2D_FACTOR`` times it."""
    import optax
    _, ref, ranks = runs
    outs, jgrads, _ = ref["batch_2d"]
    graphs, _, _, _, params2d = _batch_2d_problem()
    for r, res in enumerate(ranks):
        for name in ("batch_2d", "batch_2d/replay"):
            np.testing.assert_allclose(res[name]["losses"], outs[:, 0], **LOSS_TOL,
                                       err_msg=f"rank {r} {name}")

    def oracle(p):
        w0, b0, wd, bd = p
        ces = []
        for xg, eig, yg in graphs:
            n = xg.shape[0]
            deg = jnp.zeros(n).at[eig[0]].add(1.0) + 1e-6
            agg = jnp.zeros((n, HIDDEN)).at[eig[0]].add((xg @ w0)[eig[1]])
            h = jax.nn.relu(agg / deg[:, None] + b0)
            logits = h.mean(axis=0) @ wd + bd
            ces.append(optax.softmax_cross_entropy_with_integer_labels(logits, yg))
        return jnp.mean(jnp.stack(ces))

    loss, want = jax.value_and_grad(oracle)(tuple(map(jnp.asarray, params2d)))
    np.testing.assert_allclose(outs[0, 0], float(loss), rtol=1e-4, atol=1e-5)
    for i, (g, w, j) in enumerate(zip(_flat(ranks[0]["batch_2d"]["grads"]),
                                      _flat(_np_tree(want)), _flat(jgrads))):
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=f"leaf {i} vs oracle")
        np.testing.assert_allclose(g, j / BATCH_2D_FACTOR, **GRAD_TOL,
                                   err_msg=f"leaf {i} vs JAX")
        big = np.abs(w) > 1e-3 * np.abs(w).max()
        np.testing.assert_allclose(np.median(j[big] / w[big]), BATCH_2D_FACTOR, rtol=1e-4,
                                   err_msg=f"leaf {i}: JAX's factor")


@pytest.mark.parametrize("name", ["min_cut", "batch_2d"])
def test_build_mesh_groups(runs, name):
    """Rank r = d·P + p holds graph group {d·P + q} and data group
    {e·P + p}; without a data axis the graph group is every rank."""
    _, _, ranks = runs
    for r, res in enumerate(ranks):
        if name == "min_cut":
            assert res[name]["mesh"] == {"graph": list(range(P)), "data": [r]}
        else:
            d, p = divmod(r, P2)
            assert res[name]["mesh"] == {"graph": [d * P2 + q for q in range(P2)],
                                         "data": [e * P2 + p for e in range(D2)]}


@pytest.mark.parametrize("axes,error", [({"data": 2, "graph": 1}, ValueError),
                                        ({"data": 0}, ValueError),
                                        ({"graph": 2}, ValueError),
                                        ({"tensor": 2, "graph": 1}, ValueError),
                                        ({"tensor": 1, "data": 1, "graph": 1}, None)])
def test_build_mesh_refusals(tmp_path, axes, error):
    """A mesh whose axes do not multiply to the group's size, a data axis
    below 1 or another sharded axis is refused; size-1 axes are fine."""
    import torch.distributed as dist
    with pytest.raises(RuntimeError):
        sharded.build_mesh({"graph": 1})  # no process group yet
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)
    try:
        if error is None:
            assert sharded.build_mesh(axes) == sharded.GraphMesh(None, 0, 1)
        else:
            with pytest.raises(error):
                sharded.build_mesh(axes)
    finally:
        dist.destroy_process_group()


def _pack_cases():
    graphs = _batch_graphs(seed=3, num_graphs=8)
    return [(graphs, 2, 4, 4, 16, 64), (graphs, 2, 2, 4, 24, 96), (graphs[:5], 3, 1, 2, 40, 90),
            (graphs, 1, 3, 8, 30, 160)]


@pytest.mark.parametrize("case", range(4))
def test_pack_batch_2d_matches_jax_bit_for_bit(case):
    args = _pack_cases()[case]
    for got, want in zip(sharded.pack_batch_2d(*args), jsharded.pack_batch_2d(*args)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("args", [(2, 2, 2, 24, 96),    # more graphs than D·G slots
                                  (2, 2, 4, 4, 96),     # nodes_per_cell too small
                                  (2, 2, 4, 24, 4)])    # edges_per_cell too small
def test_pack_batch_2d_refusals_match_jax(args):
    graphs = _batch_graphs(seed=3, num_graphs=8)
    with pytest.raises(ValueError) as want:
        jsharded.pack_batch_2d(graphs, *args)
    with pytest.raises(ValueError) as got:
        sharded.pack_batch_2d(graphs, *args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kind", ["min_cut", "batch_2d"])
def test_sharded_params_from_numpy_keeps_the_steps_structures(kind):
    """``convert.sharded_params_from_numpy`` carries the JAX steps' weights
    over in their nesting: MinCut's ``((w0, b0), (wa, ba), (wc, bc), (wo,
    bo))`` and the 2-D step's flat ``(w0, b0, wd, bd)``, as float32 leaves
    that require grad, equal to the JAX arrays."""
    from tf_geometric_tpu_torch.convert import sharded_params_from_numpy
    params = _mincut_problem()["params"] if kind == "min_cut" else _batch_2d_problem()[4]
    jparams = jax.tree.map(jnp.asarray, params)
    got = sharded_params_from_numpy(jparams, "cpu")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, got, is_leaf=torch.is_tensor)) \
        == jax.tree.structure(jax.tree.map(lambda a: 0, jparams))
    for g, w in zip(sharded.param_leaves(got), _flat(params)):
        assert g.dtype == torch.float32 and g.requires_grad and g.is_leaf
        np.testing.assert_array_equal(g.detach().numpy(), w)
