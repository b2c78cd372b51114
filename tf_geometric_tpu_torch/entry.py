"""Entry points of the port (twins of the repository's ``__graft_entry__``).

``entry()`` returns ``(forward, example_args)``: the 2-layer GCN forward over
a 512-node graph through the cached CSR adjacency, with the normalization
and the CSR build done eagerly on the host first, as in the JAX entry.

``dryrun_multichip(n_ranks)`` runs one training step of the edge-partitioned
halo GCN, of the fused halo GAT, of the node-partitioned sampled SAGE, of
the edge-partitioned MinCutPool and of the 2-D batch step over ``n_ranks``
spawned ranks at the JAX dry run's tiny sizes.
"""
from __future__ import annotations

import numpy as np
import torch

from .nn.conv.gcn import compute_cache_key, gcn_norm_adj, maybe_compile_ell
from .sparse.matrix import SparseMatrix

__all__ = ["entry", "dryrun_multichip"]


def _make_graph(num_nodes=512, num_edges=2048, num_features=64, num_classes=7, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(num_nodes, num_features)).astype(np.float32)
    edge_index = rng.integers(0, num_nodes, size=(2, num_edges)).astype(np.int32)
    edge_weight = np.ones(num_edges, np.float32)
    y = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    return x, edge_index, edge_weight, y


def entry(device="cuda"):
    """(forward, example_args): ``forward(x, w0, w1) = Â·relu(Â·(x w0))·w1``
    with ``Â`` the cached CSR twin of the normalized adjacency, on ``device``."""
    x, edge_index, edge_weight, _ = _make_graph()
    num_nodes, num_features = x.shape
    hidden, num_classes = 64, 7
    rng = np.random.default_rng(1)
    w0 = rng.normal(scale=0.1, size=(num_features, hidden)).astype(np.float32)
    w1 = rng.normal(scale=0.1, size=(hidden, num_classes)).astype(np.float32)

    cache = {}
    normed = gcn_norm_adj(SparseMatrix(edge_index, edge_weight, (num_nodes, num_nodes),
                                       device=device), cache=cache)
    adj = maybe_compile_ell(normed, cache,
                            compute_cache_key("both", True, True, True, False))

    def forward(x, w0, w1):
        h = torch.relu(adj.matmul(x @ w0))
        return adj.matmul(h @ w1)

    example_args = tuple(torch.as_tensor(a, device=device) for a in (x, w0, w1))
    return forward, example_args


def dryrun_multichip(n_ranks: int, device="cuda") -> dict:
    """The GCN part (``__graft_entry__.py:91-134``), the fused-GAT part
    (``:136-177``), the sampled-SAGE part (``:179-199``), the MinCut part
    (``:201-237``) and the 2-D part (``:239-279``) of the JAX dry run over
    ``n_ranks`` spawned ranks (gloo, sharing one card on ``device="cuda"``):
    one training step each of the 2-layer halo GCN (packed ``ell`` plan,
    hidden 16, 7 classes), of the two-layer fused halo GAT (``((8, 8), (1,
    64))``, attention and feature dropout 0.6), of the two-layer sampled
    SAGE (k = (4, 3), hidden 16, weights from ``default_rng(3)``; nodes
    padded to a multiple of ``n_ranks``) and of the MinCutPool step (C = 6,
    hidden 16, over ``adj_norm_edge(..., add_self_loop=False)``) on a
    4,096-node skewed graph, then of the 2-D batch step (hidden 16) on
    ``default_rng(5)``'s batch of small graphs, 4 per data shard; checks
    that the losses (and MinCut's cut loss) are finite and returns them. The
    graph axis spans every rank (the JAX dry run's data axis only replicates
    inputs) except in the 2-D part, whose data axis folds the ranks as JAX
    folds its devices: data 2 × graph n/2 for an even n > 2."""
    from .ops import _build
    from .parallel import (ShardJob, build_csr_shards, build_gat_halo_spec, build_halo_spec,
                           partition_edges_by_row, rank_gat_plan, rank_halo_plan, run_ranks)
    from .parallel.sampled_sage import init_sampled_sage_params
    from .parallel.sharded import pack_batch_2d
    from .utils.graph_utils import adj_norm_edge
    num_classes, hidden = 7, 16
    n, num_edges = 4096, 65536
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 32)).astype(np.float32)
    # heavy-tailed in- and out-degrees: hubs, as the JAX dry run draws them
    edge_index = (rng.random((2, num_edges)) ** 3 * n).astype(np.int32)
    edge_weight = np.ones(num_edges, np.float32)
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    normed = gcn_norm_adj(SparseMatrix(edge_index, edge_weight, (n, n), device="cpu"))
    part = partition_edges_by_row(normed.index.numpy(), normed.value.numpy(), n, n_ranks,
                                  pad_multiple=64)
    npp, n_pad = part.nodes_per_part, part.num_nodes_padded
    x_p = np.zeros((n_pad, x.shape[1]), np.float32)
    x_p[:n] = x
    y_p = np.zeros(n_pad, np.int32)
    y_p[:n] = y
    mask = np.zeros(n_pad, np.float32)
    mask[:n] = 1.0
    spec = build_halo_spec(part, capacity_multiple=64, layout="ell")
    loops = np.concatenate([edge_index, np.stack([np.arange(n), np.arange(n)]).astype(np.int32)],
                           axis=1)
    gat_spec = build_gat_halo_spec(partition_edges_by_row(loops, None, n, n_ranks,
                                                          pad_multiple=64), capacity_multiple=64)
    rng = np.random.default_rng(0)

    def normal(*shape):
        return rng.normal(scale=0.1, size=shape).astype(np.float32)

    gcn_params = [(normal(x.shape[1], hidden), np.zeros(hidden, np.float32)),
                  (normal(hidden, num_classes), np.zeros(num_classes, np.float32))]
    dims, layers, fin = ((8, 8), (1, 64)), [], x.shape[1]
    for heads, units in dims:
        hd = heads * units
        layers.append((normal(fin, hd), np.zeros(hd, np.float32), normal(fin, hd),
                       np.zeros(hd, np.float32), normal(fin, hd), np.zeros(hd, np.float32)))
        fin = hd
    gat_params = (layers, (normal(fin, num_classes), np.zeros(num_classes, np.float32)))
    n_sage = -(-n // n_ranks) * n_ranks
    sage_data = [np.zeros((n_sage,) + a.shape[1:], a.dtype) for a in (x, y, mask[:n])]
    for padded, a in zip(sage_data, (x, y, mask[:n])):
        padded[:n] = a
    shards = build_csr_shards(edge_index, n_sage, n_ranks)
    sage_params = init_sampled_sage_params(np.random.default_rng(3), x.shape[1], num_classes,
                                           num_layers=2, hidden=hidden)
    C = 6
    mc_index, mc_value = adj_norm_edge(edge_index, n, None, add_self_loop=False)
    mc_part = partition_edges_by_row(mc_index.numpy(), mc_value.numpy(), n, n_ranks,
                                     pad_multiple=64)
    mc_npp = mc_part.nodes_per_part
    mc_data = [np.zeros((n_ranks * mc_npp,) + a.shape[1:], a.dtype) for a in (x, y, mask[:n])]
    for padded, a in zip(mc_data, (x, y, mask[:n])):
        padded[:n] = a
    mc_params = ((normal(x.shape[1], hidden), np.zeros(hidden, np.float32)),
                 (normal(x.shape[1], C), np.zeros(C, np.float32)),
                 (normal(hidden, hidden), np.zeros(hidden, np.float32)),
                 (normal(2 * hidden, num_classes), np.zeros(num_classes, np.float32)))
    # the 2-D part: the data axis splits a batch of small graphs
    D = 2 if n_ranks % 2 == 0 and n_ranks > 2 else 1
    graph_parts, G = n_ranks // D, 4
    brng = np.random.default_rng(5)
    batch = []
    for _ in range(D * G):
        nodes, edges = int(brng.integers(6, 14)), int(brng.integers(10, 30))
        batch.append((brng.normal(size=(nodes, 8)).astype(np.float32),
                      brng.integers(0, nodes, size=(2, edges)).astype(np.int32),
                      int(brng.integers(0, num_classes))))
    shard_nodes = max(sum(g[0].shape[0] for g in batch[d * G:(d + 1) * G]) for d in range(D))
    shard_edges = max(sum(g[1].shape[1] for g in batch[d * G:(d + 1) * G]) for d in range(D))
    cell_nodes = -(-shard_nodes // graph_parts)
    bx, brows, bcols, bvals, bngi, by, bmask = pack_batch_2d(batch, D, graph_parts, G,
                                                             cell_nodes, shard_edges)
    dp_params = (normal(8, hidden), np.zeros(hidden, np.float32), normal(hidden, num_classes),
                 np.zeros(num_classes, np.float32))
    jobs = []
    for r in range(n_ranks):
        rows = slice(r * npp, (r + 1) * npp)
        shard = (x_p[rows], y_p[rows], mask[rows])
        sage_rows = slice(r * (n_sage // n_ranks), (r + 1) * (n_sage // n_ranks))
        mc_rows = slice(r * mc_npp, (r + 1) * mc_npp)
        cell, edges, d = (slice(r * cell_nodes, (r + 1) * cell_nodes),
                          slice(r * shard_edges, (r + 1) * shard_edges), r // graph_parts)
        jobs.append([
            ShardJob("gcn", "gcn", gcn_params, *shard, rank_halo_plan(spec, r, "cpu"), {}, 1),
            ShardJob("gat", "gat_fused", gat_params, *shard, rank_gat_plan(gat_spec, r, "cpu"),
                     {"layer_dims": dims, "edge_drop_rate": 0.6, "feat_drop_rate": 0.6,
                      "seed": 7}, 1),
            ShardJob("sage", "sage", sage_params, *(a[sage_rows] for a in sage_data),
                     {name: a[r] for name, a in shards.items()}, {"k": (4, 3)}, 1),
            ShardJob("mincut", "mincut", mc_params, *(a[mc_rows] for a in mc_data),
                     (mc_part.local_row[r], mc_part.global_col[r], mc_part.value[r]), {}, 1),
            ShardJob("batch_2d", "batch_2d", dp_params, bx[cell], by[d * G:(d + 1) * G],
                     bmask[d * G:(d + 1) * G], (brows[edges], bcols[edges], bvals[edges]),
                     {"data": D, "ngi": bngi[cell]}, 1)])
    if torch.device(device).type == "cuda":
        _build.build_all()  # once, before the ranks load the libraries
    results = run_ranks(jobs, backend="gloo", device=device)
    losses = {job["name"]: job["losses"][0] for job in results[0]}
    losses["mincut_cut"] = next(job["terms"][0][2] for job in results[0]
                                if job["name"] == "mincut")
    for name, loss in losses.items():
        if not np.isfinite(loss):
            raise RuntimeError(f"non-finite {name} loss from the multi-rank step: {loss}")
    return losses
