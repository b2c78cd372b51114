"""Graph-parallel training steps over ``torch.distributed`` (JAX counterpart:
``tf_geometric_tpu/parallel/sharded.py``, whose steps run under
``shard_map``).

Nodes live in contiguous row blocks, one per rank of the ``graph`` process
group; each rank holds its block of features, labels and mask, its own
shard of the halo plan or edges, and a full replica of the parameters. A
step runs the forward on the local rows, fetching source rows from the other
ranks by an all-gather or the halo all-to-all (whose backward is the reverse
exchange), then the backward, one all-reduce of the flattened gradients and
an Adam update that leaves every replica identical. The 2-D batch step adds
a ``data`` axis: D groups of P ranks, each group training its own sub-batch
(``build_mesh``).

The loss. JAX's ``masked_ce`` divides a ``psum``-ed sum by a ``psum``-ed
count inside the loss, and the step then ``psum``s the gradients; the
``psum``'s transpose hands each device its own share, so the sum of shares
is the gradient. Here each rank differentiates ``local_sum /
global_count``, the count taken by a plain all-reduce of detached values,
and the gradients are all-reduced once after the backward. The reported
loss is the all-reduced sum over the count. After a step every parameter's
``.grad`` holds the gradient Adam was given.

Terms that every rank computes alike from all-reduced partials (MinCut's
cut and orthogonality losses and coarse GCN; the 2-D step's readout, head
and cross-entropy) follow the same convention through ``_AllReduceSum``:
its backward sums the incoming gradient over the group, so each rank's
partial receives every rank's share, and each replicated term is divided by
the group size before the backward, so that the gradient all-reduce counts
it once.

Dropout: the JAX fused step folds the mesh index into one step key; here
each rank draws its masks from its own ``torch.Generator``, seeded by the
caller from (seed, rank).
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops import config as _config
from ..ops.csr_spmm import CsrAdj, csr_spmm
from .halo import (RankGatPlan, RankHaloPlan, halo_exchange, halo_gat_attention,
                   halo_spmm_ell, halo_spmm_split)

__all__ = ["GraphMesh", "build_mesh", "sharded_spmm_local", "RankAdjacency", "rank_adjacency",
           "rank_aggregate", "make_graph_parallel_gcn_step", "make_graph_parallel_gat_step",
           "make_graph_parallel_gat_fused_step", "make_graph_parallel_mincut_step",
           "make_batch_2d_step", "pack_batch_2d", "param_leaves"]


class GraphMesh(NamedTuple):
    """This process's place on the mesh: the ``graph`` axis's process group
    (None: the default group), its rank in it and the group's size, then the
    same for the ``data`` axis (a group of one rank, None, when the mesh has
    no data axis). Rank ``d·P + p`` of the mesh's group sits at graph
    position ``p`` of data shard ``d``, as JAX's row-major mesh orders its
    devices."""
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    data_group: Optional[dist.ProcessGroup] = None
    data_rank: int = 0
    data_size: int = 1


def build_mesh(axis_sizes: dict, group: Optional[dist.ProcessGroup] = None) -> GraphMesh:
    """The mesh ``axis_sizes`` (``{"graph": P}`` or ``{"data": D, "graph":
    P}``; another axis may only be 1) over an initialized process group
    (``group``, default the world) of D·P ranks. With D = 1 the graph axis
    is ``group`` itself. With D > 1 every rank creates one graph group per
    data shard, then one data group per graph position, all in the same
    order (``dist.new_group`` is collective), and keeps its own two."""
    extra = {k: v for k, v in axis_sizes.items() if k not in ("graph", "data") and v != 1}
    if extra:
        raise ValueError(f"only the 'data' and 'graph' axes are sharded, got {extra}")
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs an initialized torch.distributed process group")
    size = dist.get_world_size(group)
    data = int(axis_sizes.get("data", 1))
    if data < 1:
        raise ValueError(f"data axis must be at least 1, got {data}")
    graph = int(axis_sizes.get("graph", size // data))
    if graph * data != size:
        raise ValueError(f"data {data} x graph {graph} != process group size {size}")
    rank = dist.get_rank(group)
    if data == 1:
        return GraphMesh(group, rank, size)
    members = [r if group is None else dist.get_global_rank(group, r) for r in range(size)]
    graph_groups = [dist.new_group([members[d * graph + p] for p in range(graph)])
                    for d in range(data)]
    data_groups = [dist.new_group([members[d * graph + p] for d in range(data)])
                   for p in range(graph)]
    d, p = divmod(rank, graph)
    return GraphMesh(graph_groups[d], p, graph, data_groups[p], d, data)


def param_leaves(params) -> List[torch.Tensor]:
    """The tensors of a nested list / tuple of parameters, in order."""
    if isinstance(params, torch.Tensor):
        return [params]
    return [t for p in params for t in param_leaves(p)]


class _AllGather(torch.autograd.Function):
    """Row blocks of every rank, concatenated in rank order; the backward
    sends each block's gradient to its owner (an all-to-all) and sums what
    arrives (a reduce-scatter, which gloo lacks)."""

    @staticmethod
    def forward(ctx, x, mesh: GraphMesh):
        ctx.mesh = mesh
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        recv = torch.empty_like(grad)
        dist.all_to_all_single(recv, grad.contiguous(), group=mesh.group)
        return recv.view(mesh.size, -1, *grad.shape[1:]).sum(0), None


def sharded_spmm_local(h_global, local_row, global_col, value, nodes_per_part: int):
    """The local half of a sharded SpMM: gather from the all-gathered
    features, sum into the local row block; padded edges (row
    ``nodes_per_part``) are dropped."""
    msg = h_global.index_select(0, global_col.long().clamp(0, h_global.shape[0] - 1))
    out = msg.new_zeros((nodes_per_part + 1, msg.shape[1]))
    return out.index_add(0, local_row.long().clamp(0, nodes_per_part),
                         msg * value[:, None])[:nodes_per_part]


class _AllReduceSum(torch.autograd.Function):
    """``psum`` of a partial that feeds terms every rank of ``group``
    computes alike. The backward sums the incoming gradient over the group,
    so each rank's partial receives the share of every rank's terms. The
    rule that goes with it: divide each replicated term by the group size
    before the backward, or the gradient all-reduce after it counts the term
    once per rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


class RankAdjacency(NamedTuple):
    """One rank's edge shard as the MinCut and 2-D steps aggregate it: a
    rectangular ``CsrAdj`` [npp, num_cols] (rows local, columns in the
    all-gathered table, padded edges dropped) for Kernel A, the flat shard
    (``rows``, ``cols``, ``vals``) for the plain version
    (``sharded_spmm_local``) and the shard's row sums ``deg`` [npp]."""
    csr: CsrAdj
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    deg: torch.Tensor
    nodes_per_part: int

    def to(self, device) -> "RankAdjacency":
        return RankAdjacency(self.csr.to(device), self.rows.to(device), self.cols.to(device),
                             self.vals.to(device), self.deg.to(device), self.nodes_per_part)


def rank_adjacency(rows, cols, vals, nodes_per_part: int, num_cols: int,
                   device="cuda") -> RankAdjacency:
    """Build a rank's ``RankAdjacency`` once, on the host, from its flat
    shard: ``rows`` local (``nodes_per_part`` marks padding), ``cols`` into
    a table of ``num_cols`` rows, ``vals`` the edge weights."""
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float32)
    ok = rows < nodes_per_part
    csr = CsrAdj.from_coo(np.stack([rows[ok], cols[ok]]), vals[ok], (nodes_per_part, num_cols),
                          device=device)
    deg = np.zeros(nodes_per_part, np.float32)
    np.add.at(deg, rows[ok], vals[ok])
    return RankAdjacency(csr, *(torch.as_tensor(a, device=device) for a in
                                (rows.astype(np.int32), cols.astype(np.int32), vals, deg)),
                         nodes_per_part)


def rank_aggregate(adj: RankAdjacency, h_global):
    """``Ã_local · h_global`` [npp, F]: Kernel A (``csr_spmm``, with its
    ``Ãᵀ·dy`` backward) on the rank's rectangular ``CsrAdj``; inside
    ``ops.config.use_plain_versions()`` the plain ``sharded_spmm_local``."""
    if _config.plain_versions:
        return sharded_spmm_local(h_global, adj.rows, adj.cols, adj.vals, adj.nodes_per_part)
    return csr_spmm(adj.csr, h_global)


def _masked_ce_sum(logits, y_local, mask_local):
    ce = F.cross_entropy(logits, y_local.long().clamp(min=0), reduction="none")
    return (ce * mask_local).sum()


def _apply_gradients(params, optimizer, objective, groups):
    """Backward of ``objective``, the flattened gradients all-reduced over
    each of ``groups`` in turn, the Adam update."""
    leaves = param_leaves(params)
    for p in leaves:
        p.grad = None
    objective.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]
    flat = torch.cat([g.reshape(-1) for g in grads])
    for group in groups:
        dist.all_reduce(flat, group=group)
    offset = 0
    for p in leaves:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    optimizer.step()


def _finish_step(mesh: GraphMesh, params, optimizer, local_sum, mask_local, replicated=None):
    """Backward of ``local_sum / global_count`` (plus ``replicated / P``,
    a term every rank of the graph group computes alike), one all-reduce of
    the flattened gradients, the Adam update; returns the global masked
    mean of ``local_sum``."""
    stats = torch.stack([local_sum.detach().float(), mask_local.sum().float()])
    dist.all_reduce(stats, group=mesh.group)
    count = stats[1].clamp(min=1.0)
    objective = local_sum / count
    if replicated is not None:
        objective = objective + replicated / mesh.size
    _apply_gradients(params, optimizer, objective, (mesh.group,))
    return stats[0] / count


def _adam(learning_rate: float) -> Callable:
    """optax.adam's counterpart: b1 0.9, b2 0.999, eps 1e-8 outside the sqrt."""
    return lambda params: torch.optim.Adam(param_leaves(params), lr=learning_rate)


def make_graph_parallel_gcn_step(mesh: GraphMesh, learning_rate: float = 1e-2,
                                 halo_plan: Optional[RankHaloPlan] = None):
    """A multi-layer GCN training step over the rank's row block; returns
    ``(step, make_optimizer)``, ``make_optimizer(params)`` the Adam over
    ``params = [(w, b), ...]``, whose shapes set the layers and widths (the
    JAX function's ``num_layers``, ``hidden`` and ``num_classes`` go unused
    there too).

    Without ``halo_plan`` (all-gather mode) the step is ``step(params,
    optimizer, x_local, rows, cols, vals, y_local, mask_local)`` with this
    rank's ``partition_edges_by_row`` shard (``cols`` global). With the
    rank's ``halo_plan`` (COO or packed) it is ``step(params, optimizer,
    x_local, y_local, mask_local)``: each layer exchanges the projected rows
    once and aggregates local and remote edges. Returns the global loss."""

    def aggregate(hw, nodes_per_part, edges):
        if halo_plan is None:
            rows, cols, vals = edges
            return sharded_spmm_local(_AllGather.apply(hw, mesh), rows, cols, vals,
                                      nodes_per_part)
        recv = halo_exchange(hw, halo_plan.send_idx, mesh.group)
        if halo_plan.local is not None:
            return halo_spmm_ell(hw, recv, halo_plan.local, halo_plan.remote)
        return halo_spmm_split(hw, recv, *halo_plan.coo, nodes_per_part)

    def run(params, optimizer, x_local, y_local, mask_local, edges=None):
        h = x_local
        for li, (w, b) in enumerate(params):
            h = aggregate(h @ w, x_local.shape[0], edges) + b
            if li < len(params) - 1:
                h = torch.relu(h)
        return _finish_step(mesh, params, optimizer, _masked_ce_sum(h, y_local, mask_local),
                            mask_local)

    if halo_plan is None:
        def step(params, optimizer, x_local, rows, cols, vals, y_local, mask_local):
            return run(params, optimizer, x_local, y_local, mask_local, (rows, cols, vals))
    else:
        def step(params, optimizer, x_local, y_local, mask_local):
            return run(params, optimizer, x_local, y_local, mask_local)
    return step, _adam(learning_rate)


def make_graph_parallel_gat_step(mesh: GraphMesh, halo_plan: RankHaloPlan, num_heads: int = 8,
                                 units: int = 8, learning_rate: float = 5e-3,
                                 query_activation=torch.relu, key_activation=torch.relu):
    """The segment-path GAT step over the rank's COO halo plan (the oracle
    of the fused step): one all-to-all per layer carries ``K‖V``, scores and
    the destination softmax are per-edge PyTorch ops over the local and
    remote edge lists. ``params = ((wq, bq, wk, bk, wv, bias), (w_out,
    b_out))``; ``step(params, optimizer, x_local, y_local, mask_local)``."""
    H, d = num_heads, units
    inv_scale = 1.0 / (d ** 0.5)
    loc_row, loc_col, loc_val, rem_row, rem_addr, rem_val = halo_plan.coo
    npp = halo_plan.nodes_per_part

    def blocksum(prod):  # [M, H·d] -> [M, H]
        return prod.float().view(prod.shape[0], H, d).sum(-1)

    def expand(a):  # [M, H] -> [M, H·d]
        return a.repeat_interleave(d, dim=-1)

    def seg_max(s, rows):
        out = torch.full((npp + 1, H), float("-inf"), device=s.device)
        idx = rows.long().clamp(0, npp)[:, None].expand(-1, H)
        return out.scatter_reduce(0, idx, s, "amax", include_self=True)

    def seg_sum(m, rows):
        return m.new_zeros((npp + 1, m.shape[1])).index_add(0, rows.long().clamp(0, npp), m)

    def gat_layer(x_local, wq, bq, wk, bk, wv, bias):
        Q = x_local @ wq + bq
        if query_activation is not None:
            Q = query_activation(Q)
        K = x_local @ wk + bk
        if key_activation is not None:
            K = key_activation(K)
        V = x_local @ wv
        kv = torch.cat([K, V], dim=-1)
        recv_flat = halo_exchange(kv, halo_plan.send_idx, mesh.group).reshape(-1, 2 * H * d)
        kv_loc = kv.index_select(0, loc_col.long().clamp(0, npp - 1))
        kv_rem = recv_flat.index_select(0, rem_addr.long().clamp(0, recv_flat.shape[0] - 1))
        safe_lr, safe_rr = loc_row.long().clamp(0, npp - 1), rem_row.long().clamp(0, npp - 1)
        loc_ok, rem_ok = (loc_row < npp)[:, None], (rem_row < npp)[:, None]
        s_loc = torch.where(loc_ok, blocksum(Q[safe_lr] * kv_loc[:, :H * d]) * inv_scale, -1e30)
        s_rem = torch.where(rem_ok, blocksum(Q[safe_rr] * kv_rem[:, :H * d]) * inv_scale, -1e30)
        m = torch.maximum(seg_max(s_loc, loc_row), seg_max(s_rem, rem_row))[:npp]
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p_loc = torch.where(loc_ok, torch.exp(s_loc - m[safe_lr]), 0.0) * loc_val[:, None]
        p_rem = torch.where(rem_ok, torch.exp(s_rem - m[safe_rr]), 0.0) * rem_val[:, None]
        denom = (seg_sum(p_loc, loc_row) + seg_sum(p_rem, rem_row))[:npp] + 1e-16
        a_loc, a_rem = p_loc / denom[safe_lr], p_rem / denom[safe_rr]
        out = (seg_sum(kv_loc[:, H * d:] * expand(a_loc).to(V.dtype), loc_row)
               + seg_sum(kv_rem[:, H * d:] * expand(a_rem).to(V.dtype), rem_row))[:npp]
        return out + bias

    def step(params, optimizer, x_local, y_local, mask_local):
        (wq, bq, wk, bk, wv, bias), (w_out, b_out) = params
        h = F.elu(gat_layer(x_local, wq, bq, wk, bk, wv, bias))
        return _finish_step(mesh, params, optimizer,
                            _masked_ce_sum(h @ w_out + b_out, y_local, mask_local), mask_local)

    return step, _adam(learning_rate)


def make_graph_parallel_gat_fused_step(mesh: GraphMesh, gat_plan: RankGatPlan,
                                       layer_dims: Sequence = ((8, 8),),
                                       learning_rate: float = 5e-3, edge_drop_rate: float = 0.0,
                                       feat_drop_rate: float = 0.0,
                                       query_activation=torch.relu, key_activation=torch.relu):
    """The GAT step on the fused attention kernels: per layer (heads
    concatenated, ELU after each) feature dropout, ``Q``, ``K``, ``V``, one
    all-to-all of ``K‖V``, then ``gat_attention_ell`` over the rank's
    rectangular layout ``[local ‖ received]`` with attention dropout; a
    linear head last. ``params = ([(wq, bq, wk, bk, wv, bias) per layer],
    (w_out, b_out))``; ``step(params, optimizer, generator, x_local,
    y_local, mask_local)``, the masks drawn from ``generator`` (on the
    tensors' device)."""
    heads = [h for h, _ in layer_dims]
    training = edge_drop_rate > 0.0

    def step(params, optimizer, generator, x_local, y_local, mask_local):
        gat_layers, (w_out, b_out) = params
        h = x_local
        for li, (wq, bq, wk, bk, wv, bias) in enumerate(gat_layers):
            if feat_drop_rate > 0.0:
                keep = torch.rand(h.shape, generator=generator, device=h.device)
                h = torch.where(keep < 1.0 - feat_drop_rate, h / (1.0 - feat_drop_rate),
                                torch.zeros_like(h))
            Q = h @ wq + bq
            if query_activation is not None:
                Q = query_activation(Q)
            K = h @ wk + bk
            if key_activation is not None:
                K = key_activation(K)
            V = h @ wv
            HD = V.shape[1]
            recv = halo_exchange(torch.cat([K, V], dim=-1), gat_plan.send_idx,
                                 mesh.group).reshape(-1, 2 * HD)
            K_src = torch.cat([K, recv[:, :HD]])
            V_src = torch.cat([V, recv[:, HD:]])
            h = F.elu(halo_gat_attention(Q, K_src, V_src, gat_plan, heads[li],
                                         edge_drop_rate=edge_drop_rate, training=training,
                                         generator=generator) + bias)
        return _finish_step(mesh, params, optimizer,
                            _masked_ce_sum(h @ w_out + b_out, y_local, mask_local), mask_local)

    return step, _adam(learning_rate)


def make_graph_parallel_mincut_step(mesh: GraphMesh, adj: RankAdjacency, num_clusters: int = 32,
                                    learning_rate: float = 1e-2, cut_coef: float = 1.0,
                                    orth_coef: float = 1.0, variant: str = "min_cut"):
    """Edge-partitioned hierarchical pooling on one large graph: a GCN
    encoder and an assignment GNN over the rank's row block, MinCutPool or
    DiffPool coarsening from all-reduced partials, a dense C×C GCN on the
    pooled graph (every rank alike), unpooling and a node-classification
    head. Returns ``(step, make_optimizer)``.

    ``adj``: the rank's ``RankAdjacency`` of the normalized adjacency
    (``adj_norm_edge(..., add_self_loop=False)`` for MinCut's semantics),
    built once, where the JAX step takes the flat shard every call.
    ``params = ((w0, b0), (wa, ba), (wc, bc), (wo, bo))``, whose shapes set
    the widths (C is ``wa``'s). ``step(params, optimizer, x_local, y_local,
    mask_local, valid_local)`` returns ``(loss, ce, cut, orth)``; ``mask``
    selects the labelled rows and ``valid`` the real ones (a padding row's
    assignment is zeroed).

    Per step: one all-gather of ``x·W0 ‖ x·Wa`` aggregated by Kernel A at
    F = hidden + C, the assignment ``S_local`` all-gathered and aggregated
    again (``pooled_adj = S_localᵀ·(Ã_local·S_g)``, JAX's ``(s_row·vals)ᵀ
    @ s_col`` without an [E, C] gather), one ``_AllReduceSum`` of every
    partial (``S_localᵀ·h1``, ``pooled_adj``, ``Σ deg·|S|²``, ``SᵀS``):
    4 Kernel A launches a step with the two ``dh``. ``variant="min_cut"``
    zeroes the pooled self-loops and adds ``cut_coef·cut + orth_coef·orth``
    to the loss; ``"diff"`` trains on the cross-entropy alone (cut = orth =
    0). The cut and orth terms are divided by P before the backward."""
    if variant not in ("min_cut", "diff"):
        raise ValueError(f"variant must be 'min_cut' or 'diff', got {variant!r}")
    C = num_clusters

    def step(params, optimizer, x_local, y_local, mask_local, valid_local):
        (w0, b0), (wa, ba), (wc, bc), (wo, bo) = params
        hidden = w0.shape[1]
        if wa.shape[1] != C:
            raise ValueError(f"wa has {wa.shape[1]} clusters, the step {C}")
        proj = torch.cat([x_local @ w0, x_local @ wa], dim=1)
        agg = rank_aggregate(adj, _AllGather.apply(proj, mesh))
        h1 = torch.relu(agg[:, :hidden] + b0)
        s_local = torch.softmax(agg[:, hidden:] + ba, dim=-1) * valid_local[:, None]
        pooled_adj = s_local.t() @ rank_aggregate(adj, _AllGather.apply(s_local, mesh))
        parts = [s_local.t() @ h1, pooled_adj]
        if variant == "min_cut":
            parts += [(adj.deg * (s_local * s_local).sum(-1)).sum()[None],
                      s_local.t() @ s_local]
        sizes = [t.numel() for t in parts]
        summed = _AllReduceSum.apply(torch.cat([t.reshape(-1) for t in parts]), mesh.group)
        summed = torch.split(summed, sizes)
        pooled_x, pooled_adj = summed[0].view(C, hidden), summed[1].view(C, C)
        zero = torch.zeros((), device=x_local.device)
        cut = orth = zero
        if variant == "min_cut":
            all_sum, sts = summed[2][0], summed[3].view(C, C)
            eye = torch.eye(C, device=x_local.device)
            cut = -torch.trace(pooled_adj) / (all_sum + 1e-8)
            sts_n = sts / (torch.sqrt((sts * sts).sum()) + 1e-8)
            dev = sts_n - eye / float(np.sqrt(np.float32(C)))
            orth = torch.sqrt((dev * dev).sum())
            pooled_adj = pooled_adj * (1.0 - eye)
        coarse = torch.relu(pooled_adj @ (pooled_x @ wc) + bc)
        logits = torch.cat([h1, s_local @ coarse], dim=1) @ wo + bo
        replicated = cut_coef * cut + orth_coef * orth
        ce = _finish_step(mesh, params, optimizer, _masked_ce_sum(logits, y_local, mask_local),
                          mask_local, replicated if variant == "min_cut" else None)
        return ce + replicated.detach(), ce, cut.detach(), orth.detach()

    return step, _adam(learning_rate)


def make_batch_2d_step(mesh: GraphMesh, adj: RankAdjacency, graphs_per_data_shard: int = 8,
                       learning_rate: float = 1e-2):
    """2-D parallel batched graph classification: the ``data`` axis splits
    the batch of graphs (each data shard owns a sub-batch), the ``graph``
    axis edge-partitions each sub-batch's disjoint union (``pack_batch_2d``).
    Returns ``(step, make_optimizer)``; ``params = (w0, b0, wd, bd)``.

    ``adj``: this cell's ``RankAdjacency`` (rows local to the cell's row
    block, columns in the data shard's node space, ``P·npp``).
    ``step(params, optimizer, x_local, ngi_local, y_shard, gmask_shard)``:
    ``ngi`` the cell's rows' graph ids within the data shard (G marks
    padding), ``y``/``gmask`` the data shard's G labels and label mask.
    Returns the mean cross-entropy over every data shard's graphs.

    Per cell: one mean-aggregation GCN layer (the all-gather over ``graph``
    only, Kernel A, the shard's row sums + 1e-6), the per-graph mean readout
    whose segment sums and counts are all-reduced over ``graph``
    (``_AllReduceSum``: a graph's nodes span row blocks), the dense head.
    The head and cross-entropy are alike on the P ranks of a graph group,
    so each rank's cross-entropy is divided by P before the backward; the
    gradients are then all-reduced over ``graph`` and over ``data``."""
    G = graphs_per_data_shard
    if mesh.data_size > 1 and mesh.data_group is None:
        raise ValueError("the mesh has a data axis but no data group")

    def step(params, optimizer, x_local, ngi_local, y_shard, gmask_shard):
        w0, b0, wd, bd = params
        hw = x_local @ w0
        agg = rank_aggregate(adj, _AllGather.apply(hw, mesh))
        h = torch.relu(agg / (adj.deg + 1e-6)[:, None] + b0)
        ids = ngi_local.long().clamp(0, G)
        ones = (ngi_local < G).to(h.dtype)[:, None]
        local = h.new_zeros((G + 1, h.shape[1] + 1)).index_add(
            0, ids, torch.cat([h * ones, ones], dim=1))[:G]
        sums = _AllReduceSum.apply(local, mesh.group)
        pooled = sums[:, :-1] / sums[:, -1:].clamp(min=1.0)
        ce_sum = _masked_ce_sum(pooled @ wd + bd, y_shard, gmask_shard)
        stats = torch.stack([ce_sum.detach().float(), gmask_shard.sum().float()])
        if mesh.data_size > 1:
            dist.all_reduce(stats, group=mesh.data_group)
        count = stats[1].clamp(min=1.0)
        groups = (mesh.group,) if mesh.data_size == 1 else (mesh.group, mesh.data_group)
        _apply_gradients(params, optimizer, ce_sum / count / mesh.size, groups)
        return stats[0] / count

    return step, _adam(learning_rate)


def pack_batch_2d(graphs, num_data_shards: int, num_graph_parts: int,
                  graphs_per_data_shard: int, nodes_per_cell: int, edges_per_cell: int):
    """Host-side packing for ``make_batch_2d_step``, bit for bit the JAX
    function's. ``graphs``: (x [n, F], edge_index [2, e], y) numpy triples.
    Graph g goes to data shard g // graphs_per_data_shard; within a data
    shard the nodes are laid out in order and cut into ``num_graph_parts``
    row blocks of ``nodes_per_cell`` rows, each edge owned by its
    destination's block. Returns ``(x [D·P·npp, F], rows, cols, vals
    [D·P·Es], ngi [D·P·npp], y [D·G], gmask [D·G])``: cell (d, p) holds
    rows ``(d·P + p)·npp ..`` and edges ``(d·P + p)·Es ..``; ``rows`` local
    to the cell (``npp`` on padding), ``cols`` in the data shard's node
    space, ``ngi`` graph ids within the data shard (G on padding)."""
    D, Pg, G = num_data_shards, num_graph_parts, graphs_per_data_shard
    F_in = graphs[0][0].shape[1]
    shard_nodes = Pg * nodes_per_cell
    x = np.zeros((D * shard_nodes, F_in), np.float32)
    ngi = np.full(D * shard_nodes, G, np.int32)
    rows = np.full((D, Pg, edges_per_cell), nodes_per_cell, np.int32)
    cols = np.zeros((D, Pg, edges_per_cell), np.int32)
    vals = np.zeros((D, Pg, edges_per_cell), np.float32)
    y = np.zeros(D * G, np.int32)
    gmask = np.zeros(D * G, np.float32)
    fill = np.zeros(D, np.int64)
    edge_fill = np.zeros((D, Pg), np.int64)
    for g, (xg, eig, yg) in enumerate(graphs):
        d = g // G
        if d >= D:
            raise ValueError("more graphs than D*G slots")
        base = fill[d]
        n = xg.shape[0]
        if base + n > shard_nodes:
            raise ValueError("nodes_per_cell too small for this batch")
        x[d * shard_nodes + base: d * shard_nodes + base + n] = xg
        ngi[d * shard_nodes + base: d * shard_nodes + base + n] = g - d * G
        y[d * G + (g - d * G)] = yg
        gmask[d * G + (g - d * G)] = 1.0
        er = np.asarray(eig[0]) + base
        ec = np.asarray(eig[1]) + base
        owner = er // nodes_per_cell
        for p in range(Pg):
            sel = owner == p
            k = int(sel.sum())
            if k == 0:
                continue
            s = edge_fill[d, p]
            if s + k > edges_per_cell:
                raise ValueError("edges_per_cell too small")
            rows[d, p, s:s + k] = er[sel] - p * nodes_per_cell
            cols[d, p, s:s + k] = ec[sel]
            vals[d, p, s:s + k] = 1.0
            edge_fill[d, p] += k
        fill[d] += n
    return (x, rows.reshape(-1), cols.reshape(-1), vals.reshape(-1), ngi, y, gmask)
