"""Graph-parallel training steps over ``torch.distributed`` (JAX counterpart:
``tf_geometric_tpu/parallel/sharded.py``, whose steps run under
``shard_map``).

Nodes live in contiguous row blocks, one per rank of the ``graph`` process
group; each rank holds its block of features, labels and mask, its own
shard of the halo plan, and a full replica of the parameters. A step runs
the forward on the local rows, fetching source rows from the other ranks by
an all-gather or the halo all-to-all (whose backward is the reverse
exchange), then the backward, one all-reduce of the flattened gradients and
an Adam update that leaves every replica identical.

The loss. JAX's ``masked_ce`` divides a ``psum``-ed sum by a ``psum``-ed
count inside the loss, and the step then ``psum``s the gradients; the
``psum``'s transpose hands each device its own share, so the sum of shares
is the gradient. ``torch.distributed.nn``'s differentiable all-reduce would
all-reduce the incoming gradient again in its backward and give every
gradient P times too large. So here each rank differentiates ``local_sum /
global_count``, the count taken by a plain all-reduce of detached values,
and the gradients are all-reduced once after the backward. The reported
loss is the all-reduced sum over the count. After a step every parameter's
``.grad`` holds the gradient Adam was given.

Dropout: the JAX fused step folds the mesh index into one step key; here
each rank draws its masks from its own ``torch.Generator``, seeded by the
caller from (seed, rank).
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .halo import (RankGatPlan, RankHaloPlan, halo_exchange, halo_gat_attention,
                   halo_spmm_ell, halo_spmm_split)

__all__ = ["GraphMesh", "build_mesh", "sharded_spmm_local", "make_graph_parallel_gcn_step",
           "make_graph_parallel_gat_step", "make_graph_parallel_gat_fused_step",
           "param_leaves"]


class GraphMesh(NamedTuple):
    """The ``graph`` axis: a process group (None: the default group), this
    process's rank in it and its size."""
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int


def build_mesh(axis_sizes: dict, group: Optional[dist.ProcessGroup] = None) -> GraphMesh:
    """The ``graph`` axis of ``axis_sizes`` over an initialized process
    group whose size it must equal. A ``data`` axis may only be 1: the JAX
    steps replicate their inputs along it, so it adds no work."""
    extra = {k: v for k, v in axis_sizes.items() if k != "graph" and v != 1}
    if extra:
        raise ValueError(f"only the 'graph' axis is sharded, got {extra}")
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs an initialized torch.distributed process group")
    size = dist.get_world_size(group)
    if axis_sizes.get("graph", size) != size:
        raise ValueError(f"graph axis {axis_sizes['graph']} != process group size {size}")
    return GraphMesh(group, dist.get_rank(group), size)


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


def _masked_ce_sum(logits, y_local, mask_local):
    ce = F.cross_entropy(logits, y_local.long().clamp(min=0), reduction="none")
    return (ce * mask_local).sum()


def _finish_step(mesh: GraphMesh, params, optimizer, local_sum, mask_local):
    """Backward of ``local_sum / global_count``, one all-reduce of the
    flattened gradients, the Adam update; returns the global loss."""
    stats = torch.stack([local_sum.detach().float(), mask_local.sum().float()])
    dist.all_reduce(stats, group=mesh.group)
    count = stats[1].clamp(min=1.0)
    leaves = param_leaves(params)
    for p in leaves:
        p.grad = None
    (local_sum / count).backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    offset = 0
    for p in leaves:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    optimizer.step()
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
