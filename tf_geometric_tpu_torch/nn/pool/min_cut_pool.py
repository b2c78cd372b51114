"""MinCutPool: spectral-clustering pooling with the min-cut and
orthogonality losses (JAX counterpart:
``tf_geometric_tpu/nn/pool/min_cut_pool.py``).

Losses, per graph then averaged over graphs:

    cut  = mean_g( − tr(Sᵀ Ã S)_g / (tr(Sᵀ D S)_g + 1e-8) )
    orth = mean_g( ‖ SᵀS / (‖SᵀS‖_F + 1e-8) − I/√C ‖_F )

with Ã the symmetric-normalized adjacency (``adj_norm_edge``, no
self-loops) and D its degree. The traces are edge and node sums:
tr(SᵀÃS)_g = Σ_{e∈g} Ã_e·⟨S[row_e], S[col_e]⟩, tr(SᵀDS)_g = Σ_{n∈g}
d_n·‖S[n]‖². The coarsening is DiffPool's batched one over Ã, with the
pooled self-loops' weights set to 0.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ...utils.graph_utils import _edge_tensors, adj_norm_edge
from ..kernel.segment import segment_sum
from .common_pool import _resolve_num_graphs
from .diff_pool import _check_assign_shape, batched_cluster_coarsen

__all__ = ["min_cut_pool", "min_cut_pool_coarsen", "min_cut_pool_compute_losses"]


def min_cut_pool_compute_losses(edge_index, edge_weight, node_graph_index, dense_assign,
                                normed_edge_weight=None, num_graphs: Optional[int] = None,
                                cache=None):
    """``(cut_loss, orth_loss)``, scalars averaged over the graphs."""
    num_nodes, num_clusters = dense_assign.shape
    device = dense_assign.device
    node_graph_index = torch.as_tensor(node_graph_index, device=device).long()
    num_graphs = _resolve_num_graphs(node_graph_index, num_graphs)
    edge_index, edge_weight = _edge_tensors(torch.as_tensor(edge_index, device=device),
                                            edge_weight)
    if normed_edge_weight is None:
        _, normed_edge_weight = adj_norm_edge(edge_index, num_nodes, edge_weight,
                                              add_self_loop=False, cache=cache)
    row, col = edge_index[0], edge_index[1]
    safe_row = row.clamp(0, num_nodes - 1)
    degree = segment_sum(normed_edge_weight, row, num_nodes)

    # index_select, as in batched_cluster_coarsen: padded edges clamp to one row
    s_dot = (dense_assign.index_select(0, safe_row)
             * dense_assign.index_select(0, col.clamp(0, num_nodes - 1))).sum(-1)
    edge_graph = torch.where((row >= 0) & (row < num_nodes), node_graph_index[safe_row],
                             num_graphs)
    intra = segment_sum(normed_edge_weight * s_dot, edge_graph, num_graphs)
    all_sum = segment_sum(degree * (dense_assign * dense_assign).sum(-1), node_graph_index,
                          num_graphs)
    cut_loss = (-intra / (all_sum + 1e-8)).mean()

    outer = dense_assign[:, :, None] * dense_assign[:, None, :]
    sts = segment_sum(outer, node_graph_index, num_graphs)                  # [G, C, C]
    norm = torch.sqrt((sts * sts).sum(dim=(-2, -1), keepdim=True))
    eye = torch.eye(num_clusters, device=device) / torch.sqrt(
        torch.tensor(float(num_clusters), device=device))
    deviation = sts / (norm + 1e-8) - eye[None]
    orth_loss = torch.sqrt((deviation * deviation).sum(dim=(-2, -1))).mean()
    return cut_loss, orth_loss


def min_cut_pool_coarsen(x, edge_index, edge_weight, node_graph_index, dense_assign,
                         num_nodes=None, num_clusters=None, num_graphs: Optional[int] = None,
                         normed_edge_weight=None, cache=None):
    """DiffPool's batched coarsening over Ã (``normed_edge_weight``, or
    ``adj_norm_edge`` of the edges), the pooled self-loops' weights set to 0.
    ``num_nodes`` and ``num_clusters`` must match ``dense_assign``'s shape
    when given."""
    _check_assign_shape(dense_assign, num_nodes, num_clusters)
    n = dense_assign.shape[0]
    num_graphs = _resolve_num_graphs(node_graph_index, num_graphs)
    edge_index, edge_weight = _edge_tensors(
        torch.as_tensor(edge_index, device=dense_assign.device), edge_weight)
    if normed_edge_weight is None:
        _, normed_edge_weight = adj_norm_edge(edge_index, n, edge_weight, cache=cache)
    pooled_x, pooled_edge_index, pooled_edge_weight, pooled_ngi = batched_cluster_coarsen(
        x, edge_index, normed_edge_weight, node_graph_index, dense_assign, num_graphs)
    is_loop = pooled_edge_index[0] == pooled_edge_index[1]
    pooled_edge_weight = torch.where(is_loop, torch.zeros_like(pooled_edge_weight),
                                     pooled_edge_weight)
    return pooled_x, pooled_edge_index, pooled_edge_weight, pooled_ngi


def min_cut_pool(x, edge_index, edge_weight, node_graph_index, feature_gnn: Callable,
                 assign_gnn: Callable, num_clusters: int, bias=None, activation=None,
                 gnn_use_normed_edge: bool = True, return_loss_func: bool = False,
                 return_losses: bool = False, cache=None, training=None,
                 num_graphs: Optional[int] = None):
    """MinCutPool: the GNNs run over Ã (or the raw weights when
    ``gnn_use_normed_edge`` is False), ``S = softmax(assign_gnn(...))``, then
    ``min_cut_pool_coarsen``, ``bias`` and ``activation``. Returns the four
    pooled outputs; with ``return_losses``, ``(outputs, (cut, orth))``; with
    ``return_loss_func``, ``(outputs, loss_func)`` where ``loss_func()``
    computes them. The GNNs are called as in ``diff_pool``."""
    if return_loss_func and return_losses:
        raise ValueError("return_loss_func and return_losses are exclusive")
    num_nodes = x.shape[0]
    edge_index, edge_weight = _edge_tensors(torch.as_tensor(edge_index, device=x.device),
                                            edge_weight)
    _, normed_edge_weight = adj_norm_edge(edge_index, num_nodes, edge_weight,
                                          add_self_loop=False, cache=cache)
    gnn_edge_weight = normed_edge_weight if gnn_use_normed_edge else edge_weight
    kwargs = {} if cache is None else {"cache": cache}
    assign_logits = assign_gnn([x, edge_index, gnn_edge_weight], **kwargs)
    h = feature_gnn([x, edge_index, gnn_edge_weight], **kwargs)
    assign_probs = torch.softmax(assign_logits, dim=-1)
    pooled_h, pooled_edge_index, pooled_edge_weight, pooled_ngi = min_cut_pool_coarsen(
        h, edge_index, edge_weight, node_graph_index, assign_probs, num_graphs=num_graphs,
        normed_edge_weight=normed_edge_weight)
    if bias is not None:
        pooled_h = pooled_h + bias
    if activation is not None:
        pooled_h = activation(pooled_h)
    outputs = pooled_h, pooled_edge_index, pooled_edge_weight, pooled_ngi
    if not (return_loss_func or return_losses):
        return outputs

    def loss_func():
        return min_cut_pool_compute_losses(edge_index, edge_weight, node_graph_index,
                                           assign_probs, normed_edge_weight=normed_edge_weight,
                                           num_graphs=num_graphs)

    return (outputs, loss_func) if return_loss_func else (outputs, loss_func())
