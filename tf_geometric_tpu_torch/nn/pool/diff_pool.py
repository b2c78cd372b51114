"""DiffPool: differentiable hierarchical pooling (JAX counterpart:
``tf_geometric_tpu/nn/pool/diff_pool.py``).

The batched coarsening keeps JAX's per-graph blocks:

    pooled_adj[g] = Σ_{e ∈ g} w_e · S[row_e] ⊗ S[col_e]   ([G, C, C])
    pooled_x[g·C + c] = Σ_{n ∈ g} S[n, c] · h[n]

by segment sums of outer products, with the flat cluster ids ``g·C + c``
and pooled edges enumerating each graph's C² pairs. Padded nodes
(``node_graph_index = G``) land on cluster ids ``≥ G·C`` and padded edges
(row out of range) on the graph id G, so the segment sums drop both; every
gather clips its ids, as JAX does.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ...utils.graph_utils import _edge_tensors
from ..kernel.segment import segment_sum
from .common_pool import _resolve_num_graphs

__all__ = ["diff_pool", "diff_pool_coarsen", "batched_cluster_coarsen"]


def batched_cluster_coarsen(h, edge_index, edge_weight, node_graph_index, dense_assign,
                            num_graphs: int):
    """Sᵀ A S and Sᵀ h over a batch of graphs. Returns ``(pooled_x [G·C, F],
    pooled_edge_index [2, G·C²], pooled_edge_weight [G·C²],
    pooled_node_graph_index [G·C])``, all on ``dense_assign``'s device."""
    num_nodes, num_clusters = dense_assign.shape
    device = dense_assign.device
    edge_index, edge_weight = _edge_tensors(torch.as_tensor(edge_index, device=device),
                                            edge_weight)
    node_graph_index = torch.as_tensor(node_graph_index, device=device).long()
    row, col = edge_index[0], edge_index[1]

    safe_row = row.clamp(0, num_nodes - 1)
    # index_select, whose backward is index_add: the padded edges all clamp
    # to row N - 1, and the sorted backward of x[idx] walks such a run of
    # duplicates serially (1.1 ms a gather on the card at the GIN batch)
    s_row = dense_assign.index_select(0, safe_row)
    s_col = dense_assign.index_select(0, col.clamp(0, num_nodes - 1))
    outer = (s_row[:, :, None] * s_col[:, None, :]) * edge_weight[:, None, None]
    edge_graph = torch.where((row >= 0) & (row < num_nodes), node_graph_index[safe_row],
                             num_graphs)
    pooled_adj = segment_sum(outer, edge_graph, num_graphs)                  # [G, C, C]

    clusters = torch.arange(num_clusters, device=device)
    flat_ids = node_graph_index[:, None] * num_clusters + clusters[None, :]  # [N, C]
    weighted = dense_assign[:, :, None] * h[:, None, :]                      # [N, C, F]
    pooled_x = segment_sum(weighted.reshape(num_nodes * num_clusters, -1), flat_ids.reshape(-1),
                           num_graphs * num_clusters)

    base = torch.arange(num_graphs, device=device)[:, None, None] * num_clusters
    shape = (num_graphs, num_clusters, num_clusters)
    rows = (base + clusters[None, :, None]).expand(shape).reshape(-1)
    cols = (base + clusters[None, None, :]).expand(shape).reshape(-1)
    pooled_ngi = torch.arange(num_graphs, device=device).repeat_interleave(num_clusters)
    return pooled_x, torch.stack([rows, cols]), pooled_adj.reshape(-1), pooled_ngi


def _check_assign_shape(dense_assign, num_nodes, num_clusters):
    if num_nodes is not None and int(num_nodes) != dense_assign.shape[0]:
        raise ValueError(f"num_nodes={num_nodes} does not match "
                         f"dense_assign.shape[0]={dense_assign.shape[0]}")
    if num_clusters is not None and int(num_clusters) != dense_assign.shape[1]:
        raise ValueError(f"num_clusters={num_clusters} does not match "
                         f"dense_assign.shape[1]={dense_assign.shape[1]}")


def diff_pool_coarsen(x, edge_index, edge_weight, node_graph_index, dense_assign,
                      num_nodes=None, num_clusters=None, num_graphs: Optional[int] = None):
    """``batched_cluster_coarsen`` with ``num_graphs`` resolved (a host sync
    when None). ``num_nodes`` and ``num_clusters`` must match
    ``dense_assign``'s shape when given."""
    _check_assign_shape(dense_assign, num_nodes, num_clusters)
    num_graphs = _resolve_num_graphs(node_graph_index, num_graphs)
    return batched_cluster_coarsen(x, edge_index, edge_weight, node_graph_index,
                                   dense_assign, num_graphs)


def diff_pool(x, edge_index, edge_weight, node_graph_index, feature_gnn: Callable,
              assign_gnn: Callable, num_clusters: int, bias=None, activation=None,
              cache=None, training=None, num_graphs: Optional[int] = None):
    """DiffPool: ``S = softmax(assign_gnn(...))``, ``h = feature_gnn(...)``,
    then the batched coarsening, plus ``bias`` and ``activation``. The GNNs
    are called as ``gnn([x, edge_index, edge_weight])`` (with ``cache=`` when
    one is given); a module carries its own training mode, so ``training``
    is not passed on."""
    edge_index, edge_weight = _edge_tensors(torch.as_tensor(edge_index, device=x.device),
                                            edge_weight)
    kwargs = {} if cache is None else {"cache": cache}
    assign_logits = assign_gnn([x, edge_index, edge_weight], **kwargs)
    h = feature_gnn([x, edge_index, edge_weight], **kwargs)
    pooled_h, pooled_edge_index, pooled_edge_weight, pooled_ngi = diff_pool_coarsen(
        h, edge_index, edge_weight, node_graph_index, torch.softmax(assign_logits, dim=-1),
        num_graphs=num_graphs)
    if bias is not None:
        pooled_h = pooled_h + bias
    if activation is not None:
        pooled_h = activation(pooled_h)
    return pooled_h, pooled_edge_index, pooled_edge_weight, pooled_ngi
