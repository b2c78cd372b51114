"""ASAP: Adaptive Structure Aware Pooling (JAX counterpart:
``tf_geometric_tpu/nn/pool/asap.py``).

A GCN embeds the nodes; each node's cluster (its self-looped
neighbourhood) attends over its members with a query from the
neighbourhood max; the attention-weighted cluster features are scored by
LEConv; each graph keeps its top clusters; the kept clusters' rows of the
attention give the assignment, and ``cluster_pool`` coarsens the graph,
whose pooled self-loops are replaced by ones of weight 1.

Two modes, as in JAX:

* ``k`` with ``num_graphs``: fixed capacity G·k clusters on the device,
  self-loops masked (not removed), invalid slots carried by out-of-range
  ids. ``cluster_pool(dense_output_edges=True)`` enumerates every pair of
  the G·k clusters across the batch, so the pooled edges number (G·k)².
* ``ratio`` (or ``k`` without ``num_graphs``): selection on the host, ragged
  sizes, the pooled edges' index as numpy.

The attention GCN runs with ``cache=None``: its adjacency is the graph with
the self-loops stripped, which must not share the caller's cache entry of
the full graph's normalization. Dropout on the attention draws from
``generator`` or takes ``keep_mask``, where JAX takes a key.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...sparse.matrix import SparseMatrix
from ...utils.graph_utils import add_self_loop_edge, mask_self_loop_edge, remove_self_loop_edge
from ...utils.union_utils import convert_union_to_numpy
from ..conv.gcn import gcn
from ..conv.le_conv import le_conv
from ..kernel.map_reduce import (aggregate_neighbors, gcn_mapper, identity_mapper, max_reducer,
                                 sum_reducer)
from ..kernel.segment import segment_softmax
from .cluster_pool import cluster_pool
from .topk_pool import topk_pool, topk_pool_fixed

__all__ = ["asap"]


def asap(x, edge_index, edge_weight, node_graph_index,
         attention_gcn_kernel, attention_gcn_bias,
         attention_query_kernel, attention_query_bias,
         attention_score_kernel, attention_score_bias,
         le_conv_self_kernel, le_conv_self_bias,
         le_conv_aggr_self_kernel, le_conv_aggr_self_bias,
         le_conv_aggr_neighbor_kernel, le_conv_aggr_neighbor_bias,
         k: Optional[int] = None, ratio: Optional[float] = None,
         le_conv_activation=torch.sigmoid, drop_rate: float = 0.0, training=None, cache=None,
         generator=None, keep_mask=None, num_graphs: Optional[int] = None):
    """ASAP pooling; returns the pooled ``(x, edge_index, edge_weight,
    node_graph_index)``. ``cache`` is accepted for the JAX signature and not
    used (see the module docstring)."""
    if k is not None and ratio is not None:
        raise ValueError("provide either k or ratio for asap, not both")
    device = x.device
    num_nodes = x.shape[0]
    fixed_mode = k is not None and num_graphs is not None
    if fixed_mode:
        edge_index, edge_weight = mask_self_loop_edge(
            torch.as_tensor(edge_index, device=device).long(), num_nodes, edge_weight)
        if edge_weight is None:
            edge_weight = (edge_index[0] < num_nodes).float()
    else:
        edge_index, edge_weight = remove_self_loop_edge(
            convert_union_to_numpy(edge_index),
            None if edge_weight is None else convert_union_to_numpy(edge_weight))
        edge_index = torch.as_tensor(edge_index, device=device).long()
        if edge_weight is not None:
            edge_weight = torch.as_tensor(edge_weight, device=device)
    edge_index_sl, edge_weight_sl = add_self_loop_edge(edge_index, num_nodes,
                                                       edge_weight=edge_weight)
    row_sl, col_sl = edge_index_sl[0], edge_index_sl[1]

    adj = SparseMatrix(edge_index, edge_weight, (num_nodes, num_nodes))
    attention_h = gcn(x, adj, attention_gcn_kernel, attention_gcn_bias, cache=None)

    # each cluster's query: the max over its self-looped neighbourhood
    attention_query = aggregate_neighbors(attention_h, edge_index_sl, None,
                                          mapper=identity_mapper, reducer=max_reducer,
                                          num_nodes=num_nodes)
    attention_query = attention_query @ attention_query_kernel + attention_query_bias
    # gathers clip, as JAX's do: masked and padded edges carry row =
    # num_nodes (index_select: see batched_cluster_coarsen)
    score_h = torch.cat([attention_query.index_select(0, row_sl.clamp(0, num_nodes - 1)),
                         attention_h.index_select(0, col_sl.clamp(0, num_nodes - 1))], dim=-1)
    att_score = F.leaky_relu(score_h @ attention_score_kernel + attention_score_bias, 0.2)
    normed_att_score = segment_softmax(att_score, row_sl, num_nodes)
    if training and drop_rate > 0:
        if keep_mask is None:
            if generator is None:
                raise ValueError("asap: attention dropout needs a generator or keep_mask")
            keep_mask = torch.rand(normed_att_score.shape, generator=generator,
                                   device=device) < (1.0 - drop_rate)
        keep_mask = torch.as_tensor(keep_mask, device=device).reshape(normed_att_score.shape)
        normed_att_score = torch.where(keep_mask.bool(), normed_att_score / (1.0 - drop_rate),
                                       torch.zeros_like(normed_att_score))

    cluster_h = aggregate_neighbors(x, edge_index_sl, normed_att_score.reshape(-1),
                                    mapper=gcn_mapper, reducer=sum_reducer, num_nodes=num_nodes)
    node_score = le_conv(cluster_h, edge_index, edge_weight,
                         le_conv_self_kernel, le_conv_self_bias,
                         le_conv_aggr_self_kernel, le_conv_aggr_self_bias,
                         le_conv_aggr_neighbor_kernel, le_conv_aggr_neighbor_bias,
                         activation=None)
    if fixed_mode:
        return _asap_fixed(cluster_h, node_score, normed_att_score, edge_index_sl,
                           edge_weight_sl, node_graph_index, k, num_graphs,
                           le_conv_activation)
    return _asap_ratio(cluster_h, node_score, normed_att_score, edge_index_sl, edge_weight_sl,
                       node_graph_index, k, ratio, le_conv_activation)


def _asap_fixed(cluster_h, node_score, normed_att_score, edge_index_sl, edge_weight_sl,
                node_graph_index, k, num_graphs, le_conv_activation):
    """The fixed-capacity tail: G·k cluster slots, invalid ones zero with
    the graph id ``num_graphs``."""
    device = cluster_h.device
    num_nodes = cluster_h.shape[0]
    row_sl, col_sl = edge_index_sl[0], edge_index_sl[1]
    topk_idx, topk_valid = topk_pool_fixed(node_graph_index, node_score, num_graphs, k)
    num_clusters = int(topk_idx.shape[0])
    safe_idx = topk_idx.clamp(0, num_nodes - 1)
    topk_node_score = node_score[safe_idx]
    if le_conv_activation is not None:
        topk_node_score = le_conv_activation(topk_node_score)
    pooled_x = torch.where(topk_valid[:, None], cluster_h[safe_idx] * topk_node_score,
                           torch.zeros((), dtype=cluster_h.dtype, device=device))
    # node -> its cluster slot, or -1. JAX scatters invalid slots at
    # num_nodes + 1, past its [num_nodes + 1] array, and drops them; here
    # they write a spare entry, sliced off. reverse[num_nodes] stays -1, so
    # masked edges (row num_nodes) map to no cluster.
    reverse = torch.full((num_nodes + 2,), -1, dtype=torch.long, device=device)
    reverse[torch.where(topk_valid, safe_idx, num_nodes + 1)] = torch.arange(num_clusters,
                                                                             device=device)
    assign_cluster = reverse[:num_nodes + 1][row_sl.clamp(0, num_nodes)]
    keep_edge = assign_cluster >= 0
    assign_edge_index = torch.stack([torch.where(keep_edge, col_sl, num_nodes),
                                     assign_cluster.clamp(0, num_clusters - 1)])
    assign_edge_weight = torch.where(keep_edge, normed_att_score.reshape(-1),
                                     torch.zeros_like(normed_att_score.reshape(-1))).detach()
    _, pooled_edge_index, pooled_edge_weight = cluster_pool(
        None, edge_index_sl, edge_weight_sl, assign_edge_index, assign_edge_weight,
        num_clusters, num_nodes=num_nodes, dense_output_edges=True)
    loops = pooled_edge_index[0] == pooled_edge_index[1]
    pooled_edge_weight = torch.where(loops, torch.zeros_like(pooled_edge_weight),
                                     pooled_edge_weight)
    pooled_edge_index, pooled_edge_weight = add_self_loop_edge(pooled_edge_index, num_clusters,
                                                               pooled_edge_weight)
    ngi = torch.as_tensor(node_graph_index, device=device).long()
    pooled_ngi = torch.where(topk_valid, ngi[safe_idx], num_graphs)
    return pooled_x, pooled_edge_index, pooled_edge_weight, pooled_ngi


def _asap_ratio(cluster_h, node_score, normed_att_score, edge_index_sl, edge_weight_sl,
                node_graph_index, k, ratio, le_conv_activation):
    """The host-side tail: clusters selected by ``topk_pool``, the
    assignment and the pooled edges built in numpy."""
    device = cluster_h.device
    num_nodes = cluster_h.shape[0]
    topk_node_index = topk_pool(node_graph_index, node_score, k=k, ratio=ratio)
    topk_t = torch.as_tensor(topk_node_index, device=device).long()
    topk_node_score = node_score[topk_t]
    if le_conv_activation is not None:
        topk_node_score = le_conv_activation(topk_node_score)
    pooled_x = cluster_h[topk_t] * topk_node_score

    num_clusters = len(topk_node_index)
    reverse = np.full(num_nodes, -1, np.int64)
    reverse[convert_union_to_numpy(topk_node_index, np.int64)] = np.arange(num_clusters)
    row_np = convert_union_to_numpy(edge_index_sl[0], np.int64)
    col_np = convert_union_to_numpy(edge_index_sl[1], np.int64)
    assign_row = reverse[row_np]
    assign_mask = assign_row >= 0
    kept = torch.as_tensor(np.nonzero(assign_mask)[0], device=device)
    assign_edge_weight = normed_att_score.reshape(-1)[kept].detach()
    # node -> cluster, as cluster_pool takes it
    assign_edge_index = np.stack([col_np[assign_mask], assign_row[assign_mask]])
    _, pooled_edge_index, pooled_edge_weight = cluster_pool(
        None, edge_index_sl, edge_weight_sl, assign_edge_index, assign_edge_weight,
        num_clusters, num_nodes=num_nodes)
    keep = pooled_edge_index[0] != pooled_edge_index[1]
    pooled_edge_weight = pooled_edge_weight[torch.as_tensor(np.nonzero(keep)[0], device=device)]
    pooled_edge_index, pooled_edge_weight = add_self_loop_edge(
        torch.as_tensor(pooled_edge_index[:, keep], device=device).long(), num_clusters,
        pooled_edge_weight)
    pooled_ngi = convert_union_to_numpy(node_graph_index, np.int32)[
        convert_union_to_numpy(topk_node_index, np.int64)]
    return pooled_x, pooled_edge_index.cpu().numpy(), pooled_edge_weight, pooled_ngi
