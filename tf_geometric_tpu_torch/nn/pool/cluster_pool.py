"""Cluster coarsening Sᵀ A S (JAX counterpart:
``tf_geometric_tpu/nn/pool/cluster_pool.py``).

A stays sparse: ``A·S`` is a gather of S's rows over A's edges and a
segment sum by row, then ``Sᵀ (A S)`` and ``Sᵀ x`` are dense products.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...utils.graph_utils import _edge_tensors
from ..kernel.segment import segment_sum

__all__ = ["cluster_pool"]


def cluster_pool(x, edge_index, edge_weight, assign_edge_index, assign_edge_weight,
                 num_clusters: int, num_nodes: Optional[int] = None,
                 dense_output_edges: bool = False):
    """Coarsen a graph by a (soft) cluster assignment given as node →
    cluster edges (``assign_edge_index[0]`` the node, ``[1]`` the cluster)
    with weights ``assign_edge_weight``.

    Returns ``(pooled_x, pooled_edge_index, pooled_edge_weight)``
    (``pooled_x`` None when ``x`` is). With ``dense_output_edges`` the pooled
    adjacency is every one of the C² pairs, row-major, on the device;
    otherwise its nonzero entries, selected on the host (the index numpy,
    the weights gathered on their device). An assignment edge with an
    out-of-range node or cluster adds nothing: it writes a spare row of S,
    which is sliced off, where JAX's scatter drops it."""
    if num_nodes is None:
        if x is None:
            raise ValueError("Please provide num_nodes if x is None")
        num_nodes = x.shape[0]
    s_weight = torch.as_tensor(assign_edge_weight)
    device = s_weight.device
    a_row, a_col = torch.as_tensor(assign_edge_index, device=device).long()
    edge_index, edge_weight = _edge_tensors(torch.as_tensor(edge_index, device=device),
                                            edge_weight)

    # dense S [N, C]: each assignment edge at flat id node·C + cluster, the
    # invalid ones at the spare id N·C
    valid = (a_row >= 0) & (a_row < num_nodes) & (a_col >= 0) & (a_col < num_clusters)
    flat = torch.where(valid, a_row * num_clusters + a_col, num_nodes * num_clusters)
    S = segment_sum(torch.where(valid, s_weight, torch.zeros_like(s_weight)), flat,
                    num_nodes * num_clusters).reshape(num_nodes, num_clusters)

    row, col = edge_index[0], edge_index[1]
    msg = S[col.clamp(0, num_nodes - 1)] * edge_weight[:, None]
    pooled_adj = S.T @ segment_sum(msg, row, num_nodes)          # Sᵀ (A S), [C, C]
    pooled_x = None if x is None else S.T @ x

    if dense_output_edges:
        c = torch.arange(num_clusters, device=device)
        pooled_edge_index = torch.stack([c.repeat_interleave(num_clusters),
                                         c.repeat(num_clusters)])
        return pooled_x, pooled_edge_index, pooled_adj.reshape(-1)
    row_np, col_np = np.nonzero(np.abs(pooled_adj.detach().cpu().numpy()) > 0.0)
    pooled_edge_index = np.stack([row_np, col_np]).astype(np.int32)
    flat_ids = torch.as_tensor(row_np * num_clusters + col_np, device=device)
    return pooled_x, pooled_edge_index, pooled_adj.reshape(-1)[flat_ids]
