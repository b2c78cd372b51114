"""LEConv: the local-extremum scoring conv of ASAP (JAX counterpart:
``tf_geometric_tpu/nn/conv/le_conv.py``).

h_i = self_h_i + Σ_{j∈N(i)} w_ij · (aggr_self_h_j − aggr_neighbor_h_j); as
the reference and the JAX function, both aggregated terms gather the
source (col) side. The sum runs on the segment core.
"""
from __future__ import annotations

import torch

from ..kernel.segment import segment_sum

__all__ = ["le_conv"]


def le_conv(x, edge_index, edge_weight, self_kernel, self_bias, aggr_self_kernel,
            aggr_self_bias, aggr_neighbor_kernel, aggr_neighbor_bias, activation=None):
    """LEConv forward: self_h + Σ_j w_ij·(aggr_self_h_j − aggr_neighbor_h_j)."""
    num_nodes = x.shape[0]
    edge_index = torch.as_tensor(edge_index, device=x.device).long()
    if edge_weight is None:
        edge_weight = torch.ones(edge_index.shape[1], dtype=torch.float32, device=x.device)
    edge_weight = torch.as_tensor(edge_weight, device=x.device)

    self_h = x @ self_kernel
    if self_bias is not None:
        self_h = self_h + self_bias
    aggr_self_h = x @ aggr_self_kernel
    if aggr_self_bias is not None:
        aggr_self_h = aggr_self_h + aggr_self_bias
    aggr_neighbor_h = x @ aggr_neighbor_kernel
    if aggr_neighbor_bias is not None:
        aggr_neighbor_h = aggr_neighbor_h + aggr_neighbor_bias

    row, col = edge_index[0], edge_index[1]
    safe_col = col.clamp(0, num_nodes - 1)
    repeated = aggr_self_h[safe_col] - aggr_neighbor_h[safe_col]
    repeated = repeated * edge_weight.unsqueeze(-1)
    h = self_h + segment_sum(repeated, row, num_nodes)
    if activation is not None:
        h = activation(h)
    return h
