"""Node-induced subgraphs for the top-k pools (JAX counterpart:
``tf_geometric_tpu/nn/pool/_subgraph.py``).

``induced_subgraph`` selects on the host (data-dependent sizes) and gathers
the features and weights on their device, so gradients reach them;
``induced_subgraph_fixed`` keeps a fixed node capacity and masks instead,
all on the tensors' device.
"""
from __future__ import annotations

import numpy as np
import torch

from ...utils.union_utils import convert_union_to_numpy

__all__ = ["induced_subgraph", "induced_subgraph_fixed"]


def induced_subgraph(x, edge_index, edge_weight, node_graph_index, keep_index):
    """Keep ``keep_index`` nodes and the edges whose ends both survive,
    relabelled. Returns ``(pooled_x, pooled_edge_index, pooled_edge_weight,
    pooled_node_graph_index)``: x and the weights gathered on their device
    (differentiable), the index arrays as numpy."""
    keep_index = convert_union_to_numpy(keep_index, np.int64)
    ei = convert_union_to_numpy(edge_index, np.int64)
    ngi = convert_union_to_numpy(node_graph_index, np.int32)
    lookup = np.full(ngi.shape[0], -1, np.int64)
    lookup[keep_index] = np.arange(len(keep_index))
    new_ends = lookup[ei]
    edge_keep = (new_ends >= 0).all(axis=0)
    pooled_x = x[torch.as_tensor(keep_index, device=x.device)]
    pooled_weight = None
    if edge_weight is not None:
        edge_weight = torch.as_tensor(edge_weight, device=x.device)
        pooled_weight = edge_weight[torch.as_tensor(np.nonzero(edge_keep)[0], device=x.device)]
    return pooled_x, new_ends[:, edge_keep].astype(np.int32), pooled_weight, ngi[keep_index]


def induced_subgraph_fixed(x, edge_index, edge_weight, node_graph_index, keep_index,
                           keep_valid, num_graphs: int):
    """Masked subgraph with node capacity ``len(keep_index)``: an invalid
    slot gets zero features and the graph id ``num_graphs``; an edge with a
    dropped end moves to the sink ``capacity`` with weight 0."""
    device = x.device
    edge_index = torch.as_tensor(edge_index, device=device).long()
    node_graph_index = torch.as_tensor(node_graph_index, device=device)
    num_nodes, cap = x.shape[0], keep_index.shape[0]
    safe_keep = keep_index.clamp(0, num_nodes - 1)
    pooled_x = torch.where(keep_valid[:, None], x[safe_keep], torch.zeros((), dtype=x.dtype,
                                                                          device=device))
    pooled_ngi = torch.where(keep_valid, node_graph_index[safe_keep].long(), num_graphs)
    # old node id -> new slot, or -1; invalid slots write the spare entry num_nodes
    lookup = torch.full((num_nodes + 1,), -1, dtype=torch.long, device=device)
    lookup[torch.where(keep_valid, safe_keep, num_nodes)] = torch.arange(cap, device=device)
    in_range = (edge_index >= 0) & (edge_index < num_nodes)
    new_ends = torch.where(in_range, lookup[edge_index.clamp(0, num_nodes - 1)], -1)
    edge_ok = (new_ends >= 0).all(dim=0)
    pooled_edge_index = torch.where(edge_ok[None, :], new_ends, cap)
    pooled_weight = None
    if edge_weight is not None:
        edge_weight = torch.as_tensor(edge_weight, device=device)
        pooled_weight = torch.where(edge_ok, edge_weight, torch.zeros((), dtype=edge_weight.dtype,
                                                                      device=device))
    return pooled_x, pooled_edge_index, pooled_weight, pooled_ngi
