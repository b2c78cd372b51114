"""SortPool (JAX counterpart: ``tf_geometric_tpu/nn/pool/sort_pool.py``):
score = x[:, sort_index], per-graph top-k, node-induced subgraph. The
fixed-k path stays on the tensors' device; the ratio path selects on the
host."""
from __future__ import annotations

from typing import Optional

from ._subgraph import induced_subgraph, induced_subgraph_fixed
from .common_pool import _resolve_num_graphs
from .topk_pool import topk_pool, topk_pool_fixed

__all__ = ["sort_pool"]


def sort_pool(x, edge_index, edge_weight, node_graph_index, k: Optional[int] = None,
              ratio: Optional[float] = None, sort_index: int = -1, training=None,
              num_graphs: Optional[int] = None):
    """Returns ``(pooled_x, pooled_edge_index, pooled_edge_weight,
    pooled_node_graph_index)``; with ``k``, ``pooled_x`` is
    [num_graphs·k, F], graph g's top-k nodes in rows g·k .. g·k + k - 1.
    ``training`` holds the JAX function's positional slot and is unused, as
    there."""
    score = x[:, sort_index]
    if k is not None:
        num_graphs = _resolve_num_graphs(node_graph_index, num_graphs)
        idx, valid = topk_pool_fixed(node_graph_index, score, num_graphs, k)
        return induced_subgraph_fixed(x, edge_index, edge_weight, node_graph_index, idx, valid,
                                      num_graphs)
    topk_node_index = topk_pool(node_graph_index, score, k=None, ratio=ratio)
    return induced_subgraph(x, edge_index, edge_weight, node_graph_index, topk_node_index)
