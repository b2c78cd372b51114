"""SAGPool: self-attention graph pooling (JAX counterpart:
``tf_geometric_tpu/nn/pool/sag_pool.py``).

``score_gnn`` scores the nodes, each graph keeps its top nodes, their
features are scaled by the (activated) score and the node-induced subgraph
is returned. With ``k`` the selection has a fixed size (``topk_pool_fixed``
and ``induced_subgraph_fixed``, all on the device); with ``ratio`` it is
made on the host (``topk_pool``, ``induced_subgraph``), with ragged sizes.
"""
from __future__ import annotations

from typing import Callable, Optional

from ._subgraph import induced_subgraph, induced_subgraph_fixed
from .common_pool import _resolve_num_graphs
from .topk_pool import topk_pool, topk_pool_fixed

__all__ = ["sag_pool"]


def sag_pool(x, edge_index, edge_weight, node_graph_index, score_gnn: Callable,
             k: Optional[int] = None, ratio: Optional[float] = None, score_activation=None,
             training=None, cache=None, num_graphs: Optional[int] = None):
    """Returns the pooled ``(x, edge_index, edge_weight, node_graph_index)``.
    ``score_gnn`` is called as ``score_gnn([x, edge_index, edge_weight])``
    (with ``cache=`` when one is given)."""
    kwargs = {} if cache is None else {"cache": cache}
    node_score = score_gnn([x, edge_index, edge_weight], **kwargs)
    scaled_score = score_activation(node_score) if score_activation is not None else node_score
    scaled_x = x * scaled_score.reshape(scaled_score.shape[0], -1)
    if k is not None:
        g = _resolve_num_graphs(node_graph_index, num_graphs)
        idx, valid = topk_pool_fixed(node_graph_index, node_score, g, k)
        return induced_subgraph_fixed(scaled_x, edge_index, edge_weight, node_graph_index,
                                      idx, valid, g)
    topk_node_index = topk_pool(node_graph_index, node_score, k=None, ratio=ratio)
    return induced_subgraph(scaled_x, edge_index, edge_weight, node_graph_index,
                            topk_node_index)
