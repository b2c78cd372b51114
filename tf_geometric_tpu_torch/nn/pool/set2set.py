"""Set2Set readout: an LSTM and content attention (JAX counterpart:
``tf_geometric_tpu/nn/pool/set2set.py``).

Per iteration the LSTM takes the query [G, 2F] and emits q [G, F];
attention scores ``<x, q[graph]>`` are soft-maxed over each graph's nodes,
and the attended sum is concatenated onto q. ``lstm`` is a callable
``(h [G, 2F], state) -> (out [G, F], new_state)``, ``state`` None on the
first call (the ``Set2Set`` layer wraps a ``torch.nn.LSTMCell`` so).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..kernel.segment import segment_softmax, segment_sum
from .common_pool import _resolve_num_graphs

__all__ = ["set2set"]


def set2set(x, node_graph_index, lstm: Callable, num_iterations: int, training=None,
            num_graphs: Optional[int] = None):
    """Set2Set over ``num_iterations`` steps; returns [num_graphs, 2F].
    Padded nodes (graph id out of range) take no part."""
    node_graph_index = torch.as_tensor(node_graph_index, device=x.device).long()
    num_graphs = _resolve_num_graphs(node_graph_index, num_graphs)
    h = torch.zeros((num_graphs, 2 * x.shape[-1]), dtype=x.dtype, device=x.device)
    state = None
    safe_ngi = node_graph_index.clamp(0, num_graphs - 1)
    for _ in range(num_iterations):
        q, state = lstm(h, state)
        att_score = (x * q[safe_ngi]).sum(-1, keepdim=True)
        normed = segment_softmax(att_score, node_graph_index, num_graphs)
        h = torch.cat([q, segment_sum(x * normed, node_graph_index, num_graphs)], dim=-1)
    return h
