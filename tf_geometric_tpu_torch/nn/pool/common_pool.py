"""Whole-graph readouts (JAX counterpart: ``tf_geometric_tpu/nn/pool/common_pool.py``).

Padded nodes carry an out-of-range ``node_graph_index`` and drop out; an
empty graph's max or min reads 0, as the segment core gives it.
"""
from __future__ import annotations

import torch

from ..kernel.segment import segment_count, segment_max, segment_min, segment_sum

__all__ = ["mean_pool", "sum_pool", "max_pool", "min_pool"]


def _resolve_num_graphs(node_graph_index, num_graphs):
    """``num_graphs`` as a Python int: the value given, or ``max + 1`` of
    ``node_graph_index`` (a host sync); shared by every pooling op."""
    if num_graphs is None:
        return int(torch.as_tensor(node_graph_index).max()) + 1
    return int(num_graphs)


def mean_pool(x, node_graph_index, num_graphs=None):
    """sum / (count + 1e-8) per graph."""
    num_graphs = _resolve_num_graphs(node_graph_index, num_graphs)
    counts = segment_count(node_graph_index, num_graphs)
    total = segment_sum(x, node_graph_index, num_graphs)
    return total / (counts.unsqueeze(-1) + 1e-8)


def sum_pool(x, node_graph_index, num_graphs=None):
    num_graphs = _resolve_num_graphs(node_graph_index, num_graphs)
    return segment_sum(x, node_graph_index, num_graphs)


def max_pool(x, node_graph_index, num_graphs=None):
    num_graphs = _resolve_num_graphs(node_graph_index, num_graphs)
    return segment_max(x, node_graph_index, num_graphs)


def min_pool(x, node_graph_index, num_graphs=None):
    num_graphs = _resolve_num_graphs(node_graph_index, num_graphs)
    return segment_min(x, node_graph_index, num_graphs)
