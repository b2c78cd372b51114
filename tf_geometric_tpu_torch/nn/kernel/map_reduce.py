"""The message-passing primitive: gather → map → segment-reduce → update
(JAX counterpart: ``tf_geometric_tpu/nn/kernel/map_reduce.py``).

Gather source/destination features along the edge list, apply a ``mapper``
per edge, reduce messages per destination with a segment op, and combine
with an ``updater``. ``edge_index[0] = row`` is the destination that
aggregates, ``edge_index[1] = col`` the source whose features flow along
the edge. Padded edges with out-of-range row ids are dropped by the
reducers (``_segment_core.py``); out-of-range cols read a clamped row.
"""
from __future__ import annotations

import torch

from .segment import segment_max, segment_mean, segment_min, segment_sum

__all__ = [
    "identity_mapper",
    "neighbor_count_mapper",
    "gcn_mapper",
    "sum_reducer",
    "mean_reducer",
    "max_reducer",
    "min_reducer",
    "identity_updater",
    "sum_updater",
    "aggregate_neighbors",
]


# Mappers: (repeated_x, neighbor_x, edge_weight) -> messages [E, F]

def identity_mapper(repeated_x, neighbor_x, edge_weight=None):
    """Pass neighbor features through unchanged."""
    return neighbor_x


def neighbor_count_mapper(repeated_x, neighbor_x, edge_weight=None):
    """Ones per edge: reduces to the neighbor count."""
    return torch.ones((neighbor_x.shape[0], 1), device=neighbor_x.device)


def gcn_mapper(repeated_x, neighbor_x, edge_weight=None):
    """Scale neighbor features by the (normalized) edge weight."""
    if edge_weight is None:
        return neighbor_x
    return neighbor_x * edge_weight.unsqueeze(-1)


# Reducers: (messages, row, num_nodes) -> aggregated [N, F]

def sum_reducer(neighbor_msg, node_index, num_nodes: int):
    """Per-destination segment sum."""
    return segment_sum(neighbor_msg, node_index, num_nodes)


def mean_reducer(neighbor_msg, node_index, num_nodes: int):
    """Per-destination segment mean."""
    return segment_mean(neighbor_msg, node_index, num_nodes)


def max_reducer(neighbor_msg, node_index, num_nodes: int):
    """Per-destination segment max, zero-filled."""
    return segment_max(neighbor_msg, node_index, num_nodes)


def min_reducer(neighbor_msg, node_index, num_nodes: int):
    """Per-destination segment min, zero-filled."""
    return segment_min(neighbor_msg, node_index, num_nodes)


# Updaters: (x, reduced_msg) -> output [N, F]

def identity_updater(x, reduced_neighbor_msg):
    """Return the reduced messages unchanged."""
    return reduced_neighbor_msg


def sum_updater(x, reduced_neighbor_msg):
    """x + reduced messages."""
    return x + reduced_neighbor_msg


def aggregate_neighbors(x, edge_index, edge_weight=None, mapper=identity_mapper,
                        reducer=sum_reducer, updater=identity_updater,
                        num_nodes: int | None = None):
    """Aggregate neighbor features along an edge list: messages flow
    col → row, ``reducer`` is keyed on ``row``.

    ``x`` [N, F]; ``edge_index`` [2, E] (destination, source), a tensor or
    anything ``torch.as_tensor`` takes; ``edge_weight`` optional [E];
    ``num_nodes`` defaults to ``x.shape[0]``."""
    if num_nodes is None:
        num_nodes = x.shape[0]
    edge_index = torch.as_tensor(edge_index, device=x.device).long()
    if edge_weight is not None:
        edge_weight = torch.as_tensor(edge_weight, device=x.device)
    row, col = edge_index[0], edge_index[1]
    last = x.shape[0] - 1
    repeated_x = x[row.clamp(0, last)]
    neighbor_x = x[col.clamp(0, last)]
    neighbor_msg = mapper(repeated_x, neighbor_x, edge_weight=edge_weight)
    reduced_msg = reducer(neighbor_msg, row, num_nodes)
    return updater(x, reduced_msg)
