"""The DropGNN expressiveness testbeds (JAX counterpart:
``tf_geometric_tpu/datasets/synthetic.py``): ``LimitsOneDataset``,
``LimitsTwoDataset``, ``LCCDataset`` and ``TrianglesDataset``. Each gives
``(x, edge_index, y, node_ids, ports)`` or a list of graph dicts, as the
JAX package does, with the same numpy generator calls. LCC and Triangles
import networkx inside ``load_data``: a machine without it can import this
module.
"""
from __future__ import annotations

import numpy as np

from ..data.dataset import Dataset

__all__ = ["LimitsOneDataset", "LimitsTwoDataset", "LCCDataset",
           "TrianglesDataset"]


def _compute_degree(edge_index, num_nodes):
    degree = np.zeros(num_nodes, np.int32)
    np.add.at(degree, edge_index[0], 1)
    return degree


def _create_ports(edge_index, num_nodes, rng=None):
    """Random port numbering of each node's incident edges."""
    rng = np.random.default_rng(rng)
    row, col = edge_index
    degree = _compute_degree(edge_index, num_nodes)
    ports = np.zeros(edge_index.shape[1])
    for node in range(num_nodes):
        node_ports = rng.permutation(degree[node])
        for i, nb in enumerate(col[row == node]):
            ports[np.logical_and(row == node, col == nb)] = node_ports[i]
    return ports


def _create_x(num_nodes):
    return np.ones((num_nodes, 1))


def _create_id(num_nodes, rng=None):
    return np.random.default_rng(rng).permutation(num_nodes)


class LimitsOneDataset(Dataset):
    """Two 8-cycles with different colorings."""

    def __init__(self):
        self.hidden_units = 16
        self.num_classes = 2
        self.num_features = 4
        self.num_nodes = 8
        self.graph_class = False

    def load_data(self):
        num_nodes = 16
        colors = [0, 1, 2, 3] * 4
        y = np.array([0] * 8 + [1] * 8)
        edge_index = np.array([
            [0, 1, 1, 2, 2, 3, 3, 0, 4, 5, 5, 6, 6, 7, 7, 4,
             8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 8],
            [1, 0, 2, 1, 3, 2, 0, 3, 5, 4, 6, 5, 7, 6, 4, 7,
             9, 8, 10, 9, 11, 10, 12, 11, 13, 12, 14, 13, 15, 14, 8, 15],
        ])
        ports = np.array([1, 1, 2, 2] * 8, np.float64)
        x = np.zeros([num_nodes, 4])
        x[range(num_nodes), colors] = 1
        node_ids = _create_id(num_nodes)
        return x, edge_index, y, node_ids, ports


class LimitsTwoDataset(Dataset):
    """Two 4-cycle pairs with crossing chords."""

    def __init__(self):
        self.hidden_units = 16
        self.num_classes = 2
        self.num_features = 4
        self.num_nodes = 8
        self.graph_class = False

    def load_data(self):
        num_nodes = 16
        ports = np.array(([1, 1, 2, 2, 1, 1, 2, 2] * 2 + [3, 3, 3, 3]) * 2,
                         np.float64)
        colors = [0, 1, 2, 3] * 4
        y = np.array([0] * 8 + [1] * 8)
        edge_index = np.array([
            [0, 1, 1, 2, 2, 3, 3, 0, 4, 5, 5, 6, 6, 7, 7, 4, 1, 3, 5, 7,
             8, 9, 9, 10, 10, 11, 11, 8, 12, 13, 13, 14, 14, 15, 15, 12,
             9, 15, 11, 13],
            [1, 0, 2, 1, 3, 2, 0, 3, 5, 4, 6, 5, 7, 6, 4, 7, 3, 1, 7, 5,
             9, 8, 10, 9, 11, 10, 8, 11, 13, 12, 14, 13, 15, 14, 12, 15,
             15, 9, 13, 11],
        ])
        x = np.zeros((num_nodes, 4))
        x[range(num_nodes), colors] = 1
        node_ids = _create_id(num_nodes)
        return x, edge_index, y, node_ids, ports


def _count_neighbor_edges(edge_index, node):
    """Edges among a node's neighborhood (used by LCC/Triangles labeling)."""
    nbs = [int(nb) for nb in edge_index[1][edge_index[0] == node]]
    edges = 0
    for nb1 in nbs:
        for nb2 in nbs:
            if np.logical_and(edge_index[0] == nb1, edge_index[1] == nb2).any():
                edges += 1
    return edges


class LCCDataset(Dataset):
    """Local-clustering-coefficient node classification over random 3-regular
    graphs."""

    def __init__(self):
        self.hidden_units = 16
        self.num_classes = 3
        self.num_features = 1
        self.num_nodes = 10
        self.graph_class = False

    def load_data(self):
        import networkx as nx
        while True:
            graphs, labels = [], []
            i = 0
            while i < 6:
                size = 10
                nx_g = nx.random_degree_sequence_graph([3] * size)
                if not nx.is_connected(nx_g):
                    continue
                i += 1
                edge_index = np.array(nx_g.to_directed().edges).T
                y = np.array([_count_neighbor_edges(edge_index, n) // 2
                              for n in range(size)])
                labels.extend(y.tolist())
                graphs.append({
                    "x": _create_x(size),
                    "edge_index": edge_index,
                    "y": y,
                    "ports": _create_ports(edge_index, size),
                    "node_ids": _create_id(size),
                })
            if (labels.count(0) >= 10 and labels.count(1) >= 10
                    and labels.count(2) >= 10):
                return graphs


class TrianglesDataset(Dataset):
    """Triangle-membership node classification over a random 3-regular
    graph."""

    def __init__(self):
        self.hidden_units = 16
        self.num_classes = 2
        self.num_features = 1
        self.num_nodes = 60
        self.graph_class = False

    def load_data(self):
        import networkx as nx
        size = self.num_nodes
        while True:
            nx_g = nx.random_degree_sequence_graph([3] * size)
            edge_index = np.array(nx_g.to_directed().edges).T
            labels = [1 if _count_neighbor_edges(edge_index, n) > 0 else 0
                      for n in range(size)]
            if labels.count(0) >= 20 and labels.count(1) >= 20:
                break
        y = np.array(labels)
        return (_create_x(size), edge_index, y, _create_id(size),
                _create_ports(edge_index, size))
