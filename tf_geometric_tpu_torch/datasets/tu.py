"""TU Dortmund graph-kernel datasets (JAX counterpart:
``tf_geometric_tpu/datasets/tu.py``).

Reads the TU text files (``<name>_A.txt``, ``_graph_indicator``,
``_node_labels``, ``_edge_labels``, ``_node_attributes``, ``_graph_labels``)
from ``raw/<name>/`` or ``raw/``, or from ``download/<name>.zip`` when that
archive is on disk; nothing is downloaded. Returns a list of per-graph
dicts, bit for bit as the JAX package builds them:

    {"edge_index": [2, E_i], "num_nodes": n_i, "degrees": [n_i],
     "node_labels"?, "node_attributes"?, "edge_labels"?, "graph_label"?}

The list is cached under ``processed/<name>_torch.p``.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..data.dataset import DownloadableDataset

__all__ = ["TUDataset"]


class TUDataset(DownloadableDataset):

    def __init__(self, dataset_name: str, dataset_root_path: Optional[str] = None):
        super().__init__(dataset_name=dataset_name, download_file_name=f"{dataset_name}.zip",
                         cache_name=f"{dataset_name}.p", dataset_root_path=dataset_root_path)

    def _txt_path(self, fid: str) -> str:
        fname = f"{self.dataset_name}_{fid}.txt"
        for base in (os.path.join(self.raw_root_path, self.dataset_name), self.raw_root_path):
            path = os.path.join(base, fname)
            if os.path.exists(path):
                return path
        return os.path.join(self.raw_root_path, self.dataset_name, fname)

    def _read(self, fid: str, dtype, required: bool = False):
        path = self._txt_path(fid)
        if not os.path.exists(path):
            if required:
                raise FileNotFoundError(path)
            return None
        arr = np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)
        if arr.shape[1] == 1:
            arr = arr[:, 0]
        return arr.astype(dtype)

    @staticmethod
    def _to_indices(label_ids):
        """Arbitrary label ids onto 0 .. C-1."""
        _, inverse = np.unique(label_ids, return_inverse=True)
        return inverse.astype(np.int32)

    def process(self):
        node_graph_index = self._read("graph_indicator", np.int32, required=True)
        offset = node_graph_index.min()
        node_graph_index = node_graph_index - offset
        edges = self._read("A", np.int32, required=True) - offset
        edge_graph_index = node_graph_index[edges[:, 0]]
        num_graphs = int(node_graph_index.max()) + 1

        node_label_ids = self._read("node_labels", np.int32)
        node_labels = None if node_label_ids is None else self._to_indices(node_label_ids)
        edge_label_ids = self._read("edge_labels", np.int32)
        edge_labels = None if edge_label_ids is None else self._to_indices(edge_label_ids)
        node_attributes = self._read("node_attributes", np.float32)
        if node_attributes is not None:
            node_attributes = node_attributes.reshape(node_attributes.shape[0], -1)
        graph_label_ids = self._read("graph_labels", np.int32)
        graph_labels = None if graph_label_ids is None else self._to_indices(graph_label_ids)

        node_counts = np.bincount(node_graph_index, minlength=num_graphs)
        node_starts = np.concatenate([[0], np.cumsum(node_counts)[:-1]])
        edge_order = np.argsort(edge_graph_index, kind="stable")
        edges_sorted = edges[edge_order]
        edge_counts = np.bincount(edge_graph_index[edge_order], minlength=num_graphs)
        edge_starts = np.concatenate([[0], np.cumsum(edge_counts)[:-1]])
        el_sorted = None if edge_labels is None else edge_labels[edge_order]

        graphs = []
        for g in range(num_graphs):
            n0, n = node_starts[g], node_counts[g]
            e0, e = edge_starts[g], edge_counts[g]
            edge_index = (edges_sorted[e0:e0 + e].T - n0).astype(np.int32)
            graph = {"edge_index": edge_index, "num_nodes": int(n)}
            if node_labels is not None:
                graph["node_labels"] = node_labels[n0:n0 + n]
            if node_attributes is not None:
                graph["node_attributes"] = node_attributes[n0:n0 + n]
            if edge_labels is not None:
                graph["edge_labels"] = el_sorted[e0:e0 + e]
            if graph_labels is not None:
                graph["graph_label"] = np.array([graph_labels[g]], np.int32)
            deg = np.zeros(n, np.int32)
            if edge_index.size:
                # undirected degree over the unique edges, a self-loop once
                und = np.unique(np.sort(edge_index, axis=0), axis=1)
                np.add.at(deg, und[0], 1)
                np.add.at(deg, und[1], 1)
                loops = und[0] == und[1]
                deg[und[0][loops]] -= 1
            graph["degrees"] = deg
            graphs.append(graph)
        return graphs
