"""Datasets stored as scipy CSR arrays in one npz (JAX counterpart:
``tf_geometric_tpu/datasets/csr_npz.py``): the first ``.npz`` under the raw
directory gives binarized attributes, the adjacency without self-loops made
symmetric, and the labels."""
from __future__ import annotations

import os

import numpy as np

from ..data.dataset import DownloadableDataset
from ..data.graph import Graph
from ..utils.graph_utils import convert_edge_to_directed, remove_self_loop_edge

__all__ = ["CSRNPZDataset"]


class CSRNPZDataset(DownloadableDataset):

    def process(self):
        import scipy.sparse as sp
        npz_names = [f for f in os.listdir(self.raw_root_path) if f.endswith(".npz")]
        if not npz_names:
            raise FileNotFoundError(f"no .npz under {self.raw_root_path}")
        with np.load(os.path.join(self.raw_root_path, npz_names[0]), allow_pickle=True) as data:
            x = np.asarray(sp.csr_matrix(
                (data["attr_data"], data["attr_indices"], data["attr_indptr"]),
                data["attr_shape"]).todense(), np.float32)
            x[x > 0.0] = 1.0
            adj = sp.csr_matrix((data["adj_data"], data["adj_indices"], data["adj_indptr"]),
                                data["adj_shape"]).tocoo()
            edge_index = np.stack([adj.row, adj.col], axis=0).astype(np.int32)
            edge_index, _ = remove_self_loop_edge(edge_index)
            edge_index, _ = convert_edge_to_directed(edge_index)
            y = data["labels"].astype(np.int32)
        return Graph(x=x, edge_index=edge_index, y=y)
