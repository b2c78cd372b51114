"""OGB node-property-prediction datasets (JAX counterpart:
``tf_geometric_tpu/datasets/ogb.py``).

Reads a preprocessed ``<raw>/graph.npz`` (keys ``x``, ``edge_index``,
``y``, ``train_index``, ``valid_index``, ``test_index``); without it, the
``ogb`` package's ``NodePropPredDataset`` over ``download/`` when that
package is installed (it is imported only then), else ``RuntimeError``.
Returns ``(Graph, (train, valid, test))``, the edges made symmetric.
"""
from __future__ import annotations

import os

import numpy as np

from ..data.dataset import DownloadableDataset
from ..data.graph import Graph
from ..utils.graph_utils import convert_edge_to_directed

__all__ = ["OGBNodePropPredDataset"]


class OGBNodePropPredDataset(DownloadableDataset):
    """dataset_name: ogbn-arxiv, ogbn-products, ogbn-proteins,
    ogbn-papers100M or ogbn-mag."""

    def __init__(self, dataset_name: str, dataset_root_path=None):
        super().__init__(dataset_name=dataset_name, cache_name="cache.p",
                         dataset_root_path=dataset_root_path)

    def _process_from_npz(self, npz_path: str):
        with np.load(npz_path, allow_pickle=True) as data:
            edge_index, _ = convert_edge_to_directed(data["edge_index"])
            graph = Graph(x=data["x"].astype(np.float32), edge_index=edge_index,
                          y=data["y"].flatten().astype(np.int32))
            return graph, (data["train_index"], data["valid_index"], data["test_index"])

    def process(self):
        npz_path = os.path.join(self.raw_root_path, "graph.npz")
        if os.path.exists(npz_path):
            return self._process_from_npz(npz_path)
        try:
            from ogb.nodeproppred import NodePropPredDataset
        except ImportError as e:
            raise RuntimeError(
                f"ogb package unavailable and no preprocessed npz at {npz_path}; place "
                "graph.npz (x, edge_index, y, train/valid/test_index) under the raw dir") from e
        dataset = NodePropPredDataset(name=self.dataset_name, root=self.download_root_path)
        graph_dict, label = dataset[0]
        edge_index, _ = convert_edge_to_directed(graph_dict["edge_index"])
        graph = Graph(x=graph_dict["node_feat"], edge_index=edge_index,
                      y=label.flatten().astype(np.int32))
        split = dataset.get_idx_split()
        return graph, (split["train"], split["valid"], split["test"])
