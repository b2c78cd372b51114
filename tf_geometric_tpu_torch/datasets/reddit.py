"""Reddit datasets in DGL's npz format (JAX counterpart:
``tf_geometric_tpu/datasets/reddit.py``): ``reddit_data.npz`` (features,
labels, node types 1 / 2 / 3 for train / valid / test) and
``reddit_graph.npz`` (a scipy sparse adjacency) under the raw directory, or
``download/reddit.zip`` when that archive is on disk; nothing is
downloaded."""
from __future__ import annotations

import os

import numpy as np

from ..data.dataset import DownloadableDataset
from ..data.graph import Graph

__all__ = ["TransductiveRedditDataset", "InductiveRedditDataset"]


class _BaseRedditDataset(DownloadableDataset):

    def __init__(self, dataset_root_path=None, cache_name=None):
        super().__init__(dataset_name="reddit", download_file_name="reddit.zip",
                         cache_name=cache_name, dataset_root_path=dataset_root_path)

    def process(self):
        import scipy.sparse as sp
        common = np.load(os.path.join(self.raw_root_path, "reddit_data.npz"))
        x = common["feature"]
        y = common["label"]
        mask = common["node_types"]
        full_index = np.arange(len(x), dtype=np.int32)
        train_index = full_index[mask == 1]
        valid_index = full_index[mask == 2]
        test_index = full_index[mask == 3]
        adj = sp.load_npz(os.path.join(self.raw_root_path, "reddit_graph.npz")).tocoo()
        edge_index = np.stack([adj.row, adj.col], axis=0).astype(np.int32)
        return Graph(x=x, edge_index=edge_index, y=y), (train_index, valid_index, test_index)


class TransductiveRedditDataset(_BaseRedditDataset):
    """The whole graph with the three index splits."""

    def __init__(self, dataset_root_path=None):
        super().__init__(dataset_root_path, cache_name="transductive_cache.p")


class InductiveRedditDataset(_BaseRedditDataset):
    """The three node-induced subgraphs of the splits."""

    def __init__(self, dataset_root_path=None):
        super().__init__(dataset_root_path, cache_name="inductive_cache.p")

    def process(self):
        graph, (train_index, valid_index, test_index) = super().process()
        return (graph.sample_new_graph_by_node_index(train_index),
                graph.sample_new_graph_by_node_index(valid_index),
                graph.sample_new_graph_by_node_index(test_index))
