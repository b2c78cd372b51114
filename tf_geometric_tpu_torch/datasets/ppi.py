"""The PPI protein-interaction dataset in DGL's format (JAX counterpart:
``tf_geometric_tpu/datasets/ppi.py``): ``{split}_graph_id.npy``,
``_feats.npy``, ``_labels.npy`` and ``_graph.json`` (networkx node-link)
for train, valid and test under the raw directory, or
``download/ppi.zip`` when that archive is on disk; nothing is downloaded.
Returns ``[train_graphs, valid_graphs, test_graphs]`` with multi-label y.
networkx is imported inside ``process``."""
from __future__ import annotations

import json
import os

import numpy as np

from ..data.dataset import DownloadableDataset
from ..data.graph import Graph
from ..utils.graph_utils import convert_edge_to_directed

__all__ = ["PPIDataset"]


class PPIDataset(DownloadableDataset):

    def __init__(self, dataset_root_path=None):
        super().__init__(dataset_name="PPI", download_file_name="ppi.zip", cache_name="cache.p",
                         dataset_root_path=dataset_root_path)

    def process(self):
        import networkx as nx
        out = []
        for split in ("train", "valid", "test"):
            def path(suffix):
                return os.path.join(self.raw_root_path, f"{split}_{suffix}")
            graph_ids = np.load(path("graph_id.npy"))
            feats = np.load(path("feats.npy")).astype(np.float32)
            labels = np.load(path("labels.npy")).astype(np.int32)
            with open(path("graph.json"), encoding="utf-8") as f:
                nx_graph = nx.DiGraph(nx.json_graph.node_link_graph(json.load(f)))
            graphs = []
            for gid in sorted(set(graph_ids.tolist())):
                node_index = np.where(graph_ids == gid)[0]
                min_node = int(node_index.min())
                edge_index = np.array(nx_graph.subgraph(node_index).edges).T - min_node
                edge_index, _ = convert_edge_to_directed(edge_index)
                graphs.append(Graph(x=feats[node_index], edge_index=edge_index,
                                    y=labels[node_index]))
            out.append(graphs)
        return out
