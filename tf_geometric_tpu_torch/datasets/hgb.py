"""Heterogeneous Graph Benchmark (HGB) node-classification datasets (JAX
counterpart: ``tf_geometric_tpu/datasets/hgb.py``).

Parses the HGB text files (``info.dat``, ``node.dat``, ``link.dat``,
``label.dat``, ``label.dat.test``) under ``raw/<sub>/`` or ``raw/`` (or
the archive under ``download/``; nothing is downloaded) into the port's
host-side ``HeteroGraph`` and the train / test mask dicts. ACM, DBLP and
IMDB use the JSON ``info.dat`` schema, Freebase the tab-table one; IMDB's
labels are multi-label.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np

from ..data.dataset import DownloadableDataset
from ..data.graph import HeteroGraph

__all__ = ["HGBDataset", "HGBACMDataset", "HGBDBLPDataset",
           "HGBFreebaseDataset", "HGBIMDBDataset"]


class HGBDataset(DownloadableDataset):
    """dataset_name: hgb_acm | hgb_dblp | hgb_freebase | hgb_imdb."""

    def __init__(self, dataset_name: str, dataset_root_path=None):
        self.sub_dataset_name = dataset_name.split("_")[1]
        super().__init__(dataset_name=dataset_name,
                         download_file_name=f"{self.sub_dataset_name}.zip", cache_name=None,
                         dataset_root_path=dataset_root_path)

    def _parse_schema(self, data_dir):
        """Returns (n_types: {id: name}, e_types: {id: (src, rel, dst)},
        num_classes or None)."""
        num_classes = None
        if self.sub_dataset_name in ("acm", "dblp", "imdb"):
            with open(os.path.join(data_dir, "info.dat"), encoding="utf-8") as f:
                info = json.load(f)
            n_types = {int(k): v for k, v in info["node.dat"]["node type"].items()}
            e_types = {}
            for key, v in info["link.dat"]["link type"].items():
                src_id, dst_id, rel = tuple(v.values())
                src, dst = n_types[int(src_id)], n_types[int(dst_id)]
                rel = rel.split("-")[1]
                rel = rel if rel != dst and rel[1:] != dst else "to"
                e_types[int(key)] = (src, rel, dst)
            num_classes = len(info["label.dat"]["node type"]["0"])
        elif self.sub_dataset_name == "freebase":
            with open(os.path.join(data_dir, "info.dat"), encoding="utf-8") as f:
                info = f.read().split("\n")
            start = info.index("TYPE\tMEANING") + 1
            end = info[start:].index("")
            n_types = {int(k): v.lower()
                       for k, v in (row.split("\t\t") for row in info[start:start + end])}
            e_types = {}
            start = info.index("LINK\tSTART\tEND\tMEANING") + 1
            end = info[start:].index("")
            for key, row in enumerate(info[start:start + end]):
                src_id, dst_id, rel = [v for v in row.split("\t")[1:] if v != ""]
                e_types[key] = (n_types[int(src_id)], rel.split("-")[1],
                                n_types[int(dst_id)])
        else:
            raise NotImplementedError(
                f"HGB link-prediction subsets unsupported: {self.sub_dataset_name}")
        return n_types, e_types, num_classes

    def process(self):
        data_dir = os.path.join(self.raw_root_path, self.sub_dataset_name)
        if not os.path.isdir(data_dir):
            data_dir = self.raw_root_path
        n_types, e_types, num_classes = self._parse_schema(data_dir)

        # nodes: global id → (type, local id); optional features
        mapping = {}
        x_dict = defaultdict(list)
        num_nodes_dict = defaultdict(int)
        with open(os.path.join(data_dir, "node.dat"), encoding="utf-8") as f:
            rows = [v.split("\t") for v in f.read().split("\n")[:-1]]
        for row in rows:
            n_id, n_type = int(row[0]), n_types[int(row[2])]
            mapping[n_id] = num_nodes_dict[n_type]
            num_nodes_dict[n_type] += 1
            if len(row) >= 4:
                x_dict[n_type].append([float(v) for v in row[3].split(",")])
            else:
                x_dict[n_type].append([np.inf])
        x_dict = {t: np.array(v, np.float64) for t, v in x_dict.items()}

        # edges
        edge_dict = defaultdict(list)
        weight_dict = defaultdict(list)
        with open(os.path.join(data_dir, "link.dat"), encoding="utf-8") as f:
            edges = [v.split("\t") for v in f.read().split("\n")[:-1]]
        for src, dst, rel, weight in edges:
            e_type = e_types[int(rel)]
            edge_dict[e_type].append([mapping[int(src)], mapping[int(dst)]])
            weight_dict[e_type].append(float(weight))
        edge_index_dict = {t: np.array(v, np.int64).T for t, v in edge_dict.items()}
        edge_weight_dict = {
            t: np.array(w, np.float64) for t, w in weight_dict.items()
            if not np.allclose(w, np.ones_like(w))
        }

        # labels + masks (label.dat = train, label.dat.test = test)
        y_dict, train_mask_dict, test_mask_dict = {}, {}, {}

        def ensure_label_store(n_type):
            if n_type in y_dict:
                return
            num_nodes = x_dict[n_type].shape[0]
            if self.sub_dataset_name == "imdb":  # multi-label
                y_dict[n_type] = np.zeros([num_nodes, num_classes], np.int64)
            else:
                y_dict[n_type] = np.full([num_nodes], -1, np.int64)
            train_mask_dict[n_type] = np.zeros(num_nodes, bool)
            test_mask_dict[n_type] = np.zeros(num_nodes, bool)

        def assign(rows, mask_dict):
            for y in rows:
                n_id, n_type = mapping[int(y[0])], n_types[int(y[2])]
                ensure_label_store(n_type)
                if y_dict[n_type].ndim > 1:
                    for v in y[3].split(","):
                        y_dict[n_type][n_id, int(v)] = 1
                else:
                    y_dict[n_type][n_id] = int(y[3])
                mask_dict[n_type][n_id] = True

        with open(os.path.join(data_dir, "label.dat"), encoding="utf-8") as f:
            assign([v.split("\t") for v in f.read().split("\n")[:-1]], train_mask_dict)
        with open(os.path.join(data_dir, "label.dat.test"), encoding="utf-8") as f:
            assign([v.split("\t") for v in f.read().split("\n")[:-1]], test_mask_dict)

        hetero_graph = HeteroGraph(x_dict=x_dict, edge_index_dict=edge_index_dict,
                                   y_dict=y_dict, edge_weight_dict=edge_weight_dict)
        return hetero_graph, train_mask_dict, test_mask_dict


class HGBACMDataset(HGBDataset):
    def __init__(self, dataset_root_path=None):
        super().__init__("hgb_acm", dataset_root_path)


class HGBDBLPDataset(HGBDataset):
    def __init__(self, dataset_root_path=None):
        super().__init__("hgb_dblp", dataset_root_path)


class HGBFreebaseDataset(HGBDataset):
    def __init__(self, dataset_root_path=None):
        super().__init__("hgb_freebase", dataset_root_path)


class HGBIMDBDataset(HGBDataset):
    def __init__(self, dataset_root_path=None):
        super().__init__("hgb_imdb", dataset_root_path)
