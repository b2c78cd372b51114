"""The NARS academic ACM heterogeneous dataset (JAX counterpart:
``tf_geometric_tpu/datasets/nars_academic.py``): ``acm.mat`` under the raw
directory becomes a ``HeteroGraph`` over paper, author and field, labelled
by conference (KDD 0, SIGMOD / VLDB 1, SIGCOMM / MOBICOMM 2), with a random
20 / 10 / 70 split per conference drawn from numpy's global generator, as
in JAX.
"""
from __future__ import annotations

import os

import numpy as np

from ..data.dataset import DownloadableDataset
from ..data.graph import HeteroGraph

__all__ = ["NARSACMDataset"]


class _NARSAcademicDataset(DownloadableDataset):

    def __init__(self, dataset_name: str, dataset_root_path=None):
        self.sub_dataset_name = dataset_name.split("_")[-1]
        super().__init__(dataset_name=dataset_name,
                         download_file_name=f"{self.sub_dataset_name}.zip", cache_name=None,
                         dataset_root_path=dataset_root_path)

    def process(self):
        from scipy.io import loadmat
        data = loadmat(os.path.join(self.raw_root_path, "acm.mat"))
        p_vs_l = data["PvsL"]   # paper-field
        p_vs_a = data["PvsA"]   # paper-author
        p_vs_t = data["PvsT"]   # paper-term (bag of words)
        p_vs_c = data["PvsC"]   # paper-conference → labels

        conf_ids = [0, 1, 9, 10, 13]
        label_ids = [0, 1, 2, 2, 1]

        p_selected = np.asarray(
            (p_vs_c[:, conf_ids].sum(1) != 0)).flatten().nonzero()[0]
        p_vs_l = p_vs_l[p_selected].tocoo()
        p_vs_a = p_vs_a[p_selected].tocoo()
        p_vs_t = p_vs_t[p_selected]
        p_vs_c = p_vs_c[p_selected]

        edge_index_dict = {
            ("paper", "pa", "author"): np.stack([p_vs_a.row, p_vs_a.col],
                                                axis=0).astype(np.int64),
            ("paper", "pf", "field"): np.stack([p_vs_l.row, p_vs_l.col],
                                               axis=0).astype(np.int64),
        }
        num_authors = int(p_vs_a.col.max()) + 1
        num_fields = int(p_vs_l.col.max()) + 1
        x_dict = {
            "paper": p_vs_t.toarray().astype(np.float64),
            "author": np.zeros([num_authors, 1], np.float32),
            "field": np.zeros([num_fields, 1], np.float32),
        }

        pc_p, pc_c = p_vs_c.nonzero()
        labels = np.zeros(len(p_selected), np.int64)
        for conf_id, label_id in zip(conf_ids, label_ids):
            labels[pc_p[pc_c == conf_id]] = label_id
        y_dict = {"paper": labels}

        float_mask = np.zeros(len(pc_p))
        for conf_id in conf_ids:
            mask = pc_c == conf_id
            float_mask[mask] = np.random.permutation(
                np.linspace(0, 1, mask.sum()))
        train_index = np.where(float_mask <= 0.2)[0]
        valid_index = np.where((float_mask > 0.2) & (float_mask <= 0.3))[0]
        test_index = np.where(float_mask > 0.3)[0]

        hetero_graph = HeteroGraph(x_dict=x_dict,
                                   edge_index_dict=edge_index_dict,
                                   y_dict=y_dict)
        return hetero_graph, "paper", (train_index, valid_index, test_index)


class NARSACMDataset(_NARSAcademicDataset):
    def __init__(self, dataset_root_path=None):
        super().__init__("nars_academic_acm", dataset_root_path)
