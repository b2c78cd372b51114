"""Fraud-detection datasets in .mat files (JAX counterpart:
``tf_geometric_tpu/datasets/abnormal.py``): ``<name>.mat`` under the raw
directory gives ``(x, edge_index_dict, y)``, one edge list per ``net_*``
relation (and ``homo``)."""
from __future__ import annotations

import os

import numpy as np

from ..data.dataset import DownloadableDataset

__all__ = ["FDYelpChiDataset", "FDAmazonDataset"]


def _csc_to_edge_index(mat):
    coo = mat.tocoo()
    return np.stack([coo.row, coo.col], axis=0)


class _BaseAbnormalMATDataset(DownloadableDataset):

    def __init__(self, dataset_name, dataset_root_path=None):
        super().__init__(dataset_name, download_file_name=f"{dataset_name}.zip",
                         cache_name=None, dataset_root_path=dataset_root_path)

    def process(self):
        from scipy.io import loadmat
        data = loadmat(os.path.join(self.raw_root_path, f"{self.dataset_name}.mat"))
        x = data["features"].tocoo().astype(np.float64)
        y = data["label"][0].astype(np.int64)
        edge_index_dict = {key: _csc_to_edge_index(value) for key, value in data.items()
                           if key.startswith("net_") or key == "homo"}
        return x, edge_index_dict, y


class FDYelpChiDataset(_BaseAbnormalMATDataset):
    def __init__(self, dataset_root_path=None):
        super().__init__("fd_yelp_chi", dataset_root_path)


class FDAmazonDataset(_BaseAbnormalMATDataset):
    def __init__(self, dataset_root_path=None):
        super().__init__("fd_amazon", dataset_root_path)
