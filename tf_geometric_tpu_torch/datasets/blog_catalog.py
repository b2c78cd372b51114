"""Multi-label BlogCatalog (JAX counterpart:
``tf_geometric_tpu/datasets/blog_catalog.py``): ``multi_label_blog_catalog.mat``
under the raw directory (or its archive under ``download/``) gives
``(edge_index, y)``."""
from __future__ import annotations

import os

import numpy as np

from ..data.dataset import DownloadableDataset

__all__ = ["MultiLabelBlogCatalogDataset"]


class MultiLabelBlogCatalogDataset(DownloadableDataset):

    def __init__(self, dataset_root_path=None):
        super().__init__(dataset_name="MultiLabelBlogCatalog",
                         download_file_name="multi_label_blog_catalog.zip",
                         cache_name="cache.p", dataset_root_path=dataset_root_path)

    def process(self):
        from scipy.io import loadmat
        data = loadmat(os.path.join(self.raw_root_path, "multi_label_blog_catalog.mat"))
        adj = data["network"].tocoo()
        edge_index = np.stack([adj.row, adj.col], axis=0)
        y = np.asarray(data["group"].tocoo().toarray(), np.float32)
        return edge_index, y
