"""Amazon Computers and Photo (JAX counterpart:
``tf_geometric_tpu/datasets/amazon_electronics.py``): ``CSRNPZDataset``s
read from the raw directory or ``download/<name>.zip``."""
from __future__ import annotations

from .csr_npz import CSRNPZDataset

__all__ = ["AmazonElectronicsDataset", "AmazonComputersDataset", "AmazonPhotoDataset"]


class AmazonElectronicsDataset(CSRNPZDataset):

    def __init__(self, dataset_name: str, dataset_root_path=None):
        super().__init__(dataset_name=dataset_name, download_file_name=f"{dataset_name}.zip",
                         cache_name=None, dataset_root_path=dataset_root_path)


class AmazonComputersDataset(AmazonElectronicsDataset):
    def __init__(self, dataset_root_path=None):
        super().__init__("amazon-computers", dataset_root_path)


class AmazonPhotoDataset(AmazonElectronicsDataset):
    def __init__(self, dataset_root_path=None):
        super().__init__("amazon-photo", dataset_root_path)
