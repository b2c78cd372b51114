"""Coauthor CS and Physics (JAX counterpart:
``tf_geometric_tpu/datasets/coauthor.py``): ``CSRNPZDataset``s read from
the raw directory or ``download/<name>.zip``."""
from __future__ import annotations

from .csr_npz import CSRNPZDataset

__all__ = ["CoauthorDataset", "CoauthorCSDataset", "CoauthorPhysicsDataset"]


class CoauthorDataset(CSRNPZDataset):

    def __init__(self, dataset_name: str, dataset_root_path=None):
        super().__init__(dataset_name=dataset_name, download_file_name=f"{dataset_name}.zip",
                         cache_name=None, dataset_root_path=dataset_root_path)


class CoauthorCSDataset(CoauthorDataset):
    def __init__(self, dataset_root_path=None):
        super().__init__("coauthor-cs", dataset_root_path)


class CoauthorPhysicsDataset(CoauthorDataset):
    def __init__(self, dataset_root_path=None):
        super().__init__("coauthor-physics", dataset_root_path)
