"""Planetoid citation datasets: Cora, Citeseer and Pubmed (JAX counterpart:
``tf_geometric_tpu/datasets/planetoid.py``).

Reads the Kipf pickle files ``ind.<name>.{x,y,tx,ty,allx,ally,graph}`` and
``ind.<name>.test.index`` from the dataset's raw directory (or one directory
below it, as an archive unpacks), or from ``download/<name>.zip`` when that
archive is on disk. Nothing is downloaded. The pipeline is the JAX
package's, bit for bit: Citeseer's isolated test nodes get zero rows, the
test rows are reordered, features are row-normalized, the semi-supervised or
supervised index split, self-loops removed and edges made symmetric.

``load_data()`` returns ``(Graph, (train_index, valid_index, test_index))``
with numpy fields; ``convert_data_to_tensor`` moves them to a device.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from ..data.dataset import DownloadableDataset
from ..data.graph import Graph
from ..utils.graph_utils import convert_edge_to_directed, remove_self_loop_edge

__all__ = ["PlanetoidDataset", "CoraDataset", "CiteseerDataset", "PubmedDataset",
           "SupervisedCoraDataset", "SupervisedCiteseerDataset", "SupervisedPubmedDataset"]

_PART_NAMES = ("x", "y", "tx", "ty", "allx", "ally", "graph")


class PlanetoidDataset(DownloadableDataset):
    """One Planetoid dataset; ``task`` is ``"semi_supervised"`` (20 labels a
    class, the next 500 nodes to validate) or ``"supervised"`` (every
    labelled node but the last 500 to train)."""

    def __init__(self, dataset_name: str, task: str = "semi_supervised",
                 dataset_root_path: Optional[str] = None):
        if task not in ("semi_supervised", "supervised"):
            raise ValueError(f"invalid planetoid task: {task}")
        self.task = task
        super().__init__(dataset_name=dataset_name, download_file_name=f"{dataset_name}.zip",
                         cache_name=None, dataset_root_path=dataset_root_path)

    def _raw_file(self, suffix: str) -> str:
        """The raw file, directly under the raw directory or one level down."""
        direct = os.path.join(self.raw_root_path, f"ind.{self.dataset_name}.{suffix}")
        if os.path.exists(direct):
            return direct
        for sub in os.listdir(self.raw_root_path):
            nested = os.path.join(self.raw_root_path, sub, f"ind.{self.dataset_name}.{suffix}")
            if os.path.exists(nested):
                return nested
        raise FileNotFoundError(direct)

    def process(self):
        import scipy.sparse as sp
        parts = {}
        for name in _PART_NAMES:
            with open(self._raw_file(name), "rb") as f:
                parts[name] = pickle.load(f, encoding="latin1")
        with open(self._raw_file("test.index"), encoding="utf-8") as f:
            test_idx_reorder = [int(line.strip()) for line in f if line.strip()]
        test_idx_sorted = np.sort(test_idx_reorder)

        x, y = parts["x"], parts["y"]
        tx, ty = parts["tx"], parts["ty"]
        allx, ally = parts["allx"], parts["ally"]
        if self.dataset_name == "citeseer":
            # isolated test nodes: widen tx / ty to the whole test id range,
            # the missing rows zero
            full = range(int(test_idx_sorted.min()), int(test_idx_sorted.max()) + 1)
            tx_ext = sp.lil_matrix((len(full), x.shape[1]))
            tx_ext[test_idx_sorted - test_idx_sorted.min(), :] = tx
            tx = tx_ext
            ty_ext = np.zeros((len(full), y.shape[1]))
            ty_ext[test_idx_sorted - test_idx_sorted.min(), :] = ty
            ty = ty_ext

        features = sp.vstack((allx, tx)).tolil()
        features[test_idx_reorder, :] = features[test_idx_sorted, :]
        labels = np.vstack((ally, ty))
        labels[test_idx_reorder, :] = labels[test_idx_sorted, :]

        test_index = test_idx_sorted.tolist()
        if self.task == "semi_supervised":
            train_index = list(range(y.shape[0]))
            valid_index = list(range(y.shape[0], y.shape[0] + 500))
        else:
            train_index = list(range(ally.shape[0] - 500))
            valid_index = list(range(ally.shape[0] - 500, ally.shape[0]))

        dense_x = np.asarray(features.todense(), np.float32)
        row_sum = dense_x.sum(axis=-1, keepdims=True)
        dense_x *= np.divide(1.0, row_sum, out=np.ones_like(row_sum), where=row_sum != 0)

        rows, cols = [], []
        for src, neighbors in parts["graph"].items():
            rows.extend([src] * len(neighbors))
            cols.extend(neighbors)
        edge_index = np.stack([np.asarray(rows, np.int64), np.asarray(cols, np.int64)], axis=0)
        edge_index, _ = remove_self_loop_edge(edge_index)
        edge_index, _ = convert_edge_to_directed(edge_index)
        graph = Graph(x=dense_x, edge_index=edge_index,
                      y=np.argmax(labels, axis=-1).astype(np.int32))
        return graph, (train_index, valid_index, test_index)


class CoraDataset(PlanetoidDataset):
    def __init__(self, dataset_root_path=None):
        super().__init__("cora", dataset_root_path=dataset_root_path)


class CiteseerDataset(PlanetoidDataset):
    def __init__(self, dataset_root_path=None):
        super().__init__("citeseer", dataset_root_path=dataset_root_path)


class PubmedDataset(PlanetoidDataset):
    def __init__(self, dataset_root_path=None):
        super().__init__("pubmed", dataset_root_path=dataset_root_path)


class SupervisedCoraDataset(PlanetoidDataset):
    def __init__(self, dataset_root_path=None):
        super().__init__("cora", task="supervised", dataset_root_path=dataset_root_path)


class SupervisedCiteseerDataset(PlanetoidDataset):
    def __init__(self, dataset_root_path=None):
        super().__init__("citeseer", task="supervised", dataset_root_path=dataset_root_path)


class SupervisedPubmedDataset(PlanetoidDataset):
    def __init__(self, dataset_root_path=None):
        super().__init__("pubmed", task="supervised", dataset_root_path=dataset_root_path)
