"""ModelNet10 and ModelNet40 meshes as graphs (JAX counterpart:
``tf_geometric_tpu/datasets/model_net.py``): every OFF mesh under
``raw/<name>/<class>/{train,test}/`` becomes a Graph of its vertices, the
triangles' edges made symmetric and deduplicated (quads split in two), its
class index as y; parsed by a worker pool. Reads the files on disk (or the
archive under ``download/``); nothing is downloaded. Returns
``(train_graphs, test_graphs, label_names)``; within a class and split the
graphs follow the directory listing's order (``Pool.imap``)."""
from __future__ import annotations

import os
from multiprocessing import Pool

import numpy as np

from ..data.dataset import DownloadableDataset
from ..data.graph import Graph

__all__ = ["ModelNetDataset", "ModelNet10Dataset", "ModelNet40Dataset"]


class ModelNetDataset(DownloadableDataset):

    def __init__(self, dataset_name, dataset_root_path=None, num_processes: int = 8):
        super().__init__(dataset_name, download_file_name=f"{dataset_name}.zip",
                         cache_name="cache.p", dataset_root_path=dataset_root_path)
        self.num_processes = num_processes

    def read_off(self, off_file_info):
        """One OFF mesh as a Graph."""
        import scipy.sparse as sp
        off_fpath, label_index = off_file_info
        with open(off_fpath, encoding="utf-8") as f:
            line = f.readline()
            # some files put the counts on the OFF line itself
            line = line[3:] if line.strip() != "OFF" else f.readline()
            num_nodes, num_faces, _ = [int(v) for v in line.split()]
            node_features = [[float(v) for v in f.readline().split()] for _ in range(num_nodes)]
            triangles = []
            for _ in range(num_faces):
                items = [int(v) for v in f.readline().split()]
                if items[0] == 3:
                    triangles.append(items[1:4])
                else:
                    triangles.append([items[1], items[2], items[3]])
                    triangles.append([items[1], items[3], items[4]])
        x = np.array(node_features)
        tri = np.array(triangles)
        edges = np.concatenate([tri[:, :2], tri[:, 1:], tri[:, ::2]], axis=0)
        row = np.concatenate([edges[:, 0], edges[:, 1]])
        col = np.concatenate([edges[:, 1], edges[:, 0]])
        adj = sp.csr_matrix((np.ones_like(row), (row, col)), shape=[num_nodes, num_nodes])
        adj.data[adj.data > 1] = 1
        adj = adj.tocoo()
        return Graph(x=x, edge_index=np.stack([adj.row, adj.col], axis=0), y=[label_index])

    def process(self):
        data_dir = os.path.join(self.raw_root_path, self.dataset_name)
        label_names = sorted(d for d in os.listdir(data_dir)
                             if os.path.isdir(os.path.join(data_dir, d)))
        train_graphs, test_graphs = [], []
        with Pool(processes=self.num_processes) as pool:
            for label_index, label_name in enumerate(label_names):
                for split, split_graphs in (("train", train_graphs), ("test", test_graphs)):
                    split_path = os.path.join(data_dir, label_name, split)
                    inputs = [(os.path.join(split_path, f), label_index)
                              for f in os.listdir(split_path) if f != ".DS_Store"]
                    split_graphs.extend(pool.imap(self.read_off, inputs))
        return train_graphs, test_graphs, label_names


class ModelNet10Dataset(ModelNetDataset):
    def __init__(self, dataset_root_path=None, num_processes: int = 8):
        super().__init__("ModelNet10", dataset_root_path=dataset_root_path,
                         num_processes=num_processes)


class ModelNet40Dataset(ModelNetDataset):
    def __init__(self, dataset_root_path=None, num_processes: int = 8):
        super().__init__("ModelNet40", dataset_root_path=dataset_root_path,
                         num_processes=num_processes)
