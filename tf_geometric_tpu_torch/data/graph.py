"""Graph container (JAX counterpart: ``Graph`` in ``tf_geometric_tpu/data/graph.py``).

A ``Graph`` holds whatever arrays it is given (numpy on the host, as the
datasets make them); ``adj(device=...)`` and ``convert_data_to_tensor``
move them to a device. The per-graph ``cache`` dict holds the normalized
adjacency and its derived CSR twin (``nn/conv/gcn.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.union_utils import convert_union_to_numpy, union_len

__all__ = ["Graph"]


class Graph:
    """A homogeneous graph: node features + weighted edge list + labels.

    ``x`` may be a dense array or a lazy zero-arg callable; ``edge_index`` is
    ``[2, E]`` int32 (row = destination); ``edge_weight`` defaults to ones.
    """

    _FIELDS = ("x", "edge_index", "edge_weight", "y")

    def __init__(self, x=None, edge_index=None, y=None, edge_weight=None):
        if callable(x) and not hasattr(x, "shape"):
            x = x()  # lazy feature callable
        self.x = x
        self.edge_index = None if edge_index is None else self._cast_index(edge_index)
        self.y = y
        if edge_weight is None and self.edge_index is not None:
            edge_weight = np.ones((self.num_edges,), np.float32)
        self.edge_weight = edge_weight
        self.cache: dict = {}

    @staticmethod
    def _cast_index(edge_index):
        if isinstance(edge_index, torch.Tensor):
            return edge_index
        return np.asarray(edge_index, np.int32)

    @property
    def num_nodes(self) -> int:
        if self.x is not None:
            return int(self.x.shape[0])
        if self.edge_index is not None and union_len(self.edge_index[0]):
            return int(np.max(convert_union_to_numpy(self.edge_index))) + 1
        return 0

    @property
    def num_edges(self) -> int:
        return 0 if self.edge_index is None else int(self.edge_index.shape[1])

    @property
    def num_features(self) -> int:
        return int(self.x.shape[-1])

    def adj(self, device="cuda"):
        """The weighted adjacency as a SparseMatrix on ``device``."""
        from ..sparse.matrix import SparseMatrix
        n = self.num_nodes
        return SparseMatrix(self.edge_index, self.edge_weight, (n, n), device=device)

    def convert_data_to_tensor(self, device="cuda") -> "Graph":
        """Move every field onto ``device`` as a tensor, in place."""
        for f in self._FIELDS:
            v = getattr(self, f)
            if v is not None:
                setattr(self, f, torch.as_tensor(convert_union_to_numpy(v), device=device))
        return self
