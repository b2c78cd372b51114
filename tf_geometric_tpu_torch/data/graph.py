"""Graph containers (JAX counterparts: ``Graph`` and ``BatchGraph`` in
``tf_geometric_tpu/data/graph.py``).

A ``Graph`` holds whatever arrays it is given (numpy on the host, as the
datasets make them); ``adj(device=...)`` and ``convert_data_to_tensor``
move them to a device. The per-graph ``cache`` dict holds the normalized
adjacency and its derived CSR twin (``nn/conv/gcn.py``). A ``BatchGraph``
is the disjoint union of graphs with per-node and per-edge graph ids, built
on the host with numpy, bit for bit as the JAX package builds it; dense
node features only.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..utils.union_utils import convert_union_to_numpy, union_len

__all__ = ["Graph", "BatchGraph"]


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


class BatchGraph(Graph):
    """Disjoint union of graphs with per-node/per-edge graph ids."""

    _FIELDS = ("x", "edge_index", "edge_weight", "y", "node_graph_index", "edge_graph_index")

    def __init__(self, x=None, edge_index=None, node_graph_index=None,
                 edge_graph_index=None, y=None, edge_weight=None, graphs=None):
        super().__init__(x=x, edge_index=edge_index, y=y, edge_weight=edge_weight)
        self.node_graph_index = node_graph_index
        self.edge_graph_index = edge_graph_index
        self.graphs = graphs

    @property
    def num_graphs(self) -> int:
        if self.graphs is not None:
            return len(self.graphs)
        return int(np.max(convert_union_to_numpy(self.node_graph_index))) + 1

    @classmethod
    def from_graphs(cls, graphs: Sequence[Graph]) -> "BatchGraph":
        """Pack graphs into one disjoint union: edges shifted by each graph's
        node offset, default edge weights of ones, labels concatenated."""
        xs, eis, ews, ys, ngi, egi = [], [], [], [], [], []
        node_offset = 0
        for gid, g in enumerate(graphs):
            n, e = g.num_nodes, g.num_edges
            xs.append(convert_union_to_numpy(g.x))
            if g.edge_index is None:
                eis.append(np.zeros((2, 0), np.int64))
            else:
                eis.append(convert_union_to_numpy(g.edge_index, np.int64) + node_offset)
            ews.append(convert_union_to_numpy(g.edge_weight, np.float32)
                       if g.edge_weight is not None else np.ones(e, np.float32))
            if g.y is not None:
                ys.append(np.atleast_1d(convert_union_to_numpy(g.y)))
            elif ys:
                raise ValueError(f"from_graphs: graph {gid} has y=None while earlier graphs "
                                 "are labeled; mixed labeling would misalign y with graph ids")
            ngi.append(np.full(n, gid, np.int32))
            egi.append(np.full(e, gid, np.int32))
            node_offset += n
        if ys and len(ys) != len(graphs):
            raise ValueError("from_graphs: some graphs have y=None while others are labeled; "
                             "mixed labeling would misalign y with graph ids")
        return cls(x=np.concatenate(xs, axis=0),
                   edge_index=np.concatenate(eis, axis=1).astype(np.int32),
                   node_graph_index=np.concatenate(ngi), edge_graph_index=np.concatenate(egi),
                   y=np.concatenate(ys, axis=0) if ys else None,
                   edge_weight=np.concatenate(ews), graphs=list(graphs))

    def to_graphs(self) -> List[Graph]:
        """Split the union back into graphs. A node's local id is its rank
        among its graph's nodes in input order, so an interleaved
        ``node_graph_index`` splits correctly too."""
        ngi = convert_union_to_numpy(self.node_graph_index, np.int64)
        egi = convert_union_to_numpy(self.edge_graph_index, np.int64)
        x = convert_union_to_numpy(self.x)
        ei = convert_union_to_numpy(self.edge_index, np.int64)
        ew = convert_union_to_numpy(self.edge_weight, np.float32)
        y = convert_union_to_numpy(self.y)
        num_graphs = self.num_graphs
        node_counts = np.bincount(ngi, minlength=num_graphs)
        starts = np.concatenate([[0], np.cumsum(node_counts)[:-1]])
        order = np.argsort(ngi, kind="stable")
        local = np.empty(len(ngi), np.int64)
        local[order] = np.arange(len(ngi)) - starts[ngi[order]]
        graphs = []
        for gid in range(num_graphs):
            nmask, emask = ngi == gid, egi == gid
            sub_y = None
            if y is not None:
                sub_y = y[nmask] if union_len(y) == union_len(ngi) else y[gid]
            graphs.append(Graph(x[nmask], local[ei[:, emask]].astype(np.int32), sub_y,
                                ew[emask]))
        return graphs

    def __repr__(self):
        return (f"BatchGraph(num_graphs={self.num_graphs}, num_nodes={self.num_nodes}, "
                f"num_edges={self.num_edges})")
