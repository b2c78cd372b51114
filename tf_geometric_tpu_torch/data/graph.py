"""Graph containers (JAX counterpart: ``tf_geometric_tpu/data/graph.py``):
``Graph``, ``BatchGraph``, ``HeteroGraph`` and ``HeteroBatchGraph``.

A ``Graph`` holds whatever arrays it is given (numpy on the host, as the
datasets make them); ``adj(device=...)`` and ``convert_data_to_tensor``
move them to a device. ``x`` may also be a SparseMatrix. The per-graph
``cache`` dict holds the normalized adjacency and its derived CSR twin
(``nn/conv/gcn.py``). A ``BatchGraph`` is the disjoint union of graphs with
per-node and per-edge graph ids, built on the host with numpy, bit for bit
as the JAX package builds it (sparse node features through
``sparse.concat``). The edge transforms (``to_directed``) and node-induced
subgraphs (``sample_new_graph_by_node_index``) run on the host and give
numpy arrays, as in JAX. The hetero containers are host-side dicts of numpy
arrays keyed by node type and by ``(src, relation, dst)`` edge type.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..sparse.matrix import SparseMatrix
from ..utils.union_utils import convert_union_to_numpy, union_len

__all__ = ["Graph", "BatchGraph", "HeteroGraph", "HeteroBatchGraph"]


class Graph:
    """A homogeneous graph: node features + weighted edge list + labels.

    ``x`` may be a dense array, a SparseMatrix or a lazy zero-arg callable;
    ``edge_index`` is ``[2, E]`` int32 (row = destination); ``edge_weight``
    defaults to ones.
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
        n = self.num_nodes
        return SparseMatrix(self.edge_index, self.edge_weight, (n, n), device=device)

    def _copy_for_conversion(self) -> "Graph":
        """A shallow copy of the same class (a BatchGraph keeps ``graphs``)
        with its own cache dict."""
        target = copy.copy(self)
        target.cache = dict(self.cache)
        return target

    def convert_data_to_tensor(self, inplace: bool = True, device="cuda") -> "Graph":
        """Every field as a tensor on ``device``, in place or on a copy (a
        SparseMatrix ``x`` is rebuilt there). A field that is already a
        tensor is moved with ``.to``, so one that requires grad stays in its
        autograd graph."""
        target = self if inplace else self._copy_for_conversion()
        for f in self._FIELDS:
            v = getattr(self, f)
            if isinstance(v, SparseMatrix):
                v = SparseMatrix(v.index.to(device), v.value.to(device), v.shape)
            elif isinstance(v, torch.Tensor):
                v = v.to(device)
            elif v is not None:
                v = torch.as_tensor(convert_union_to_numpy(v), device=device)
            setattr(target, f, v)
        return target

    def convert_data_to_numpy(self, inplace: bool = True) -> "Graph":
        """Every field but a SparseMatrix ``x`` as numpy, in place or on a copy."""
        target = self if inplace else self._copy_for_conversion()
        for f in self._FIELDS:
            v = getattr(self, f)
            if v is not None and not isinstance(v, SparseMatrix):
                v = convert_union_to_numpy(v)
            setattr(target, f, v)
        return target

    def to_directed(self, merge_mode: str = "sum", inplace: bool = True) -> "Graph":
        """An undirected edge list as a symmetric directed one: each edge
        canonicalized to (min, max), duplicates merged by ``merge_mode``
        (sum, mean, max, min or first), then mirrored. Host-side."""
        from ..utils.graph_utils import convert_edge_to_directed
        edge_index, props = convert_edge_to_directed(
            convert_union_to_numpy(self.edge_index, np.int32),
            None if self.edge_weight is None else [convert_union_to_numpy(self.edge_weight)],
            None if self.edge_weight is None else [merge_mode])
        target = self if inplace else Graph(self.x, edge_index, self.y)
        target.edge_index = edge_index
        target.edge_weight = None if props is None else props[0]
        if target.edge_weight is None:
            target.edge_weight = np.ones(edge_index.shape[1], np.float32)
        return target

    def sample_new_graph_by_node_index(self, sampled_node_index) -> "Graph":
        """The subgraph induced by ``sampled_node_index``, its edges
        relabelled to the sample's order. Host-side (the sizes depend on the
        data); the fixed-size, masked form is ``nn/pool/_subgraph.py``'s."""
        return self._sample_subgraph(sampled_node_index)[0]

    def _sample_subgraph(self, sampled_node_index):
        """The subgraph and its kept-edge mask (numpy), so a subclass can cut
        its own per-edge fields without computing the mask again."""
        from ..utils.graph_utils import (compute_edge_mask_by_node_index,
                                         reindex_sampled_edge_index)
        node_index = convert_union_to_numpy(sampled_node_index, np.int64)
        if isinstance(self.x, SparseMatrix):
            from ..utils.tf_sparse_utils import sparse_gather_sub
            new_x = sparse_gather_sub(self.x, node_index)
        else:
            x = convert_union_to_numpy(self.x)
            new_x = None if x is None else x[node_index]
        edge_index = convert_union_to_numpy(self.edge_index, np.int64)
        mask = compute_edge_mask_by_node_index(edge_index, node_index,
                                               num_nodes=self.num_nodes).numpy()
        new_edge_index = reindex_sampled_edge_index(edge_index[:, mask], node_index)
        new_weight = (None if self.edge_weight is None
                      else convert_union_to_numpy(self.edge_weight)[mask])
        y = convert_union_to_numpy(self.y)
        new_y = None if y is None else (y[node_index] if union_len(y) == self.num_nodes else y)
        return Graph(new_x, new_edge_index, new_y, new_weight), mask

    def __repr__(self):
        return (f"Graph(num_nodes={self.num_nodes}, num_edges={self.num_edges}, "
                f"num_features={None if self.x is None else self.num_features})")


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
        node offset, default edge weights of ones, labels concatenated. When
        any graph's ``x`` is a SparseMatrix, the features are stacked with
        ``sparse.concat``."""
        from ..sparse.matrix import concat as sparse_concat
        eis, ews, ys, ngi, egi = [], [], [], [], []
        node_offset = 0
        for gid, g in enumerate(graphs):
            n, e = g.num_nodes, g.num_edges
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
        if any(isinstance(g.x, SparseMatrix) for g in graphs):
            x = sparse_concat([g.x for g in graphs], axis=0)
        else:
            x = np.concatenate([convert_union_to_numpy(g.x) for g in graphs], axis=0)
        return cls(x=x, edge_index=np.concatenate(eis, axis=1).astype(np.int32),
                   node_graph_index=np.concatenate(ngi), edge_graph_index=np.concatenate(egi),
                   y=np.concatenate(ys, axis=0) if ys else None,
                   edge_weight=np.concatenate(ews), graphs=list(graphs))

    def to_graphs(self) -> List[Graph]:
        """Split the union back into graphs. A node's local id is its rank
        among its graph's nodes in input order, so an interleaved
        ``node_graph_index`` splits correctly too; a SparseMatrix ``x``
        splits by ``sparse_gather_sub``."""
        ngi = convert_union_to_numpy(self.node_graph_index, np.int64)
        egi = convert_union_to_numpy(self.edge_graph_index, np.int64)
        x_is_sparse = isinstance(self.x, SparseMatrix)
        x = self.x if x_is_sparse else convert_union_to_numpy(self.x)
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
            if x_is_sparse:
                from ..utils.tf_sparse_utils import sparse_gather_sub
                sub_x = sparse_gather_sub(x, np.nonzero(nmask)[0])
            else:
                sub_x = x[nmask]
            sub_y = None
            if y is not None:
                sub_y = y[nmask] if union_len(y) == union_len(ngi) else y[gid]
            graphs.append(Graph(sub_x, local[ei[:, emask]].astype(np.int32), sub_y, ew[emask]))
        return graphs

    def to_directed(self, merge_mode: str = "sum", inplace: bool = True) -> "BatchGraph":
        """``Graph.to_directed`` that also carries ``edge_graph_index``
        (merged with "max": a merged edge keeps its graph's id)."""
        from ..utils.graph_utils import convert_edge_to_directed
        props = [convert_union_to_numpy(self.edge_weight),
                 convert_union_to_numpy(self.edge_graph_index)]
        edge_index, new_props = convert_edge_to_directed(
            convert_union_to_numpy(self.edge_index, np.int32), props, [merge_mode, "max"])
        target = self if inplace else BatchGraph(
            self.x, edge_index, self.node_graph_index, None, self.y, None, self.graphs)
        target.edge_index = edge_index
        target.edge_weight = new_props[0]
        target.edge_graph_index = new_props[1].astype(np.int32)
        return target

    def sample_new_graph_by_node_index(self, sampled_node_index) -> "BatchGraph":
        """The induced subgraph with its batch bookkeeping: the kept nodes'
        and edges' graph ids."""
        base, mask = self._sample_subgraph(sampled_node_index)
        node_index = convert_union_to_numpy(sampled_node_index, np.int64)
        ngi = convert_union_to_numpy(self.node_graph_index, np.int32)[node_index]
        egi = convert_union_to_numpy(self.edge_graph_index, np.int32)[mask]
        return BatchGraph(base.x, base.edge_index, ngi, egi, base.y, base.edge_weight)

    def __repr__(self):
        return (f"BatchGraph(num_graphs={self.num_graphs}, num_nodes={self.num_nodes}, "
                f"num_edges={self.num_edges})")


class HeteroGraph:
    """A heterogeneous graph on the host: ``x_dict`` and ``y_dict`` keyed by
    node type, ``edge_index_dict`` and ``edge_weight_dict`` by ``(src,
    relation, dst)``; for an edge type, ``edge_index[0]`` holds src-typed
    ids and ``edge_index[1]`` dst-typed ids. Weights default to ones."""

    def __init__(self, x_dict=None, edge_index_dict=None, y_dict=None,
                 edge_weight_dict=None):
        self.x_dict = dict(x_dict or {})
        self.edge_index_dict = {k: np.asarray(convert_union_to_numpy(v), np.int32)
                                for k, v in (edge_index_dict or {}).items()}
        self.y_dict = dict(y_dict or {})
        self.edge_weight_dict = {k: np.asarray(convert_union_to_numpy(w), np.float32)
                                 for k, w in (edge_weight_dict or {}).items()}
        for etype, ei in self.edge_index_dict.items():
            if etype not in self.edge_weight_dict:
                self.edge_weight_dict[etype] = np.ones(ei.shape[1], np.float32)
        self.cache: dict = {}

    @property
    def node_types(self):
        return list(self.x_dict.keys())

    @property
    def edge_types(self):
        return list(self.edge_index_dict.keys())

    def num_nodes_of(self, ntype) -> int:
        return int(self.x_dict[ntype].shape[0])

    @property
    def num_nodes_dict(self) -> Dict[str, int]:
        return {t: self.num_nodes_of(t) for t in self.node_types}

    def add_reversed_edges(self, inplace: bool = True) -> "HeteroGraph":
        """Add the mirror ``(dst, "r." + rel, src)`` of every edge type that
        has none, with the same weights. ``inplace=False`` works on a copy of
        the same class."""
        target = self if inplace else copy.copy(self)
        if not inplace:
            target.edge_index_dict = dict(self.edge_index_dict)
            target.edge_weight_dict = dict(self.edge_weight_dict)
            target.cache = {}
        for (src, rel, dst) in list(target.edge_index_dict.keys()):
            rev = (dst, "r." + rel, src)
            if rev in target.edge_index_dict:
                continue
            target.edge_index_dict[rev] = target.edge_index_dict[(src, rel, dst)][::-1].copy()
            target.edge_weight_dict[rev] = target.edge_weight_dict[(src, rel, dst)].copy()
        return target

    def __repr__(self):
        return f"HeteroGraph(node_types={self.node_types}, edge_types={self.edge_types})"


class HeteroBatchGraph(HeteroGraph):
    """The disjoint union of HeteroGraphs, per node type and per edge type,
    with per-type graph ids (``node_graph_index_dict``,
    ``edge_graph_index_dict``)."""

    def __init__(self, x_dict=None, edge_index_dict=None, node_graph_index_dict=None,
                 edge_graph_index_dict=None, y_dict=None, edge_weight_dict=None, graphs=None):
        super().__init__(x_dict, edge_index_dict, y_dict, edge_weight_dict)
        self.node_graph_index_dict = dict(node_graph_index_dict or {})
        self.edge_graph_index_dict = dict(edge_graph_index_dict or {})
        self.graphs = graphs

    @property
    def num_graphs(self) -> int:
        if self.graphs is not None:
            return len(self.graphs)
        any_ngi = next(iter(self.node_graph_index_dict.values()))
        return int(np.max(convert_union_to_numpy(any_ngi))) + 1

    @classmethod
    def from_graphs(cls, graphs: Sequence[HeteroGraph]) -> "HeteroBatchGraph":
        """Types in first-seen order; each node type's features stacked with
        per-graph offsets, each edge type's edges shifted by its source and
        destination types' offsets, labels concatenated per type."""
        ntypes, etypes = [], []
        for g in graphs:
            ntypes += [t for t in g.node_types if t not in ntypes]
            etypes += [t for t in g.edge_types if t not in etypes]
        x_dict, ngi_dict, offsets = {}, {}, {t: [] for t in ntypes}
        for t in ntypes:
            xs, ngis, off = [], [], 0
            for gid, g in enumerate(graphs):
                offsets[t].append(off)
                if t not in g.x_dict:
                    continue
                x = convert_union_to_numpy(g.x_dict[t])
                xs.append(x)
                ngis.append(np.full(x.shape[0], gid, np.int32))
                off += x.shape[0]
            x_dict[t] = np.concatenate(xs, axis=0)
            ngi_dict[t] = np.concatenate(ngis)
        ei_dict, ew_dict, egi_dict = {}, {}, {}
        for t in etypes:
            src_t, _, dst_t = t
            eis, ews, egis = [], [], []
            for gid, g in enumerate(graphs):
                if t not in g.edge_index_dict:
                    continue
                ei = convert_union_to_numpy(g.edge_index_dict[t], np.int64).copy()
                ei[0] += offsets[src_t][gid] if src_t in offsets else 0
                ei[1] += offsets[dst_t][gid] if dst_t in offsets else 0
                eis.append(ei)
                ews.append(convert_union_to_numpy(g.edge_weight_dict[t], np.float32))
                egis.append(np.full(ei.shape[1], gid, np.int32))
            ei_dict[t] = np.concatenate(eis, axis=1).astype(np.int32)
            ew_dict[t] = np.concatenate(ews)
            egi_dict[t] = np.concatenate(egis)
        y_dict = {}
        for t in ntypes:
            ys = [np.atleast_1d(convert_union_to_numpy(g.y_dict[t]))
                  for g in graphs if t in g.y_dict and g.y_dict[t] is not None]
            if ys:
                y_dict[t] = np.concatenate(ys, axis=0)
        return cls(x_dict, ei_dict, ngi_dict, egi_dict, y_dict, ew_dict, list(graphs))
