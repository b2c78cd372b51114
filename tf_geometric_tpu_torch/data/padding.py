"""Fixed-capacity padding and padded batches (JAX counterparts:
``tf_geometric_tpu/data/padding.py`` and ``batch_padding_spec`` /
``padded_batch_generator`` of ``demo/demo_utils.py``).

The conventions are the JAX package's, kept exactly:

* **Padded nodes** follow the real nodes with zero features and
  ``node_graph_index = num_graphs`` (out of range, dropped by every segment
  op and pool).
* **Padded edges** are ``row = col = num_nodes_capacity`` (out of range)
  with ``edge_weight = 0``: the scatter side drops them, the gather side
  clamps and multiplies by 0.
* Capacities round up to geometric bucket boundaries.

PyTorch needs no fixed shapes to avoid recompiles; the port keeps the
padding so its batches, and so its results, are the JAX package's. All of
it runs on the host with numpy.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..utils.union_utils import convert_union_to_numpy
from .graph import BatchGraph, Graph

__all__ = ["bucket_size", "PaddingSpec", "pad_graph", "pad_batch_graph", "batch_padding_spec",
           "padded_batch_generator"]


def bucket_size(n: int, multiple: int = 128, growth: float = 1.3) -> int:
    """Round ``n`` up to a geometric bucket boundary aligned to ``multiple``."""
    if n <= 0:
        return multiple
    target = multiple
    while target < n:
        target = int(math.ceil(target * growth / multiple) * multiple)
    return target


class PaddingSpec:
    """Fixed capacities for (nodes, edges, graphs) a padded batch must satisfy."""

    def __init__(self, num_nodes: int, num_edges: int, num_graphs: Optional[int] = None):
        self.num_nodes = int(num_nodes)
        self.num_edges = int(num_edges)
        self.num_graphs = None if num_graphs is None else int(num_graphs)

    @classmethod
    def for_graph(cls, graph: Graph, multiple: int = 128,
                  num_graphs: Optional[int] = None) -> "PaddingSpec":
        return cls(bucket_size(graph.num_nodes, multiple),
                   bucket_size(graph.num_edges, multiple), num_graphs)

    def __repr__(self):
        return (f"PaddingSpec(nodes={self.num_nodes}, edges={self.num_edges}, "
                f"graphs={self.num_graphs})")


def _pad_rows(arr, target_rows: int, fill=0):
    arr = convert_union_to_numpy(arr)
    pad = target_rows - arr.shape[0]
    if pad < 0:
        raise ValueError(f"capacity {target_rows} < actual {arr.shape[0]}")
    if pad == 0:
        return arr
    widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, widths, constant_values=fill)


def pad_graph(graph: Graph, spec: PaddingSpec) -> Graph:
    """Pad a Graph to ``spec`` capacities (padded edges point at the
    out-of-range sink index ``spec.num_nodes``)."""
    n_real, e_real = graph.num_nodes, graph.num_edges
    x = _pad_rows(graph.x, spec.num_nodes) if graph.x is not None else None
    ei = convert_union_to_numpy(graph.edge_index, np.int32)
    pad_e = spec.num_edges - e_real
    if pad_e < 0:
        raise ValueError(f"edge capacity {spec.num_edges} < actual {e_real}")
    if pad_e:
        ei = np.concatenate([ei, np.full((2, pad_e), spec.num_nodes, np.int32)], axis=1)
    ew = _pad_rows(graph.edge_weight, spec.num_edges, fill=0.0)
    y = graph.y
    if y is not None and convert_union_to_numpy(y).shape[:1] == (n_real,):
        y = _pad_rows(y, spec.num_nodes)
    out = Graph(x, ei, y, ew)
    out.cache["num_real_nodes"] = n_real
    out.cache["num_real_edges"] = e_real
    return out


def pad_batch_graph(batch: BatchGraph, spec: PaddingSpec) -> BatchGraph:
    """Pad a BatchGraph; padded nodes and edges get the graph id
    ``num_graphs`` (out of range) so pooled readouts ignore them."""
    if spec.num_graphs is None:
        raise ValueError("PaddingSpec.num_graphs required for BatchGraph")
    base = pad_graph(batch, spec)
    ngi = _pad_rows(batch.node_graph_index, spec.num_nodes, fill=spec.num_graphs)
    egi = _pad_rows(batch.edge_graph_index, spec.num_edges, fill=spec.num_graphs)
    out = BatchGraph(base.x, base.edge_index, ngi, egi, base.y, base.edge_weight)
    out.cache.update(base.cache)
    out.cache["num_real_graphs"] = batch.num_graphs
    return out


def batch_padding_spec(graphs, batch_size: int, node_multiple: int = 128,
                       edge_multiple: int = 128) -> PaddingSpec:
    """Fixed capacities covering any ``batch_size`` graphs of ``graphs``."""
    max_nodes = max(g.num_nodes for g in graphs)
    max_edges = max(g.num_edges for g in graphs)
    return PaddingSpec(bucket_size(max_nodes * batch_size, node_multiple),
                       bucket_size(max_edges * batch_size, edge_multiple), batch_size)


def padded_batch_generator(graphs, batch_size: int, shuffle: bool = True, infinite: bool = True,
                           seed: int = 0, node_multiple: int = 128, edge_multiple: int = 128,
                           spec: Optional[PaddingSpec] = None):
    """Yield ``(padded BatchGraph, number of real graphs)``, every batch at
    one spec's capacities; the order comes from ``default_rng(seed)`` as in
    the JAX package's generator."""
    rng = np.random.default_rng(seed)
    if infinite and len(graphs) < batch_size:
        raise ValueError(f"padded_batch_generator: {len(graphs)} graphs < batch_size "
                         f"{batch_size}; every chunk would be dropped")
    if spec is None:
        spec = batch_padding_spec(graphs, batch_size, node_multiple, edge_multiple)
    while True:
        order = rng.permutation(len(graphs)) if shuffle else np.arange(len(graphs))
        for start in range(0, len(order), batch_size):
            chunk = [graphs[i] for i in order[start:start + batch_size]]
            if len(chunk) < batch_size and infinite:
                continue
            yield pad_batch_graph(BatchGraph.from_graphs(chunk), spec), len(chunk)
        if not infinite:
            break
