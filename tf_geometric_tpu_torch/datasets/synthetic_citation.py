"""Synthetic graphs for benchmarks and tests (JAX counterparts:
``synthetic_ogbn_arxiv_like`` and ``synthetic_graph_classification_hard`` in
``tf_geometric_tpu/datasets/synthetic_citation.py``, and the offline graph
set of ``load_graph_classification_data`` in ``demo/demo_utils.py``).

Pure numpy: the same seed gives arrays bit-identical to the JAX package's,
so both benches run on identical inputs. Nothing here downloads.
"""
from __future__ import annotations

import numpy as np

from ..data.graph import Graph

__all__ = ["synthetic_ogbn_arxiv_like", "synthetic_graph_classification",
           "synthetic_graph_classification_hard"]


def synthetic_ogbn_arxiv_like(
    num_nodes: int = 169_343,
    num_edges: int = 1_166_243,
    num_features: int = 128,
    num_classes: int = 40,
    seed: int = 0,
) -> Graph:
    """ogbn-arxiv-scale graph for throughput benchmarks (dense float features,
    directed citation edges with skewed in-degree)."""
    rng = np.random.default_rng(seed)
    # skewed destinations (preferential-attachment-ish via squared uniform)
    dst = (rng.random(num_edges) ** 2 * num_nodes).astype(np.int64)
    src = rng.integers(0, num_nodes, size=num_edges)
    edge_index = np.stack([dst, src], axis=0).astype(np.int32)
    x = rng.normal(size=(num_nodes, num_features)).astype(np.float32)
    y = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    return Graph(x=x, edge_index=edge_index, y=y)


def synthetic_graph_classification(num_graphs: int = 600, seed: int = 0):
    """The graph set ``load_graph_classification_data`` trains on when the
    TU files are not on disk (``demo/demo_utils.py``): ``num_graphs`` random
    graphs of 10-19 nodes with one-hot features over 4 node labels; class 0
    has 2 random directed edges per node, class 1 has 5. Returns
    ``(graphs, num_classes)``."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(num_graphs):
        label = int(rng.integers(0, 2))
        n = int(rng.integers(10, 20))
        num_edges = n * (2 if label == 0 else 5)
        ei = rng.integers(0, n, size=(2, num_edges)).astype(np.int32)
        x = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
        graphs.append(Graph(x=x, edge_index=ei, y=[label]))
    return graphs, 2


def synthetic_graph_classification_hard(num_graphs: int = 400, num_features: int = 4,
                                        hub_exponent: float = 4.5, seed: int = 0):
    """The hard-mode graph-classification set: two classes with the same
    node and edge counts and constant features; only the wiring differs
    (class 0 draws edge destinations uniformly, class 1 hub-biased,
    ``u ** hub_exponent``), with exactly ``3 n`` unique directed edges per
    graph. Returns ``(graphs, num_classes)``."""
    rng = np.random.default_rng(seed)

    def draw_unique(n, e, hubby):
        pairs = np.empty((0, 2), np.int64)
        for _ in range(64):
            need = e - len(pairs)
            if need <= 0:
                break
            src = rng.integers(0, n, size=need * 2)
            if hubby:
                dst = np.minimum((rng.random(need * 2) ** hub_exponent * n).astype(np.int64),
                                 n - 1)
            else:
                dst = rng.integers(0, n, size=need * 2)
            pairs = np.unique(np.concatenate([pairs, np.stack([dst, src], axis=1)]), axis=0)
        if len(pairs) < e:
            raise RuntimeError(f"drew {len(pairs)} unique edges of {e} for a {n}-node graph")
        return pairs[rng.permutation(len(pairs))[:e]].T

    graphs = []
    for g in range(num_graphs):
        label = int(g % 2)
        n = int(rng.integers(12, 28))
        ei = draw_unique(n, 3 * n, hubby=label == 1).astype(np.int32)
        x = np.full((n, num_features), 1.0 / num_features, np.float32)
        graphs.append(Graph(x=x, edge_index=ei, y=np.asarray([label])))
    order = rng.permutation(num_graphs)
    return [graphs[i] for i in order], 2
