"""Synthetic citation-style graph for benchmarks (JAX counterpart:
``synthetic_ogbn_arxiv_like`` in ``tf_geometric_tpu/datasets/synthetic_citation.py``).

Pure numpy: the same seed gives arrays bit-identical to the JAX package's,
so both benches run on identical inputs.
"""
from __future__ import annotations

import numpy as np

from ..data.graph import Graph

__all__ = ["synthetic_ogbn_arxiv_like"]


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
