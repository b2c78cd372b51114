"""Reddit-shaped synthetic graph for the sampled GraphSAGE benchmark (JAX
counterpart: the graph that ``benchmarks/sage_sampling_throughput.py``
builds).

Pure numpy, with the same ``np.random.default_rng`` calls in the same order,
so the same seed gives arrays bit-identical to the JAX benchmark's: uniform
random endpoints, normal float32 features, uniform labels.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..data.graph import Graph

__all__ = ["synthetic_reddit_like", "REDDIT_NODES", "REDDIT_EDGES", "REDDIT_FEATURES",
           "REDDIT_CLASSES"]

REDDIT_NODES, REDDIT_EDGES, REDDIT_FEATURES, REDDIT_CLASSES = 232_965, 11_606_919, 602, 41


def synthetic_reddit_like(num_nodes: int = REDDIT_NODES, num_edges: int = REDDIT_EDGES,
                          num_features: int = REDDIT_FEATURES,
                          num_classes: int = REDDIT_CLASSES, seed: int = 0,
                          rng: Optional[np.random.Generator] = None) -> Graph:
    """Reddit-scale graph: ``edge_index`` int32 [2, E] with uniform random
    endpoints, ``x`` float32 [N, F] standard normal, ``y`` int32 [N]. Draws
    from ``rng`` when given (so the caller can go on drawing from it, as
    the benchmark draws its weights next), else from ``default_rng(seed)``."""
    if rng is None:
        rng = np.random.default_rng(seed)
    edge_index = np.stack([rng.integers(0, num_nodes, num_edges),
                           rng.integers(0, num_nodes, num_edges)]).astype(np.int32)
    x = rng.normal(size=(num_nodes, num_features)).astype(np.float32)
    y = rng.integers(0, num_classes, num_nodes).astype(np.int32)
    return Graph(x=x, edge_index=edge_index, y=y)
