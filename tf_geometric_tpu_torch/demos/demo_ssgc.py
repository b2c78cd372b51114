"""SSGC (S²GC) node classification (JAX counterpart: ``demo/demo_ssgc.py``):
``SSGC([C], k=10, alpha=0.1)``, the masked loss with L2 5e-4, Adam 1e-2,
200 steps.

    python -m tf_geometric_tpu_torch.demos.demo_ssgc            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_ssgc --cpu

Each of the ten hops runs Kernel A (``csrc/csr_spmm.cu``) on the cached
normalized adjacency, forward and ``dh``, at F = C.
"""
from __future__ import annotations

import sys
from typing import Optional

import torch

from ..layers.conv.propagation import SSGC
from ..nn.conv.gcn import gcn_build_cache_for_graph
from .demo_utils import run_node_demo

__all__ = ["build_model", "main", "K", "ALPHA"]

K, ALPHA = 10, 0.1


def build_model(graph, num_classes: int, seed: int = 0, device="cuda"):
    """The layer (glorot kernel from ``seed``, the flax parameter names)
    and its ``forward(training, generator, masks=None)`` on ``graph``. The
    layer has no dropout, so no draw is made."""
    gcn_build_cache_for_graph(graph, device=device)
    model = SSGC(graph.num_features, [num_classes], k=K, alpha=ALPHA,
                 generator=torch.Generator().manual_seed(seed), device=device)
    return model, (lambda training, generator, masks=None:
                   model([graph.x, graph.edge_index, graph.edge_weight], cache=graph.cache,
                         generator=generator))


def main(device="cuda", num_steps: int = 200, stats: Optional[dict] = None):
    """Train on ``load_cora``; returns the test accuracy."""
    return run_node_demo(build_model, num_steps, device=device, stats=stats)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
