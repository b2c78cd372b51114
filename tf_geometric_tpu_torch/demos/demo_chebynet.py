"""ChebyNet node classification (JAX counterpart: ``demo/demo_chebynet.py``):
``ChebyNet(C, k=3)`` over its cached scaled Laplacian, the masked loss with
L2 5e-4, Adam 1e-2, 200 steps.

    python -m tf_geometric_tpu_torch.demos.demo_chebynet            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_chebynet --cpu

Each ``L̂ @ T`` is ``SparseMatrix @``, the COO SpMM (``csrc/spmm_heads.cu``,
X6) at the input width; the input is data, so a step runs the two forward
products and no ``dh``.
"""
from __future__ import annotations

import sys
from typing import Optional

import torch

from ..layers.conv.propagation import ChebyNet
from .demo_utils import run_node_demo

__all__ = ["build_model", "main", "K"]

K = 3


def build_model(graph, num_classes: int, seed: int = 0, device="cuda"):
    """The layer (glorot kernels from ``seed``, the flax parameter names)
    and its ``forward(training, generator, masks=None)`` on ``graph``, whose
    scaled-Laplacian cache the layer builds here."""
    model = ChebyNet(graph.num_features, num_classes, k=K,
                     generator=torch.Generator().manual_seed(seed), device=device)
    model.build_cache_for_graph(graph, device=device)
    return model, (lambda training, generator, masks=None:
                   model([graph.x, graph.edge_index, graph.edge_weight], cache=graph.cache))


def main(device="cuda", num_steps: int = 200, stats: Optional[dict] = None):
    """Train on ``load_cora``; returns the test accuracy."""
    return run_node_demo(build_model, num_steps, device=device, stats=stats)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
