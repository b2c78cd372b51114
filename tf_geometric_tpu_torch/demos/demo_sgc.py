"""SGC node classification (JAX counterpart: ``demo/demo_sgc.py``):
``SGC(units=C, k=2)`` on the cached normalized adjacency, the masked loss
with L2 5e-5, Adam 0.2, 200 steps.

    python -m tf_geometric_tpu_torch.demos.demo_sgc            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_sgc --cpu

Each step runs Kernel A (``csrc/csr_spmm.cu``) forward and ``dh`` for each
of the two hops at F = C.
"""
from __future__ import annotations

import sys
from typing import Optional

import torch

from ..layers.conv.propagation import SGC
from ..nn.conv.gcn import gcn_build_cache_for_graph
from .demo_utils import run_node_demo

__all__ = ["build_model", "main", "K", "LEARNING_RATE", "L2_COEF"]

K = 2
LEARNING_RATE = 0.2
L2_COEF = 5e-5


def build_model(graph, num_classes: int, seed: int = 0, device="cuda"):
    """The layer (glorot kernel from ``seed``; the flax layer's parameter
    names: ``convert.propagation_state_dict_from_flax``) and its
    ``forward(training, generator, masks=None)`` on ``graph``, whose
    normalization cache is built here."""
    gcn_build_cache_for_graph(graph, device=device)
    model = SGC(graph.num_features, num_classes, k=K,
                generator=torch.Generator().manual_seed(seed), device=device)
    return model, (lambda training, generator, masks=None:
                   model([graph.x, graph.edge_index, graph.edge_weight], cache=graph.cache))


def main(device="cuda", num_steps: int = 200, stats: Optional[dict] = None):
    """Train on ``load_cora`` (files, the synthetic fallback, or the hard
    set under ``TFG_HARD_PROTOCOL=1``); returns the test accuracy."""
    return run_node_demo(build_model, num_steps, LEARNING_RATE, L2_COEF, device, stats)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
