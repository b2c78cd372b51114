"""APPNP node classification (JAX counterpart: ``demo/demo_appnp.py``):
``APPNP([64, C], k=10, alpha=0.1, dense_drop_rate=0.5,
edge_drop_rate=0.5)``, the masked loss with L2 5e-4, Adam 1e-2, 200 steps.

    python -m tf_geometric_tpu_torch.demos.demo_appnp            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_appnp --cpu

The edge dropout re-skins the cached CSR's values every training step
(``nn.conv.gcn.compile_and_dropout``); each of the ten hops runs Kernel A
(``csrc/csr_spmm.cu``) forward and ``dh`` at F = C.
"""
from __future__ import annotations

import sys
from typing import Optional

import torch

from ..layers.conv.propagation import APPNP
from ..nn.conv.gcn import gcn_build_cache_for_graph
from .demo_utils import run_node_demo

__all__ = ["build_model", "main", "UNITS", "K", "ALPHA", "DROP_RATE"]

UNITS, K, ALPHA, DROP_RATE = 64, 10, 0.1, 0.5


def build_model(graph, num_classes: int, seed: int = 0, device="cuda"):
    """The layer (glorot kernels from ``seed``, the flax parameter names)
    and its ``forward(training, generator, masks=None)`` on ``graph``;
    ``masks``: the edge keep mask over the normalized adjacency's values
    (bool [E + N]) and the first dense layer's (bool [N, 64]), in place of
    draws."""
    gcn_build_cache_for_graph(graph, device=device)
    model = APPNP(graph.num_features, [UNITS, num_classes], k=K, alpha=ALPHA,
                  dense_drop_rate=DROP_RATE, edge_drop_rate=DROP_RATE,
                  generator=torch.Generator().manual_seed(seed), device=device)

    def forward(training, generator, masks=None):
        edge, dense = masks if masks is not None else (None, None)
        return model([graph.x, graph.edge_index, graph.edge_weight], cache=graph.cache,
                     generator=generator, edge_keep_mask=edge,
                     dense_keep_masks=None if dense is None else [dense, None])
    return model, forward


def main(device="cuda", num_steps: int = 200, stats: Optional[dict] = None):
    """Train on ``load_cora``; returns the test accuracy."""
    return run_node_demo(build_model, num_steps, device=device, stats=stats)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
