"""TAGCN node classification (JAX counterpart: ``demo/demo_tagcn.py``):
dropout 0.5, ``TAGCN(16, k=3, relu)``, dropout 0.5, ``TAGCN(C, k=3)`` over
the cache built with ``renorm=False``; the masked loss with L2 5e-4, Adam
1e-2, 200 steps.

    python -m tf_geometric_tpu_torch.demos.demo_tagcn            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_tagcn --cpu

Each layer concatenates [x, Âx, Â²x, Â³x] before its dense product, so
Kernel A (``csrc/csr_spmm.cu``) runs three hops at the input width (the
first layer's input is data: forward only) and three hops forward and
``dh`` at F = 16.
"""
from __future__ import annotations

import sys
from typing import Optional

import torch
from torch import nn

from ..layers.base import dropout
from ..layers.conv.propagation import TAGCN
from ..nn.conv.gcn import gcn_build_cache_for_graph
from .demo_utils import run_node_demo

__all__ = ["TAGCNModel", "build_model", "main", "HIDDEN", "K", "DROP_RATE"]

HIDDEN, K, DROP_RATE = 16, 3, 0.5


class TAGCNModel(nn.Module):
    """The demo's model; its layers carry the flax names (``TAGCN_0``,
    ``TAGCN_1``: ``convert.tagcn_model_state_dict_from_flax``).
    ``keep_masks``: x's and the hidden layer's dropout masks (bool), in
    place of draws."""

    def __init__(self, in_features: int, num_classes: int,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.TAGCN_0 = TAGCN(in_features, HIDDEN, k=K, activation=torch.relu,
                             generator=generator, device=device)
        self.TAGCN_1 = TAGCN(HIDDEN, num_classes, k=K, generator=generator, device=device)

    def forward(self, x, edge_index, edge_weight, cache=None, generator=None,
                keep_masks=(None, None)):
        x = dropout(x, DROP_RATE, self.training, generator, keep_masks[0])
        h = self.TAGCN_0([x, edge_index, edge_weight], cache=cache)
        h = dropout(h, DROP_RATE, self.training, generator, keep_masks[1])
        return self.TAGCN_1([h, edge_index, edge_weight], cache=cache)


def build_model(graph, num_classes: int, seed: int = 0, device="cuda"):
    """The model (glorot kernels from ``seed``) and its ``forward(training,
    generator, masks=None)`` on ``graph``, whose cache is built with
    ``renorm=False`` under the key the layers read."""
    gcn_build_cache_for_graph(graph, renorm=False, device=device)
    model = TAGCNModel(graph.num_features, num_classes,
                       generator=torch.Generator().manual_seed(seed), device=device)
    return model, (lambda training, generator, masks=None:
                   model(graph.x, graph.edge_index, graph.edge_weight, graph.cache, generator,
                         masks if masks is not None else (None, None)))


def main(device="cuda", num_steps: int = 200, stats: Optional[dict] = None):
    """Train on ``load_cora``; returns the test accuracy."""
    return run_node_demo(build_model, num_steps, device=device, stats=stats)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
