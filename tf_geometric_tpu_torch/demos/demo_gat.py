"""Multi-head GAT node classification (JAX counterpart: ``demo/demo_gat.py``):
dropout 0.6, ``GAT(64, attention_units=64, heads=8, relu,
edge_drop_rate=0.6)``, dropout 0.6, ``GAT(num_classes, heads=1)``; the
masked loss with L2 5e-4, Adam 5e-3, 200 steps.

    python -m tf_geometric_tpu_torch.demos.demo_gat            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_gat --cpu

Both layers share one ``CsrGatLayout`` of the self-looped graph, built once
in the cache. Each step launches the three attention kernels
(``csrc/gat_attention.cu``: forward, destination and source passes) once a
layer on the card, at (H, d) = (8, 8) with the attention keep mask and
(1, num_classes) without.
"""
from __future__ import annotations

import sys
from typing import Optional

import torch
from torch import nn

from ..layers.base import dropout
from ..layers.conv.gat import GAT
from .demo_utils import load_cora, train_node_classifier

__all__ = ["GATModel", "build_model", "main"]

DROP_RATE = 0.6
LEARNING_RATE = 5e-3
L2_COEF = 5e-4


class GATModel(nn.Module):
    """The demo's model; its layers carry the flax model's names (``GAT_0``,
    ``GAT_1``), so ``convert.gat_state_dict_from_flax`` of the flax
    variables loads into it. ``keep_masks``: x's dropout mask (bool), the
    first layer's attention keep mask ([E, 8] float, scaled, in the cached
    layout's edge order) and the hidden layer's dropout mask (bool), in
    place of draws."""

    def __init__(self, in_features: int, num_classes: int, drop_rate: float = DROP_RATE,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.drop_rate = drop_rate
        self.GAT_0 = GAT(in_features, 64, attention_units=64, activation=torch.relu,
                         num_heads=8, edge_drop_rate=drop_rate, generator=generator,
                         device=device)
        self.GAT_1 = GAT(64, num_classes, attention_units=num_classes, num_heads=1,
                         generator=generator, device=device)

    def forward(self, x, edge_index, cache: Optional[dict] = None,
                generator: Optional[torch.Generator] = None, keep_masks=(None, None, None)):
        x = dropout(x, self.drop_rate, self.training, generator, keep_masks[0])
        h = self.GAT_0([x, edge_index], cache=cache, generator=generator,
                       keep_mask=keep_masks[1])
        h = dropout(h, self.drop_rate, self.training, generator, keep_masks[2])
        return self.GAT_1([h, edge_index], cache=cache)


def build_model(graph, num_classes: int, seed: int = 0, device="cuda"):
    """The model (glorot weights from ``seed``) and the cache dict its
    layers share (the layout is built at the first call)."""
    model = GATModel(graph.num_features, num_classes,
                     generator=torch.Generator().manual_seed(seed), device=device)
    return model, graph.cache


def main(device="cuda", num_steps: int = 200, patience: Optional[int] = None):
    """Train on ``load_cora`` (real files or the synthetic fallback);
    returns the test accuracy."""
    graph, splits = load_cora(device=device)
    num_classes = int(graph.y.max()) + 1
    model, cache = build_model(graph, num_classes, device=device)
    return train_node_classifier(
        lambda training, generator: model(graph.x, graph.edge_index, cache, generator),
        model, graph.y, splits, num_steps=num_steps, learning_rate=LEARNING_RATE,
        l2_coef=L2_COEF, patience=patience)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
