"""Batched graph classification with a GCN encoder and a mean-pool readout
(JAX counterpart: ``demo/demo_mean_pool.py``): ``GCN(64, relu)``, dropout
0.4, ``GCN(32, relu)``, ``mean_pool``, dropout 0.4, ``Dense(C)``; padded
batches of 32 graphs, Adam 5e-3, 300 steps.

    python -m tf_geometric_tpu_torch.demos.demo_mean_pool            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_mean_pool --cpu

The GCNs run uncached on each padded batch: the COO SpMM
(``csrc/spmm_heads.cu``) forward and ``dh`` for each layer on the card.
"""
from __future__ import annotations

import sys

import torch

from ..layers.conv.gcn import GCN
from ..nn.pool.common_pool import mean_pool
from .demo_utils import GraphClassifier, load_graph_classification_data, run_graph_classification

__all__ = ["MeanPoolNetwork", "main"]

BATCH_SIZE = 32
LEARNING_RATE = 5e-3


class MeanPoolNetwork(GraphClassifier):
    """The demo's model; its layers carry the flax names (``GCN_0``,
    ``GCN_1``, ``Dense_0``: ``convert.pool_model_state_dict_from_flax``).
    ``keep_masks``: the two dropout masks (bool), in place of draws."""

    def __init__(self, in_features: int, num_classes: int, num_graphs: int, seed: int = 0,
                 device="cuda"):
        super().__init__(num_graphs, seed, device)
        self.GCN_0 = GCN(in_features, 64, activation=torch.relu, device=device)
        self.GCN_1 = GCN(64, 32, activation=torch.relu, device=device)
        self.Dense_0 = torch.nn.Linear(32, num_classes, device=device)
        self._init()

    def forward(self, x, edge_index, edge_weight, node_graph_index, keep_masks=None):
        h = self.GCN_0([x, edge_index, edge_weight])
        h = self.drop(h, 0, keep_masks)
        h = self.GCN_1([h, edge_index, edge_weight])
        h = mean_pool(h, node_graph_index, num_graphs=self.num_graphs)
        return self.Dense_0(self.drop(h, 1, keep_masks))


def main(num_steps: int = 300, device="cuda"):
    """Train on NCI1 (its files, or the synthetic fallback); returns the test
    accuracy."""
    graphs, _ = load_graph_classification_data("NCI1")
    in_features = graphs[0].x.shape[1]
    return run_graph_classification(
        lambda c, g: MeanPoolNetwork(in_features, c, g, device=device), batch_size=BATCH_SIZE,
        num_steps=num_steps, learning_rate=LEARNING_RATE, device=device)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
