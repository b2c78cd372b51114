"""SortPool graph classification (JAX counterpart: ``demo/demo_sort_pool.py``):
two ``GCN(32, tanh)``, ``SortPool(k=8)`` (each graph's 8 nodes with the
largest last feature), the [G·8, 32] result read as [G, 256],
``Dense(64)``, relu, dropout 0.4, ``Dense(C)``; padded batches of 32
graphs, Adam 5e-3, 300 steps.

    python -m tf_geometric_tpu_torch.demos.demo_sort_pool            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_sort_pool --cpu
"""
from __future__ import annotations

import sys

import torch

from ..layers.conv.gcn import GCN
from ..layers.pool.pool_layers import SortPool
from .demo_utils import GraphClassifier, load_graph_classification_data, run_graph_classification

__all__ = ["SortPoolModel", "main", "K"]

K, UNITS = 8, 32


class SortPoolModel(GraphClassifier):
    """The demo's model; its layers carry the flax names (``GCN_0``,
    ``GCN_1``, ``Dense_0``, ``Dense_1``:
    ``convert.pool_model_state_dict_from_flax``). ``keep_masks``: the
    dropout mask (bool), in place of a draw."""

    def __init__(self, in_features: int, num_classes: int, num_graphs: int, seed: int = 0,
                 device="cuda"):
        super().__init__(num_graphs, seed, device)
        self.GCN_0 = GCN(in_features, UNITS, activation=torch.tanh, device=device)
        self.GCN_1 = GCN(UNITS, UNITS, activation=torch.tanh, device=device)
        self.SortPool_0 = SortPool(k=K, num_graphs=num_graphs)
        self.Dense_0 = torch.nn.Linear(K * UNITS, 64, device=device)
        self.Dense_1 = torch.nn.Linear(64, num_classes, device=device)
        self._init()

    def forward(self, x, edge_index, edge_weight, node_graph_index, keep_masks=None):
        h = self.GCN_0([x, edge_index, edge_weight])
        h = self.GCN_1([h, edge_index, edge_weight])
        px = self.SortPool_0([h, edge_index, edge_weight, node_graph_index])[0]
        h = torch.relu(self.Dense_0(px.reshape(self.num_graphs, -1)))
        return self.Dense_1(self.drop(h, 0, keep_masks))


def main(num_steps: int = 300, device="cuda"):
    """Train on NCI1 (its files, or the synthetic fallback); returns the test
    accuracy."""
    graphs, _ = load_graph_classification_data("NCI1")
    in_features = graphs[0].x.shape[1]
    return run_graph_classification(lambda c, g: SortPoolModel(in_features, c, g, device=device),
                                    num_steps=num_steps, device=device)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
