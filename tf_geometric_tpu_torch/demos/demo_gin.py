"""GIN graph classification (JAX counterpart: ``demo/demo_gin.py``): three
``GIN`` layers, each over an MLP ``Dense(32)``, relu, ``Dense(32)`` with a
trained ε and followed by relu; ``sum_pool``, dropout 0.4, ``Dense(C)``;
padded batches of 32 graphs, Adam 5e-3 (the head-to-head trains it at
3e-3), 300 steps.

    python -m tf_geometric_tpu_torch.demos.demo_gin            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_gin --cpu

Each GIN layer's neighbour sum is the COO SpMM (``csrc/spmm_heads.cu``) on
the card: three forward calls and two ``dh`` a step (the first layer's
input is data).
"""
from __future__ import annotations

import sys

import torch

from ..layers.conv.propagation import GIN
from ..nn.pool.common_pool import sum_pool
from .demo_utils import GraphClassifier, load_graph_classification_data, run_graph_classification

__all__ = ["MLP", "GINModel", "main"]

UNITS, NUM_LAYERS = 32, 3


class MLP(torch.nn.Module):
    """``Dense(units)``, relu, ``Dense(units)``."""

    def __init__(self, in_features: int, units: int = UNITS, device="cuda"):
        super().__init__()
        self.dense0 = torch.nn.Linear(in_features, units, device=device)
        self.dense1 = torch.nn.Linear(units, units, device=device)

    def forward(self, h):
        return self.dense1(torch.relu(self.dense0(h)))


class GINModel(GraphClassifier):
    """The demo's model, with ``bench.GinClassifier``'s parameter names
    (``gins.i.mlp_model.dense0``, ``dense1``, ``gins.i.eps``, ``head``:
    ``convert.gin_classifier_state_dict_from_flax``). ``keep_masks``: the
    readout's dropout mask (bool), in place of a draw."""

    def __init__(self, in_features: int, num_classes: int, num_graphs: int, seed: int = 0,
                 device="cuda"):
        super().__init__(num_graphs, seed, device)
        self.gins = torch.nn.ModuleList(
            GIN(MLP(in_features if i == 0 else UNITS, device=device), train_eps=True,
                device=device)
            for i in range(NUM_LAYERS))
        self.head = torch.nn.Linear(UNITS, num_classes, device=device)
        self._init()

    def forward(self, x, edge_index, edge_weight, node_graph_index, keep_masks=None):
        h = x
        for layer in self.gins:
            h = torch.relu(layer([h, edge_index]))
        h = sum_pool(h, node_graph_index, num_graphs=self.num_graphs)
        return self.head(self.drop(h, 0, keep_masks))


def main(num_steps: int = 300, device="cuda"):
    """Train on NCI1 (its files, or the synthetic fallback); returns the test
    accuracy."""
    graphs, _ = load_graph_classification_data("NCI1")
    in_features = graphs[0].x.shape[1]
    return run_graph_classification(lambda c, g: GINModel(in_features, c, g, device=device),
                                    num_steps=num_steps, device=device)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
