"""Hierarchical SAGPool graph classification (JAX counterpart:
``demo/demo_sag_pool_h.py``): two levels of ``GCN(32, relu)`` then
``SAGPool`` (score ``GCN(1)``, k = 8, tanh), a ``mean_pool`` readout per
level, concatenated, dropout 0.4, ``Dense(C)``; padded batches of 32
graphs, Adam 5e-3, 300 steps.

    python -m tf_geometric_tpu_torch.demos.demo_sag_pool_h            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_sag_pool_h --cpu

The model is the bench's workload 16 (``bench.SAGPoolClassifier``) with
its own dropout generator and the flax demo's initializers.
"""
from __future__ import annotations

import sys

from ..bench import SAGPoolClassifier
from .demo_utils import (dropout_generator, init_like_flax, load_graph_classification_data,
                         run_graph_classification)

__all__ = ["SAGPoolHModel", "main"]


class SAGPoolHModel(SAGPoolClassifier):
    """The demo's model (submodules with the flax names:
    ``convert.pool_model_state_dict_from_flax``); draws its dropout from a
    generator of its own unless ``keep_mask`` is given."""

    def __init__(self, in_features: int, num_classes: int, num_graphs: int, seed: int = 0,
                 device="cuda"):
        super().__init__(in_features, num_classes, num_graphs, device=device)
        self.generator = dropout_generator(seed, device)
        init_like_flax(self, seed)

    def forward(self, x, edge_index, edge_weight, node_graph_index, keep_mask=None):
        return super().forward(x, edge_index, edge_weight, node_graph_index, self.generator,
                               keep_mask)


def main(num_steps: int = 300, device="cuda"):
    """Train on NCI1 (its files, or the synthetic fallback); returns the test
    accuracy."""
    graphs, _ = load_graph_classification_data("NCI1")
    in_features = graphs[0].x.shape[1]
    return run_graph_classification(lambda c, g: SAGPoolHModel(in_features, c, g, device=device),
                                    num_steps=num_steps, device=device)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
