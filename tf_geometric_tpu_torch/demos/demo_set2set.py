"""Set2Set readout graph classification (JAX counterpart:
``demo/demo_set2set.py``): two ``GCN(32, relu)``, ``Set2Set`` over 3
iterations, dropout 0.4, ``Dense(C)``; padded batches of 32 graphs, Adam
5e-3, 300 steps.

    python -m tf_geometric_tpu_torch.demos.demo_set2set            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_set2set --cpu

The model is ``bench.Set2SetClassifier`` with its own dropout generator and
the flax demo's initializers. Its GCNs run the COO SpMM
(``csrc/spmm_heads.cu``, X6) on the padded batch, forward and ``dh``.
"""
from __future__ import annotations

import sys

from ..bench import Set2SetClassifier
from .demo_utils import (dropout_generator, init_like_flax, load_graph_classification_data,
                         run_graph_classification)

__all__ = ["Set2SetModel", "main"]


class Set2SetModel(Set2SetClassifier):
    """The demo's model (submodules with the flax names:
    ``convert.pool_model_state_dict_from_flax``); draws its dropout from a
    generator of its own unless ``keep_mask`` is given. The LSTM cell's
    input bias stays 0 and is not trained: the flax cell's input kernels
    have no bias, its one bias a gate is the cell's ``bias_hh``."""

    def __init__(self, in_features: int, num_classes: int, num_graphs: int, seed: int = 0,
                 device="cuda"):
        super().__init__(in_features, num_classes, num_graphs, device=device)
        self.generator = dropout_generator(seed, device)
        init_like_flax(self, seed)
        self.Set2Set_0.cell.bias_ih.requires_grad_(False)

    def forward(self, x, edge_index, edge_weight, node_graph_index, keep_mask=None):
        return super().forward(x, edge_index, edge_weight, node_graph_index, self.generator,
                               keep_mask)


def main(num_steps: int = 300, device="cuda", stats=None):
    """Train on NCI1 (its files, or the synthetic fallback); returns the
    test accuracy."""
    graphs, _ = load_graph_classification_data("NCI1")
    in_features = graphs[0].x.shape[1]
    return run_graph_classification(lambda c, g: Set2SetModel(in_features, c, g, device=device),
                                    num_steps=num_steps, device=device, stats=stats)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
