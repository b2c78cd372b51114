"""ASAP hierarchical pooling graph classification (JAX counterpart:
``demo/demo_asap.py``): ``GCN(32, relu)``, ``ASAP(32, k=8)`` in its fixed
mode, ``mean_pool``, dropout 0.4, ``Dense(C)``; padded batches of 16
graphs, Adam 5e-3, 200 steps.

    python -m tf_geometric_tpu_torch.demos.demo_asap            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_asap --cpu

The model is ``bench.ASAPClassifier`` with its own dropout generator and
the flax demo's initializers. Its GCN runs the COO SpMM
(``csrc/spmm_heads.cu``, X6) on the padded batch, forward and ``dh``.
"""
from __future__ import annotations

import sys

from ..bench import ASAP_BATCH, ASAPClassifier
from .demo_utils import (dropout_generator, init_like_flax, load_graph_classification_data,
                         run_graph_classification)

__all__ = ["ASAPModel", "main", "BATCH_SIZE"]

BATCH_SIZE = ASAP_BATCH


class ASAPModel(ASAPClassifier):
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


def main(num_steps: int = 200, device="cuda", stats=None):
    """Train on NCI1 (its files, or the synthetic fallback); returns the
    test accuracy."""
    graphs, _ = load_graph_classification_data("NCI1")
    in_features = graphs[0].x.shape[1]
    return run_graph_classification(lambda c, g: ASAPModel(in_features, c, g, device=device),
                                    batch_size=BATCH_SIZE, num_steps=num_steps, device=device,
                                    stats=stats)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
