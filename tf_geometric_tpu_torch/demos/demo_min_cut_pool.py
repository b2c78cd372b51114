"""MinCutPool graph classification (JAX counterpart:
``demo/demo_min_cut_pool.py``): ``GCN(32, relu)``, a ``MinCutPool`` of 8
clusters over a feature ``GCN(32, relu)`` and an assign ``GCN(8)``,
``mean_pool``, dropout 0.4, ``Dense(C)``; the pool's cut and
orthogonality losses added to the objective (``_aux_loss``); padded
batches of 32 graphs, Adam 5e-3, 300 steps.

    python -m tf_geometric_tpu_torch.demos.demo_min_cut_pool            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_min_cut_pool --cpu

The model is the bench's workload 15 (``bench.MinCutPoolClassifier``) with
its own dropout generator and the flax demo's initializers; where the flax
model sows its losses into a collection, this one returns them beside the
logits (the pool's ``return_losses``).
"""
from __future__ import annotations

import sys

from ..bench import MinCutPoolClassifier
from .demo_utils import (dropout_generator, init_like_flax, load_graph_classification_data,
                         run_graph_classification)

__all__ = ["MinCutPoolModel", "_aux_loss", "main"]


class MinCutPoolModel(MinCutPoolClassifier):
    """The demo's model (submodules with the flax names:
    ``convert.pool_model_state_dict_from_flax``): returns ``(logits, (cut,
    orth))``; draws its dropout from a generator of its own unless
    ``keep_mask`` is given."""

    def __init__(self, in_features: int, num_classes: int, num_graphs: int, seed: int = 0,
                 device="cuda"):
        super().__init__(in_features, num_classes, num_graphs, device=device)
        self.generator = dropout_generator(seed, device)
        init_like_flax(self, seed)

    def forward(self, x, edge_index, edge_weight, node_graph_index, keep_mask=None):
        return super().forward(x, edge_index, edge_weight, node_graph_index, self.generator,
                               keep_mask)


def _aux_loss(state):
    """The cut and orthogonality losses the model returned, summed (the JAX
    demo's ``_aux_loss`` of its sown collection)."""
    cut, orth = state
    return cut + orth


def main(num_steps: int = 300, device="cuda"):
    """Train on NCI1 (its files, or the synthetic fallback); returns the test
    accuracy."""
    graphs, _ = load_graph_classification_data("NCI1")
    in_features = graphs[0].x.shape[1]
    return run_graph_classification(
        lambda c, g: MinCutPoolModel(in_features, c, g, device=device), num_steps=num_steps,
        extra_loss_from_state=_aux_loss, device=device)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
