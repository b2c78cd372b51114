"""Top-k pooling graph classification (JAX counterpart:
``demo/demo_topk_pool.py``): ``GCN(32, relu)``, a score ``GCN(1)``, the
fixed-k top-k selection (``topk_pool_fixed``, K = 4 nodes a graph), the
picked rows read as [G, 4·32] (zeros where a graph has fewer nodes),
dropout 0.4, ``Dense(C)``; padded batches of 32 graphs, Adam 5e-3, 300
steps.

    python -m tf_geometric_tpu_torch.demos.demo_topk_pool            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_topk_pool --cpu

Both GCNs run the COO SpMM (``csrc/spmm_heads.cu``, X6) on the padded
batch, forward and ``dh``, at F = 32 and F = 1.
"""
from __future__ import annotations

import sys

import torch

from ..layers.conv.gcn import GCN
from ..nn.pool.topk_pool import topk_pool_fixed
from .demo_utils import GraphClassifier, load_graph_classification_data, run_graph_classification

__all__ = ["TopKPoolModel", "main", "K", "UNITS"]

K, UNITS = 4, 32


class TopKPoolModel(GraphClassifier):
    """The demo's model; its layers carry the flax names (``GCN_0``, the
    score ``GCN_1``, ``Dense_0``: ``convert.topk_pool_model_state_dict_from_flax``).
    ``keep_masks``: the dropout mask (bool), in place of a draw."""

    def __init__(self, in_features: int, num_classes: int, num_graphs: int, seed: int = 0,
                 device="cuda"):
        super().__init__(num_graphs, seed, device)
        self.GCN_0 = GCN(in_features, UNITS, activation=torch.relu, device=device)
        self.GCN_1 = GCN(UNITS, 1, device=device)
        self.Dense_0 = torch.nn.Linear(K * UNITS, num_classes, device=device)
        self._init()

    def forward(self, x, edge_index, edge_weight, node_graph_index, keep_masks=None):
        h = self.GCN_0([x, edge_index, edge_weight])
        score = self.GCN_1([h, edge_index, edge_weight]).reshape(-1)
        idx, valid = topk_pool_fixed(node_graph_index, score, self.num_graphs, K)
        picked = torch.where(valid[:, None], h[idx.clamp(0, h.shape[0] - 1)],
                             torch.zeros((), dtype=h.dtype, device=h.device))
        h = picked.reshape(self.num_graphs, -1)
        return self.Dense_0(self.drop(h, 0, keep_masks))


def main(num_steps: int = 300, device="cuda", stats=None):
    """Train on NCI1 (its files, or the synthetic fallback); returns the
    test accuracy."""
    graphs, _ = load_graph_classification_data("NCI1")
    in_features = graphs[0].x.shape[1]
    return run_graph_classification(lambda c, g: TopKPoolModel(in_features, c, g, device=device),
                                    num_steps=num_steps, device=device, stats=stats)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
