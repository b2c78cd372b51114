"""Sparse (one-hot) node features through a GCN (JAX counterpart:
``demo/demo_sparse_node_features.py``): x is the identity ``sparse.eye(N)``,
multiplied directly against the first kernel; two ``gcn`` calls on
``gcn_build_cache_by_adj(adj)``; numpy-initialized weights, the masked loss
(L2 on no parameter: none is named kernel), Adam 1e-2, 150 steps.

    python -m tf_geometric_tpu_torch.demos.demo_sparse_node_features            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_sparse_node_features --cpu

``x.matmul(w0)`` is the COO SpMM (``csrc/spmm_heads.cu``, X6) on the
identity at F = 32, forward and ``dh``; the propagation is Kernel A
(``csrc/csr_spmm.cu``) on the cached CSR, forward and ``dh`` at F = 32 and
F = C.
"""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..nn.conv.gcn import gcn, gcn_build_cache_by_adj
from ..sparse.matrix import eye
from .demo_utils import load_cora, train_node_classifier

__all__ = ["SparseFeatureGCN", "build_model", "main", "HIDDEN", "INIT_SCALE"]

HIDDEN, INIT_SCALE = 32, 0.05


class SparseFeatureGCN(nn.Module):
    """The demo's parameters ``w0`` [N, 32], ``b0``, ``w1`` [32, C],
    ``b1``, drawn as the JAX demo draws them: ``default_rng(seed)``
    normals of scale 0.05 for ``w0`` then ``w1``, zero biases."""

    def __init__(self, num_nodes: int, num_classes: int, seed: int = 0, device="cuda"):
        super().__init__()
        rng = np.random.default_rng(seed)
        w0 = rng.normal(scale=INIT_SCALE, size=(num_nodes, HIDDEN))
        w1 = rng.normal(scale=INIT_SCALE, size=(HIDDEN, num_classes))
        self.w0 = nn.Parameter(torch.tensor(w0, dtype=torch.float32, device=device))
        self.b0 = nn.Parameter(torch.zeros(HIDDEN, device=device))
        self.w1 = nn.Parameter(torch.tensor(w1, dtype=torch.float32, device=device))
        self.b1 = nn.Parameter(torch.zeros(num_classes, device=device))

    def forward(self, sparse_x, adj, cache: dict):
        h = gcn(sparse_x, adj, self.w0, self.b0, activation=torch.relu, cache=cache)
        return gcn(h, adj, self.w1, self.b1, cache=cache)


def build_model(graph, num_classes: int, seed: int = 0, device="cuda"):
    """The parameters and ``forward(training, generator, masks=None)`` on
    ``graph``: the identity features and the normalization cache of
    ``graph.adj()``, built here."""
    n = graph.num_nodes
    sparse_x, adj = eye(n, device=device), graph.adj(device=device)
    cache = gcn_build_cache_by_adj(adj)
    model = SparseFeatureGCN(n, num_classes, seed, device)
    return model, lambda training, generator, masks=None: model(sparse_x, adj, cache)


def main(device="cuda", num_steps: int = 150, stats: Optional[dict] = None):
    """Train on ``load_cora``; returns the test accuracy."""
    graph, splits = load_cora(device=device)
    model, forward = build_model(graph, int(graph.y.max()) + 1, device=device)
    return train_node_classifier(forward, model, graph.y, splits, num_steps=num_steps,
                                 stats=stats)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
