"""Entry point: the flagship forward of the port (twin of the repository's
``__graft_entry__.entry()``).

``entry()`` returns ``(forward, example_args)``: the 2-layer GCN forward over
a 512-node graph through the cached CSR adjacency, with the normalization
and the CSR build done eagerly on the host first, as in the JAX entry.
"""
from __future__ import annotations

import numpy as np
import torch

from .nn.conv.gcn import compute_cache_key, gcn_norm_adj, maybe_compile_ell
from .sparse.matrix import SparseMatrix

__all__ = ["entry"]


def _make_graph(num_nodes=512, num_edges=2048, num_features=64, num_classes=7, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(num_nodes, num_features)).astype(np.float32)
    edge_index = rng.integers(0, num_nodes, size=(2, num_edges)).astype(np.int32)
    edge_weight = np.ones(num_edges, np.float32)
    y = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    return x, edge_index, edge_weight, y


def entry(device="cuda"):
    """(forward, example_args): ``forward(x, w0, w1) = Â·relu(Â·(x w0))·w1``
    with ``Â`` the cached CSR twin of the normalized adjacency, on ``device``."""
    x, edge_index, edge_weight, _ = _make_graph()
    num_nodes, num_features = x.shape
    hidden, num_classes = 64, 7
    rng = np.random.default_rng(1)
    w0 = rng.normal(scale=0.1, size=(num_features, hidden)).astype(np.float32)
    w1 = rng.normal(scale=0.1, size=(hidden, num_classes)).astype(np.float32)

    cache = {}
    normed = gcn_norm_adj(SparseMatrix(edge_index, edge_weight, (num_nodes, num_nodes),
                                       device=device), cache=cache)
    adj = maybe_compile_ell(normed, cache,
                            compute_cache_key("both", True, True, True, False))

    def forward(x, w0, w1):
        h = torch.relu(adj.matmul(x @ w0))
        return adj.matmul(h @ w1)

    example_args = tuple(torch.as_tensor(a, device=device) for a in (x, w0, w1))
    return forward, example_args
