"""SSGC / S²GC: Simple Spectral Graph Convolution (JAX counterpart:
``tf_geometric_tpu/nn/conv/ssgc.py``): out = α·h + Σ_k (1-α)/k · Â^k h.
Dropout as in ``appnp``."""
from __future__ import annotations

import torch

from ...sparse.matrix import SparseMatrix
from .appnp import mlp_encode
from .gcn import compile_and_dropout, compute_cache_key, gcn_norm_adj

__all__ = ["ssgc"]


def ssgc(x, edge_index, edge_weight, kernels=None, biases=None, k: int = 10, alpha: float = 0.1,
         dense_activation=torch.relu, activation=None, dense_drop_rate: float = 0.0,
         last_dense_drop_rate: float = 0.0, edge_drop_rate: float = 0.0, cache=None,
         training: bool = False, generator=None, edge_keep_mask=None, dense_keep_masks=None):
    """The MLP encoder, then out = α·h + Σ_k (1−α)/k · Â^k h over the CSR
    twin of the cached normalized adjacency."""
    num_nodes = x.shape[0]
    normed_adj = gcn_norm_adj(
        SparseMatrix(edge_index, edge_weight, (num_nodes, num_nodes), device=x.device),
        cache=cache)
    normed_adj = compile_and_dropout(
        normed_adj, cache, compute_cache_key("both", True, True, True, False),
        edge_drop_rate, training, generator=generator, keep_mask=edge_keep_mask)

    h = mlp_encode(x, kernels, biases, dense_activation, dense_drop_rate,
                   last_dense_drop_rate, training, generator, dense_keep_masks)

    output = h * alpha
    for _ in range(k):
        h = normed_adj @ h
        output = output + (1.0 - alpha) * h / k

    if activation is not None:
        output = activation(output)
    return output
