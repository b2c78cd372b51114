"""GIN: Graph Isomorphism Network (JAX counterpart:
``tf_geometric_tpu/nn/conv/gin.py``): ``h = MLP((1 + ε)·x + A·x)`` with a
binary adjacency, its product the COO SpMM of ``ops/spmm.py``.

The MLP is called as ``mlp_model(h)``: a torch module carries its own
training mode, where the JAX function passes ``training`` when the MLP
takes it.
"""
from __future__ import annotations

from ...sparse.matrix import SparseMatrix

__all__ = ["gin", "gin_updater"]


def gin_updater(x, reduced_neighbor_msg, eps):
    return x * (1.0 + eps) + reduced_neighbor_msg


def gin(x, edge_index, mlp_model, eps=0.0):
    """GIN forward: ``MLP((1 + eps)·x + A @ x)``; ``eps`` a float or a
    (trainable) tensor. Out-of-range (padded) edges drop out."""
    num_nodes = x.shape[0]
    sparse_adj = SparseMatrix(edge_index, None, (num_nodes, num_nodes), device=x.device)
    return mlp_model(gin_updater(x, sparse_adj @ x, eps))
