"""SGC: Simple Graph Convolution (JAX counterpart:
``tf_geometric_tpu/nn/conv/sgc.py``)."""
from __future__ import annotations

from ...sparse.matrix import SparseMatrix
from .gcn import compute_cache_key, gcn_norm_adj, maybe_compile_ell

__all__ = ["sgc"]


def sgc(x, edge_index, edge_weight, k: int, kernel, bias=None, activation=None,
        renorm: bool = True, improved: bool = False, cache=None):
    """h = Â^k (x W): one dense product, then k SpMM hops over the CSR twin
    of the cached normalized adjacency (Kernels A and B on the card)."""
    num_nodes = x.shape[0]
    normed_adj = gcn_norm_adj(
        SparseMatrix(edge_index, edge_weight, (num_nodes, num_nodes), device=x.device),
        renorm=renorm, improved=improved, cache=cache)
    normed_adj = maybe_compile_ell(
        normed_adj, cache, compute_cache_key("both", True, True, renorm, improved))

    h = x.matmul(kernel) if isinstance(x, SparseMatrix) else x @ kernel
    for _ in range(k):
        h = normed_adj @ h

    if bias is not None:
        h = h + bias
    if activation is not None:
        h = activation(h)
    return h
